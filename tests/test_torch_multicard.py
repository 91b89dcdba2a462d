"""The port's sharded layer at world size 4, and how a rank picks its card.

- ``parallel/multihost.py::global_mesh`` (through ``make_mesh``) with
  ``torch.cuda`` and ``torch.distributed`` stood in for: ``LOCAL_RANK``
  puts a rank on its card before and after the process used CUDA; without
  it, or where it names no visible card (one visible card a rank), a rank
  takes ``rank % cards`` unless it used CUDA before; NCCL ranks that would
  share a physical card (one UUID) raise on every rank and name it, ranks
  on one card index of different physical cards pass; gloo ranks may
  share one.
- Four gloo ranks on the CPU (``tests/torch_dist_ranks.py``, started once
  for the module): the sharded BA, the data-parallel frontend,
  keyframe-sharded matching and composed SLAM on the orbit, held to
  ``tests/test_torch_distributed.py``'s bars (its ``check_*`` helpers); the
  BA also against the JAX package's on a 4-device mesh; the store exchange
  of every rank's card; every rank's outputs bit-equal to rank 0's.
"""

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sift_scale_space_extrema_detection_tpu_torch.parallel import make_mesh, multihost

from tests.test_torch_distributed import (
    BA_PROBLEMS,
    _inputs as world_2_inputs,
    check_ba,
    check_ba_against_the_reference,
    check_frontend,
    check_keyframe_matching,
    check_same_bits,
    check_slam_orbit,
)
from tests.torch_dist_ranks import THRESHOLDS, shared_run

torch.set_num_threads(2)

WORLD = 4
SCENARIOS = ["bundle_adjust", "card_exchange", "frontend", "keyframe_matching", "slam_orbit"]
# The store exchange's cases: row 0 each rank's card index, row 1 the
# physical card (UUID) it names.
CARD_CASES = {
    "own": np.array([[0, 1, 2, 3], [0, 1, 2, 3]]),  # rank r on card r
    "shared": np.array([[0, 1, 2, 2], [0, 1, 2, 2]]),  # ranks 2 and 3 on card 2
    "one_visible": np.array([[0, 0, 0, 0], [0, 1, 2, 3]]),  # each sees only its own card
}


# --- the card a rank takes ------------------------------------------------------------------


class FakeCards:
    """``torch.cuda`` and ``torch.distributed`` as a rank of a host with
    ``cards`` visible cards sees them; card ``i``'s UUID is
    ``uuids[i]``. ``exchanged`` is what the store exchange returns
    (``None``: it must not run); ``asked`` what this rank offered it."""

    def __init__(self, monkeypatch, rank, world, backend="nccl", cards=4, initialized=False,
                 current=0, exchanged=None, uuids=None):
        self.initialized, self.current, self.set_to = initialized, current, []
        self.exchanged, self.asked = exchanged, []
        uuids = uuids or [f"GPU-{i}" for i in range(cards)]
        cuda = torch.cuda
        monkeypatch.setattr(cuda, "is_available", lambda: True)
        monkeypatch.setattr(cuda, "device_count", lambda: cards)
        monkeypatch.setattr(cuda, "is_initialized", lambda: self.initialized)
        monkeypatch.setattr(cuda, "set_device", self._set_device)
        monkeypatch.setattr(cuda, "current_device", lambda: self.current)
        monkeypatch.setattr(cuda, "get_device_properties",
                            lambda card: types.SimpleNamespace(uuid=uuids[card]))
        monkeypatch.setattr(dist, "get_rank", lambda: rank)
        monkeypatch.setattr(dist, "get_world_size", lambda: world)
        monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
        monkeypatch.setattr(multihost, "_rank_cards", self._rank_cards)
        monkeypatch.setattr(multihost, "init_device_mesh",
                            lambda kind, shape, mesh_dim_names: (kind, shape, mesh_dim_names))

    def _set_device(self, card):
        self.set_to.append(card)
        self.current = card

    def _rank_cards(self, identity):
        assert self.exchanged is not None, "the cards were exchanged under gloo"
        self.asked.append(identity[1:])
        return self.exchanged


def _own(world, host="host"):
    """Rank r on card r of ``host``."""
    return [[host, r, f"{host}-GPU-{r}"] for r in range(world)]


@pytest.mark.parametrize("initialized", [False, True])
def test_local_rank_picks_the_card_before_and_after_cuda_was_used(monkeypatch, initialized):
    """Rank 6 of 8 on two hosts of 4 cards, started by torchrun: card 2,
    whatever the process did with CUDA before (``get_device_name`` alone
    initialises it)."""
    monkeypatch.setenv("LOCAL_RANK", "2")
    fake = FakeCards(monkeypatch, rank=6, world=8, initialized=initialized,
                     exchanged=_own(4, "a") + _own(4, "b"))
    assert make_mesh(8) == ("cuda", (8,), ("shard",))
    assert fake.set_to == [2] and fake.current == 2 and fake.asked == [[2, "GPU-2"]]


def test_without_local_rank_a_rank_takes_rank_modulo_cards(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    fake = FakeCards(monkeypatch, rank=5, world=8, exchanged=_own(4, "a") + _own(4, "b"))
    make_mesh(8)
    assert fake.set_to == [1] and fake.asked == [[1, "GPU-1"]]


def test_without_local_rank_a_rank_that_used_cuda_keeps_its_card(monkeypatch):
    """The rule before ``LOCAL_RANK`` was read, kept where torchrun is not
    used: a process that chose its card itself keeps it."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    fake = FakeCards(monkeypatch, rank=1, world=4, initialized=True, current=3,
                     exchanged=[_own(4)[c] for c in (2, 3, 0, 1)])
    make_mesh(4)
    assert fake.set_to == [] and fake.asked == [[3, "GPU-3"]]


@pytest.mark.parametrize("local_rank", [1, 2, 3])
def test_one_visible_card_a_rank_under_nccl_passes(monkeypatch, local_rank):
    """``srun --gpus-per-task=1`` or ``CUDA_VISIBLE_DEVICES`` per rank: each
    rank sees one card, index 0, whatever its ``LOCAL_RANK``; the cards are
    told apart by their UUIDs, and every rank stays on its one card."""
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    fake = FakeCards(monkeypatch, rank=local_rank, world=4, cards=1, initialized=True,
                     uuids=[f"GPU-{local_rank}"],
                     exchanged=[["h", 0, f"GPU-{r}"] for r in range(4)])
    assert make_mesh(4)[0] == "cuda"
    assert fake.set_to == [] and fake.asked == [[0, f"GPU-{local_rank}"]]


def test_gloo_ranks_beyond_the_visible_cards_share_one(monkeypatch):
    """torchrun with four gloo ranks on a host of one card: ``LOCAL_RANK`` 3
    names no card, so the rank takes ``rank % cards``; no exchange, no
    error."""
    monkeypatch.setenv("LOCAL_RANK", "3")
    fake = FakeCards(monkeypatch, rank=3, world=4, backend="gloo", cards=1)
    assert make_mesh(4)[0] == "cuda" and fake.set_to == [0]


def test_nccl_ranks_that_would_share_a_card_raise_and_name_it(monkeypatch):
    """The old failure: every rank printed the card's name first (CUDA
    initialised), so every rank stayed on card 0."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    FakeCards(monkeypatch, rank=2, world=4, initialized=True, current=0,
              exchanged=[["h", 0, "GPU-0"]] * 4)
    with pytest.raises(RuntimeError, match=r"ranks \[0, 1, 2, 3\] on cuda:0 of h \(GPU-0\)"):
        make_mesh(4)


def test_nccl_ranks_on_one_card_index_of_two_hosts_pass(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    FakeCards(monkeypatch, rank=1, world=2, cards=1, exchanged=_own(1, "a") + _own(1, "b"))
    assert make_mesh(2)[0] == "cuda"


def test_gloo_ranks_may_share_a_card(monkeypatch):
    """Two gloo ranks on one card (``chip_smoke.py`` phase 17 (b)): no
    exchange, no error."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    fake = FakeCards(monkeypatch, rank=1, world=2, backend="gloo", cards=1, initialized=True)
    assert make_mesh(2)[0] == "cuda" and fake.set_to == []


# --- four gloo ranks -------------------------------------------------------------------------


def _inputs():
    scenarios = tuple(f"{name}/" for name in SCENARIOS)
    inputs = {k: v for k, v in world_2_inputs().items() if k.startswith(scenarios)}
    inputs.update({f"card_exchange/{name}": case for name, case in CARD_CASES.items()})
    return inputs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return shared_run(tmp_path_factory, "multicard", SCENARIOS, _inputs, world=WORLD)


@pytest.mark.parametrize("name", sorted(BA_PROBLEMS))
def test_world_4_ba_matches_single_device(ranks, name):
    """93 landmarks of ``pad`` leave 3 pad rows at world 4."""
    check_ba(ranks, name)


def test_world_4_ba_matches_the_reference_on_a_4_device_mesh(ranks):
    check_ba_against_the_reference(ranks, WORLD)


@pytest.mark.parametrize("blur", ["fused", "separable"])
def test_world_4_frontend_equals_the_batched_one(ranks, blur):
    """8 frames, 2 a rank."""
    check_frontend(ranks, blur)


def test_world_4_keyframe_matching_matches_match_descriptors(ranks):
    """8 keyframes, 2 a rank."""
    check_keyframe_matching(ranks)


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_world_4_slam_on_the_orbit_matches_single_device(ranks, threshold):
    check_slam_orbit(ranks, threshold)


def test_the_store_exchange_gives_every_ranks_card(ranks):
    """Four real processes: the exchange returns every rank's card in rank
    order; cards of their own pass, also where each rank sees only its own
    card as index 0; ranks 2 and 3 on card 2 raise on every rank (rank 0
    writes its outputs; the digests hold the others to it)."""
    outputs, _ = ranks
    for name, case in CARD_CASES.items():
        np.testing.assert_array_equal(outputs[f"card_exchange/{name}.cards"], case[0])
    assert str(outputs["card_exchange/own.error"]) == ""
    assert str(outputs["card_exchange/one_visible.error"]) == ""
    assert "ranks [2, 3] on cuda:2 of host (GPU-2)" in str(outputs["card_exchange/shared.error"])


def test_every_rank_returns_the_same_bits(ranks):
    check_same_bits(ranks, WORLD, SCENARIOS)
