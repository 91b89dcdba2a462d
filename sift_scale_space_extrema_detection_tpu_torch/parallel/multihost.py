"""Multi-process execution scaffolding: the process group, the mesh over it,
and the replicated-input SPMD pattern.

Port of the JAX package's ``parallel/multihost.py`` onto
``torch.distributed``. A JAX ``Mesh`` is driven by one controller; here
every rank runs the same program (multi-controller SPMD), and the port
takes the pattern the JAX package uses for its multi-process runs: every
rank holds the same full host data, each function of
``parallel/distributed.py`` takes its own share of it, and the shares are
reduced or gathered so that every rank returns the same full result. A
caller's code is then the same at world size 1, 2 or N.

- :func:`initialize_multihost`: ``init_process_group``, from explicit
  arguments (``tcp://`` or any ``init_method`` URL) or from the
  environment ``torchrun`` sets.
- :func:`global_mesh`: a 1-D ``DeviceMesh`` over the whole world, dimension
  ``"shard"`` (the counterpart of the JAX package's 1-D mesh), with each
  rank on its own card (see there).
- :func:`put_global`: this rank's contiguous slice of a full copy.
- :func:`replicate_global`: rank 0's copy on every rank.
"""

from __future__ import annotations

import datetime
import json
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout: datetime.timedelta | None = None,
) -> None:
    """Join (or form) the process group; nothing happens if one exists.

    Pass all three of ``coordinator_address`` (``host:port``, taken as
    ``tcp://host:port``, or a URL such as ``file:///path`` that
    ``init_process_group`` accepts as its ``init_method``),
    ``num_processes`` and ``process_id``, or none of them to read the
    rendezvous from the environment (``torchrun``). ``backend`` defaults to
    NCCL where CUDA is present, else gloo; ``timeout`` bounds every
    collective (``torch.distributed``'s default when ``None``).
    """
    if dist.is_initialized():
        return
    given = [a is not None for a in (coordinator_address, num_processes, process_id)]
    if any(given) and not all(given):
        # A process that dropped these would form a group of its own and
        # compute on its share of the data with no rendezvous.
        raise ValueError(
            "coordinator_address, num_processes and process_id go together: "
            "pass all three, or none to read them from the environment"
        )
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {} if timeout is None else {"timeout": timeout}
    if all(given):
        init = coordinator_address
        if "://" not in init:
            init = f"tcp://{init}"
        dist.init_process_group(
            backend, init_method=init, world_size=num_processes, rank=process_id, **kwargs
        )
    else:
        dist.init_process_group(backend, init_method="env://", **kwargs)


def global_mesh(axis: str = "shard", device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over every rank of the initialised group, on ``device_type``.

    ``"cuda"`` (the default) raises where there is no card, and puts each
    rank on a card: on ``LOCAL_RANK`` where the environment sets it
    (``torchrun`` does) to one of the visible cards, whether or not the
    process used CUDA before; otherwise on ``rank % cards``, unless the
    process used CUDA before, in which case it stays on its current card
    (one visible card a rank, as ``CUDA_VISIBLE_DEVICES`` gives it, lands on
    that card whatever ``LOCAL_RANK`` says). Under NCCL no two ranks may
    compute on one physical card (told apart by its UUID): where they would,
    every rank raises and names the card (NCCL would fail at the first
    collective, or hang). Under gloo ranks may share one. ``"cpu"`` is asked
    for by name, as ``device="cpu"`` is at the entry points
    (``core/device.py``)."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device: a "cuda" mesh needs a card; ask for a "cpu" mesh '
                "to run on the CPU"
            )
        card = _choose_card()
        if "nccl" in dist.get_backend():
            _require_own_cards(_rank_cards(_card_identity(card)))
    elif device_type != "cpu":
        raise ValueError(f"mesh device type {device_type!r}: 'cuda' or 'cpu'")
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis,))


def _choose_card() -> int:
    """Set and return this rank's card (the rule of :func:`global_mesh`)."""
    cards = torch.cuda.device_count()
    local = os.environ.get("LOCAL_RANK")
    if local is not None and 0 <= int(local) < cards:
        torch.cuda.set_device(int(local))
    elif not torch.cuda.is_initialized():
        torch.cuda.set_device(dist.get_rank() % cards)
    return torch.cuda.current_device()


def _card_identity(card: int) -> list:
    """``[host, card index, card UUID]``: the UUID tells physical cards
    apart where the index does not (one visible card a rank, containers
    that share a host name)."""
    uuid = str(torch.cuda.get_device_properties(card).uuid)
    return [socket.gethostname(), card, uuid]


def _rank_cards(identity: list) -> list[list]:
    """Every rank's ``identity`` in rank order, exchanged through the
    group's store: no collective, since NCCL cannot run one before each
    rank has a card of its own. Every rank calls this as often as the
    others (SPMD); the call's number keeps the exchanges apart."""
    store = dist.distributed_c10d._get_default_store()
    rank, world = dist.get_rank(), dist.get_world_size()
    call = store.add(f"sift_mesh_cards/calls/{rank}", 1)
    store.set(f"sift_mesh_cards/{call}/{rank}", json.dumps(identity))
    return [json.loads(store.get(f"sift_mesh_cards/{call}/{r}")) for r in range(world)]


def _require_own_cards(cards: list[list]) -> None:
    """Raise where two ranks' ``[host, card, UUID]`` name one physical
    card."""
    seen: dict[str, list[int]] = {}
    for r, (_, _, uuid) in enumerate(cards):
        seen.setdefault(uuid, []).append(r)
    shared = [ranks for ranks in seen.values() if len(ranks) > 1]
    if shared:
        what = "; ".join(f"ranks {ranks} on cuda:{cards[ranks[0]][1]} of {cards[ranks[0]][0]} "
                         f"({cards[ranks[0]][2]})" for ranks in shared)
        raise RuntimeError(
            f"NCCL ranks would share a card: {what}. Give each rank a card of its "
            "own (torchrun sets LOCAL_RANK; without it, rank r takes card r % "
            "cards unless it used CUDA before the mesh), or use gloo"
        )


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_group(mesh: DeviceMesh):
    """``(process group, world size, this rank)`` of the mesh's one axis."""
    return mesh.get_group(), mesh.size(), mesh.get_local_rank()


def put_global(x, mesh: DeviceMesh, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``axis``, on the mesh's
    device. Every rank must hold the same ``x`` (numpy or tensor), whose
    ``axis`` divides evenly by the world size."""
    _, world, rank = mesh_group(mesh)
    x = torch.as_tensor(x)
    if x.shape[axis] % world:
        raise ValueError(
            f"put_global: axis {axis} of length {x.shape[axis]} does not split "
            f"over {world} ranks"
        )
    n = x.shape[axis] // world
    return x.narrow(axis, rank * n, n).to(mesh_device(mesh))


def replicate_global(x, mesh: DeviceMesh) -> torch.Tensor:
    """Rank 0's copy of ``x`` on every rank (a broadcast), on the mesh's
    device. Every rank passes an ``x`` of the same shape and dtype."""
    group, _, _ = mesh_group(mesh)
    x = torch.as_tensor(x)
    out = x.to(mesh_device(mesh), copy=True).contiguous()
    dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)
    return out
