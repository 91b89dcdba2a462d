"""The port's readers of the JAX package's orbax checkpoints.

``utils/zstd.py`` against ``zstandard``, ``utils/ocdbt.py`` against
tensorstore, and ``utils/checkpoint.py`` against the JAX package's own
orbax saves and restores, on the CPU at small sizes. ``zstandard`` and
tensorstore are only the oracles here: the port imports neither.
"""

import json
import os
import shutil
import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sift_scale_space_extrema_detection_tpu.sfm.ba import BAState as JBAState
from sift_scale_space_extrema_detection_tpu.utils import checkpoint as jckpt
import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.sfm.ba import BAState
from sift_scale_space_extrema_detection_tpu_torch.utils import checkpoint as pckpt
from sift_scale_space_extrema_detection_tpu_torch.utils import ocdbt, zstd
from sift_scale_space_extrema_detection_tpu_torch.utils.synthetic import orbit_sequence

zstandard = pytest.importorskip("zstandard")
ts = pytest.importorskip("tensorstore")

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "jax_orbax"
ORBIT_MIN_LANDMARKS = 200  # BASELINE config[3]'s bars, chip_smoke.py
ORBIT_ATE = 0.08
SLAM_ATE_GAP = 0.02
CPU = {"device": "cpu"}


def _text(rng, n_words: int) -> bytes:
    words = [b"the", b"camera", b"pose", b"of", b"frame", b"landmark", b"and", b"track",
             b"is", b"a", b"keypoint", b"bundle", b"adjustment", b"scale", b"space"]
    return b" ".join(words[i] for i in rng.integers(0, len(words), n_words)) + b".\n"


def _corpus() -> dict[str, bytes]:
    rng = np.random.default_rng(0)
    return {
        "empty": b"",
        "one_byte": b"x",
        "zeros_1mb": bytes(1 << 20),
        "random_256kb": rng.bytes(256 * 1024),
        "float32_ramp": np.arange(100_000, dtype=np.float32).tobytes(),
        # A smooth float32 signal: blocks after the first reuse their
        # Huffman table (treeless literals) at every level but -5.
        "float32_wave": np.sin(np.arange(100_000) / 50.0).astype(np.float32).tobytes(),
        "slam_int32": np.cumsum(rng.integers(0, 5, 60_000)).astype(np.int32).tobytes(),
        "text": _text(rng, 60_000),
    }


CORPUS = _corpus()
LEVELS = [1, 3, 19, -5]


def _compress(raw: bytes, level: int, content_size: bool, checksum: bool) -> bytes:
    c = zstandard.ZstdCompressor(level=level, write_content_size=content_size,
                                 write_checksum=checksum)
    if content_size:
        return c.compress(raw)
    stream = c.compressobj()  # streaming: no content size in the header
    return stream.compress(raw) + stream.flush()


# ---- zstd -------------------------------------------------------------------


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", list(CORPUS))
def test_zstd_decodes_what_zstandard_encodes(name, level):
    raw = CORPUS[name]
    for content_size in (True, False):
        for checksum in (True, False):
            frame = _compress(raw, level, content_size, checksum)
            assert zstd.decompress(frame) == raw, (content_size, checksum)


def test_the_corpus_reaches_every_literal_and_table_mode(monkeypatch):
    """The rare paths: treeless and four-stream Huffman literals, RLE
    literals, and every sequence-table mode (repeat mode only follows a
    compressed block)."""
    literals, tables = set(), set()
    real_literals, real_table = zstd._literals, zstd._sequence_table

    def spy_literals(data, pos, end, st):
        kind, fmt = data[pos] & 3, (data[pos] >> 2) & 3
        literals.add((kind, 1 if kind < 2 or fmt == 0 else 4))
        return real_literals(data, pos, end, st)

    def spy_table(data, pos, end, mode, *args):
        tables.add(mode)
        return real_table(data, pos, end, mode, *args)

    monkeypatch.setattr(zstd, "_literals", spy_literals)
    monkeypatch.setattr(zstd, "_sequence_table", spy_table)
    for raw in CORPUS.values():
        for level in LEVELS:
            assert zstd.decompress(_compress(raw, level, True, False)) == raw
    assert {(0, 1), (1, 1), (2, 1), (2, 4), (3, 4)} <= literals, literals
    assert tables == {0, 1, 2, 3}, tables


def test_zstd_reads_several_frames_and_skips_skippable_ones():
    a = _compress(b"hello " * 300, 3, True, True)
    b = _compress(CORPUS["text"][:50_000], 19, False, True)
    skip = struct.pack("<II", 0x184D2A5E, 7) + b"padding"
    assert zstd.decompress(a + skip + b + a) == b"hello " * 300 + CORPUS["text"][:50_000] + b"hello " * 300
    assert zstd.decompress(skip) == b""


@pytest.mark.parametrize("size", [0, 1, 200, 256, 300, 65_791, 65_792, 70_000])
def test_zstd_reads_every_content_size_field(size):
    """Single-segment frames carry a 1-, 2-, 4- or 8-byte content size (the
    2-byte field adds 256); the others a window descriptor."""
    raw = CORPUS["text"][:size]
    for content_size in (True, False):
        assert zstd.decompress(_compress(raw, 3, content_size, False)) == raw
    params = zstandard.ZstdCompressionParameters.from_level(3, window_log=10, format=0)
    windowed = zstandard.ZstdCompressor(compression_params=params).compress(raw)
    assert zstd.decompress(windowed) == raw
    # An 8-byte content size, written by hand: single segment, FCS flag 3, one raw block.
    frame = (struct.pack("<IB", zstd.ZSTD_MAGIC, 0xE0) + struct.pack("<Q", len(raw[:100]))
             + struct.pack("<I", (len(raw[:100]) << 3) | 1)[:3] + raw[:100])
    assert zstd.decompress(frame) == raw[:100]


def test_zstd_refuses_a_dictionary():
    d = zstandard.train_dictionary(4096, [CORPUS["text"][i:i + 500] for i in range(0, 200_000, 500)])
    frame = zstandard.ZstdCompressor(dict_data=d).compress(b"the camera pose of the frame")
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(frame)


@pytest.mark.parametrize("where", ["checksum", "block", "magic", "header", "truncated"])
def test_zstd_raises_on_corrupt_input(where):
    raw = CORPUS["text"][:40_000]
    frame = bytearray(_compress(raw, 19, True, True))
    if where == "checksum":
        frame[-1] ^= 0x01
    elif where == "block":
        frame[len(frame) // 2] ^= 0x40
    elif where == "magic":
        frame[0] ^= 0xFF
    elif where == "header":
        frame[4] |= 0x08  # the reserved bit
    else:
        frame = frame[:-9]
    with pytest.raises(ValueError, match="byte"):
        zstd.decompress(bytes(frame))


def test_zstd_xxh64_matches_the_reference_vectors():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999


@settings(max_examples=50, deadline=None)
@given(raw=st.binary(max_size=16 * 1024), level=st.sampled_from(LEVELS),
       content_size=st.booleans(), checksum=st.booleans())
def test_zstd_property(raw, level, content_size, checksum):
    assert zstd.decompress(_compress(raw, level, content_size, checksum)) == raw


# ---- OCDBT ------------------------------------------------------------------


def _spec(kind: str, **fields) -> dict:
    """A tensorstore JSON spec of the given kind."""
    return {"driver": kind, **fields}


def _ocdbt_spec(path) -> dict:
    return _spec("ocdbt", base=_spec("file", path=str(path)))


def _kvstore(path, config=None, context=None):
    spec = _ocdbt_spec(path)
    if config is not None:
        spec["config"] = config
    return ts.KvStore.open(spec, context=context).result()


def _fill(kv, rng, n, size):
    txn = ts.Transaction()
    for i in range(n):
        kv.with_transaction(txn).write(f"k/{i:05d}/{'x' * (i % 7)}", rng.bytes(size(i))).result()
    txn.commit_async().result()


def _same_as_tensorstore(path):
    kv = _kvstore(path)
    want = {k.decode(): kv.read(k).result().value for k in kv.list().result()}
    db = ocdbt.Database(str(path))
    assert db.keys() == sorted(want)
    assert db.items() == want
    for key in sorted(want)[:: max(1, len(want) // 7)]:
        assert ocdbt.read(str(path), key) == want[key]
    assert db.get("k/none") is None
    with pytest.raises(KeyError):
        db.read("k/none")
    return db


OCDBT_VARIANTS = {
    "default": (None, 200, lambda i: i % 300),
    "uncompressed": ({"compression": None}, 200, lambda i: i % 300),
    "indirect_values": ({"max_inline_value_bytes": 8}, 200, lambda i: i % 50),
    "interior_nodes": ({"max_decoded_node_bytes": 256}, 300, lambda i: 5),
    "numbered_manifest": ({"manifest_kind": "numbered"}, 50, lambda i: 20),
}


@pytest.mark.parametrize("variant", list(OCDBT_VARIANTS))
def test_ocdbt_reads_what_tensorstore_writes(tmp_path, variant):
    config, n, size = OCDBT_VARIANTS[variant]
    _fill(_kvstore(tmp_path, config), np.random.default_rng(1), n, size)
    db = _same_as_tensorstore(tmp_path)
    if variant == "interior_nodes":
        assert db.root["height"] > 1
    if variant == "uncompressed":
        assert db.config["compression"] == 0


def test_ocdbt_reads_versions_past_the_manifest(tmp_path):
    """Over 100 generations: the older versions live in version-tree nodes
    (arity 4), which the reader walks."""
    kv = _kvstore(tmp_path, {"version_tree_arity_log2": 2})
    rng = np.random.default_rng(2)
    for g in range(110):
        kv.write(f"g{g % 13}", rng.bytes(g)).result()
    db = _same_as_tensorstore(tmp_path)
    generations = [v["generation"] for v in db.all_versions()]
    assert generations == list(range(1, generations[-1] + 1)) and len(generations) > 100
    assert len(db.versions) < len(generations)


def test_ocdbt_reads_merged_per_process_databases(tmp_path):
    """Orbax's layout: one database per process, merged into the root by
    reference, so a root node names its children's files through their
    base path."""
    context = ts.Context()
    config = {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 16,
              "manifest_kind": "single"}
    rng = np.random.default_rng(3)
    children = []
    for p in range(2):
        _fill(_kvstore(tmp_path / f"ocdbt.process_{p}", config, context), rng, 120,
              lambda i: i % 40)
        children.append(_kvstore(tmp_path / f"ocdbt.process_{p}", None, context))
    spec = {**_ocdbt_spec(tmp_path), "config": config, "assume_config": True}
    parent = ts.KvStore.open(spec, context=context).result()
    txn = ts.Transaction(atomic=True)
    for child in children:
        child.experimental_copy_range_to(parent.with_transaction(txn)).result()
    txn.commit_async().result()
    assert _same_as_tensorstore(tmp_path).root["height"] > 0


def test_ocdbt_reads_an_empty_database(tmp_path):
    kv = _kvstore(tmp_path)
    kv.write("a", b"1").result()
    kv.delete_range(ts.KvStore.KeyRange()).result()
    assert _same_as_tensorstore(tmp_path).keys() == []


@pytest.mark.parametrize("target", ["manifest", "node"])
def test_ocdbt_raises_on_a_flipped_byte_naming_the_file(tmp_path, target):
    _fill(_kvstore(tmp_path, {"max_inline_value_bytes": 8}), np.random.default_rng(4), 50,
          lambda i: 30)
    db = ocdbt.Database(str(tmp_path))
    if target == "manifest":
        path, offset = tmp_path / "manifest.ocdbt", 20
    else:
        _, rel, start, length = db.root["root"]
        path, offset = tmp_path / rel, start + length // 2
    data = bytearray(path.read_bytes())
    data[offset] ^= 0x10
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=path.name):
        ocdbt.Database(str(tmp_path)).items()


# ---- zarr v2 in OCDBT ---------------------------------------------------------


def _zarr(path, name, array, **metadata):
    spec = _spec("zarr", kvstore=_ocdbt_spec(path), path=name, create=True,
                 metadata={"dtype": array.dtype.str, "shape": list(array.shape), **metadata})
    store = ts.open(spec).result()
    store.write(array).result()


@pytest.mark.parametrize(
    "dtype,chunks,order,separator,compressor",
    [
        ("<f4", [7, 5], "C", ".", {"id": "zstd", "level": 3}),
        ("<f8", [4, 16], "F", "/", {"id": "zlib", "level": 5}),
        ("<i8", [16, 3], "C", "/", {"id": "gzip", "level": 1}),
        ("<i4", [5, 5], "F", ".", None),
        ("|b1", [16, 16], "C", ".", {"id": "zstd", "level": 1}),
        (">f4", [9, 9], "C", ".", {"id": "zstd", "level": 1}),
    ],
)
def test_read_zarr_v2_matches_tensorstore(tmp_path, dtype, chunks, order, separator, compressor):
    rng = np.random.default_rng(5)
    array = (rng.normal(size=(16, 13)) * 100).astype(dtype)
    _zarr(tmp_path, "a.b", array, chunks=chunks, order=order, dimension_separator=separator,
          compressor=compressor, fill_value=None)
    got = ocdbt.read_zarr_v2(str(tmp_path), "a.b")
    assert got.dtype == np.dtype(dtype) and got.shape == array.shape
    assert got.tobytes() == array.tobytes()


def test_read_zarr_v2_reads_a_0d_array_and_an_empty_one(tmp_path):
    _zarr(tmp_path, "frame", np.asarray(7, np.int64), chunks=[], compressor={"id": "zstd",
                                                                               "level": 1})
    _zarr(tmp_path, "none", np.zeros((0, 3), np.float32), chunks=[1, 3], compressor=None)
    got = ocdbt.read_zarr_v2(str(tmp_path), "frame")
    assert got.shape == () and got.dtype == np.int64 and int(got) == 7
    assert ocdbt.read_zarr_v2(str(tmp_path), "none").shape == (0, 3)


def _raw_zarr(path, name, meta, chunks):
    kv = _kvstore(path)
    kv.write(f"{name}/.zarray", json.dumps(meta).encode()).result()
    for key, value in chunks.items():
        kv.write(f"{name}/{key}", value).result()


def _meta(**kw):
    meta = {"zarr_format": 2, "shape": [4], "chunks": [2], "dtype": "<i4", "order": "C",
            "compressor": None, "filters": None, "fill_value": None}
    return {**meta, **kw}


def test_read_zarr_v2_fills_missing_chunks_only_with_a_fill_value(tmp_path):
    _raw_zarr(tmp_path, "nan", _meta(dtype="<f4", fill_value="NaN"),
              {"1": np.array([1, 2], "<f4").tobytes()})
    got = ocdbt.read_zarr_v2(str(tmp_path), "nan")
    np.testing.assert_array_equal(got, np.array([np.nan, np.nan, 1, 2], np.float32))
    _raw_zarr(tmp_path, "null", _meta(), {"1": np.array([1, 2], "<i4").tobytes()})
    with pytest.raises(ValueError, match="missing and fill_value is null"):
        ocdbt.read_zarr_v2(str(tmp_path), "null")


@pytest.mark.parametrize(
    "meta,match",
    [
        (_meta(compressor={"id": "blosc", "cname": "lz4"}), "blosc"),
        (_meta(filters=[{"id": "delta", "dtype": "<i4"}]), "filters"),
        (_meta(zarr_format=3), "zarr_format 3"),
        (_meta(dtype=[["x", "<i4"]]), "structured"),
    ],
)
def test_read_zarr_v2_refuses_what_it_does_not_read(tmp_path, meta, match):
    _raw_zarr(tmp_path, "a", meta, {"0": bytes(8), "1": bytes(8)})
    with pytest.raises(ValueError, match=match):
        ocdbt.read_zarr_v2(str(tmp_path), "a")


# ---- orbax checkpoints of the JAX package ------------------------------------


def _slam_like_state(rng) -> dict:
    return {
        "frame": np.asarray(11),
        "est_r": rng.normal(size=(9, 3, 3)),
        "est_t": rng.normal(size=(9, 3)).astype(np.float32),
        "lm_valid": rng.random(300) > 0.4,
        "first_seen_kf": rng.integers(-1, 9, 300),
        "obs_cam": rng.integers(0, 9, 2000).astype(np.int32),
        "obs_uv": rng.normal(size=(2000, 2)),
        "points": np.where(rng.random((300, 1)) > 0.1, rng.normal(size=(300, 3)), np.nan),
    }


def _same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k


def test_the_port_reads_the_references_orbax_slam_state(tmp_path):
    state = _slam_like_state(np.random.default_rng(6))
    written = jckpt.save_checkpoint(str(tmp_path / "ref"), state)
    assert os.path.isdir(written) and os.path.isfile(os.path.join(written, "manifest.ocdbt"))
    _same_arrays(pckpt.restore_checkpoint_flat(written), state)
    template = {k: torch.zeros(0, dtype=torch.from_numpy(np.asarray(v)).dtype)
                for k, v in state.items()}
    got = pckpt.restore_checkpoint(written, template)
    _same_arrays({k: v.numpy() for k, v in got.items()}, state)


def test_the_port_reads_the_references_orbax_ba_state(tmp_path):
    rng = np.random.default_rng(7)
    shapes = {"rotations": (5, 3, 3), "translations": (5, 3), "points": (40, 3), "k_mat": (3, 3)}
    jstate = JBAState(**{k: jnp.asarray(rng.normal(size=s)) for k, s in shapes.items()})
    written = jckpt.save_checkpoint(str(tmp_path / "ref"), jstate, step=2)
    assert os.path.isfile(os.path.join(written, "_sharding"))
    template = BAState(**{k: torch.zeros(s, dtype=torch.float64) for k, s in shapes.items()})
    got = pckpt.restore_checkpoint(written, template)
    for name in shapes:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(jstate, name)))
    flat = pckpt.restore_checkpoint_flat(written)
    assert sorted(flat) == sorted(shapes)


def test_a_foreign_or_zarr3_directory_is_refused(tmp_path):
    (tmp_path / "foreign").mkdir()
    (tmp_path / "foreign" / "data.bin").write_bytes(b"x")
    with pytest.raises(RuntimeError, match="orbax"):
        pckpt.restore_checkpoint_flat(str(tmp_path / "foreign"))
    written = jckpt.save_checkpoint(str(tmp_path / "ref"), {"x": np.arange(3)})
    meta_path = os.path.join(written, "_METADATA")
    with open(meta_path) as f:
        meta = json.load(f)
    with open(meta_path, "w") as f:
        json.dump({**meta, "use_zarr3": True}, f)
    with pytest.raises(RuntimeError, match="use_zarr3=True"):
        pckpt.restore_checkpoint_flat(written)


def test_a_corrupt_orbax_checkpoint_stops_a_resume(tmp_path):
    """A read error propagates: run_slam never starts afresh when a
    checkpoint exists and cannot be read."""
    seq = orbit_sequence(np.random.default_rng(3), num_frames=8, num_landmarks=150, noise_px=0.3)
    written = jckpt.save_checkpoint(str(tmp_path / "ck"), _slam_like_state(np.random.default_rng(8)))
    manifest = Path(written) / "manifest.ocdbt"
    data = bytearray(manifest.read_bytes())
    data[30] ^= 0x01
    manifest.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="manifest.ocdbt"):
        port.run_slam(seq.pixels, seq.visible, seq.k_mat, port.SlamConfig(ba_interval=3),
                      checkpoint_dir=str(tmp_path / "ck"), resume=True, **CPU)


def test_a_resume_from_orbax_equals_the_resume_from_npz(tmp_path):
    seq = orbit_sequence(np.random.default_rng(3), num_frames=8, num_landmarks=150, noise_px=0.3)
    cfg = port.SlamConfig(ba_interval=3)

    def run(directory, **kw):
        return port.run_slam(seq.pixels, seq.visible, seq.k_mat, cfg,
                             checkpoint_dir=str(directory), checkpoint_interval=3, **kw, **CPU)

    run(tmp_path / "npz", _stop_after=4)
    state = pckpt.restore_checkpoint_flat(str(tmp_path / "npz" / "state"))
    assert int(state["frame"]) < 7
    written = jckpt.save_checkpoint(str(tmp_path / "orbax"), state)
    assert os.path.isdir(written)
    from_npz = run(tmp_path / "npz", resume=True)
    from_orbax = run(tmp_path / "orbax", resume=True)
    np.testing.assert_array_equal(from_orbax.rotations, from_npz.rotations)
    np.testing.assert_array_equal(from_orbax.translations, from_npz.translations)
    np.testing.assert_array_equal(from_orbax.points, from_npz.points)
    assert not os.path.isdir(written)  # the resumed run's npz save removed it


# ---- the committed fixture ---------------------------------------------------


def _fixture_hash() -> dict:
    return {str(p.relative_to(FIXTURE)): p.read_bytes() for p in sorted(FIXTURE.rglob("*"))
            if p.is_file()}


def test_the_fixture_reads_as_the_reference_reads_it():
    flat = pckpt.restore_checkpoint_flat(str(FIXTURE / "slam" / "state"))
    want = {k: np.asarray(v) for k, v in
            jckpt.restore_checkpoint_flat(str(FIXTURE / "slam" / "state")).items()}
    _same_arrays(flat, want)
    _same_arrays(flat, pckpt.restore_checkpoint_flat(str(FIXTURE / "slam_npz" / "state")))
    shapes = {k: np.shape(v) for k, v in
              pckpt.restore_checkpoint_flat(str(FIXTURE / "ba" / "state")).items()}
    template = BAState(**{k: torch.zeros(s, dtype=torch.float32) for k, s in shapes.items()})
    got = pckpt.restore_checkpoint(str(FIXTURE / "ba" / "state"), template)
    npz = pckpt.restore_checkpoint(str(FIXTURE / "ba_npz" / "state"), template)
    jtemplate = JBAState(**{k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()})
    ref = jckpt.restore_checkpoint(str(FIXTURE / "ba" / "state"), jtemplate)
    for name in shapes:
        assert getattr(got, name).dtype == torch.float32
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(npz, name).numpy())


def test_config3_resumes_from_the_fixture(tmp_path):
    before = _fixture_hash()
    record = json.loads((FIXTURE / "fixture.json").read_text())
    recipe = record["recipe"]
    seq = orbit_sequence(np.random.default_rng(recipe["seed"]), num_frames=recipe["num_frames"],
                         num_landmarks=recipe["num_landmarks"], noise_px=recipe["noise_px"],
                         outlier_frac=recipe["outlier_frac"])
    results = {}
    for name in ("slam", "slam_npz"):
        shutil.copytree(FIXTURE / name, tmp_path / name)
        results[name] = port.run_slam(seq.pixels, seq.visible, seq.k_mat, port.SlamConfig(),
                                      checkpoint_dir=str(tmp_path / name), resume=True, **CPU)
    got, npz = results["slam"], results["slam_npz"]
    np.testing.assert_array_equal(got.rotations, npz.rotations)
    np.testing.assert_array_equal(got.translations, npz.translations)
    ate = port.evaluate_ate(got, seq.rotations, seq.translations, **CPU)
    assert int(got.landmark_valid.sum()) > ORBIT_MIN_LANDMARKS
    assert ate < ORBIT_ATE
    assert abs(ate - record["jax_resumed_ate"]) < SLAM_ATE_GAP
    assert _fixture_hash() == before
