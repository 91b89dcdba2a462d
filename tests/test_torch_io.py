"""The port's image and dataset I/O: ``core/image.py``, ``core/native_io.py``,
``data/`` and ``utils/visualize.py``.

Each copied function is pinned equal to its original in the JAX package;
``tests/test_native_io.py`` and the format tests of ``tests/test_datasets.py``
are mirrored against the port's modules; the PNG writer of the port is held
to PIL's pixels; and TUM and KITTI sequences cross between the packages both
ways with equal pixels, poses and intrinsics."""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from sift_scale_space_extrema_detection_tpu.core import image as jimage
from sift_scale_space_extrema_detection_tpu.core import native_io as jnative
from sift_scale_space_extrema_detection_tpu import data as jdata
from sift_scale_space_extrema_detection_tpu.data import kitti as jkitti
from sift_scale_space_extrema_detection_tpu.data import tum as jtum
from sift_scale_space_extrema_detection_tpu.ops import gaussian as jgaussian
from sift_scale_space_extrema_detection_tpu.utils import visualize as jvis
import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch import data as pdata
from sift_scale_space_extrema_detection_tpu_torch.core import image as pimage
from sift_scale_space_extrema_detection_tpu_torch.core import native_io
from sift_scale_space_extrema_detection_tpu_torch.core.image import rgb_to_gray
from sift_scale_space_extrema_detection_tpu_torch.data import (
    associate,
    load_kitti_sequence,
    load_tum_sequence,
    quat_to_rotation,
    read_tum_trajectory,
    rotation_to_quat,
    write_kitti_sequence,
    write_tum_sequence,
    write_tum_trajectory,
)
from sift_scale_space_extrema_detection_tpu_torch.data import kitti as pkitti
from sift_scale_space_extrema_detection_tpu_torch.data import tum as ptum
from sift_scale_space_extrema_detection_tpu_torch.data.tum import intrinsics_for
from sift_scale_space_extrema_detection_tpu_torch.ops import gaussian as pgaussian
from sift_scale_space_extrema_detection_tpu_torch.sfm import geometry as pgeo
from sift_scale_space_extrema_detection_tpu_torch.utils import visualize as pvis

torch.set_num_threads(2)

KITTI_K = np.array([[718.856, 0, 607.19], [0, 718.856, 185.2], [0, 0, 1.0]])


def _random_poses(rng, n):
    """Random smooth world→camera trajectory (``tests/test_datasets.py``)."""
    rots, ts = [], []
    for f in range(n):
        w = torch.from_numpy(0.05 * rng.standard_normal(3))
        r = pgeo.so3_exp(w).numpy()
        center = np.array([0.3 * f, 0.05 * f, 0.01 * f**2])
        rots.append(r)
        ts.append(-r @ center)
    return np.stack(rots), np.stack(ts)


# --- the copies, pinned to their originals -----------------------------------


def test_copied_constants_equal_the_originals():
    assert pimage.GRAY_WEIGHTS == jimage.GRAY_WEIGHTS
    assert ptum.TUM_INTRINSICS == jtum.TUM_INTRINSICS
    assert pdata.__all__ == jdata.__all__


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rgb_to_gray_is_the_originals(dtype):
    rgb = np.random.default_rng(0).integers(0, 256, size=(2, 9, 11, 4), dtype=np.uint8)
    got = rgb_to_gray(rgb, dtype=dtype)
    want = jimage.rgb_to_gray(rgb, dtype=dtype)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        rgb_to_gray(rgb[..., :2])


@pytest.mark.parametrize(
    "shape, multiples",
    [((2, 376, 1241), (32, 64)), ((40, 37), (16, 16)), ((3, 64, 128), (32, 64)), ((5, 7), (4, 3))],
)
def test_pad_to_tpu_friendly_is_the_originals(shape, multiples):
    images = np.random.default_rng(1).random(shape)
    got = pimage.pad_to_tpu_friendly(images, *multiples)
    np.testing.assert_array_equal(got, jimage.pad_to_tpu_friendly(images, *multiples))


def test_pose_conversions_are_the_originals(tmp_path):
    rng = np.random.default_rng(2)
    quats = rng.standard_normal((17, 4))
    np.testing.assert_array_equal(quat_to_rotation(quats), jdata.quat_to_rotation(quats))
    rots = jdata.quat_to_rotation(quats)
    # Every branch of Shepperd's method: large trace, and each diagonal.
    rots = np.concatenate([rots, np.diag([1.0, -1, -1])[None], np.diag([-1.0, 1, -1])[None],
                           np.diag([-1.0, -1, 1])[None]])
    np.testing.assert_array_equal(rotation_to_quat(rots), jdata.rotation_to_quat(rots))
    centers = rng.standard_normal((20, 3))
    for got, want in zip(pdata.cam_to_world_to_wc(rots, centers),
                         jdata.cam_to_world_to_wc(rots, centers)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(pdata.wc_to_cam_to_world(rots, centers),
                         jdata.wc_to_cam_to_world(rots, centers)):
        np.testing.assert_array_equal(got, want)
    stamps = np.arange(20) / 30.0
    write_tum_trajectory(str(tmp_path / "p.txt"), stamps, rots, centers)
    jdata.write_tum_trajectory(str(tmp_path / "j.txt"), stamps, rots, centers)
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    for got, want in zip(read_tum_trajectory(str(tmp_path / "j.txt")),
                         jdata.read_tum_trajectory(str(tmp_path / "j.txt"))):
        np.testing.assert_array_equal(got, want)


def test_read_tum_trajectory_names_a_truncated_line(tmp_path):
    path = tmp_path / "bad.txt"
    path.write_text("# header\n0.0 1 2 3 0 0 0 1\n0.1 1 2\n")
    with pytest.raises(ValueError, match="bad.txt:3"):
        read_tum_trajectory(str(path))
    (tmp_path / "empty.txt").write_text("# only a comment\n")
    ts, rot, t = read_tum_trajectory(str(tmp_path / "empty.txt"))
    assert ts.shape == (0,) and rot.shape == (0, 3, 3) and t.shape == (0, 3)


def test_associate_is_the_originals():
    rng = np.random.default_rng(3)
    a = np.sort(rng.uniform(0, 5, 60))
    b = rng.uniform(0, 5, 200)
    for max_difference, offset in ((0.02, 0.0), (0.05, 0.01), (0.001, 0.0)):
        got = associate(a, b, max_difference, offset)
        want = jdata.associate(a, b, max_difference, offset)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["rgbd_dataset_freiburg3_long", "seq_freiburg1_x", "other"])
def test_intrinsics_for_is_the_originals(name):
    np.testing.assert_array_equal(intrinsics_for(f"/d/{name}/"), jtum.intrinsics_for(f"/d/{name}/"))


def test_kitti_readers_are_the_originals(tmp_path):
    rng = np.random.default_rng(4)
    gt_r, gt_t = _random_poses(rng, 5)
    jkitti.write_kitti_sequence(str(tmp_path), "03", rng.random((5, 8, 8)), np.arange(5) * 0.1,
                                gt_r, gt_t, KITTI_K)
    seq_dir = tmp_path / "sequences" / "03"
    for cam in range(4):
        np.testing.assert_array_equal(pkitti.read_calib(str(seq_dir / "calib.txt"), cam),
                                      jkitti.read_calib(str(seq_dir / "calib.txt"), cam))
    with pytest.raises(ValueError, match="P4:"):
        pkitti.read_calib(str(seq_dir / "calib.txt"), 4)
    for got, want in zip(pkitti.read_poses(str(tmp_path / "poses" / "03.txt")),
                         jkitti.read_poses(str(tmp_path / "poses" / "03.txt"))):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 9, 40])
def test_blur_band_matrix_is_the_originals(n):
    for sigma in (0.8, 1.6, 4.1):
        np.testing.assert_array_equal(pgaussian._blur_band_matrix(n, sigma, 3.0),
                                      jgaussian._blur_band_matrix(n, sigma, 3.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blur_matmul_matches_the_reference_and_the_tap_loop(test_image, dtype):
    import jax.numpy as jnp

    image = torch.from_numpy(np.stack([test_image, test_image[::-1]])).to(dtype)
    for sigma in (0.9, 2.5):
        got = pgaussian.blur_matmul(image, sigma)
        want = np.asarray(jgaussian.blur_matmul(jnp.asarray(image.numpy()), sigma))
        tol = 1e-12 if dtype == torch.float64 else 2e-6
        assert got.dtype == dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
        np.testing.assert_allclose(got.numpy(), pgaussian.blur_separable(image, sigma).numpy(),
                                   rtol=0, atol=1e-6)


def test_matmul_is_a_scale_space_strategy(test_image):
    cfg = port.SiftConfig(num_octaves=2)
    image = torch.from_numpy(test_image.astype(np.float32))[None]
    space = port.build_scale_space(image, cfg, "matmul", device="cpu")
    plain = port.build_scale_space(image, cfg, "separable", device="cpu")
    for got, want in zip(space, plain):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("normalize", ["none", "minmax", "sigmoid"])
def test_gallery_image_is_the_originals(test_image, normalize):
    stack = np.stack([test_image, test_image * 0.5 - 0.2, np.zeros_like(test_image)])
    want = jvis.gallery_image(stack, normalize=normalize)
    np.testing.assert_array_equal(pvis.gallery_image(stack, normalize=normalize), want)
    np.testing.assert_array_equal(pvis.gallery_image(torch.from_numpy(stack), normalize=normalize),
                                  want)


def test_markers_and_overlay_are_the_originals(test_image):
    import jax.numpy as jnp
    from sift_scale_space_extrema_detection_tpu import SiftConfig, detect

    marks = [(3, 4, False), (0, 0, True), (47, 63, True), (20, 30, False)]
    np.testing.assert_array_equal(pvis.draw_candidate_markers(torch.from_numpy(test_image), marks),
                                  jvis.draw_candidate_markers(test_image, marks))
    keypoints, _ = detect(jnp.asarray(test_image), SiftConfig(num_octaves=3,
                                                              max_keypoints_per_trio=128))
    cands = [(10.4, 12.6, False), (30.0, 50.0, True)]
    want = jvis.draw_keypoints(test_image, keypoints, cands)
    from tests.torch_port_helpers import keypoints_to_port

    got = pvis.draw_keypoints(torch.from_numpy(test_image), keypoints_to_port(keypoints), cands)
    assert got.dtype == np.uint8 and got.shape == test_image.shape + (3,)
    np.testing.assert_array_equal(got, want)


# --- the PNG writer ----------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (24, 33), (17, 40, 3)])
def test_png_writer_decodes_to_the_same_pixels_in_pil_and_the_native_loader(tmp_path, shape):
    pixels = np.random.default_rng(5).integers(0, 256, size=shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    pvis.save_png(path, pixels)
    with Image.open(path) as img:
        assert img.mode == ("L" if len(shape) == 2 else "RGB")
        np.testing.assert_array_equal(np.asarray(img), pixels)
    rgb = pixels if len(shape) == 3 else np.repeat(pixels[..., None], 3, -1)
    np.testing.assert_allclose(native_io.load_batch_gray([path], fallback=False)[0],
                               rgb_to_gray(rgb, np.float64), atol=1e-6)


def test_png_writer_refuses_what_it_cannot_encode(tmp_path):
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8), np.zeros(4, np.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            pimage.write_png(str(tmp_path / "x.png"), bad)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_load_image_gray_is_the_originals_for_gray_files(tmp_path, dtype):
    gray = np.random.default_rng(6).integers(0, 256, size=(19, 23), dtype=np.uint8)
    png, pgm = str(tmp_path / "g.png"), str(tmp_path / "g.pgm")
    Image.fromarray(gray).save(png)
    Image.fromarray(gray).save(pgm)
    for path in (png, pgm):
        got = pimage.load_image_gray(path, dtype=dtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, jimage.load_image_gray(path, dtype=dtype))


def test_load_image_gray_of_rgb_files_is_the_native_value(tmp_path):
    rgb = np.random.default_rng(7).integers(0, 256, size=(12, 14, 3), dtype=np.uint8)
    path = str(tmp_path / "c.png")
    Image.fromarray(rgb).save(path)
    got = pimage.load_image_gray(path, dtype=np.float64)
    np.testing.assert_array_equal(got, rgb_to_gray(rgb, np.float64).astype(np.float32))
    np.testing.assert_allclose(got, jimage.load_image_gray(path), rtol=0, atol=1e-7)


def test_refused_file_goes_through_pil_or_names_file_and_format(tmp_path, monkeypatch):
    rgb = np.random.default_rng(8).integers(0, 256, size=(10, 12, 3), dtype=np.uint8)
    path = str(tmp_path / "x.jpg")
    Image.fromarray(rgb).save(path, quality=95)  # the native decoder has no JPEG
    with pytest.raises(native_io.NativeIOError):
        native_io.load_batch_gray([path], fallback=False)
    np.testing.assert_array_equal(pimage.load_image_gray(path), jimage.load_image_gray(path))
    monkeypatch.setitem(sys.modules, "PIL", None)  # no PIL: the import fails
    with pytest.raises(native_io.NativeIOError, match=r"x\.jpg.*JPEG.*PIL"):
        pimage.load_image_gray(path)
    with pytest.raises(native_io.NativeIOError, match="JPEG"):
        native_io.load_batch_gray([path])


def test_failed_build_raises_with_the_compiler_output_and_no_pil(tmp_path, monkeypatch):
    native = tmp_path / "native"
    native.mkdir()
    (native / "sift_io.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native_io, "_NATIVE_DIR", str(native))
    monkeypatch.setattr(native_io, "_LIB_PATH", str(native / "build" / "torch" / "libsift_io.so"))
    monkeypatch.setattr(native_io, "_lib", None)
    path = str(tmp_path / "g.png")
    pimage.write_png(path, np.zeros((4, 5), np.uint8))  # a file PIL would decode
    for load in (lambda: pimage.load_image_gray(path),
                 lambda: native_io.load_batch_gray([path])):
        with pytest.raises(RuntimeError, match=r"sift_io\.cpp failed:\n.*error") as err:
            load()
        assert not isinstance(err.value, native_io.NativeIOError)
    assert not native_io.native_available()


def test_native_library_builds_apart_from_the_jax_packages():
    assert native_io.native_available()
    assert native_io._LIB_PATH != jnative._LIB_PATH
    assert os.path.dirname(native_io._LIB_PATH).endswith(os.path.join("native", "build", "torch"))


# --- mirrors of tests/test_native_io.py ---------------------------------------


def _write_ppm(path, rgb):
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(rgb.astype(np.uint8).tobytes())


def _write_pgm(path, gray):
    h, w = gray.shape
    with open(path, "wb") as f:
        f.write(f"P5\n# comment\n{w} {h}\n255\n".encode())
        f.write(gray.astype(np.uint8).tobytes())


def test_probe_and_load_ppm_matches_reference_gray(tmp_path):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, size=(24, 32, 3), dtype=np.uint8)
    p = str(tmp_path / "a.ppm")
    _write_ppm(p, rgb)

    assert native_io.probe(p) == (32, 24)
    out = native_io.load_batch_gray([p], fallback=False)
    ref = rgb_to_gray(rgb, dtype=np.float32)
    np.testing.assert_allclose(out[0], ref, atol=1e-6)


def test_batch_load_pgm_multithreaded(tmp_path):
    rng = np.random.default_rng(1)
    paths = []
    grays = []
    for i in range(16):
        g = rng.integers(0, 256, size=(16, 20), dtype=np.uint8)
        p = str(tmp_path / f"g{i}.pgm")
        _write_pgm(p, g)
        paths.append(p)
        grays.append(g / 255.0)
    before = native_io.load_batch_gray.native_frames
    out = native_io.load_batch_gray(paths, threads=4, fallback=False)
    np.testing.assert_allclose(out, np.stack(grays), atol=1e-6)
    assert native_io.load_batch_gray.native_frames == before + 16


def test_size_mismatch_rejected(tmp_path):
    rng = np.random.default_rng(2)
    p1 = str(tmp_path / "a.pgm")
    p2 = str(tmp_path / "b.pgm")
    _write_pgm(p1, rng.integers(0, 256, size=(8, 8), dtype=np.uint8))
    _write_pgm(p2, rng.integers(0, 256, size=(9, 8), dtype=np.uint8))
    with pytest.raises(native_io.NativeIOError):
        native_io.load_batch_gray([p1, p2], fallback=False)


def test_fallback_to_pil_for_png(tmp_path):
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, size=(12, 14, 3), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    Image.fromarray(rgb).save(p)
    out = native_io.load_batch_gray([p])  # decoded natively (PIL would agree)
    ref = rgb_to_gray(rgb, dtype=np.float32)
    np.testing.assert_allclose(out[0], ref, atol=1e-6)


def test_missing_file_error(tmp_path):
    with pytest.raises(native_io.NativeIOError):
        native_io.load_batch_gray([str(tmp_path / "nope.pgm")], fallback=False)


def test_pgm_nonstandard_maxval(tmp_path):
    """PNM maxval != 255 must scale intensities by the file's maxval."""
    g = np.array([[0, 31, 63], [63, 15, 0]], dtype=np.uint8)
    p = str(tmp_path / "m.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n3 2\n63\n")
        f.write(g.tobytes())
    out = native_io.load_batch_gray([p], fallback=False)
    np.testing.assert_allclose(out[0], g / 63.0, atol=1e-6)


def test_sequence_prefetcher_streams_in_order(tmp_path):
    """Prefetcher yields every frame, in order, equal to the batch load.

    depth < n forces ring-slot reuse; threads > 1 exercises the
    producer ordering under contention."""
    rng = np.random.default_rng(5)
    paths, grays = [], []
    for i in range(23):
        g = rng.integers(0, 256, size=(12, 16), dtype=np.uint8)
        p = str(tmp_path / f"s{i:03d}.pgm")
        _write_pgm(p, g)
        paths.append(p)
        grays.append(g / 255.0)
    got = list(native_io.SequencePrefetcher(paths, threads=3, depth=4))
    assert len(got) == 23
    np.testing.assert_allclose(np.stack(got), np.stack(grays), atol=1e-6)


def test_sequence_prefetcher_early_close(tmp_path):
    """Closing mid-stream must not deadlock or leak worker threads."""
    rng = np.random.default_rng(6)
    paths = []
    for i in range(12):
        p = str(tmp_path / f"e{i}.pgm")
        _write_pgm(p, rng.integers(0, 256, size=(10, 10), dtype=np.uint8))
        paths.append(p)
    pf = native_io.SequencePrefetcher(paths, threads=2, depth=3)
    it = iter(pf)
    next(it)
    next(it)
    pf.close()  # workers must join despite 10 undelivered frames
    pf.close()  # idempotent


# --- mirrors of the format tests of tests/test_datasets.py --------------------


def test_quat_rotation_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(20):
        r = pgeo.so3_exp(torch.from_numpy(rng.standard_normal(3))).numpy()
        q = rotation_to_quat(r)
        np.testing.assert_allclose(quat_to_rotation(q), r, atol=1e-9)


def test_associate_greedy_nearest():
    a = np.array([0.0, 1.0, 2.0, 3.0])
    b = np.array([0.004, 0.96, 1.2, 2.99, 5.0])  # 2.0 has no partner < 0.02
    ia, ib = associate(a, b, max_difference=0.05)
    assert list(zip(ia.tolist(), ib.tolist())) == [(0, 0), (1, 1), (3, 3)]


def test_associate_falls_back_to_second_nearest():
    a = np.array([0.0, 0.01])
    b = np.array([0.009, 0.015])
    ia, ib = associate(a, b, max_difference=0.02)
    # (0.01, 0.009) is the closest pair; 0.0 then pairs with 0.015.
    assert list(zip(ia.tolist(), ib.tolist())) == [(0, 1), (1, 0)]


def test_tum_intrinsics_table():
    k1 = intrinsics_for("/data/rgbd_dataset_freiburg1_xyz")
    assert k1[0, 0] == 517.3
    kd = intrinsics_for("/data/some_other_seq")
    assert kd[0, 0] == 525.0


def test_tum_format_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    n, h, w = 5, 32, 40
    images = rng.random((n, h, w))
    stamps = 1305031102.175 + np.arange(n) / 30.0
    gt_r, gt_t = _random_poses(rng, n)
    root = str(tmp_path / "rgbd_dataset_freiburg2_test")
    write_tum_sequence(root, images, stamps, gt_r, gt_t)

    seq = load_tum_sequence(root)
    assert len(seq.image_paths) == n
    assert seq.k_mat[0, 0] == 520.9  # freiburg2 from the dir name
    np.testing.assert_allclose(seq.timestamps, stamps, atol=1e-6)
    np.testing.assert_allclose(seq.gt_rotations, gt_r, atol=1e-7)
    np.testing.assert_allclose(seq.gt_translations, gt_t, atol=1e-7)
    loaded = seq.load_images()
    assert loaded.shape == (n, h, w)
    np.testing.assert_allclose(loaded, np.round(images * 255.0) / 255.0, atol=1e-6)
    streamed = np.stack(list(seq.stream_frames(threads=2, depth=2)))
    np.testing.assert_array_equal(streamed, loaded)
    # stride / max_frames subsetting
    sub = load_tum_sequence(root, max_frames=2, stride=2)
    np.testing.assert_allclose(sub.timestamps, stamps[[0, 2]], atol=1e-6)


def test_kitti_format_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    n, h, w = 4, 24, 80
    images = rng.random((n, h, w))
    stamps = np.arange(n) * 0.103
    gt_r, gt_t = _random_poses(rng, n)
    root = str(tmp_path / "kitti")
    write_kitti_sequence(root, "07", images, stamps, gt_r, gt_t, KITTI_K)

    seq = load_kitti_sequence(root, "07")
    assert len(seq.image_paths) == n
    np.testing.assert_allclose(seq.k_mat, KITTI_K, atol=1e-9)
    np.testing.assert_allclose(seq.timestamps, stamps, atol=1e-9)
    np.testing.assert_allclose(seq.gt_rotations, gt_r, atol=1e-7)
    np.testing.assert_allclose(seq.gt_translations, gt_t, atol=1e-7)
    loaded = seq.load_images()
    np.testing.assert_allclose(loaded, np.round(images * 255.0) / 255.0, atol=1e-6)
    streamed = np.stack(list(seq.stream_frames(threads=2, depth=2)))
    np.testing.assert_array_equal(streamed, loaded)


def test_trajectory_file_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    n = 6
    gt_r, gt_t = _random_poses(rng, n)
    stamps = np.arange(n) / 30.0
    path = str(tmp_path / "est.txt")
    write_tum_trajectory(path, stamps, gt_r, gt_t)
    ts, rot, t = read_tum_trajectory(path)
    np.testing.assert_allclose(ts, stamps, atol=1e-6)
    np.testing.assert_allclose(rot, gt_r, atol=1e-7)
    np.testing.assert_allclose(t, gt_t, atol=1e-7)


def test_pad_to_tpu_friendly_kitti_dims():
    """KITTI-sized frames pad to aligned dims; the blur over the original
    area is unchanged (edge replication is the clamp-to-edge border rule)."""
    rng = np.random.default_rng(0)
    imgs = rng.random((2, 376, 1241))
    padded = pimage.pad_to_tpu_friendly(imgs)
    assert padded.shape == (2, 384, 1280)
    h, w = 2 * 384, 2 * 1280
    for _ in range(4):
        assert (h * w) % 128 == 0
        h //= 2
        w //= 2
    np.testing.assert_array_equal(padded[:, :376, :1241], imgs)
    np.testing.assert_array_equal(padded[:, 380, :1241], imgs[:, 375])
    np.testing.assert_array_equal(padded[:, :376, 1270], imgs[:, :, 1240])
    small = imgs[0, :40, :37].astype(np.float32)
    blurred = pgaussian.blur_separable(torch.from_numpy(small), 1.3)
    blurred_pad = pgaussian.blur_separable(
        torch.from_numpy(pimage.pad_to_tpu_friendly(small, 16, 16)), 1.3
    )
    np.testing.assert_array_equal(blurred_pad[:40, :37].numpy(), blurred.numpy())
    aligned = rng.random((64, 128))
    assert pimage.pad_to_tpu_friendly(aligned) is aligned


# --- sequences across the packages ---------------------------------------------


def _sequence(seed, n=4, h=20, w=36):
    rng = np.random.default_rng(seed)
    images = rng.random((n, h, w))
    gt_r, gt_t = _random_poses(rng, n)
    return images, 1305031102.175 + np.arange(n) / 30.0, gt_r, gt_t


def _same_sequence(got, want):
    assert got.image_paths == want.image_paths
    for field in ("timestamps", "gt_rotations", "gt_translations", "k_mat"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    np.testing.assert_array_equal(got.load_images(), want.load_images())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tum_sequences_cross_between_the_packages(tmp_path, writer):
    images, stamps, gt_r, gt_t = _sequence(9)
    root = str(tmp_path / "rgbd_dataset_freiburg3_cross")
    (jdata if writer == "jax" else pdata).write_tum_sequence(root, images, stamps, gt_r, gt_t)
    got, want = load_tum_sequence(root), jdata.load_tum_sequence(root)
    _same_sequence(got, want)
    np.testing.assert_array_equal(got.load_images(),
                                  (np.round(images * 255.0) / 255.0).astype(np.float32))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_kitti_sequences_cross_between_the_packages(tmp_path, writer):
    images, stamps, gt_r, gt_t = _sequence(10, w=41)
    root = str(tmp_path / "kitti")
    (jdata if writer == "jax" else pdata).write_kitti_sequence(root, "05", images, stamps, gt_r,
                                                               gt_t, KITTI_K)
    got, want = load_kitti_sequence(root, "05"), jdata.load_kitti_sequence(root, "05")
    _same_sequence(got, want)
    np.testing.assert_array_equal(got.load_images(),
                                  (np.round(images * 255.0) / 255.0).astype(np.float32))


def test_both_writers_write_the_same_files_but_the_png_bytes(tmp_path):
    images, stamps, gt_r, gt_t = _sequence(11)
    jdata.write_tum_sequence(str(tmp_path / "j"), images, stamps, gt_r, gt_t)
    pdata.write_tum_sequence(str(tmp_path / "p"), images, stamps, gt_r, gt_t)
    jdata.write_kitti_sequence(str(tmp_path / "j"), "00", images, stamps, gt_r, gt_t, KITTI_K)
    pdata.write_kitti_sequence(str(tmp_path / "p"), "00", images, stamps, gt_r, gt_t, KITTI_K)
    files = sorted(str(p.relative_to(tmp_path / "j")) for p in (tmp_path / "j").rglob("*")
                   if p.is_file())
    assert files == sorted(str(p.relative_to(tmp_path / "p")) for p in (tmp_path / "p").rglob("*")
                           if p.is_file())
    assert sum(f.endswith(".png") for f in files) == 2 * len(images)
    for name in files:
        j, p = tmp_path / "j" / name, tmp_path / "p" / name
        if name.endswith(".png"):
            with Image.open(j) as a, Image.open(p) as b:
                assert a.mode == b.mode == "L"
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            assert j.read_bytes() == p.read_bytes(), name
