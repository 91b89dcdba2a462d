"""The port's visual SLAM: images → tracks → trajectory, batch and
streaming. The mirrors of ``tests/test_visual_slam.py`` at its sizes and
bars, run with ``device="cpu"``; and the association of both packages on
the SAME described keypoints (the port's, handed to the JAX package in
place of its frontend, whose CPU path caps candidates by trio where the
port caps them by octave) with the JAX package's RANSAC draws: identical
``pixels`` and ``visible``, with and without the loop-closure pass.

The reference's runs here compile with JAX's persistent compilation cache
switched off (``ROADMAP.md`` §3)."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sift_scale_space_extrema_detection_tpu import SiftConfig as JSiftConfig
from sift_scale_space_extrema_detection_tpu.models import frontend as jfrontend
from sift_scale_space_extrema_detection_tpu.models import slam as jslam
from sift_scale_space_extrema_detection_tpu.ops.descriptor import DescribedKeypoints as JDescribed
import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.models.slam import (
    SlamConfig,
    build_tracks_from_images,
    evaluate_ate,
    run_slam,
    run_slam_from_images,
)
from sift_scale_space_extrema_detection_tpu_torch.models.streaming import SlamSession
from sift_scale_space_extrema_detection_tpu_torch.models import slam as pslam
from sift_scale_space_extrema_detection_tpu_torch.sfm import geometry as pgeo
from sift_scale_space_extrema_detection_tpu_torch.utils import checkpoint as pckpt
from sift_scale_space_extrema_detection_tpu_torch.utils.synthetic import (
    render_blob_image,
    textured_blob_field,
)

from tests.torch_port_helpers import (
    K_LOOP,
    _texture,
    jax_ransac_draws,
    loop_distractor_images,
)

torch.set_num_threads(2)

CPU = dict(device="cpu")
SIFT = port.SiftConfig(num_octaves=3, max_keypoints_per_trio=256)


@pytest.fixture(scope="module", autouse=True)
def _no_persistent_jax_cache():
    before = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", before)


def render_sequence(rng, num_frames=8, w=320, h=240):
    """Slow lateral dolly past a textured blob field (the recipe of
    ``tests/test_visual_slam.py::_render_sequence``)."""
    k_mat = np.array([[260.0, 0, w / 2], [0, 260.0, h / 2], [0, 0, 1.0]])
    pts = rng.uniform([-3.5, -1.8, 4.0], [3.5, 1.8, 9.0], size=(110, 3))
    rpts, amps, ss = textured_blob_field(rng, pts)
    rots, ts, imgs = [], [], []
    for f in range(num_frames):
        w_vec = torch.tensor([0.004 * f, -0.01 * f, 0.002 * f], dtype=torch.float64)
        r = pgeo.so3_exp(w_vec).numpy()
        t = -r @ np.array([0.28 * f, 0.02 * f, 0.0])
        imgs.append(render_blob_image(rpts, r, t, k_mat, (w, h), amplitudes=amps,
                                      sigma_scales=ss, rng=np.random.default_rng(100 + f)))
        rots.append(r)
        ts.append(t)
    return np.stack(imgs), np.stack(rots), np.stack(ts), k_mat


def test_visual_slam_end_to_end():
    images, gt_r, gt_t, k_mat = render_sequence(np.random.default_rng(0))
    result = run_slam_from_images(images, k_mat, SIFT, SlamConfig(ba_interval=3, ba_window=6), **CPU)
    assert result.landmark_valid.sum() > 20
    ate = evaluate_ate(result, gt_r, gt_t, **CPU)
    assert ate < 0.06, f"ATE {ate:.4f}"


def test_window_reassociation_reacquires_lost_tracks():
    """A track lost in a blank middle frame is re-acquired from the 2-frame
    window and lands on the RIGHT keypoints: every shared track shows the
    texture's (dx, dy) shift."""
    tex = _texture(np.random.default_rng(3), (160, 160), 1.5)
    dy, dx = 5, 3
    images = np.stack([tex[dy : dy + 128, dx : dx + 128], np.full((128, 128), 0.5),
                       tex[0:128, 0:128]]).astype(np.float32)
    cfg = port.SiftConfig(num_octaves=2, max_keypoints_per_trio=256)
    pixels, visible, _ = build_tracks_from_images(images, cfg, k_mat=None, reassoc_window=2, **CPU)
    shared = visible[0] & visible[2] & ~visible[1]
    assert shared.sum() >= 5, f"only {shared.sum()} re-acquired tracks"
    offsets = pixels[2, shared] - pixels[0, shared]
    np.testing.assert_allclose(np.median(offsets, axis=0), [dx, dy], atol=0.5)
    spread = np.abs(offsets - [dx, dy]).max()
    assert spread < 1.0, f"re-associated offsets scattered by {spread:.2f}px"


def test_relocalization_after_blackout_via_loop_association():
    """Kidnapped-camera recovery through loop association: after a blackout
    the camera reappears near the start; with ``loop_stride`` its keypoints
    merge into the original tracks and the windowed PnP localizes it
    against the bootstrap-era map."""
    rng = np.random.default_rng(9)
    k_mat = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
    pts = rng.uniform([-3.5, -1.8, 4.0], [6.0, 1.8, 9.0], size=(140, 3))
    rpts, amps, ss = textured_blob_field(rng, pts)
    xs_path = [0.0, 0.3, 0.6, 0.9, 1.2, 1.5, None, None, 0.15, 0.35]
    imgs, gt_centers = [], []
    for f, x in enumerate(xs_path):
        if x is None:  # blackout
            imgs.append(np.full((240, 320), 0.5))
            gt_centers.append(None)
            continue
        imgs.append(render_blob_image(rpts, np.eye(3), -np.array([x, 0.0, 0.0]), k_mat,
                                      (320, 240), amplitudes=amps, sigma_scales=ss,
                                      rng=np.random.default_rng(100 + f)))
        gt_centers.append(np.array([x, 0.0, 0.0]))
    images = np.stack(imgs).astype(np.float32)
    slam_cfg = SlamConfig(ba_interval=3, ba_window=6, bootstrap_baseline=2)

    def centers(loop_stride):
        pixels, visible, _ = build_tracks_from_images(
            images, SIFT, k_mat=k_mat, reassoc_window=1, loop_stride=loop_stride,
            loop_min_gap=3, loop_min_matches=8, **CPU,
        )
        res = run_slam(pixels, visible, k_mat, slam_cfg, **CPU)
        return -np.einsum("nji,nj->ni", res.rotations, res.translations)

    c_loop, c_none = centers(1), centers(0)
    # Monocular gauge: errors in dolly-path units.
    err_loop = np.linalg.norm(c_loop[8] / (np.linalg.norm(c_loop[5] - c_loop[0]) / 1.5) - gt_centers[8])
    err_none = np.linalg.norm(c_none[8] / (np.linalg.norm(c_none[5] - c_none[0]) / 1.5) - gt_centers[8])
    assert err_none > 0.7, f"blackout did not strand the pose ({err_none:.2f})"
    assert err_loop < 0.4, f"relocalization failed ({err_loop:.2f})"


def test_streaming_session_matches_batch():
    """Frame-by-frame ingest through ``SlamSession`` reproduces the batch
    pipeline's trajectory, bit for bit, with a provisional update per filled
    window, and leaves nothing in the mem:// store."""
    images, gt_r, gt_t, k_mat = render_sequence(np.random.default_rng(12), num_frames=10)
    slam_cfg = SlamConfig(ba_interval=3, ba_window=6, bootstrap_baseline=2)
    batch = run_slam_from_images(images, k_mat, SIFT, slam_cfg, reassoc_window=2, **CPU)
    ate_batch = evaluate_ate(batch, gt_r, gt_t, **CPU)

    stored = set(pckpt._MEM_STORE)
    sess = SlamSession(k_mat, SIFT, slam_cfg, reassoc_window=2, **CPU)
    updates = [sess.add_frame(im) for im in images]
    assert sum(u is not None for u in updates) == 3  # frames 4, 7, 10
    last = [u for u in updates if u is not None][-1]
    assert last.rotations.shape[0] == 10
    assert np.isfinite(last.translations).all()

    result = sess.finalize()
    assert sess.frames_processed == 10
    assert set(pckpt._MEM_STORE) == stored
    ate_stream = evaluate_ate(result, gt_r, gt_t, **CPU)
    assert ate_stream < 0.35, f"stream ATE {ate_stream:.4f}"
    assert ate_batch < 0.35, f"batch ATE {ate_batch:.4f}"
    assert abs(ate_stream - ate_batch) < 0.02, f"stream {ate_stream:.4f} vs batch {ate_batch:.4f}"
    np.testing.assert_array_equal(result.rotations, batch.rotations)
    np.testing.assert_array_equal(result.translations, batch.translations)


def _inject_port_frontend(monkeypatch, cfg):
    """Hand the JAX package's ``build_tracks_from_images`` the port's
    described keypoints (it imports its frontend at call time)."""

    def frontend(images, sift_cfg, blur="separable"):
        got = port.detect_and_describe_batched(torch.from_numpy(np.array(images)), cfg, **CPU)
        return JDescribed(**{f.name: jnp.asarray(getattr(got, f.name).numpy())
                             for f in dataclasses.fields(got)})

    monkeypatch.setattr(jfrontend, "detect_and_describe_batched_jit", frontend)


# Three frames of ``chip_smoke.py`` phase 16's TUM rehearsal (200 × 640×480
# frames of the bench dolly, seed 0), with ``evaluate``'s SiftConfig and
# intrinsics (the TUM layout's), its gated association flags and a track
# room that the three frames overflow (287 keypoints in the first). Over the
# whole rehearsal the two packages' associations first part at frame 80
# (pair 79→80), in pair verification (``tools/torch_dolly_parity.py
# --frames 200 --max-tracks 65536 --legs a``); through frame 79 they are
# bit-equal.
REHEARSAL_FRAMES = (59, 60, 61)
REHEARSAL_SIFT = port.SiftConfig(num_octaves=4, scales_per_octave=3, max_keypoints_per_trio=512)
REHEARSAL_GATED = dict(reassoc_window=2, max_match_px=30.0)
REHEARSAL_SMALL_ROOM = 400


@functools.cache
def _rehearsal_frames():
    """The rehearsal's three frames as ``evaluate`` decodes them,
    the intrinsics it reads for them, and the port's described keypoints of
    them."""
    import chip_smoke
    from sift_scale_space_extrema_detection_tpu_torch.benchmarks.slam_bench import render_sequence
    from sift_scale_space_extrema_detection_tpu_torch.data.tum import intrinsics_for

    frames = render_sequence(np.random.default_rng(0), chip_smoke.SURFACE_FRAMES,
                             chip_smoke.WIDTH, chip_smoke.HEIGHT, keep=REHEARSAL_FRAMES)[0]
    k_mat = intrinsics_for("rgbd_dataset_freiburg1_rehearsal")  # write_rehearsal_sequence's root
    pixels = np.clip(np.round(frames * 255.0), 0, 255).astype(np.uint8)
    images = (pixels / 255.0).astype(np.float32)
    described = port.detect_and_describe_batched(torch.from_numpy(images), REHEARSAL_SIFT,
                                                 "separable", **CPU)
    return images, k_mat, described


@pytest.mark.parametrize(
    "scene", ["dolly_reassoc", "loop_sketch", "dolly_gated_room", "dolly_gated_overflow"])
def test_association_matches_the_reference_on_the_same_keypoints(monkeypatch, scene):
    described = None
    if scene == "dolly_reassoc":
        images, _, _, k_mat = render_sequence(np.random.default_rng(0))
        cfg, kw = SIFT, dict(reassoc_window=2)
    elif scene == "loop_sketch":
        images, k_mat = loop_distractor_images(), K_LOOP
        cfg = port.SiftConfig(num_octaves=2, max_keypoints_per_trio=256)
        kw = dict(reassoc_window=0, loop_min_gap=3, loop_min_matches=8, loop_stride=1, loop_topk=2)
    else:
        images, k_mat, described = _rehearsal_frames()
        cfg = REHEARSAL_SIFT
        room = 65_536 if scene == "dolly_gated_room" else REHEARSAL_SMALL_ROOM
        kw = dict(REHEARSAL_GATED, max_tracks=room)
    if described is None:
        _inject_port_frontend(monkeypatch, cfg)
    else:
        fields = {f.name: jnp.asarray(getattr(described, f.name).numpy())
                  for f in dataclasses.fields(described)}
        monkeypatch.setattr(jfrontend, "detect_and_describe_batched_jit",
                            lambda images, sift_cfg, blur="separable": JDescribed(**fields))
    want = jslam.build_tracks_from_images(
        images, JSiftConfig(num_octaves=cfg.num_octaves), k_mat=k_mat, **kw
    )
    monkeypatch.setattr(pslam, "_pair_draws", jax_ransac_draws)
    if described is None:
        got = build_tracks_from_images(images, cfg, k_mat=k_mat, **kw, **CPU)
    else:
        got = pslam.build_tracks_from_described(described, k_mat, **kw, **CPU)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[1].sum() > 100
    if scene == "loop_sketch":
        assert (got[1][0] & got[1][10]).sum() >= 8  # the merge happened in both
    if scene.startswith("dolly_gated"):
        # The gate and the window both acted: a frame-2 keypoint re-acquired
        # from frame 0 past frame 1 (the gate scaled by the frame gap).
        assert (got[1][0] & ~got[1][1] & got[1][2]).any()
    if scene == "dolly_gated_overflow":
        # The room filled, and valid keypoints were left without a track.
        assert got[1].shape[1] == REHEARSAL_SMALL_ROOM
        assert got[1].sum(axis=1).tolist() != got[2].tolist()


def _first_centre(rotations, translations):
    """Frame 1's camera centre (frame 0 sits at the origin)."""
    return -rotations[1].T @ translations[1]


@pytest.mark.slow
def test_full_width_bench_sequence_through_both_packages():
    """``chip_smoke.py`` phase 15's full-width sequence (40 × 480×640
    uint16 frames, ``chip_smoke.slam_bench_recipe``) through both packages
    on the CPU (about ten minutes, 2 GiB).

    - The recipe's tracks (the port's keypoints and association): neither
      back end, in float32 or float64, recovers frame 1's motion (the truth
      is a sideways step; the bootstrap's essential matrix puts it along
      the optical axis), and neither solves the sequence.
    - The JAX package's own pipeline (its frontend, its association) loses
      the sequence too, in float32.
    - The same keypoints tracked with the recipe's ``solved`` match gate and
      track room: both back ends solve it, within 0.02 ATE of each other;
      so does the JAX package's own pipeline with the same association.

    Prints one JSON line of every reading (``-s``)."""
    import json

    import chip_smoke

    recipe = chip_smoke.slam_bench_recipe(port)
    images, gt_r, gt_t, k_mat = (recipe[k] for k in ("images", "gt_r", "gt_t", "k_mat"))
    cfg = recipe["slam_cfg"]
    jcfg = jslam.SlamConfig(**dataclasses.asdict(cfg))
    described = pslam.describe_frames(images, recipe["sift_cfg"], chip_smoke.SLAM_CHUNK, **CPU)
    track = dict(reassoc_window=recipe["reassoc_window"], **CPU)
    tracks = {
        "recipe": pslam.build_tracks_from_described(described, k_mat, **track)[:2],
        "solved": pslam.build_tracks_from_described(described, k_mat, **track,
                                                    **recipe["solved"])[:2],
    }
    true_step = _first_centre(gt_r, gt_t)

    def reading(result, ate, visible=None):
        step = _first_centre(result.rotations, result.translations)
        cos = float(step @ true_step / (np.linalg.norm(step) * np.linalg.norm(true_step)))
        out = dict(ate=float(ate), first_step_cos=cos, landmarks=int(result.landmark_valid.sum()))
        if visible is not None:
            out.update(tracks=int(visible.shape[1]), last_frame_sees=int(visible[-1].sum()))
        return out

    readings = {}
    x64 = jax.config.jax_enable_x64
    try:
        for name, (pixels, visible) in tracks.items():
            for bits, dtype in ((32, torch.float32), (64, torch.float64)):
                jax.config.update("jax_enable_x64", bits == 64)
                want = jslam.run_slam(pixels, visible, k_mat, jcfg)
                readings[f"{name}_jax_f{bits}"] = reading(
                    want, jslam.evaluate_ate(want, gt_r, gt_t))
                got = run_slam(pixels, visible, k_mat, cfg, dtype=dtype, **CPU)
                readings[f"{name}_port_f{bits}"] = reading(
                    got, evaluate_ate(got, gt_r, gt_t, **CPU), visible)
        jax.config.update("jax_enable_x64", False)
        jsift = JSiftConfig(**{f.name: getattr(recipe["sift_cfg"], f.name)
                               for f in dataclasses.fields(recipe["sift_cfg"])})
        for name, kw in (("", {}), ("_solved", recipe["solved"])):
            pixels, visible, _ = jslam.build_tracks_from_images(
                images, jsift, k_mat=k_mat, reassoc_window=recipe["reassoc_window"],
                frontend_chunk=8, **kw,
            )
            own = jslam.run_slam(pixels, visible, k_mat, jcfg)
            readings[f"jax_own_pipeline{name}_f32"] = reading(
                own, jslam.evaluate_ate(own, gt_r, gt_t), visible)
    finally:
        jax.config.update("jax_enable_x64", x64)
    print(json.dumps(readings))

    for bits in (32, 64):
        for pkg in ("jax", "port"):
            lost = readings[f"recipe_{pkg}_f{bits}"]
            assert lost["first_step_cos"] < 0.5 and lost["ate"] > 0.5, (pkg, bits, lost)
            solved = readings[f"solved_{pkg}_f{bits}"]
            assert solved["ate"] < 0.06 and solved["first_step_cos"] > 0.99, (pkg, bits, solved)
        gap = readings[f"solved_jax_f{bits}"]["ate"] - readings[f"solved_port_f{bits}"]["ate"]
        assert abs(gap) < 0.02, (bits, gap)
    assert readings["jax_own_pipeline_f32"]["ate"] > 0.5
    assert readings["jax_own_pipeline_solved_f32"]["ate"] < 0.06


@pytest.mark.slow
def test_rehearsal_association_at_80_frames_through_both_packages():
    """Leg (a) of ``tools/torch_dolly_parity.py``: the association of both
    packages on the port's keypoints of the TUM rehearsal's first 80 frames
    (``evaluate``'s SiftConfig, ``blur="separable"``), gated at 30 px,
    re-associating over 2 keyframes, with room for 65,536 tracks and the JAX
    package's draws, as ``evaluate`` runs it (JAX in 32-bit mode). About six
    minutes on the CPU.

    - With the port's pair verification pinned to the JAX package's verdicts
      on the same correspondences and keys, the two track tables are
      bit-equal: matching, the ratio test, the cross-check, the gate (scaled
      by the frame gap for re-association), re-association, new tracks and
      the room make the reference's decisions at every frame.
    - Unpinned, the tables are bit-equal through these 80 frames on the
      machines measured; where they part (frame 80 of the rehearsal's 200),
      it is where the two pair verifications give different verdicts: the
      minimal 8-point solves of ill-conditioned samples differ in float32
      between the two implementations (``ROADMAP.md`` §3).

    The tool prints the leg's JSON record (``-s``)."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_dolly_parity", os.path.join(root, "tools", "torch_dolly_parity.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    images, k_mat, _, _ = tool.load_frames(80)
    described = pslam.describe_frames(images, REHEARSAL_SIFT, 16, blur="separable", **CPU)
    described = {f.name: getattr(described, f.name).numpy() for f in dataclasses.fields(described)}
    ref = tool.Reference()
    with ref.x64(False):
        _, got, record = tool.leg_a(ref, described, k_mat, 65_536, jax_ransac_draws)
    assert record["pinned"]["bit_equal"], record["pinned"]
    assert record["bit_equal"] or record["first_stage"] == "pair verification", record
    assert got[1].shape[1] > 16_384  # past the room of phase 15's solved recipe
