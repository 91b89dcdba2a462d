"""The two-view slice as a whole on the port: two rendered views of a blob
field → detect + describe → ratio/mutual matching → RANSAC essential →
pose recovery → triangulation → PnP, at 320×240 on the CPU, with the bars
of ``tests/test_two_view_images.py``; the same descriptors through the JAX
package's matching and RANSAC (float64, the same sample indices) give the
same matches, inliers and pose; and the port's copy of the synthetic
scene generator is pinned to the original bit for bit.

The full-width scene of ``chip_smoke.py`` is fragile: the blobs' textures
are alike, and of its fields only some give a pose inside the bars. A test
marked ``slow`` (``-m slow``; some three minutes, most of it XLA compiling
the JAX pipeline at 480×640) runs the script's own field, a seed that
fails and a 300-blob field through both packages and requires the same
keypoints described, the same matched pairs, inlier counts within three and
the same verdict from both: the fragility is the field's, not the port's."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sift_scale_space_extrema_detection_tpu.ops import matching as jmatch
from sift_scale_space_extrema_detection_tpu.ops import ransac as jransac
from sift_scale_space_extrema_detection_tpu.sfm import geometry as jgeo
from sift_scale_space_extrema_detection_tpu.utils import synthetic as jsynthetic
import sift_scale_space_extrema_detection_tpu as jsift
import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.models.frontend import detect_octaves
from sift_scale_space_extrema_detection_tpu_torch.ops import ransac as pransac
from sift_scale_space_extrema_detection_tpu_torch.ops.descriptor import describe_compact
from sift_scale_space_extrema_detection_tpu_torch.sfm import geometry as pgeo
from sift_scale_space_extrema_detection_tpu_torch.sfm.pnp import pnp_dlt, solve_pnp
from sift_scale_space_extrema_detection_tpu_torch.utils import synthetic as psynthetic

from tests.torch_port_helpers import rotation_angle_deg

torch.set_num_threads(2)

W, H, FOCAL = 320, 240, 260.0
K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1.0]])
T_DIR = np.array([-0.8, 0.05, 0.1])


def _scene(module, seed=0, n_pts=90):
    """The scene of ``tests/test_two_view_images.py``: the blob field, the
    second camera and both rendered frames, by ``module``'s generator."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2.2, -1.6, 4.0], [2.2, 1.6, 9.0], size=(n_pts, 3))
    r2 = pgeo.so3_exp(torch.tensor([0.02, -0.08, 0.01], dtype=torch.float64)).numpy()
    rpts, amps, sscales = module.textured_blob_field(rng, pts)
    frames = [
        module.render_blob_image(rpts, r, t, K, (W, H), amplitudes=amps, sigma_scales=sscales, rng=rng)
        for r, t in ((np.eye(3), np.zeros(3)), (r2, T_DIR))
    ]
    return pts, r2, (rpts, amps, sscales), frames


# --- the copy of the generator is the original -----------------------------------


def test_blob_field_and_frames_bit_equal():
    _, _, pfield, pframes = _scene(psynthetic)
    _, _, jfield, jframes = _scene(jsynthetic)
    for p, j in zip(pfield + tuple(pframes), jfield + tuple(jframes)):
        assert p.dtype == j.dtype
        np.testing.assert_array_equal(p, j)
    assert pframes[0].shape == (H, W) and 0.0 <= pframes[0].min() < pframes[0].max() <= 1.0


@pytest.mark.parametrize("kwargs", [dict(), dict(blob_sigma_at_unit_depth=6.0, background=0.5, noise=0.0)])
def test_render_defaults_bit_equal(kwargs):
    rng = np.random.default_rng(3)
    pts = rng.uniform([-2, -2, 3], [2, 2, 9], size=(40, 3))
    pts[0, 2] = -1.0  # behind the camera
    args = (pts, np.eye(3), np.zeros(3), K, (W, H))
    np.testing.assert_array_equal(
        psynthetic.render_blob_image(*args, rng=np.random.default_rng(1), **kwargs),
        jsynthetic.render_blob_image(*args, rng=np.random.default_rng(1), **kwargs),
    )


def test_orbit_sequence_bit_equal():
    got = psynthetic.orbit_sequence(np.random.default_rng(5), num_frames=6, num_landmarks=40)
    want = jsynthetic.orbit_sequence(np.random.default_rng(5), num_frames=6, num_landmarks=40)
    assert isinstance(got, psynthetic.SyntheticSequence)
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(want)]
    for name in names:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


# --- the slice as a whole ---------------------------------------------------------


@pytest.fixture(scope="module")
def two_view():
    pts, r2, _, frames = _scene(psynthetic)
    cfg = port.SiftConfig(num_octaves=3, max_keypoints_per_trio=256)
    described = port.detect_and_describe_batched(
        torch.from_numpy(np.stack(frames)).float(), cfg, device="cpu"
    )
    matches = port.match_descriptors(
        described.descriptor[0], described.valid[0], described.descriptor[1], described.valid[1],
        device="cpu",
    )
    k_mat = torch.from_numpy(K).float()
    index = matches.index.long()
    uv1 = torch.stack([described.abs_x[0], described.abs_y[0]], dim=-1)
    uv2 = torch.stack([described.abs_x[1][index], described.abs_y[1][index]], dim=-1)
    rays1, rays2 = pgeo.backproject(uv1, k_mat), pgeo.backproject(uv2, k_mat)
    result = port.estimate_essential_ransac(
        rays1, rays2, matches.valid, torch.Generator().manual_seed(0),
        num_hypotheses=256, inlier_threshold=2.0 / FOCAL, device="cpu",
    )
    return dict(pts=pts, r2=r2, described=described, matches=matches, uv1=uv1, uv2=uv2,
                rays1=rays1, rays2=rays2, result=result, k_mat=k_mat)


def test_two_view_pose_from_images(two_view):
    d, m, res = two_view["described"], two_view["matches"], two_view["result"]
    assert int(d.valid[0].sum()) > 20 and int(d.valid[1].sum()) > 20
    assert int(m.valid.sum()) >= 15
    assert int(res.num_inliers) >= 12
    # Pose: rotation within 1°, translation direction within ~5.7°.
    assert rotation_angle_deg(res.rotation, two_view["r2"]) < 1.0
    cos_t = abs(float(res.translation.double().numpy() @ (T_DIR / np.linalg.norm(T_DIR))))
    assert cos_t > 0.995


def test_two_view_triangulation_and_pnp(two_view):
    res, inl = two_view["result"], two_view["result"].inliers
    eye, zero = torch.eye(3), torch.zeros(3)
    tri, depths = pgeo.triangulate_midpoint(
        eye, zero, res.rotation, res.translation, two_view["rays1"][inl], two_view["rays2"][inl]
    )
    assert bool((depths > 0).all())
    # Depth ratios against the true depths of the nearest projected blobs
    # are scale-consistent: most within 10 % of the median scale.
    pts = two_view["pts"]
    proj = pts[:, :2] / pts[:, 2:3] * FOCAL + [W / 2, H / 2]
    uv1 = two_view["uv1"][inl].numpy()
    true_z = pts[np.argmin(((proj[None] - uv1[:, None]) ** 2).sum(-1), axis=1), 2]
    ratio = depths[:, 0].numpy() / true_z
    assert np.mean(np.abs(ratio / np.median(ratio) - 1.0) < 0.1) > 0.75

    # PnP on the triangulated inliers recovers the second camera (in the
    # reconstruction's own scale: its translation has unit norm).
    ok = torch.ones(len(tri), dtype=torch.bool)
    uv2 = two_view["uv2"][inl]
    r0, t0 = pnp_dlt(tri, uv2, ok, two_view["k_mat"])
    rot, t, rms = solve_pnp(tri, uv2, ok, two_view["k_mat"], r0, t0, device="cpu")
    assert rotation_angle_deg(rot, two_view["r2"]) < 1.0
    cos_t = float((t / t.norm()).double().numpy() @ (T_DIR / np.linalg.norm(T_DIR)))
    assert cos_t > 0.995
    assert float(rms) < 2.0


def test_two_view_from_the_same_descriptors_matches_jax(two_view):
    d = two_view["described"]
    desc = [d.descriptor[i].double().numpy() for i in (0, 1)]
    valid = [d.valid[i].numpy() for i in (0, 1)]
    want = jmatch.match_descriptors(
        jnp.asarray(desc[0]), jnp.asarray(valid[0]), jnp.asarray(desc[1]), jnp.asarray(valid[1])
    )
    got = port.match_descriptors(
        torch.from_numpy(desc[0]), d.valid[0], torch.from_numpy(desc[1]), d.valid[1], device="cpu"
    )
    # Real descriptors: a ratio near 0.8² may flip in the last bits, so hold
    # the matches by agreement, not equality.
    same = (got.valid.numpy() == np.asarray(want.valid)) & (
        ~got.valid.numpy() | (got.index.numpy() == np.asarray(want.index))
    )
    assert same.mean() >= 0.99 and int(got.valid.sum()) >= 15

    rays1, rays2 = two_view["rays1"].double().numpy(), two_view["rays2"].double().numpy()
    mv = two_view["matches"].valid.numpy()
    key = jax.random.PRNGKey(2)
    jres = jransac.estimate_essential_ransac(
        jnp.asarray(rays1), jnp.asarray(rays2), jnp.asarray(mv), key,
        num_hypotheses=64, inlier_threshold=2.0 / FOCAL,
    )
    u = jnp.where(jnp.asarray(mv)[None, :], jax.random.uniform(key, (64, len(mv))), -1.0)
    idx = torch.from_numpy(np.array(jax.lax.top_k(u, 8)[1])).long()
    pres = pransac.essential_from_samples(
        torch.from_numpy(rays1), torch.from_numpy(rays2), torch.from_numpy(mv), idx,
        inlier_threshold=2.0 / FOCAL,
    )
    assert np.array_equal(pres.inliers.numpy(), np.asarray(jres.inliers))
    np.testing.assert_allclose(pres.rotation.numpy(), np.asarray(jres.rotation), atol=1e-6)
    np.testing.assert_allclose(pres.translation.numpy(), np.asarray(jres.translation), atol=1e-6)


# --- the full-width scene, through both packages ------------------------------------

# (blobs, satellites, seed, inside the bars): the field of ``chip_smoke.py``,
# another seed of it, and a field of 300 blobs with the generator's default
# three satellites.
FULL_WIDTH_FIELDS = [(150, 5, 2, True), (150, 5, 1, False), (300, 3, 0, False)]


@pytest.mark.slow
@pytest.mark.parametrize("blobs, satellites, seed, passes", FULL_WIDTH_FIELDS)
def test_full_width_fields_read_the_same_in_both_packages(blobs, satellites, seed, passes):
    import chip_smoke

    frames, k_np, r2, t_dir = chip_smoke._two_view_scene(psynthetic, blobs, satellites, seed)
    sizes = dict(num_octaves=4, scales_per_octave=5, max_keypoints_per_trio=512)
    thresh = chip_smoke.RANSAC_PX / chip_smoke.TWO_VIEW_FOCAL
    jd = [jsift.detect_and_describe(jnp.asarray(f), jsift.SiftConfig(**sizes)) for f in frames]
    # On the CPU the JAX entry point takes its separable path, which caps the
    # candidates of each trio (256 at octave 1: a 300-blob field overflows
    # it); the port's entry point follows the fused path, which caps them by
    # octave. So the port runs the same composition from the same pieces.
    pcfg = port.SiftConfig(**sizes)
    stacks = port.build_scale_space(torch.from_numpy(frames), pcfg, blur="separable", device="cpu")
    keypoints, _ = detect_octaves(port.build_dog(stacks), pcfg)
    pd = describe_compact(stacks, keypoints, pcfg)
    # The same keypoints described. XLA:CPU contracts the blur's products
    # and sums where the port rounds twice, so a near-tie may move one
    # candidate and shift the slots behind it: keypoints are paired by
    # position, not by slot.
    def pairs(abs_x, abs_y, index, match_valid):
        """The matched pairs as a set of rounded (x1, y1, x2, y2)."""
        x1, y1 = np.asarray(abs_x[0]), np.asarray(abs_y[0])
        x2, y2 = np.asarray(abs_x[1])[index], np.asarray(abs_y[1])[index]
        rows = np.stack([x1, y1, x2, y2], axis=-1)[np.asarray(match_valid)]
        return {tuple(np.round(r, 1)) for r in rows}

    jm = jmatch.match_descriptors(jd[0].descriptor, jd[0].valid, jd[1].descriptor, jd[1].valid)
    pm = port.match_descriptors(
        pd.descriptor[0], pd.valid[0], pd.descriptor[1], pd.valid[1], device="cpu"
    )
    counts = dict(jax=[int(d.valid.sum()) for d in jd], port=pd.valid.sum(dim=1).tolist())
    jvalid = np.asarray(jm.valid)
    jpairs = pairs([d.abs_x for d in jd], [d.abs_y for d in jd], np.asarray(jm.index), jvalid)
    ppairs = pairs(pd.abs_x.numpy(), pd.abs_y.numpy(), pm.index.long().numpy(), pm.valid.numpy())
    common = len(jpairs & ppairs)

    # RANSAC, each package on its own matches, the samples drawn from JAX's
    # stream over each package's own valid slots (the same draw where the
    # slots are the same).
    k_mat = torch.from_numpy(k_np).float()
    uv1 = torch.stack([pd.abs_x[0], pd.abs_y[0]], dim=-1)
    uv2 = torch.stack([pd.abs_x[1], pd.abs_y[1]], dim=-1)[pm.index.long()]
    prays = pgeo.backproject(uv1, k_mat), pgeo.backproject(uv2, k_mat)
    jk = jnp.asarray(k_np, jnp.float32)
    juv1 = jnp.stack([jd[0].abs_x, jd[0].abs_y], axis=-1)
    juv2 = jnp.stack([jd[1].abs_x, jd[1].abs_y], axis=-1)[jm.index]
    jrays = jgeo.backproject(juv1, jk), jgeo.backproject(juv2, jk)
    key = jax.random.PRNGKey(0)
    hypotheses = chip_smoke.RANSAC_HYPOTHESES
    jres = jransac.estimate_essential_ransac(
        *jrays, jm.valid, key, num_hypotheses=hypotheses, inlier_threshold=thresh
    )
    draw = jax.random.uniform(key, (hypotheses, len(jvalid)))
    u = jnp.where(jnp.asarray(pm.valid.numpy())[None, :], draw, -1.0)
    idx = torch.from_numpy(np.array(jax.lax.top_k(u, 8)[1])).long()
    pres = pransac.essential_from_samples(*prays, pm.valid, idx, inlier_threshold=thresh)

    t_unit = t_dir / np.linalg.norm(t_dir)
    readings = {}
    for name, rot, t, inliers in (
        ("jax", np.asarray(jres.rotation), np.asarray(jres.translation), np.asarray(jres.inliers)),
        ("port", pres.rotation.numpy(), pres.translation.numpy(), pres.inliers.numpy()),
    ):
        angle = rotation_angle_deg(rot, r2)
        cos_t = abs(float(t.astype(np.float64) @ t_unit))
        readings[name] = dict(
            inliers=int(inliers.sum()), rotation_deg=round(float(angle), 4), cos_t=round(cos_t, 6),
            passes=bool(angle < chip_smoke.MAX_ROTATION_DEG and cos_t > chip_smoke.MIN_TRANSLATION_COS),
        )
    print(
        f"full width, {blobs} blobs x {satellites} satellites, seed {seed}: valid descriptors "
        f"{counts}, distinct matched positions jax {len(jpairs)} port {len(ppairs)}, {common} of "
        f"them the same; {readings}"
    )
    for i in (0, 1):
        assert abs(counts["jax"][i] - counts["port"][i]) <= 0.01 * counts["jax"][i]
    assert common >= 0.9 * max(len(jpairs), len(ppairs))
    assert abs(readings["port"]["inliers"] - readings["jax"]["inliers"]) <= 3
    assert readings["port"]["passes"] == readings["jax"]["passes"] == passes
