"""The port's rules: no JAX on its import path, no silent fallback from CUDA."""

import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import sift_scale_space_extrema_detection_tpu_torch as port
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels import _build
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.blur import blur_fused
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.describe import (
    window_sample_pair,
)
from sift_scale_space_extrema_detection_tpu_torch.ops.kernels.octave import fused_octave

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def test_port_runs_without_importing_jax():
    # A fresh interpreter: this process has jax loaded by conftest.
    code = textwrap.dedent(
        """
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import sift_scale_space_extrema_detection_tpu_torch as port
        rng = np.random.default_rng(0)
        image = torch.from_numpy((rng.random((24, 32)) * 255).astype(np.uint8))
        kp, ex = port.detect(image, port.SiftConfig(num_octaves=2), device="cpu")
        assert kp.valid.shape == (kp.capacity,)
        described = port.detect_and_describe(
            image, port.SiftConfig(num_octaves=2), device="cpu"
        )
        assert described.descriptor.shape == (described.capacity, 128)
        port.build_scale_space(
            image.float(), port.SiftConfig(num_octaves=2), "cuda", device="cpu"
        )
        space = port.build_scale_space(
            image.double()[None] / 255, port.SiftConfig(num_octaves=2), "exact", device="cpu"
        )
        port.detect_from_dog(port.build_dog(space), port.SiftConfig(num_octaves=2))
        from sift_scale_space_extrema_detection_tpu_torch.utils import oracle, synthetic
        ok = torch.ones(20, dtype=torch.bool)
        port.match_descriptors(torch.rand(20, 128), ok, torch.rand(20, 128), ok, device="cpu")
        rays = torch.cat([torch.rand(20, 2), torch.ones(20, 1)], dim=1)
        port.estimate_essential_ransac(
            rays, rays + 0.01, ok, torch.Generator().manual_seed(0), num_hypotheses=8, device="cpu"
        )
        pts = torch.rand(20, 3) + torch.tensor([0.0, 0.0, 3.0])
        k = torch.tensor([[100.0, 0, 50], [0, 100.0, 50], [0, 0, 1]])
        uv = port.sfm.geometry.project(pts, k)
        port.sfm.pnp.solve_pnp(pts, uv, ok, k, torch.eye(3), torch.zeros(3), iterations=2, device="cpu")
        state = port.sfm.ba.BAState(torch.eye(3)[None], torch.zeros(1, 3), pts, k)
        obs = port.sfm.ba.Observations(
            torch.zeros(20, dtype=torch.int32), torch.arange(20, dtype=torch.int32), uv, ok
        )
        port.sfm.ba.bundle_adjust(state, obs, num_iterations=1, num_fixed_cameras=0, device="cpu")
        edges = port.sfm.pose_graph.PoseGraphEdges(
            torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32),
            torch.eye(3)[None], torch.zeros(1, 3), torch.ones(1),
        )
        port.sfm.pose_graph.optimize_pose_graph(
            torch.eye(3).repeat(2, 1, 1), torch.zeros(2, 3), edges, num_iterations=1, device="cpu"
        )
        from sift_scale_space_extrema_detection_tpu_torch.utils import debug, metrics, profile
        from sift_scale_space_extrema_detection_tpu_torch.utils.synthetic import orbit_sequence
        seq = orbit_sequence(np.random.default_rng(3), num_frames=6, num_landmarks=60)
        res = port.run_slam(seq.pixels, seq.visible, seq.k_mat, port.SlamConfig(ba_interval=3),
                            checkpoint_dir="mem://no_jax", device="cpu")
        debug.assert_finite(res.rotations)
        import tempfile
        from sift_scale_space_extrema_detection_tpu_torch import parallel
        with tempfile.TemporaryDirectory() as tmp:
            parallel.initialize_multihost(f"file://{tmp}/store", 1, 0, backend="gloo")
            mesh = parallel.make_mesh(device_type="cpu")
            parallel.distributed_bundle_adjust(state, obs, mesh, num_iterations=1,
                                               num_fixed_cameras=0)
            torch.distributed.destroy_process_group()
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
        assert not leaked, leaked
        assert "sift_scale_space_extrema_detection_tpu" not in sys.modules
        print("ok", int(kp.valid.sum()))
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok ")


def test_a_cuda_mesh_without_a_card_raises(monkeypatch):
    # The check comes before any process group is needed.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device.*"cpu" mesh'):
        port.parallel.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.parallel.global_mesh(device_type="cuda")


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(coordinator_address="localhost:1"),
        dict(num_processes=2),
        dict(process_id=0),
        dict(coordinator_address="localhost:1", num_processes=2),
    ],
    ids=["address", "processes", "id", "address+processes"],
)
def test_a_partial_initialize_multihost_raises(kwargs):
    # Raised before any rendezvous is tried.
    with pytest.raises(ValueError, match="go together"):
        port.parallel.initialize_multihost(**kwargs)


def test_a_mesh_of_another_device_type_is_refused():
    class CudaMesh:
        device_type = "cuda"

    seq_pix, seq_vis = np.zeros((3, 4, 2)), np.ones((3, 4), bool)
    with pytest.raises(ValueError, match="mesh cannot serve a run on cpu"):
        port.run_slam(seq_pix, seq_vis, np.eye(3), mesh=CudaMesh(), device="cpu")


def test_no_file_of_the_port_imports_jax():
    banned = re.compile(
        r"^\s*(import|from)\s+(jax|flax|sift_scale_space_extrema_detection_tpu[. ])", re.M
    )
    files = sorted((REPO / "sift_scale_space_extrema_detection_tpu_torch").rglob("*.py"))
    assert len(files) > 25
    for path in files + [REPO / "chip_smoke.py"]:
        assert not banned.search(path.read_text()), path


def test_load_kernels_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    _build.load_kernels.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load_kernels()
    finally:
        _build.load_kernels.cache_clear()


def test_fused_octave_has_no_fallback_for_other_devices():
    base = torch.empty((1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_octave(base, [0.8, 1.0, 1.2, 1.4], 1, 0.01)


@pytest.mark.parametrize(
    "base, error",
    [
        (torch.zeros((1, 8, 8), dtype=torch.float64), TypeError),
        (torch.zeros((8, 8)), ValueError),
        (torch.zeros((1, 8, 16))[..., ::2], ValueError),
    ],
    ids=["float64", "2d", "strided"],
)
def test_fused_octave_checks_its_input(base, error):
    with pytest.raises(error):
        fused_octave(base, [0.8, 1.0, 1.2, 1.4], 1, 0.01)


def test_octave_smaller_than_two_pixels_raises():
    # 8x8 input: octave 0 is 16x16, octave 4 is 1x1.
    with pytest.raises(ValueError, match="fewer octaves"):
        port.detect(torch.rand(8, 8), port.SiftConfig(num_octaves=5), device="cpu")


def test_blur_fused_has_no_fallback_for_other_devices():
    with pytest.raises(ValueError, match="no kernel for device"):
        blur_fused(torch.empty((1, 8, 8), device="meta"), 1.2)


@pytest.mark.parametrize(
    "image, error",
    [
        (torch.zeros((1, 8, 8), dtype=torch.float64), TypeError),
        (torch.zeros((8,)), ValueError),
        (torch.zeros((1, 8, 16))[..., ::2], ValueError),
    ],
    ids=["float64", "1d", "strided"],
)
def test_blur_fused_checks_its_input(image, error):
    with pytest.raises(error):
        blur_fused(image, 1.2)


def _sample_args(device="cpu"):
    stacks = [torch.zeros((1, 4, 8, 8), device=device), torch.zeros((1, 4, 4, 4), device=device)]
    slots = torch.zeros((3, 4), dtype=torch.int32, device=device)
    coords = torch.zeros((3, 5), device=device)
    return stacks, slots, coords, coords.clone()


def test_window_sample_pair_has_no_fallback_for_other_devices():
    with pytest.raises(ValueError, match="no kernel for device"):
        window_sample_pair(*_sample_args("meta"))


def _with(index, value):
    args = list(_sample_args())
    args[index] = value
    return args


@pytest.mark.parametrize(
    "args, error",
    [
        (_with(2, torch.zeros((3, 5), dtype=torch.float64)), TypeError),
        (_with(1, torch.zeros((3, 4), dtype=torch.int64)), TypeError),
        (_with(0, [torch.zeros((1, 4, 8, 8), dtype=torch.float16)]), TypeError),
        (_with(3, torch.zeros((3, 10))[:, ::2]), ValueError),
        (_with(0, [torch.zeros((1, 4, 8, 16))[..., ::2]]), ValueError),
        (_with(1, torch.zeros((3, 5), dtype=torch.int32)), ValueError),
        (_with(3, torch.zeros((3, 6))), ValueError),
        (_with(0, [torch.zeros((1, 4, 8, 8)), torch.zeros((2, 4, 4, 4))]), ValueError),
        (_with(0, []), ValueError),
        (_with(1, torch.zeros((3, 4), dtype=torch.int32, device="meta")), ValueError),
    ],
    ids=[
        "float64_coords", "int64_slots", "float16_stack", "strided_coords",
        "strided_stack", "slot_columns", "coords_shapes", "stack_batches",
        "no_stack", "mixed_devices",
    ],
)
def test_window_sample_pair_checks_its_input(args, error):
    with pytest.raises(error):
        window_sample_pair(*args)


def test_unknown_blur_strategy_raises():
    with pytest.raises(KeyError):
        port.build_scale_space(
            torch.rand(1, 8, 8), port.SiftConfig(num_octaves=1), "pallas", device="cpu"
        )


_CFG = port.SiftConfig(num_octaves=2)
ENTRY_POINTS = {
    "detect": lambda **kw: port.detect(torch.rand(16, 20), _CFG, **kw),
    "detect_batched": lambda **kw: port.detect_batched(torch.rand(1, 16, 20), _CFG, **kw),
    "detect_and_describe": lambda **kw: port.detect_and_describe(
        torch.rand(16, 20), _CFG, **kw
    ),
    "detect_and_describe_batched": lambda **kw: port.detect_and_describe_batched(
        torch.rand(1, 16, 20), _CFG, **kw
    ),
    "build_pyramid_fused": lambda **kw: port.build_pyramid_fused(
        torch.rand(1, 16, 20), _CFG, **kw
    ),
    "build_scale_space": lambda **kw: port.build_scale_space(
        torch.rand(1, 16, 20), _CFG, **kw
    ),
}


def _tensors(result):
    """Every tensor of an entry point's result (dataclasses, lists, tuples)."""
    if isinstance(result, torch.Tensor):
        return [result]
    if isinstance(result, (list, tuple)):
        return [t for item in result for t in _tensors(item)]
    return [t for value in vars(result).values() for t in _tensors(value)]


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_card_unless_asked_for_the_cpu(name, monkeypatch):
    # Without a CUDA device the default raises and names the way out; it
    # never carries on on the CPU by itself.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()
    tensors = _tensors(ENTRY_POINTS[name](device="cpu"))
    assert tensors and all(t.device.type == "cpu" for t in tensors)


# --- the solvers' entry points -----------------------------------------------------


def _solver_inputs():
    """Tiny float32 inputs of the five solver entry points, from a seed."""
    rng = np.random.default_rng(0)
    k = torch.tensor([[100.0, 0, 50], [0, 100.0, 50], [0, 0, 1]])
    pts = torch.from_numpy(rng.uniform([-1, -1, 3], [1, 1, 6], size=(24, 3))).float()
    rots = port.sfm.geometry.so3_exp(torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.1, 0.0], [0.0, 0.2, 0.0]]))
    ts = torch.tensor([[0.0, 0.0, 0.0], [-0.3, 0.0, 0.0], [-0.6, 0.0, 0.1]])
    uv = port.sfm.geometry.project(port.sfm.geometry.transform(rots, ts, pts), k)  # (3, 24, 2)
    ok = torch.ones(24, dtype=torch.bool)
    state = port.sfm.ba.BAState(rots, ts, pts + 0.01, k)
    obs = port.sfm.ba.Observations(
        torch.arange(3, dtype=torch.int32).repeat_interleave(24),
        torch.arange(24, dtype=torch.int32).repeat(3),
        uv.reshape(-1, 2),
        torch.ones(72, dtype=torch.bool),
    )
    edges = port.sfm.pose_graph.PoseGraphEdges(
        torch.tensor([0, 1], dtype=torch.int32), torch.tensor([1, 2], dtype=torch.int32),
        torch.eye(3).repeat(2, 1, 1), torch.zeros(2, 3), torch.ones(2),
    )
    desc = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(24, 128))).float(), dim=1)
    rays = port.sfm.geometry.backproject(uv, k)
    return dict(k=k, pts=pts, rots=rots, ts=ts, uv=uv, ok=ok, state=state, obs=obs,
                edges=edges, desc=desc, rays=rays)


_S = _solver_inputs()
SOLVER_ENTRY_POINTS = {
    "match_descriptors": lambda **kw: port.match_descriptors(
        _S["desc"], _S["ok"], _S["desc"].flip(0), _S["ok"], **kw
    ),
    "estimate_essential_ransac": lambda **kw: port.estimate_essential_ransac(
        _S["rays"][0], _S["rays"][1], _S["ok"], torch.Generator().manual_seed(0),
        num_hypotheses=16, **kw,
    ),
    "solve_pnp": lambda **kw: port.sfm.pnp.solve_pnp(
        _S["pts"], _S["uv"][1], _S["ok"], _S["k"], _S["rots"][0], _S["ts"][0], iterations=2, **kw
    ),
    "optimize_pose_graph": lambda **kw: port.sfm.pose_graph.optimize_pose_graph(
        _S["rots"], _S["ts"], _S["edges"], num_iterations=2, **kw
    ),
    "bundle_adjust": lambda **kw: port.sfm.ba.bundle_adjust(
        _S["state"], _S["obs"], num_iterations=2, **kw
    ),
    "bundle_adjust_cg": lambda **kw: port.sfm.ba.bundle_adjust(
        _S["state"], _S["obs"], num_iterations=2, solver="cg", cg_iterations=4, **kw
    ),
}


@pytest.mark.parametrize("name", sorted(SOLVER_ENTRY_POINTS))
def test_solver_runs_on_the_card_unless_asked_for_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SOLVER_ENTRY_POINTS[name]()
    tensors = _tensors(SOLVER_ENTRY_POINTS[name](device="cpu"))
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    assert all(bool(torch.isfinite(t).all()) for t in tensors if t.is_floating_point())


@pytest.mark.parametrize("name", ["match_descriptors", "bundle_adjust", "bundle_adjust_cg"])
def test_matrix_products_refuse_tf32_on_cuda(name, monkeypatch):
    # The card is only pretended: the guard fires before a tensor moves.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        SOLVER_ENTRY_POINTS[name]()
    SOLVER_ENTRY_POINTS[name](device="cpu")  # the CPU has no TF32


def test_bundle_adjust_refuses_an_undersized_sorted_pad():
    # Every landmark is seen by all three cameras.
    with pytest.raises(ValueError, match="sorted_pad"):
        port.sfm.ba.bundle_adjust(_S["state"], _S["obs"], num_iterations=1, sorted_pad=2, device="cpu")
    port.sfm.ba.bundle_adjust(_S["state"], _S["obs"], num_iterations=1, sorted_pad=3, device="cpu")


def test_ransac_draws_on_the_generators_device():
    # A CPU generator serves any target device: the keys are drawn where
    # the generator lives and copied.
    from sift_scale_space_extrema_detection_tpu_torch.ops.ransac import sample_minimal_sets

    idx = sample_minimal_sets(_S["ok"], 8, torch.Generator(device="cpu").manual_seed(3))
    assert idx.shape == (8, 8) and idx.device.type == "cpu"


# --- the SLAM entry points ----------------------------------------------------------


def _slam_inputs():
    """Three frames of twenty landmarks seen from a short dolly, and tiny
    images: enough for each SLAM entry point to start."""
    rng = np.random.default_rng(1)
    k = np.array([[100.0, 0, 50], [0, 100.0, 50], [0, 0, 1]])
    pts = rng.uniform([-1, -1, 3], [1, 1, 6], size=(20, 3))
    ts = np.array([[0.0, 0, 0], [-0.2, 0, 0], [-0.4, 0, 0]])
    cam = pts[None] + ts[:, None]
    pixels = cam[..., :2] / cam[..., 2:] * 100.0 + 50.0
    visible = np.ones((3, 20), bool)
    images = (rng.random((3, 24, 32)) * 255).astype(np.uint8)
    return k, pixels, visible, images


_K, _PIX, _VIS, _IMGS = _slam_inputs()
_RESULT = port.SlamResult(np.eye(3)[None].repeat(3, 0), -np.eye(3)[:, :3] * 0.1, np.zeros((1, 3)),
                          np.ones(1, bool), 0)
SLAM_ENTRY_POINTS = {
    "run_slam": lambda **kw: port.run_slam(_PIX, _VIS, _K, **kw),
    "build_tracks_from_images": lambda **kw: port.build_tracks_from_images(
        _IMGS, _CFG, k_mat=_K, **kw
    ),
    "run_slam_from_images": lambda **kw: port.run_slam_from_images(_IMGS, _K, _CFG, **kw),
    "SlamSession": lambda **kw: port.SlamSession(_K, _CFG, **kw),
    "evaluate_ate": lambda **kw: port.evaluate_ate(_RESULT, _RESULT.rotations, _RESULT.translations,
                                                   **kw),
    "measure_loop_edge": lambda **kw: port.models.slam.measure_loop_edge(
        _PIX, _VIS, _K, _RESULT.rotations, _RESULT.translations, 0, 2, port.SlamConfig(), **kw
    ),
}


@pytest.mark.parametrize("name", sorted(SLAM_ENTRY_POINTS))
def test_slam_entry_point_runs_on_the_card_unless_asked_for_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SLAM_ENTRY_POINTS[name]()
    SLAM_ENTRY_POINTS[name](device="cpu")


# --- the user surfaces: cli.py and evaluate.py -------------------------------------


def _surface_inputs(root):
    """A 24x32 PNG and a three-frame TUM sequence of it under ``root``:
    ``(cli argv, evaluate argv)``, each to be completed by a device flag."""
    from sift_scale_space_extrema_detection_tpu_torch.core.image import write_png
    from sift_scale_space_extrema_detection_tpu_torch.data import write_tum_sequence

    image = str(root / "in.png")
    write_png(image, _IMGS[0])
    seq = str(root / "seq")
    write_tum_sequence(seq, _IMGS / 255.0, np.arange(3) / 30.0, np.eye(3)[None].repeat(3, 0),
                       np.array([[0.0, 0, 0], [0.2, 0, 0], [0.4, 0, 0]]))
    return ([image, "-o", str(root / "out"), "--octaves", "2", "--no-galleries"],
            [seq, "--octaves", "2"])


@pytest.mark.parametrize("surface", ["cli", "evaluate"])
def test_surface_runs_on_the_card_unless_asked_for_the_cpu(surface, monkeypatch, tmp_path):
    from sift_scale_space_extrema_detection_tpu_torch import cli, evaluate

    main = {"cli": cli.main, "evaluate": evaluate.main}[surface]
    argv = _surface_inputs(tmp_path)[surface == "evaluate"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(SystemExit, match="no CUDA device.*--device cpu"):
            main(argv + device)
    assert main(argv + ["--device", "cpu"]) == 0


def test_surfaces_run_without_importing_jax(tmp_path):
    cli_argv, eval_argv = _surface_inputs(tmp_path)
    code = textwrap.dedent(
        f"""
        import sys
        import torch
        torch.set_num_threads(1)
        from sift_scale_space_extrema_detection_tpu_torch import cli, evaluate
        assert cli.main({cli_argv!r} + ["--device", "cpu", "--descriptors"]) == 0
        assert evaluate.main({eval_argv!r} + ["--device", "cpu"]) == 0
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "PIL"))
        assert not leaked, leaked
        assert "sift_scale_space_extrema_detection_tpu" not in sys.modules
        print("ok")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "ok"
