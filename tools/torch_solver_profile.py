#!/usr/bin/env python3
"""Where the time of the port's solvers goes on one NVIDIA GPU.

Run from the repository root: ``python3 tools/torch_solver_profile.py``.
Each solver entry point of the PyTorch port runs once under
``torch.profiler`` at the sizes of ``chip_smoke.py`` phases 13-14 (whose
problem builders it imports): the host-clock time of the call, the summed
device time of its kernels, the share of the call during which the device
was busy, the number of kernels launched, and the five ops with the most
device time. The profiler adds host time to every op, so the busy share is
a lower bound of the share without it; the host-clock time of a call
without the profiler is printed beside it.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def _profiled(torch, name: str, fn, smi: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    device_ms = sum(e.device_time for e in kernels) / 1e3
    by_op = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True)
    top = ", ".join(
        f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}" for e in by_op[:5]
    )
    print(
        f"{name}: {plain_ms:.2f} ms per call; under the profiler {wall_ms:.2f} ms, device "
        f"busy {device_ms:.2f} ms ({100 * device_ms / wall_ms:.1f} % of the call), "
        f"{len(kernels)} kernels; most device time: {top} [{smi}]",
        flush=True,
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_solver_profile: no CUDA device")
    import sift_scale_space_extrema_detection_tpu_torch as port
    from sift_scale_space_extrema_detection_tpu_torch.benchmarks.ba_bench import make_problem
    from sift_scale_space_extrema_detection_tpu_torch.sfm.ba import bundle_adjust
    from sift_scale_space_extrema_detection_tpu_torch.sfm.pnp import solve_pnp
    from sift_scale_space_extrema_detection_tpu_torch.sfm.pose_graph import (
        PoseGraphEdges,
        optimize_pose_graph,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rng = np.random.default_rng(0)

    n = 1800
    desc = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(2, n, 128))).float(), dim=-1).cuda()
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    _profiled(torch, f"match_descriptors {n}x{n}",
              lambda: port.match_descriptors(desc[0], valid, desc[1], valid), smi)

    # Correspondences of a known pose with a third of outliers.
    pts = torch.from_numpy(rng.uniform([-2, -2, 4], [2, 2, 9], size=(n, 3))).float().cuda()
    rot = torch.from_numpy(chip_smoke._rodrigues([0.02, -0.08, 0.01])).float().cuda()
    t = torch.tensor([-0.8, 0.05, 0.1], device="cuda")
    xc = pts @ rot.T + t
    rays1, rays2 = pts / pts[:, 2:3], xc / xc[:, 2:3]
    rays2[::3] = rays2[::3].roll(1, dims=0)
    generator = torch.Generator().manual_seed(0)
    _profiled(torch, f"estimate_essential_ransac, 512 hypotheses over {n} slots",
              lambda: port.estimate_essential_ransac(rays1, rays2, valid, generator,
                                                     inlier_threshold=2.0 / 520.0), smi)

    k_mat = torch.tensor([[520.0, 0, 320], [0, 520.0, 240], [0, 0, 1]], device="cuda")
    uv = port.sfm.geometry.project(xc, k_mat)
    _profiled(torch, f"solve_pnp on {n} points",
              lambda: solve_pnp(pts, uv, valid, k_mat, torch.eye(3, device="cuda"),
                                torch.zeros(3, device="cuda")), smi)

    nodes = chip_smoke.POSE_GRAPH_NODES
    est_r, est_t, src, dst, rel_r, rel_t = chip_smoke._circle_graph(np.random.default_rng(5), nodes)
    edges = PoseGraphEdges(
        torch.from_numpy(src).int().cuda(), torch.from_numpy(dst).int().cuda(),
        torch.from_numpy(rel_r).float().cuda(), torch.from_numpy(rel_t).float().cuda(),
        torch.ones(len(src), device="cuda"),
    )
    rots, ts = torch.from_numpy(est_r).float().cuda(), torch.from_numpy(est_t).float().cuda()
    _profiled(torch, f"optimize_pose_graph, {nodes} nodes, 5 iterations",
              lambda: optimize_pose_graph(rots, ts, edges, 5), smi)

    for solver, assembly, (c, l, opc) in (
        ("dense", "sorted", (50, 4096, 512)),
        ("dense", "scatter", (50, 4096, 512)),
        ("cg", "sorted", (1000, 100_000, 300)),
    ):
        state, obs = make_problem(np.random.default_rng(0), c, l, opc, device="cuda")
        _profiled(
            torch,
            f"bundle_adjust {solver}/{assembly}, {c} x {l} x {c * opc}, 3 LM iterations",
            lambda: bundle_adjust(state, obs, num_iterations=3, solver=solver, assembly=assembly),
            smi,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
