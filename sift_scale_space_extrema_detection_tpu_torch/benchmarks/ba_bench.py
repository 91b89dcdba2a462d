"""LM iterations/s of the port's Schur bundle adjustment on one card.

The port of the JAX package's ``benchmarks/ba_bench.py``: a synthetic
multi-view problem at SLAM scale (:func:`make_problem`: a ring of cameras
around a point cloud, 0.5 px of pixel noise, the points started 0.05 off),
``bundle_adjust`` for ``--iters`` LM iterations, with a FLOP model counted
from the problem's shapes reported against the measured time, and with
``--breakdown`` (dense) the normal-equation assembly and the reduced solve
timed apart. ``--large`` is 1,000 cameras × 100,000 landmarks × 300
observations a camera with the matrix-free CG solver.

Timing on the card: two warm-up solves, then one solve timed by the host
clock up to a ``torch.cuda.synchronize()``; the breakdown's stages are the
mean of 10 synchronised calls each. Nothing is subtracted (there is no
dispatch tunnel to discount).

Run: ``python -m sift_scale_space_extrema_detection_tpu_torch.benchmarks.ba_bench
[--cams 50] [--pts 4096] [--obs-per-cam 512] [--iters 10] [--solver dense|cg]
[--cg-iters 32] [--large] [--breakdown] [--assembly sorted|scatter]
[--device cuda|cpu]``. Prints the original's lines, then one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..sfm import geometry as geo
from ..sfm.ba import BAState, Observations, bundle_adjust, shard_schur_pieces, solve_reduced
from . import device_entry, host_ms, launch_counts, path_launches, peak_gib, probe_device

LARGE = (1000, 100_000, 300)
BREAKDOWN_REPS = 10


def problem_arrays(rng, c: int, l: int, opc: int, dtype=np.float32) -> dict:
    """The numbers of :func:`make_problem` as numpy arrays (``rotations``,
    ``translations``, ``points``, ``k_mat``, ``camera``, ``landmark``,
    ``uv``): the original's recipe, each rotation from ``so3_exp`` in
    float32 as the original takes it."""
    # Camera ring orbiting the cloud (bounded poses at any camera count);
    # observations keep only points in front, so every residual is well-posed.
    pts = rng.uniform([-4, -4, -4], [4, 4, 4], size=(l, 3)).astype(dtype)
    k_mat = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], dtype)
    radius = 12.0

    rots, ts, cams, lms, uvs = [], [], [], [], []
    for ci in range(c):
        ang = 2.0 * np.pi * ci / max(c, 1)
        r = geo.so3_exp(torch.tensor([0.0, ang, 0.0], dtype=torch.float32)).numpy().astype(dtype)
        center = radius * np.array([np.sin(ang), 0.1 * np.sin(3 * ang), -np.cos(ang)])
        t = (-r @ center).astype(dtype)
        depths = pts @ r.T[:, 2] + t[2]
        front = np.where(depths > 2.0)[0]
        sel = rng.choice(front, opc, replace=len(front) < opc)
        xc = pts[sel] @ r.T + t
        uv = xc[:, :2] / xc[:, 2:3] * 500.0 + [320, 240]
        uv += 0.5 * rng.normal(size=uv.shape)
        rots.append(r)
        ts.append(t)
        cams.append(np.full(opc, ci))
        lms.append(sel)
        uvs.append(uv)
    return dict(
        rotations=np.stack(rots).astype(dtype),
        translations=np.stack(ts).astype(dtype),
        points=(pts + 0.05 * rng.normal(size=pts.shape).astype(dtype)).astype(dtype),
        k_mat=k_mat,
        camera=np.concatenate(cams).astype(np.int32),
        landmark=np.concatenate(lms).astype(np.int32),
        uv=np.concatenate(uvs).astype(dtype),
    )


def to_tensors(p: dict, device="cpu") -> tuple[BAState, Observations]:
    """``(BAState, Observations)`` of :func:`problem_arrays` on ``device``,
    every observation valid."""
    t = {k: torch.from_numpy(v).to(device) for k, v in p.items()}
    state = BAState(t["rotations"], t["translations"], t["points"], t["k_mat"])
    obs = Observations(t["camera"], t["landmark"], t["uv"],
                       torch.ones(t["camera"].shape[0], dtype=torch.bool, device=device))
    return state, obs


def make_problem(rng, c: int, l: int, opc: int, dtype=np.float32, device="cpu"):
    """The original's problem: ``(BAState, Observations)`` of ``c`` cameras,
    ``l`` landmarks and ``opc`` observations a camera."""
    return to_tensors(problem_arrays(rng, c, l, opc, dtype), device)


def flop_model(solver: str, c: int, l: int, n_obs: int, cg_iters: int) -> int:
    """The original's FLOPs an LM iteration. Dense: the Schur products.
    CG: per CG step ~4 matrix-vector products over the observations and the
    (L, 3, 3) inverse apply, and the assembly (~54 FLOPs an observation)."""
    if solver == "dense":
        return 2 * c * l * 6 * 3 * 3 + 2 * c * c * l * 6 * 6 * 3
    per_cg = n_obs * 2 * (2 * 6 * 2 + 2 * 3 * 2) + l * 2 * 9
    return cg_iters * per_cg + n_obs * 2 * (36 + 18 + 12)


def run(cams: int = 50, pts: int = 4096, obs_per_cam: int = 512, iters: int = 10,
        solver: str = "dense", cg_iters: int = 32, large: bool = False, breakdown: bool = False,
        assembly: str = "sorted", device="cuda") -> dict:
    """The benchmark's JSON object; the original's lines are under ``lines``."""
    dev = probe_device(str(device))
    if large:
        cams, pts, obs_per_cam = LARGE
        solver = "cg"
    rng = np.random.default_rng(0)
    c, l, opc = cams, pts, obs_per_cam
    state, obs = make_problem(rng, c, l, opc, device=dev)
    n_obs = c * opc

    def solve():
        return bundle_adjust(state, obs, num_iterations=iters, solver=solver,
                             cg_iterations=cg_iters, assembly=assembly, device=dev)

    solve()
    (_, cost), peak = peak_gib(solve, dev)  # the second warm-up, and the peak
    final = float(cost)
    before = launch_counts()
    dt = host_ms(solve, dev, 1, warmup=0) / 1e3
    launches = path_launches(before)  # none: the back end runs no hand-written kernel
    flops_iter = flop_model(solver, c, l, n_obs, cg_iters)
    out = {
        "solver": solver,
        "assembly": assembly,
        "cams": c,
        "pts": l,
        "obs": n_obs,
        "iters": iters,
        "lm_iters_per_s": round(iters / dt, 3),
        "ms_per_iter": round(1e3 * dt / iters, 3),
        "final_cost": final,
        "gflop_per_iter": round(flops_iter / 1e9, 4),
        "tflop_s_achieved": round(flops_iter * iters / dt / 1e12, 5),
        "peak_gib": peak,
        "launches": launches,
    }
    lines = [
        f"BA[{solver}] {c} cams x {l} pts x {n_obs} obs: {iters / dt:.2f} LM iters/s "
        f"({1e3 * dt / iters:.1f} ms/iter, final cost {final:.1f})",
        f"FLOP model: {flops_iter / 1e9:.2f} GFLOP/iter -> "
        f"{flops_iter * iters / dt / 1e12:.3f} TFLOP/s achieved",
    ]

    if breakdown and solver == "dense":
        lam = torch.tensor(1e-4, dtype=state.points.dtype, device=dev)
        valid = obs.valid

        def assemble():
            return shard_schur_pieces(state.rotations, state.translations, state.k_mat,
                                      state.points, obs.camera, obs.landmark, obs.uv, valid,
                                      lam, c)

        t_asm = host_ms(assemble, dev, BREAKDOWN_REPS, warmup=1)
        pieces = assemble()
        t_slv = host_ms(lambda: solve_reduced(pieces.h_cc, pieces.b_c, pieces.s_off,
                                              pieces.rhs_off, lam, 1),
                        dev, BREAKDOWN_REPS, warmup=1)
        overhead = 1e3 * dt / iters - t_asm - t_slv
        out["breakdown"] = {"assembly_schur_ms": round(t_asm, 3),
                            "reduced_solve_ms": round(t_slv, 3),
                            "lm_overhead_ms": round(overhead, 3)}
        lines.append(f"breakdown: assembly+schur {t_asm:.2f} ms, reduced solve {t_slv:.2f} ms "
                     f"(LM overhead = {overhead:.2f} ms)")
    out["lines"] = lines
    out["device"] = device_entry(dev)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cams", type=int, default=50)
    ap.add_argument("--pts", type=int, default=4096)
    ap.add_argument("--obs-per-cam", type=int, default=512)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--solver", choices=["dense", "cg"], default="dense")
    ap.add_argument("--cg-iters", type=int, default=32)
    ap.add_argument("--large", action="store_true",
                    help="1000 cams x 100k landmarks x 300k obs with the CG solver")
    ap.add_argument("--breakdown", action="store_true", help="per-stage timing (dense)")
    ap.add_argument("--assembly", choices=["sorted", "scatter"], default="sorted",
                    help="dense-path landmark-side assembly (see sfm/ba.py)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    probe_device(args.device)
    out = run(cams=args.cams, pts=args.pts, obs_per_cam=args.obs_per_cam, iters=args.iters,
              solver=args.solver, cg_iters=args.cg_iters, large=args.large,
              breakdown=args.breakdown, assembly=args.assembly, device=args.device)
    for line in out["lines"]:
        print(line, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
