#!/usr/bin/env python3
"""The port on the card against the JAX package at full size: 16 × 480×640.

The north star's bars (``TPU_PARITY_r05.json``, ``benchmarks/tpu_parity.py``)
held between the port's frontend on the card and the JAX package's on the
CPU, on ``tpu_parity.py``'s own frames (``textured_batch(16, 480, 640)``,
pinned here) at the default ``SiftConfig`` (5 octaves × 3 scales). Two
steps, so that the JAX package need not run where the card is:

1. ``--card`` (on the card): ``detect_and_describe_batched(images, cfg,
   blur=B)`` for B = ``fused`` (K1, the port's default) and ``cuda`` (K3,
   blur by blur); the fields ``tpu_parity.py`` compares (``valid``,
   ``octave``, ``scale_level``, ``abs_x``, ``abs_y``, ``descriptor``) of
   each, with the card's ``nvidia-smi`` name and power limit, go to
   ``--npz`` (default ``build/gpu_parity.npz``; git ignores ``build/``).
   ``--device cpu`` runs the plain versions instead (a rehearsal, not the
   card's result).
2. ``--compare`` (where the JAX package runs): the JAX package's
   ``detect_and_describe_batched_jit(images, cfg, "separable")`` on the CPU
   in float32, ``--chunk`` frames a call (frames are independent), against
   each blur of the npz at ``tpu_parity.py``'s bars: slot agreement (valid
   mask, octave and scale equal) >= 0.999, p99 position delta over the
   slots valid in both < 0.1 px, descriptor min cosine there > 0.999. The
   result goes to ``--out`` (default ``GPU_PARITY_r01.json``); the command
   exits 1 where a bar is missed.

Run: ``python3 tools/torch_gpu_parity.py --card`` on the card, then
``python3 tools/torch_gpu_parity.py --compare`` where the JAX package is
installed, with the npz beside it (about 2 minutes and 1.6 GiB of the CPU
at 4 frames a call).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BLURS = ("fused", "cuda")
FIELDS = ("valid", "octave", "scale_level", "abs_x", "abs_y", "descriptor")
THRESH_AGREEMENT = 0.999  # benchmarks/tpu_parity.py
THRESH_P99_PX = 0.1
THRESH_MIN_COS = 0.999
SHAPE = (16, 480, 640)


def textured_batch(b, h, w, seed=0):
    """``benchmarks/tpu_parity.py::textured_batch``, pinned by
    ``tests/test_torch_gpu_parity.py``: a smooth pattern plus 120 random
    Gaussian blobs a frame, clipped to [0, 1], float32."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = []
    for k in range(b):
        r = np.random.default_rng(seed * 1000 + k)
        img = 0.5 + 0.1 * np.sin(xx / 6.0 + k) * np.cos(yy / 8.0)
        for _ in range(120):
            cy, cx = r.uniform(8, h - 8), r.uniform(8, w - 8)
            s = r.uniform(1.5, 6.0)
            img += r.uniform(-0.35, 0.35) * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s)
            )
        imgs.append(np.clip(img, 0.0, 1.0))
    return np.stack(imgs)


def parity(got: dict, want: dict) -> dict:
    """``tpu_parity.py``'s comparison of two runs' fields (``got`` the port,
    ``want`` the reference), unrounded."""
    slot_eq = (got["valid"] == want["valid"]) & (
        ~got["valid"]
        | ((got["octave"] == want["octave"]) & (got["scale_level"] == want["scale_level"]))
    )
    agreement = float(slot_eq.mean())
    both = got["valid"] & want["valid"]
    d = np.hypot(got["abs_x"][both] - want["abs_x"][both], got["abs_y"][both] - want["abs_y"][both])
    p99 = float(np.percentile(d, 99)) if d.size else float("nan")
    dg, dw = got["descriptor"][both], want["descriptor"][both]
    cos = np.sum(dg * dw, -1) / np.maximum(
        np.linalg.norm(dg, axis=-1) * np.linalg.norm(dw, axis=-1), 1e-9
    )
    min_cos = float(cos.min()) if cos.size else float("nan")
    return {
        "valid_port": int(got["valid"].sum()),
        "valid_jax": int(want["valid"].sum()),
        "slot_agreement": agreement,
        "p99_position_px": p99,
        "mean_position_px": float(d.mean()) if d.size else None,
        "descriptor_min_cos": min_cos,
        "pass": bool(agreement >= THRESH_AGREEMENT and p99 < THRESH_P99_PX
                     and min_cos > THRESH_MIN_COS),
    }


def run_card(images: np.ndarray, device: str) -> dict:
    """The port's fields for each blur on ``device``, as numpy arrays keyed
    ``<blur>/<field>``, with the seconds of each run."""
    import torch

    import sift_scale_space_extrema_detection_tpu_torch as port

    cfg = port.SiftConfig()
    dev = torch.device(device)
    x = torch.from_numpy(images.astype(np.float32)).to(dev)
    out = {}
    for blur in BLURS:
        port.detect_and_describe_batched(x[:1], cfg, blur=blur, device=dev)  # warm-up
        t0 = time.perf_counter()
        res = port.detect_and_describe_batched(x, cfg, blur=blur, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out[f"{blur}/seconds"] = np.float64(time.perf_counter() - t0)
        for f in FIELDS:
            out[f"{blur}/{f}"] = getattr(res, f).cpu().numpy()
    return out


def run_reference(images: np.ndarray, chunk: int) -> dict:
    """The JAX package's fields on the CPU in float32, ``chunk`` frames a call."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from sift_scale_space_extrema_detection_tpu import SiftConfig
    from sift_scale_space_extrema_detection_tpu.models.frontend import (
        detect_and_describe_batched_jit,
    )

    cfg = SiftConfig()
    parts = []
    for i in range(0, len(images), chunk):
        res = detect_and_describe_batched_jit(
            jnp.asarray(images[i : i + chunk].astype(np.float32)), cfg, "separable"
        )
        parts.append({f: np.asarray(getattr(res, f)) for f in FIELDS})
    return {f: np.concatenate([p[f] for p in parts]) for f in FIELDS}


def compare(card: dict, want: dict, images_shape) -> dict:
    """The artifact: each blur's comparison, the thresholds and the card."""
    result = {
        "images": list(images_shape),
        "config": "SiftConfig() (5 octaves x 3 scales), both packages",
        "reference": "JAX package, detect_and_describe_batched_jit(..., 'separable'), CPU, float32",
        "port": "detect_and_describe_batched(..., blur=B) on the card",
        "card": str(card["smi"]),
        "torch": str(card["torch"]),
        "thresholds": {
            "slot_agreement": THRESH_AGREEMENT,
            "p99_position_px": THRESH_P99_PX,
            "descriptor_min_cos": THRESH_MIN_COS,
        },
    }
    for blur in BLURS:
        got = {f: card[f"{blur}/{f}"] for f in FIELDS}
        result[blur] = parity(got, want) | {"card_seconds": float(card[f"{blur}/seconds"])}
    result["pass"] = all(result[b]["pass"] for b in BLURS)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    step = ap.add_mutually_exclusive_group(required=True)
    step.add_argument("--card", action="store_true", help="step 1: the port on the card")
    step.add_argument("--compare", action="store_true", help="step 2: against the JAX package")
    ap.add_argument("--npz", default=os.path.join(REPO, "build", "gpu_parity.npz"))
    ap.add_argument("--out", default=os.path.join(REPO, "GPU_PARITY_r01.json"))
    ap.add_argument("--device", default="cuda", help="step 1's device: cuda, or cpu to rehearse")
    ap.add_argument("--chunk", type=int, default=4, help="step 2's frames a JAX call")
    ap.add_argument("--shape", type=int, nargs=3, default=SHAPE, metavar=("B", "H", "W"))
    args = ap.parse_args(argv)
    images = textured_batch(*args.shape)
    if args.card:
        import torch

        from sift_scale_space_extrema_detection_tpu_torch.benchmarks import card_smi, probe_device

        dev = probe_device(args.device)
        out = run_card(images, str(dev))
        out["smi"] = np.array(card_smi() if dev.type == "cuda" else "cpu (plain versions)")
        out["torch"] = np.array(f"{torch.__version__}, CUDA {torch.version.cuda}")
        out["shape"] = np.array(images.shape)
        os.makedirs(os.path.dirname(os.path.abspath(args.npz)), exist_ok=True)
        np.savez_compressed(args.npz, **out)
        print(json.dumps({b: int(out[f"{b}/valid"].sum()) for b in BLURS} | {"npz": args.npz}))
        return 0
    with np.load(args.npz) as npz:
        card = dict(npz)
    if tuple(card["shape"]) != images.shape:
        raise SystemExit(f"{args.npz} holds {tuple(card['shape'])} frames, not {images.shape}")
    result = compare(card, run_reference(images, args.chunk), images.shape)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(json.dumps(result))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
