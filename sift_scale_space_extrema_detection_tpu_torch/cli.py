"""Command-line interface: one image → keypoints, descriptors and galleries.

The port of the JAX package's ``cli.py``, with its flags and outputs: the
Gaussian/DoG galleries, candidate markers, refined-keypoint overlay and a
keypoints JSON in the reference's record schema, plus the pipeline's time
and the reference's accept/reject counters (mirroring the console.log
taxonomy, background.js:581-672). It runs on the card unless
``--device cpu`` is given; without a card it exits with a message and never
carries on on the CPU by itself.

``--blur`` names the scale-space path: ``fused`` (the default, the main
path: one octave kernel launch per octave, the Gaussian stacks kept),
``cuda`` or ``pallas`` (the stand-alone blur kernel, one launch per blurred
scale; ``pallas`` is the JAX package's name for it), ``separable`` (the
plain tap loop), ``matmul`` (banded matrix products, TF32 refused) and
``exact`` (the reference's 2-D accumulation order). Detection is
``detect_from_dog``, so ``SiftConfig``'s pooled-refinement flags act here as
in the JAX package's CLI. ``--float64`` is the CPU in float64, for
``exact``, ``separable`` or ``matmul``; the kernels are float32 only, so
with ``fused``, ``cuda`` or ``pallas`` it exits with a message.

Usage:
    python -m sift_scale_space_extrema_detection_tpu_torch.cli IMAGE [-o OUTDIR]
        [--octaves N] [--scales N] [--float64] [--blur STRATEGY]
        [--descriptors] [--max-features N] [--no-galleries] [--device cuda|cpu]

``--max-features N`` describes the image as a photo-collection extractor
does: its N strongest (keypoint, orientation) pairs by ``|value|``, ties at
the N-th kept, in one compacting describe pass
(``ops/descriptor.py::describe_compact``); it implies ``--descriptors``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

KERNEL_BLURS = ("fused", "cuda", "pallas")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sift-torch",
        description="SIFT scale-space extrema detection on an NVIDIA GPU (PyTorch/CUDA)",
    )
    p.add_argument("image", help="input image (PNG, PGM/PPM or BMP; others through PIL)")
    p.add_argument("-o", "--outdir", default="sift_out", help="output directory")
    p.add_argument("--octaves", type=int, default=5)
    p.add_argument("--scales", type=int, default=3, help="scales per octave")
    p.add_argument(
        "--blur",
        default="fused",
        choices=["fused", "cuda", "pallas", "separable", "matmul", "exact"],
        help="fused is the whole-octave CUDA kernel (the main path); cuda and "
        "pallas the stand-alone blur kernel; separable, matmul and exact are "
        "plain PyTorch",
    )
    p.add_argument(
        "--float64",
        action="store_true",
        help="CPU float64 (reference bit-parity mode; exact, separable or matmul)",
    )
    p.add_argument(
        "--descriptors",
        action="store_true",
        help="also compute orientations + 128-D descriptors",
    )
    p.add_argument(
        "--max-features",
        type=int,
        default=None,
        metavar="N",
        help="describe only the N strongest (keypoint, orientation) pairs, "
        "ranked by |value| with ties at the N-th kept (implies --descriptors)",
    )
    p.add_argument(
        "--no-galleries",
        action="store_true",
        help="skip PNG gallery dumps (keypoints JSON only)",
    )
    p.add_argument("--capacity", type=int, default=1024, help="max keypoints per trio")
    p.add_argument(
        "--quality",
        action="store_true",
        help="SiftConfig.quality() detection preset: standard-SIFT "
        "sigma0 1.6 + OpenCV-equivalent thresholds (~3x keypoint "
        "density; a documented divergence from reference parity)",
    )
    p.add_argument(
        "--verbose",
        action="store_true",
        help="log every candidate's accept/reject decision "
        "(mirrors the reference's console.log, background.js:581-672)",
    )
    p.add_argument(
        "--device",
        default=None,
        choices=["cuda", "cpu"],
        help="where the pipeline runs (default: cuda; cpu with --float64)",
    )
    return p


def _resolve(args) -> str:
    """The device the run uses, or ``SystemExit`` with a message."""
    import torch

    if args.float64:
        if args.blur in KERNEL_BLURS:
            raise SystemExit(
                f"--float64 runs on the CPU in float64, and the --blur {args.blur} "
                "kernels are float32 only: use --blur exact, separable or matmul"
            )
        if args.device == "cuda":
            raise SystemExit("--float64 runs on the CPU: drop --device cuda")
        return "cpu"
    device = args.device or "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device: this command runs on the card; pass --device cpu "
            "for the plain PyTorch versions on the CPU"
        )
    return device


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = _resolve(args)

    import torch

    from . import SiftConfig
    from .core.image import load_image_gray
    from .core.types import REJECT_REASON_NAMES, split_keypoints
    from .models import frontend
    from .utils import visualize as vis

    dtype = np.float64 if args.float64 else np.float32
    gray = load_image_gray(args.image, dtype=dtype)
    print(f"loaded {args.image}: {gray.shape[1]}x{gray.shape[0]}")

    cfg_kw = dict(
        num_octaves=args.octaves,
        scales_per_octave=args.scales,
        max_keypoints_per_trio=args.capacity,
    )
    cfg = SiftConfig.quality(**cfg_kw) if args.quality else SiftConfig(**cfg_kw)
    os.makedirs(args.outdir, exist_ok=True)
    image = torch.from_numpy(gray)[None].to(device)  # a batch of one

    t0 = time.perf_counter()
    if args.blur == "fused":
        dog, masks, scale_space = frontend.build_pyramid_fused(
            image, cfg, emit_scales=True, device=device
        )
    else:
        scale_space = frontend.build_scale_space(image, cfg, args.blur, device=device)
        dog = frontend.build_dog(scale_space)
        masks = None
    keypoints, extrema = frontend.detect_from_dog(dog, cfg, masks)
    described = None
    if args.max_features is not None:
        # One compacting pass over the keypoints detection refined, sliced at
        # each octave's refinement capacity, keeping the strongest pairs. The
        # describe stages are float32, as in the batched entry.
        from .ops.descriptor import describe_compact

        per_octave = split_keypoints(
            keypoints, [cfg.refine_capacity(o) for o in range(len(dog))]
        )
        stacks = scale_space
        if args.float64:
            stacks = [s.to(torch.float32) for s in scale_space]
            per_octave = [frontend._float32(kp) for kp in per_octave]
        described = describe_compact(stacks, per_octave, cfg, max_features=args.max_features)
    elif args.descriptors:
        # Octave by octave on the keypoints detection refined, sliced at
        # each octave's refinement capacity: two window-sampling launches
        # per octave.
        from .ops.descriptor import concat_described, describe_octave

        per_octave = split_keypoints(
            keypoints, [cfg.refine_capacity(o) for o in range(len(dog))]
        )
        described = concat_described(
            [
                describe_octave(stack, kp, octave, cfg)
                for octave, (stack, kp) in enumerate(zip(scale_space, per_octave))
            ]
        )
    # The headline time includes the descriptors: the card runs behind the
    # host until it is synchronised.
    if image.is_cuda:
        torch.cuda.synchronize(image.device)
    n_valid = int(keypoints.valid.sum())
    t1 = time.perf_counter()
    print(f"pipeline: {1e3 * (t1 - t0):.1f} ms ({device}), {n_valid} keypoints")

    # Rejection taxonomy (reference console.log categories, SURVEY §5.5).
    counts = keypoints.reject_counts()[0].tolist()
    for name, c in zip(REJECT_REASON_NAMES, counts):
        print(f"  {name}: {int(c)}")

    host = {k: v[0].cpu().numpy() for k, v in vars(keypoints).items()}
    if args.verbose:
        # Per-candidate decision log (reference/background.js:581, :602,
        # :615, :648-663, :672). Keypoint slots per octave are aligned
        # with the refine input = compact_extrema(e, refine_capacity),
        # so each slot's initial candidate identity comes from there.
        from .ops.extrema import compact_extrema

        offset = 0
        for octave, e in enumerate(extrema):
            cap = cfg.refine_capacity(octave)
            sel = compact_extrema(e, cap)
            sy, sx, ss, sv = (getattr(sel, k)[0].cpu().numpy()
                              for k in ("y", "x", "scale_level", "valid"))
            for i in range(cap):
                if not sv[i]:
                    continue
                slot = offset + i
                reason = REJECT_REASON_NAMES[int(host["reject_reason"][slot])]
                line = (
                    f"  octave {octave} scale {int(ss[i])} "
                    f"(x={int(sx[i])}, y={int(sy[i])}): {reason}"
                )
                if host["valid"][slot]:
                    line += (
                        f" -> abs=({float(host['abs_x'][slot]):.2f}, "
                        f"{float(host['abs_y'][slot]):.2f}) "
                        f"sigma={float(host['abs_sigma'][slot]):.3f}"
                    )
                print(line)
            offset += cap

    # Keypoints JSON with the reference record schema
    # (reference/background.js:619-628).
    valid = host["valid"]
    records = [
        {
            "octave": int(o),
            "scaleLevel": int(s),
            "localX": int(lx),
            "localY": int(ly),
            "absoluteSigma": float(sg),
            "absoluteX": float(ax),
            "absoluteY": float(ay),
            "interpolatedValue": float(v),
        }
        for o, s, lx, ly, sg, ax, ay, v in zip(
            *(host[k][valid] for k in ("octave", "scale_level", "local_x", "local_y",
                                       "abs_sigma", "abs_x", "abs_y", "value"))
        )
    ]
    with open(os.path.join(args.outdir, "keypoints.json"), "w") as f:
        json.dump({"keypoints": records, "rejectionCounts": {
            name: int(c) for name, c in zip(REJECT_REASON_NAMES, counts)
        }}, f, indent=1)

    if described is not None:
        d = {k: v[0].cpu().numpy() for k, v in vars(described).items()}
        dv = d["valid"]
        np.savez(
            os.path.join(args.outdir, "descriptors.npz"),
            **{k: d[k][dv] for k in ("descriptor", "theta", "abs_x", "abs_y", "abs_sigma")},
        )
        print(f"descriptors: {int(dv.sum())} → descriptors.npz")

    if not args.no_galleries:
        for o, stack in enumerate(scale_space):
            vis.save_png(
                os.path.join(args.outdir, f"gaussian_octave{o}.png"),
                vis.gallery_image(stack[0]),
            )
        for o, d in enumerate(dog):
            vis.save_png(
                os.path.join(args.outdir, f"dog_octave{o}.png"),
                # float32 first, as the JAX package displays its DoG.
                vis.gallery_image(d[0].float(), normalize="sigmoid"),
            )
        # Candidate-marker galleries: yellow = candidates, translucent
        # red = low-contrast pre-filter rejects, painted onto each
        # octave's base image like the reference's third gallery
        # (reference/main.js:315-319, background.js:408-421).
        from .ops.extrema import find_low_contrast_extrema

        for o, (stack, d) in enumerate(zip(scale_space, dog)):
            low = find_low_contrast_extrema(d, cfg, cfg.keypoints_per_trio(o))
            marks = []
            for e, is_low in ((extrema[o], False), (low, True)):
                ev = e.valid[0]
                ys, xs = torch.stack([e.y[0], e.x[0]])[:, ev].cpu().numpy()
                marks.extend((int(y), int(x), is_low) for y, x in zip(ys, xs))
            vis.save_png(
                os.path.join(args.outdir, f"candidates_octave{o}.png"),
                vis.draw_candidate_markers(stack[0, 0], marks),
            )
        first = type(keypoints)(**{k: v[0] for k, v in vars(keypoints).items()})
        overlay = vis.draw_keypoints(np.asarray(gray, np.float64), first)
        vis.save_png(os.path.join(args.outdir, "keypoints.png"), overlay)
        print(f"galleries + candidate markers + overlay → {args.outdir}/")

    return 0


if __name__ == "__main__":
    raise SystemExit(main())
