#!/usr/bin/env python3
"""How fast the port's own readers restore an orbax SLAM state of a real
size: phase 15's 40 × 480×640 gated sequence (``chip_smoke.slam_bench_recipe``
with a 30 px match gate and room for 16,384 tracks), stopped after its last
frame, so the checkpoint holds every observation of the run.

Three steps, run from the repository root:

    python3 tools/torch_orbax_speed.py state DIR       # on a GPU: the port writes DIR/state.{npz,json}
    python3 tools/torch_orbax_speed.py orbax DIR OUT   # needs jax and orbax: the JAX package's
                                                       # save_checkpoint rewrites it as OUT/state/
    python3 tools/torch_orbax_speed.py time OUT DIR    # the port restores OUT/state (orbax) and
                                                       # DIR/state (npz), 3 times each

``time`` checks that both restores give the same arrays and prints, for
each, the bytes on disk, the bytes decoded, the median restore time and
the rates, after the card's name and power limit (the decoding runs on the
host's CPU). The card's machine has no orbax, so the ``orbax`` step runs
where the JAX package is installed, between the other two.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _state(directory: str) -> int:
    import torch

    import chip_smoke
    import sift_scale_space_extrema_detection_tpu_torch as port

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    recipe = chip_smoke.slam_bench_recipe(port)
    frames = recipe["images"].shape[0]
    port.run_slam_from_images(
        recipe["images"], recipe["k_mat"], recipe["sift_cfg"], recipe["slam_cfg"],
        reassoc_window=recipe["reassoc_window"], frontend_chunk=chip_smoke.SLAM_CHUNK,
        checkpoint_dir=directory, _stop_after=frames - 1, device=torch.device("cuda", 0),
        **recipe["solved"],
    )
    size = sum(os.path.getsize(os.path.join(directory, n)) for n in os.listdir(directory))
    print(f"{directory}: {size} bytes after frame {frames - 1}")
    return 0


def _orbax(directory: str, out: str) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from sift_scale_space_extrema_detection_tpu.utils import checkpoint as jax_checkpoint
    from sift_scale_space_extrema_detection_tpu_torch.utils import checkpoint

    if jax_checkpoint._orbax() is None:
        print("orbax is not installed", file=sys.stderr)
        return 1
    state = checkpoint.restore_checkpoint_flat(os.path.join(directory, "state"))
    print(jax_checkpoint.save_checkpoint(out, state))
    return 0


def _time(*directories: str) -> int:
    from sift_scale_space_extrema_detection_tpu_torch.utils import checkpoint

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError):
        smi = "no nvidia-smi: not a GPU machine"
    print(smi, flush=True)
    restored = []
    for directory in directories:
        path = os.path.join(directory, "state")
        files = ([os.path.join(d, n) for d, _, ns in os.walk(path) for n in ns]
                 if os.path.isdir(path) else [path + ".npz", path + ".json"])
        on_disk = sum(os.path.getsize(f) for f in files)
        seconds = []
        for _ in range(3):
            t0 = time.perf_counter()
            state = checkpoint.restore_checkpoint_flat(path)
            seconds.append(time.perf_counter() - t0)
        decoded = sum(v.nbytes for v in state.values())
        median = float(np.median(seconds))
        kind = "orbax" if os.path.isdir(path) else "npz"
        print(f"{kind} {path}: {len(state)} arrays, {on_disk} bytes on disk, {decoded} bytes "
              f"decoded, restore {1e3 * median:.1f} ms (median of "
              f"{', '.join(f'{1e3 * t:.1f}' for t in seconds)}), {on_disk / median / 1e6:.2f} "
              f"MB/s read, {decoded / median / 1e6:.2f} MB/s decoded", flush=True)
        restored.append(state)
    first = restored[0]
    same = all(sorted(s) == sorted(first) and all(
        s[k].dtype == first[k].dtype and s[k].tobytes() == first[k].tobytes() for k in first)
        for s in restored[1:])
    print(f"the same arrays from every directory: {same}")
    return 0 if same else 1


def main() -> int:
    commands = {"state": (_state, 1), "orbax": (_orbax, 2), "time": (_time, None)}
    if len(sys.argv) < 2 or sys.argv[1] not in commands:
        print(__doc__, file=sys.stderr)
        return 2
    fn, nargs = commands[sys.argv[1]]
    args = sys.argv[2:]
    if (nargs is not None and len(args) != nargs) or not args:
        print(__doc__, file=sys.stderr)
        return 2
    return fn(*args)


if __name__ == "__main__":
    sys.exit(main())
