#!/usr/bin/env python3
"""Write ``tests/fixtures/jax_orbax/``: checkpoints that the JAX package
writes with orbax, each beside its npz + JSON twin, for the port's readers
(``sift_scale_space_extrema_detection_tpu_torch/utils/{zstd,ocdbt,checkpoint}.py``).

Run from the repository root: ``python3 tools/torch_make_orbax_fixture.py``
(about a minute on a CPU). It needs jax, orbax-checkpoint and tensorstore,
which the card's machine does not have; the port reads the result with none
of them.

What it writes, all from BASELINE config[3] (``orbit_sequence(
default_rng(2), 50, 400, noise_px=0.4, outlier_frac=0.02)``, ``SlamConfig()``,
the recipe of ``chip_smoke.py``'s phase 15 (g)) through the JAX package's
own ``run_slam`` on the CPU, float32 (``jax_enable_x64`` off):

- ``slam/state/``: the rolling checkpoint of a run stopped with
  ``_stop_after=STOP``, written by orbax, unpatched;
- ``slam_npz/state.{npz,json}``: the same stop with ``_orbax`` patched to
  ``None``, so the same state in the npz + JSON format;
- ``ba/state/`` and ``ba_npz/state.*``: the final ``BAState`` (``jax.Array``
  leaves) of the run resumed from ``slam/``, with orbax and with npz;
- ``fixture.json``: the recipe, ``STOP``, the versions of jax, orbax and
  tensorstore, both ATEs and landmark counts; beside it, ``jax_resumed_*.npy``
  and ``jax_full_*.npy``, the resumed and the uninterrupted trajectories.

No track is stored: the port's pinned ``utils/synthetic.py`` regenerates
them bit for bit from the seed.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
from importlib import metadata

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "fixtures", "jax_orbax")
RECIPE = {"seed": 2, "num_frames": 50, "num_landmarks": 400, "noise_px": 0.4,
          "outlier_frac": 0.02}
STOP = 20  # the frame the stopped run ends after, near the middle (the fixture stays under 512 KB)


def main() -> int:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from sift_scale_space_extrema_detection_tpu.models import slam
    from sift_scale_space_extrema_detection_tpu.sfm.ba import BAState
    from sift_scale_space_extrema_detection_tpu.utils import checkpoint, synthetic

    if checkpoint._orbax() is None:
        print("orbax is not installed: nothing to write", file=sys.stderr)
        return 1
    seq = synthetic.orbit_sequence(
        np.random.default_rng(RECIPE["seed"]), num_frames=RECIPE["num_frames"],
        num_landmarks=RECIPE["num_landmarks"], noise_px=RECIPE["noise_px"],
        outlier_frac=RECIPE["outlier_frac"],
    )
    cfg = slam.SlamConfig()

    def run(**kw):
        return slam.run_slam(seq.pixels, seq.visible, seq.k_mat, cfg, **kw)

    def ate(result):
        return slam.evaluate_ate(result, seq.rotations, seq.translations)

    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    run(checkpoint_dir=os.path.join(OUT, "slam"), _stop_after=STOP)
    real_orbax = checkpoint._orbax
    checkpoint._orbax = lambda: None
    try:
        run(checkpoint_dir=os.path.join(OUT, "slam_npz"), _stop_after=STOP)
    finally:
        checkpoint._orbax = real_orbax
    with tempfile.TemporaryDirectory() as tmp:
        work = os.path.join(tmp, "slam")
        shutil.copytree(os.path.join(OUT, "slam"), work)
        resumed = run(checkpoint_dir=work, resume=True)
    full = run()

    ba = BAState(
        rotations=jnp.asarray(resumed.rotations),
        translations=jnp.asarray(resumed.translations),
        points=jnp.asarray(resumed.points),
        k_mat=jnp.asarray(seq.k_mat),
    )
    checkpoint.save_checkpoint(os.path.join(OUT, "ba"), ba)
    checkpoint._orbax = lambda: None
    try:
        checkpoint.save_checkpoint(os.path.join(OUT, "ba_npz"), ba)
    finally:
        checkpoint._orbax = real_orbax

    for name, result in (("resumed", resumed), ("full", full)):
        np.save(os.path.join(OUT, f"jax_{name}_rotations.npy"), result.rotations)
        np.save(os.path.join(OUT, f"jax_{name}_translations.npy"), result.translations)
    record = {
        "recipe": {**RECIPE, "slam_config": "SlamConfig()", "jax_enable_x64": False},
        "stop_after": STOP,
        "versions": {p: metadata.version(p) for p in ("jax", "orbax-checkpoint", "tensorstore")},
        "jax_resumed_ate": ate(resumed),
        "jax_full_ate": ate(full),
        "jax_resumed_landmarks": int(np.asarray(resumed.landmark_valid).sum()),
        "jax_full_landmarks": int(np.asarray(full.landmark_valid).sum()),
    }
    with open(os.path.join(OUT, "fixture.json"), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(OUT) for n in ns)
    print(json.dumps(record))
    print(f"{OUT}: {size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
