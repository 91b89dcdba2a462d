"""Tiny copies of the benchmark's cells for the CPU tests: the same files,
with frames, octaves, capacities and batches cut so that a whole run takes
seconds on the CPU."""

from __future__ import annotations

import copy

from port_bench import spec

CELLS = ("tum-vga.describe-b64", "kitti-odom.describe-b64")


def tiny_cell(workload: str, width: int = 96, height: int = 64, batch: int = 2) -> dict:
    cell = copy.deepcopy(spec.cell(spec.load_benchmark(), workload))
    config, traffic = cell["config"], cell["traffic"]
    config.update(width=width, height=height, intrinsics={
        "fx": 0.8 * width, "fy": 0.8 * width, "cx": width / 2, "cy": height / 2})
    config["sift"].update(num_octaves=2, max_keypoints_per_trio=64)
    traffic.update(batch=batch, ring_batches=2, warmup_batches=1, trace_batches=2)
    return cell
