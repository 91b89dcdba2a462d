"""Frames completed in the window over the window's seconds (host clock;
each batch ends in a synchronise)."""

from port_bench.trace import rate


def read(summary):
    if "window_s" not in summary:
        return None
    return rate(summary["frames"], summary["window_s"])
