"""The 95th percentile, by nearest rank, of every batch of the window: from
the call into the port to its outputs ready on the card (host clock)."""

from port_bench.trace import percentile


def read(summary):
    if not summary.get("latencies_s"):
        return None
    return 1e3 * percentile(summary["latencies_s"], 95)
