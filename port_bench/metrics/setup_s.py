"""Process start to the first timed batch: imports, the kernels' load (and
their build, in the first run in a checkout), the frames made from the
seed, the cell's shape warmed up (host clock)."""


def read(summary):
    return summary.get("setup_s")
