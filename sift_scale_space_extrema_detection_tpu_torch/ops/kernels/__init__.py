"""The port's hand-written CUDA kernels and their wrappers. Every launch is
counted by name in ``_build``'s record: :func:`launch_counts`,
:func:`launches_since`."""

from ._build import launch_counts, launches_since

__all__ = ["launch_counts", "launches_since"]
