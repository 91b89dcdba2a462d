"""Multi-rank execution over ``torch.distributed`` (see distributed.py,
multihost.py)."""

from .distributed import (
    detect_and_describe_data_parallel,
    distributed_bundle_adjust,
    make_mesh,
    match_against_keyframes_sharded,
)
from .multihost import (
    global_mesh,
    initialize_multihost,
    put_global,
    replicate_global,
)

__all__ = [
    "detect_and_describe_data_parallel",
    "distributed_bundle_adjust",
    "global_mesh",
    "initialize_multihost",
    "make_mesh",
    "match_against_keyframes_sharded",
    "put_global",
    "replicate_global",
]
