"""Structure-from-motion back end: geometry, PnP, pose graph, bundle
adjustment and trajectory evaluation."""

from . import ba, evaluate, geometry, pnp, pose_graph

__all__ = ["ba", "evaluate", "geometry", "pnp", "pose_graph"]
