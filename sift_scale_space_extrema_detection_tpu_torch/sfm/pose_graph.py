"""Pose-graph optimization over SE(3).

Port of the JAX package's ``sfm/pose_graph.py``: the SLAM backend's
loop-closure layer. Nodes are world→camera poses; edges carry measured
relative transforms ``T_ij`` (pose of frame j expressed from frame i:
``T_j ≈ T_ij ∘ T_i``) with per-edge weights. The residual of an edge is
the se(3) log of the loop discrepancy.

Edges live in a fixed-capacity masked buffer; the geometry functions take
leading batch dimensions, so the residuals of all edges are one batched
evaluation, and the per-edge 6×12 Jacobians come from
``torch.func.jacfwd`` mapped over the buffer with ``torch.func.vmap`` (the
closed form would need the inverse right Jacobian of SE(3); the Taylor
branches of the geometry keep the tangents finite). The (6N × 6N) normal
system is assembled from dense blocks and solved densely: at
keyframe-graph scales (N ≲ 10³) a dense solve beats any sparse scheme.
Edges repeat nodes and may repeat (src, dst) pairs, so the blocks are summed
by node pair, by bundle adjustment's means (``sfm/ba.py::segment_sum``: the
blocks sorted by pair once per solve, each run added in one fixed order, so
that two runs give the same bits).
Branchless LM, node 0 gauge-fixed; nothing in the loop reads a value back
to the host.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.device import Device, on_device, resolve_device
from .ba import Segments, segment_sum, segment_tables
from .geometry import compose, invert, se3_exp, se3_log


@dataclasses.dataclass
class PoseGraphEdges:
    """Fixed-capacity relative-pose constraints ``i → j``."""

    src: torch.Tensor  # (E,) int32 node i
    dst: torch.Tensor  # (E,) int32 node j
    rel_rotation: torch.Tensor  # (E, 3, 3) measured R_ij
    rel_translation: torch.Tensor  # (E, 3) measured t_ij
    weight: torch.Tensor  # (E,) float (0 = invalid)

    @property
    def capacity(self) -> int:
        return self.src.shape[-1]


def _edge_residual(xi_i, xi_j, rot_i, t_i, rot_j, t_j, rel_r, rel_t):
    """se3 residual of edges under increments (ξ_i, ξ_j): the log of
    ``T_err = (T_ij ∘ T_i) ∘ T_j⁻¹``. Takes one edge or, with leading
    dimensions on every argument, a batch."""
    ri, ti = compose(*se3_exp(xi_i), rot_i, t_i)
    rj, tj = compose(*se3_exp(xi_j), rot_j, t_j)
    pr, pt = compose(rel_r, rel_t, ri, ti)
    return se3_log(*compose(pr, pt, *invert(rj, tj)))


def _edge_args(rotations, translations, edges: PoseGraphEdges):
    src, dst = edges.src.long(), edges.dst.long()
    return (
        rotations[src], translations[src], rotations[dst], translations[dst],
        edges.rel_rotation, edges.rel_translation,
    )


def pose_graph_residuals(
    rotations: torch.Tensor, translations: torch.Tensor, edges: PoseGraphEdges
) -> torch.Tensor:
    """Weighted residuals ``(E, 6)``."""
    zero = translations.new_zeros((edges.capacity, 6))
    res = _edge_residual(zero, zero, *_edge_args(rotations, translations, edges))
    return res * edges.weight[:, None]


def _system_tables(edges: PoseGraphEdges, n: int) -> tuple[Segments, Segments]:
    """The :func:`segment_tables` of :func:`_build_system`: the four blocks
    of every edge by node pair, and its two gradient terms by node. They
    depend on the edges' ends alone: built once per solve."""
    src, dst = edges.src.long(), edges.dst.long()
    pairs = torch.cat([src * n + src, dst * n + dst, src * n + dst, dst * n + src])
    return segment_tables(pairs, n * n), segment_tables(torch.cat([src, dst]), n)


def _build_system(rotations, translations, edges: PoseGraphEdges, tables):
    """``(h (N, N, 6, 6), b (N, 6))``: the Gauss-Newton normal system in
    block layout (``h[i, j]`` couples nodes i and j). ``tables``: the
    :func:`_system_tables` of these edges."""
    n = rotations.shape[0]
    pair_table, node_table = tables
    args = _edge_args(rotations, translations, edges)
    zero = translations.new_zeros((edges.capacity, 6))
    w = edges.weight[:, None]
    res = _edge_residual(zero, zero, *args) * w
    # One jacfwd call yields both block Jacobians of an edge.
    ji, jj = torch.func.vmap(torch.func.jacfwd(_edge_residual, argnums=(0, 1)))(
        zero, zero, *args
    )
    ji, jj = ji * w[:, :, None], jj * w[:, :, None]  # (E, 6, 6)
    jit, jjt = ji.transpose(-1, -2), jj.transpose(-1, -2)

    # Edges repeat nodes, and may repeat (src, dst) pairs: sum by pair.
    # (An indexed ``+=`` would keep one addend per repeated index.)
    h_ij = jit @ jj
    blocks = torch.cat([jit @ ji, jjt @ jj, h_ij, h_ij.transpose(-1, -2)])
    h = segment_sum(blocks, pair_table).reshape(n, n, 6, 6)
    grads = torch.cat([jit @ res[:, :, None], jjt @ res[:, :, None]])[:, :, 0]
    b = segment_sum(-grads, node_table)
    return h, b


def optimize_pose_graph(
    rotations: torch.Tensor,
    translations: torch.Tensor,
    edges: PoseGraphEdges,
    num_iterations: int = 20,
    device: Device = None,
):
    """LM pose-graph optimization; node 0 is the gauge anchor.

    Returns ``(rotations, translations, final_cost)``. ``device``: see
    ``core/device.py``.
    """
    target = resolve_device(rotations, device)
    rotations, translations = rotations.to(target), translations.to(target)
    edges = on_device(edges, target)
    n = rotations.shape[0]
    dtype = translations.dtype
    node = torch.arange(n, device=target)
    tables = _system_tables(edges, n)

    def cost_of(rots, ts):
        r = pose_graph_residuals(rots, ts, edges)
        return 0.5 * (r * r).sum()

    lam = torch.full((), 1e-4, dtype=dtype, device=target)
    cost = cost_of(rotations, translations)
    eye6 = torch.eye(6, dtype=dtype, device=target)
    free = (node >= 1).to(dtype)

    for _ in range(num_iterations):
        h, b = _build_system(rotations, translations, edges, tables)
        diag = h[node, node].diagonal(dim1=-2, dim2=-1)
        h[node, node] += torch.diag_embed(lam * diag.clamp(min=1e-8) + 1e-8)
        # Gauge fix node 0.
        h = h * (free[:, None, None, None] * free[None, :, None, None])
        h[node, node] += (1.0 - free)[:, None, None] * eye6
        b = b * free[:, None]

        delta = torch.linalg.solve(
            h.permute(0, 2, 1, 3).reshape(n * 6, n * 6), b.reshape(n * 6)
        ).reshape(n, 6)
        delta = delta * free[:, None]

        rot_new, t_new = compose(*se3_exp(delta), rotations, translations)
        cost_new = cost_of(rot_new, t_new)
        accept = cost_new < cost
        rotations = torch.where(accept, rot_new, rotations)
        translations = torch.where(accept, t_new, translations)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.where(accept, lam * 0.3, lam * 6.0).clamp(1e-9, 1e5)
    return rotations, translations, cost
