"""Multi-process execution scaffolding: the process group, the mesh over it,
and the replicated-input SPMD pattern.

Port of the JAX package's ``parallel/multihost.py`` onto
``torch.distributed``. A JAX ``Mesh`` is driven by one controller; here
every rank runs the same program (multi-controller SPMD), and the port
takes the pattern the JAX package uses for its multi-process runs: every
rank holds the same full host data, each function of
``parallel/distributed.py`` takes its own share of it, and the shares are
reduced or gathered so that every rank returns the same full result. A
caller's code is then the same at world size 1, 2 or N.

- :func:`initialize_multihost`: ``init_process_group``, from explicit
  arguments (``tcp://`` or any ``init_method`` URL) or from the
  environment ``torchrun`` sets.
- :func:`global_mesh`: a 1-D ``DeviceMesh`` over the whole world, dimension
  ``"shard"`` (the counterpart of the JAX package's 1-D mesh).
- :func:`put_global`: this rank's contiguous slice of a full copy.
- :func:`replicate_global`: rank 0's copy on every rank.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout: datetime.timedelta | None = None,
) -> None:
    """Join (or form) the process group; nothing happens if one exists.

    Pass all three of ``coordinator_address`` (``host:port``, taken as
    ``tcp://host:port``, or a URL such as ``file:///path`` that
    ``init_process_group`` accepts as its ``init_method``),
    ``num_processes`` and ``process_id``, or none of them to read the
    rendezvous from the environment (``torchrun``). ``backend`` defaults to
    NCCL where CUDA is present, else gloo; ``timeout`` bounds every
    collective (``torch.distributed``'s default when ``None``).
    """
    if dist.is_initialized():
        return
    given = [a is not None for a in (coordinator_address, num_processes, process_id)]
    if any(given) and not all(given):
        # A process that dropped these would form a group of its own and
        # compute on its share of the data with no rendezvous.
        raise ValueError(
            "coordinator_address, num_processes and process_id go together: "
            "pass all three, or none to read them from the environment"
        )
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {} if timeout is None else {"timeout": timeout}
    if all(given):
        init = coordinator_address
        if "://" not in init:
            init = f"tcp://{init}"
        dist.init_process_group(
            backend, init_method=init, world_size=num_processes, rank=process_id, **kwargs
        )
    else:
        dist.init_process_group(backend, init_method="env://", **kwargs)


def global_mesh(axis: str = "shard", device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over every rank of the initialised group, on ``device_type``.

    ``"cuda"`` (the default) puts each rank on the card ``rank % cards``
    unless the process chose one before, and raises where there is no
    card; ``"cpu"`` is asked for by name, as ``device="cpu"`` is at the
    entry points (``core/device.py``)."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device: a "cuda" mesh needs a card; ask for a "cpu" mesh '
                "to run on the CPU"
            )
        if not torch.cuda.is_initialized():
            torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    elif device_type != "cpu":
        raise ValueError(f"mesh device type {device_type!r}: 'cuda' or 'cpu'")
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_group(mesh: DeviceMesh):
    """``(process group, world size, this rank)`` of the mesh's one axis."""
    return mesh.get_group(), mesh.size(), mesh.get_local_rank()


def put_global(x, mesh: DeviceMesh, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``axis``, on the mesh's
    device. Every rank must hold the same ``x`` (numpy or tensor), whose
    ``axis`` divides evenly by the world size."""
    _, world, rank = mesh_group(mesh)
    x = torch.as_tensor(x)
    if x.shape[axis] % world:
        raise ValueError(
            f"put_global: axis {axis} of length {x.shape[axis]} does not split "
            f"over {world} ranks"
        )
    n = x.shape[axis] // world
    return x.narrow(axis, rank * n, n).to(mesh_device(mesh))


def replicate_global(x, mesh: DeviceMesh) -> torch.Tensor:
    """Rank 0's copy of ``x`` on every rank (a broadcast), on the mesh's
    device. Every rank passes an ``x`` of the same shape and dtype."""
    group, _, _ = mesh_group(mesh)
    x = torch.as_tensor(x)
    out = x.to(mesh_device(mesh), copy=True).contiguous()
    dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)
    return out
