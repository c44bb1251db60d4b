"""The device mesh and batch placement, counterpart of ``satflow_tpu/parallel/mesh.py``.

The JAX package expresses parallelism once, as a global ``Mesh`` with axes
``("data", "model")``: batches are sharded over ``data``, parameters are
replicated and XLA all-reduces the gradient. Here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the processes of the
default group (one card each, or one CPU process each on gloo), and what a
sharded global array is in JAX is, in each process, its own block:

- :func:`shard_batch` cuts this rank's block of the global batch (dim 0 over
  ``data``; inside a spatial :func:`mesh_scope` also H over ``model``) and
  puts it on this rank's device;
- :func:`put_replicated` broadcasts a module's parameters and buffers from
  rank 0, so that every rank starts from the same weights;
- the train state averages the gradients over the group
  (:meth:`TrainState.apply_gradients <satflow_tpu_torch.train.state.TrainState.apply_gradients>`),
  and BatchNorm takes its statistics over the ``data`` group
  (:func:`data_group`), which is what GSPMD gives the JAX package.

:func:`batch_sharding` and :func:`replicated_sharding` are the DTensor
placements of those two layouts (``torch.distributed.tensor.Shard`` /
``Replicate``, one per mesh dimension): ``distribute_tensor(x, mesh,
batch_sharding(mesh)).to_local()`` is the block :func:`shard_batch` cuts
along dim 0.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from satflow_tpu_torch.parallel.distributed import is_distributed, local_device

_GLOBAL_MESH = None
# The mesh axis over which shard_batch also cuts H, inside a spatial
# mesh_scope (the trainer's spatial=DxM mode): the rollout then reads its rows
# as the loader delivers them.
_SPATIAL_AXIS: Optional[str] = None

log = logging.getLogger(__name__)


def make_mesh(axis_shapes: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("data", "model")):
    """A ``DeviceMesh`` over the initialized world: by default every rank on
    ``data``. Its device type follows the group's backend (NCCL: ``cuda``,
    gloo: ``cpu``). Shapes that do not cover the world raise ValueError."""
    if not is_distributed():
        raise RuntimeError(
            "a device mesh spans the processes of a process group: start one first "
            "(parallel.distributed.maybe_initialize_distributed)"
        )
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if axis_shapes is None:
        axis_shapes = [n] + [1] * (len(axis_names) - 1)
    if int(np.prod(axis_shapes)) != n:
        raise ValueError(f"Mesh {list(axis_shapes)} does not cover {n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(int(s) for s in axis_shapes),
                            mesh_dim_names=tuple(axis_names))


def get_mesh():
    """The process-global mesh (made on first use)."""
    global _GLOBAL_MESH
    if _GLOBAL_MESH is None:
        _GLOBAL_MESH = make_mesh()
    return _GLOBAL_MESH


def set_mesh(mesh) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


@contextlib.contextmanager
def mesh_scope(mesh, spatial_axis: Optional[str] = None):
    """Bind ``mesh`` as the process-global mesh for the duration of a block.

    The trainer's spatial mode binds its DxM mesh for one entry point only: a
    permanent rebind would leave every later :func:`get_mesh` user (a
    non-spatial fit after a spatial one) on D-way data parallelism with M-way
    replication, an M-fold loss of throughput with no error. Inside the
    scope, ``spatial_axis`` is the axis over which :func:`shard_batch` also
    cuts the H of image-like leaves."""
    global _GLOBAL_MESH, _SPATIAL_AXIS
    prev, prev_sp = _GLOBAL_MESH, _SPATIAL_AXIS
    _GLOBAL_MESH = mesh
    _SPATIAL_AXIS = spatial_axis
    try:
        yield mesh
    finally:
        _GLOBAL_MESH = prev
        _SPATIAL_AXIS = prev_sp


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_device(mesh) -> torch.device:
    """This rank's device in ``mesh``."""
    return local_device(mesh.device_type)


def data_group():
    """The process group BatchNorm takes its statistics over: the current
    mesh's ``data`` axis, or None without a process group or where that axis
    holds one rank (the statistics are then this process's own)."""
    if not is_distributed():
        return None
    mesh = get_mesh()
    if "data" not in mesh.mesh_dim_names or axis_size(mesh, "data") == 1:
        return None
    return mesh.get_group("data")


def batch_sharding(mesh=None, axis: str = "data"):
    """The DTensor placements of a batch-leading tensor: dim 0 sharded over
    ``axis``, replicated over the mesh's other dimensions."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = mesh or get_mesh()
    return tuple(Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names)


def replicated_sharding(mesh=None):
    """The DTensor placements of a replicated tensor (parameters)."""
    from torch.distributed.tensor import Replicate

    mesh = mesh or get_mesh()
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


@torch.no_grad()
def put_replicated(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 to every
    rank: the replicated placement of the train state. Returns the module."""
    if is_distributed():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


# Leaves whose dim ndim-3 is really H (NHWC video / image): see shard_batch.
_SPATIAL_LEAF_KEYS = frozenset({"sat_data", "topo_data"})
_WARNED_INDIVISIBLE = set()


def shard_batch(batch: Any, mesh=None, spatial_axis: Optional[str] = None) -> Any:
    """This rank's block of a global batch (numpy arrays or tensors, nested
    in dicts, tuples and lists), on this rank's device.

    Every rank passes the same global batch. A leaf's dim 0 is cut over
    ``data`` when it divides; a batch dim that does not divide stays whole
    on every rank (JAX's replicated leaf: the gradient mean is then still
    the global one), with a one-time warning, since every rank then computes
    the whole batch. Rank-0 leaves and non-arrays pass through.

    ``spatial_axis`` (default: the axis a spatial :func:`mesh_scope` binds)
    also cuts H (dim ``ndim-3``) over that axis, for the ``sat_data`` /
    ``topo_data`` leaves of a dict and for bare arrays of rank >= 4 (an
    (B, 10, T, 2, 2) NWP leaf is no image). An H that does not divide raises
    ValueError: the rollout reads this rank's rows as its block of the image,
    so a whole image here would be computed as if it were a block.
    """
    mesh = mesh or get_mesh()
    if spatial_axis is None:
        spatial_axis = _SPATIAL_AXIS
    if spatial_axis is not None and spatial_axis not in mesh.mesh_dim_names:
        spatial_axis = None
    device = mesh_device(mesh)
    n_data = axis_size(mesh, "data")
    i_data = mesh.get_local_rank("data")

    def put(x, key: Optional[str]):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if not isinstance(x, torch.Tensor):
            return x
        if x.dim() > 0 and x.shape[0] % n_data == 0:
            size = x.shape[0] // n_data
            x = x.narrow(0, i_data * size, size)
        elif x.dim() > 0 and x.shape[0] > 1:
            _warn_indivisible_once(x.shape[0], n_data)
        if spatial_axis is not None and x.dim() >= 4 and (key is None
                                                          or key in _SPATIAL_LEAF_KEYS):
            dim, m = x.dim() - 3, axis_size(mesh, spatial_axis)
            if x.shape[dim] % m:
                raise ValueError(f"H={x.shape[dim]} of {key or 'the batch'} must divide by the "
                                 f"{spatial_axis!r} axis size {m}")
            size = x.shape[dim] // m
            x = x.narrow(dim, mesh.get_local_rank(spatial_axis) * size, size)
        return x.contiguous().to(device)

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v, key) for v in tree)
        return put(tree, key)

    return walk(batch)


def _warn_indivisible_once(batch_dim: int, data_axis: int) -> None:
    key = (batch_dim, data_axis)
    if key in _WARNED_INDIVISIBLE:
        return
    _WARNED_INDIVISIBLE.add(key)
    log.warning(
        "batch dim %d is not divisible by the data axis (%d): the leaf is "
        "REPLICATED — every rank computes the full batch, i.e. no DP "
        "speedup. Pick a batch size divisible by %d.",
        batch_dim, data_axis, data_axis,
    )
