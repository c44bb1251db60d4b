"""Multi-process start-up and the collectives the port's data parallelism
uses, counterpart of ``satflow_tpu/parallel/distributed.py``.

The JAX package calls ``jax.distributed.initialize`` before any backend use,
from the coordinator triplet (arguments or ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``) or a TPU pod's own environment.
Here :func:`maybe_initialize_distributed` calls
``torch.distributed.init_process_group`` from the same triplet, or from
torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``,
which take the place of the pod's autodetection. The backend follows the
device the caller asked for: NCCL for ``cuda``, gloo for ``cpu``; a ``cuda``
request without a card raises, as every entry point of the port does.

Launch, one process per card::

    torchrun --nproc-per-node 4 -m satflow_tpu_torch.run trainer=zero

or, per process, ``JAX_COORDINATOR_ADDRESS=host:port JAX_NUM_PROCESSES=N
JAX_PROCESS_ID=i python -m satflow_tpu_torch.run ...``. A coordinator
address with a scheme (``tcp://``, ``file://``) is passed as it is.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

_INITIALIZED = False

log = logging.getLogger(__name__)


def is_distributed() -> bool:
    """Whether a default process group is up in this process."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def is_rank_zero() -> bool:
    """Whether this process writes checkpoints and logs: rank 0, or the only
    process."""
    return rank() == 0


def backend_for(device) -> str:
    """The process group backend of ``device`` (a device, or a backend name
    passed through): ``nccl`` for CUDA, ``gloo`` for the CPU. ``None`` is
    the card, the port's default device; a card that is not there raises."""
    if device in ("nccl", "gloo"):
        return device
    from satflow_tpu_torch import resolve_device

    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda":
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"no process group backend for device {str(dev)!r}")


def local_device(device) -> torch.device:
    """``device`` for this process: a bare ``cuda`` under a process group is
    this rank's card, ``cuda:{LOCAL_RANK}`` (else the card
    :func:`maybe_initialize_distributed` selected)."""
    from satflow_tpu_torch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and is_distributed():
        local = os.environ.get("LOCAL_RANK")
        return resolve_device(f"cuda:{local}" if local else f"cuda:{torch.cuda.current_device()}")
    return dev


def _local_rank(process_id: int) -> int:
    env = os.environ.get("LOCAL_RANK")
    return int(env) if env else process_id % max(torch.cuda.device_count(), 1)


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def maybe_initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend=None,
) -> bool:
    """Start the default process group when a multi-process launch asks for
    one; returns whether it spans more than one process.

    ``backend`` is ``"nccl"``, ``"gloo"`` or the device the run trains on
    (``"cuda"``, the default, gives NCCL; ``"cpu"`` gloo). A group that is
    already up (this function's, or one a launcher made) is reported, not
    made again. A coordinator and a count without a rank raise ValueError:
    every process would claim rank 0. A failed start is logged as an error
    and the function reports what is up, as the JAX function does; on NCCL
    each process first selects its card (``LOCAL_RANK``, else its rank
    modulo the visible cards). The rank-zero logging gate is set from the
    group's rank.
    """
    global _INITIALIZED
    from satflow_tpu_torch.core.utils import set_logging_process_index

    if _INITIALIZED or is_distributed():
        _INITIALIZED = True
        set_logging_process_index(dist.get_rank())
        return dist.get_world_size() > 1

    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes or _int_env("JAX_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("JAX_PROCESS_ID")
    torchrun = all(os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"))
    if (coordinator_address and num_processes and num_processes > 1
            and process_id is None):
        # a default rank would make every process claim rank 0: the first
        # binds the store and the others fail or hang
        raise ValueError(
            "JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES are set but "
            "JAX_PROCESS_ID is missing — each process needs its unique rank"
        )
    triplet = bool(coordinator_address and num_processes)
    if not (triplet or torchrun):
        return False
    name = backend_for(backend)
    try:
        if triplet:
            rank_ = process_id or 0
            if name == "nccl":
                torch.cuda.set_device(_local_rank(rank_))
            dist.init_process_group(backend=name, init_method=_init_method(coordinator_address),
                                    world_size=num_processes, rank=rank_)
        else:
            if name == "nccl":
                torch.cuda.set_device(_local_rank(int(os.environ["RANK"])))
            dist.init_process_group(backend=name, init_method="env://")
        _INITIALIZED = True
    except Exception as e:  # noqa: BLE001 - reported, and what is up is returned
        log.error(
            "multi-process launch detected but init_process_group FAILED (%s: %s); "
            "this process is NOT part of a group: its gradients are not averaged with "
            "the others'", type(e).__name__, e,
        )
        if not is_distributed():
            return False
    set_logging_process_index(dist.get_rank())
    return dist.get_world_size() > 1


def shutdown_distributed() -> None:
    """Leave the default process group and forget the global mesh made over
    it (the counterpart of ``jax.distributed.shutdown``); a later
    :func:`maybe_initialize_distributed` may start another."""
    global _INITIALIZED
    from satflow_tpu_torch.core.utils import set_logging_process_index
    from satflow_tpu_torch.parallel.mesh import set_mesh

    if is_distributed():
        dist.destroy_process_group()
    _INITIALIZED = False
    set_mesh(None)
    set_logging_process_index(0)


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Average ``tensors`` in place over ``group`` (the world by default):
    one flat buffer and one collective per dtype (gloo has no AVG, so a SUM
    then a division)."""
    if not is_distributed():
        return
    n = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def mean_metrics(metrics: Dict[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """A step's metrics averaged over the ranks (the global batch's, for
    shards of equal size); a boolean one (``finite``) holds on every rank or
    is False. Without a process group the metrics come back as they are."""
    if not is_distributed():
        return metrics
    keys = list(metrics)
    values = [metrics[k].detach().clone() if metrics[k].is_floating_point()
              else metrics[k].detach().to(torch.float32) for k in keys]
    all_reduce_mean_(values, group)
    return {k: (v == 1.0) if metrics[k].dtype == torch.bool else v.to(metrics[k].dtype)
            for k, v in zip(keys, values)}


class _AllReduceSum(torch.autograd.Function):
    """SUM over a group whose backward sums the cotangents over the group:
    every rank's output depends on every rank's input."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The SUM of ``x`` over ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)
