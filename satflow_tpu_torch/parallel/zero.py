"""ZeRO optimizer sharding over the data axis, counterpart of ``satflow_tpu/parallel/zero.py``.

The JAX package shards the optimizer state (and, with ``shard_params``, the
parameters) over ``data`` by sharding metadata on the state's pytree, and XLA
adds the reduce-scatter / all-gather. Here:

- ``shard_params=False`` (what the Trainer's ``zero_sharding`` does):
  ``torch.distributed.optim.ZeroRedundancyOptimizer`` around the state's
  optimizer class, its defaults and param groups. Each rank keeps the
  moments of its share of the parameters, steps that share, and broadcasts
  it; the gradients are still averaged whole and the parameters stay
  replicated.
- ``shard_params=True``: FSDP2's ``fully_shard`` on the state's module over
  the ``data`` axis, and the optimizer rebuilt on its sharded parameters, so
  the parameters, their gradients and the moments are all sharded. FSDP
  averages the gradients itself, so the state's own all-reduce is switched
  off. No caller in the repo passes it.

A sharded checkpoint is the unsharded one: :meth:`TrainState.state_dict
<satflow_tpu_torch.train.state.TrainState.state_dict>` gathers ZeRO's moments
to rank 0 (``consolidate_state_dict``) and FSDP's shards to full tensors
(:func:`gathered`), collectives every rank joins, in the plain model's and
optimizer's layout; :func:`load_model_state` and :func:`load_optimizer_state`
read it into a state of any kind.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional

import torch

from satflow_tpu_torch.parallel.distributed import is_distributed, rank
from satflow_tpu_torch.parallel.mesh import get_mesh


def _rebuilt(optimizer: torch.optim.Optimizer, params_of, **zero_kw) -> torch.optim.Optimizer:
    """``optimizer``'s class over its param groups (each parameter through
    ``params_of``), with its constructor's defaults and its step hooks (a
    learning-rate schedule's); a ZeroRedundancyOptimizer with ``zero_kw``."""
    cls = type(optimizer)
    takes = inspect.signature(cls.__init__).parameters
    defaults = {k: v for k, v in optimizer.defaults.items() if k in takes}
    groups = [{**g, "params": [params_of(p) for p in g["params"]]}
              for g in optimizer.param_groups]
    if zero_kw:
        from torch.distributed.optim import ZeroRedundancyOptimizer

        new = ZeroRedundancyOptimizer(groups, optimizer_class=cls, **zero_kw, **defaults)
    else:
        new = cls(groups, **defaults)
    for hook in optimizer._optimizer_step_pre_hooks.values():
        new.register_step_pre_hook(hook)
    for hook in optimizer._optimizer_step_post_hooks.values():
        new.register_step_post_hook(hook)
    return new


def _shard_half(half, mesh, shard_params: bool) -> None:
    """ZeRO (or FSDP) on one :class:`TrainState`, in place."""
    if half.optimizer.state:
        raise ValueError("apply_zero_sharding takes a state that has not stepped yet")
    if not shard_params:
        half.optimizer = _rebuilt(half.optimizer, lambda p: p,
                                  process_group=mesh.get_group("data"))
        return
    from torch.distributed.fsdp import fully_shard

    module = half.model
    names = {id(p): n for n, p in module.named_parameters()}
    fully_shard(module, mesh=mesh["data"])
    new = dict(module.named_parameters())
    half.optimizer = _rebuilt(half.optimizer, lambda p: new[names[id(p)]])
    half.all_reduce = False


def apply_zero_sharding(state, mesh=None, shard_params: bool = False):
    """Shard a :class:`TrainState`'s optimizer state over the ``data`` axis
    (stage 2) and, with ``shard_params``, its parameters (stage 3); both
    halves of a :class:`GANTrainState`. Returns the state, changed in place.
    Call it before the first step and before a resume loads the moments."""
    mesh = mesh or get_mesh()
    halves = (state.g, state.d) if hasattr(state, "g") else (state,)
    for half in halves:
        _shard_half(half, mesh, shard_params)
    return state


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def gathered(tree: Any) -> Any:
    """A state dict (nested dicts and lists) with every FSDP shard (DTensor)
    gathered to its full tensor: an all-gather every rank joins."""
    if not is_distributed():
        return tree
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gathered(v) for v in tree]
    return tree.full_tensor() if isinstance(tree, _dtensor()) else tree


def _sharded_as(value: Any, like: Any) -> Any:
    """A full tensor laid out as the DTensor ``like`` is (anything else as
    it is)."""
    if not (is_distributed() and isinstance(like, _dtensor()) and isinstance(value, torch.Tensor)
            and tuple(value.shape) == tuple(like.shape)):
        return value
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(value.to(like.device), like.device_mesh, like.placements)


def load_model_state(module: torch.nn.Module, state: Dict[str, Any]) -> None:
    """``module.load_state_dict`` of a full (unsharded) state dict, into
    FSDP shards where the module holds them."""
    own = module.state_dict()
    module.load_state_dict({k: _sharded_as(v, own.get(k)) for k, v in state.items()})


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: Dict[str, Any]) -> None:
    """``optimizer.load_state_dict`` of a full state dict (a plain, ZeRO or
    gathered FSDP one), each moment laid out as its parameter is."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    moments = {i: {k: _sharded_as(v, params[i]) for k, v in s.items()}
               for i, s in state["state"].items()}
    optimizer.load_state_dict({**state, "state": moments})


def optimizer_state_dict(optimizer: torch.optim.Optimizer) -> Optional[Dict[str, Any]]:
    """``optimizer.state_dict()`` in the plain optimizer's layout: a
    ZeroRedundancyOptimizer's moments gathered to rank 0 (the other ranks
    get None), FSDP's shards to full tensors. Every rank must call it."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    if isinstance(optimizer, ZeroRedundancyOptimizer):
        optimizer.consolidate_state_dict(to=0)
        return optimizer.state_dict() if rank() == 0 else None
    return gathered(optimizer.state_dict())
