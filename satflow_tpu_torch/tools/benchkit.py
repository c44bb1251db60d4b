"""What the bench tools share: the device they run on, the card's stamp, the
kernels' launch counters and the chained timing.

The bench tools (``bench``, ``bench_int8``, ``bench_axial``, ``bench_zoo``,
``bench_serve``, ``bench_train``, ``exp_train_ceiling``) are the port's
copies of the JAX package's ``bench.py`` and ``tools/bench_*.py``. Each
times the JAX tools' way: the iterations are chained through a real data
dependence (the output feeds the next input, or the train state carries
on), one warm-up run builds the kernels first, the time comes from CUDA
events (or the host clock around a synchronised loop where the host is part
of what is timed) and one scalar is fetched at the end. Each JSON line keeps
the JAX tool's keys and adds ``card`` (the name and power limit
``nvidia-smi`` gives, or the device type) and ``kernel_launches`` (each
kernel's launches per timed iteration). On a card, a timed path that should
reach a kernel and launched it no time raises before anything is printed.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, Iterable, Tuple, TypeVar

import torch

from satflow_tpu_torch import resolve_device
from satflow_tpu_torch.tools.studies import card_name

T = TypeVar("T")


def counters() -> Dict[str, object]:
    """The launch counter of each kernel a bench path can reach, by its id:
    K1 (and K1h under ``SATFLOW_STEP_VARIANT=halo``), K2, K3, K4, K5, K6a and
    K6b. A wrapper counts only where it launches its kernel on a card."""
    from satflow_tpu_torch.ops.axial_attention import axial_attention
    from satflow_tpu_torch.ops.cmajor_convlstm import cmajor_conv3x3, cmajor_convlstm_step
    from satflow_tpu_torch.ops.fused_convlstm_int8 import fused_convlstm_step_int8
    from satflow_tpu_torch.ops.fused_convlstm_step import (
        fused_convlstm_step,
        fused_convlstm_step_halo,
        gate_bwd,
    )
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates

    return {"K1": fused_convlstm_step, "K1h": fused_convlstm_step_halo, "K2": gate_bwd,
            "K3": fused_lstm_gates, "K4": axial_attention, "K5": fused_convlstm_step_int8,
            "K6a": cmajor_convlstm_step, "K6b": cmajor_conv3x3}


def launches() -> Dict[str, int]:
    """Every counter of :func:`counters` as it stands now."""
    return {k: c.launches for k, c in counters().items()}


def per_iteration(before: Dict[str, int], iterations: int) -> Dict[str, float]:
    """Each kernel's launches since ``before`` over ``iterations``: an int
    where they divide evenly."""
    out = {}
    for k, n in launches().items():
        q = (n - before[k]) / max(iterations, 1)
        out[k] = int(q) if q == int(q) else q
    return out


def step_kernel() -> str:
    """The id of the fused step's forward kernel: K1, or K1h under
    ``SATFLOW_STEP_VARIANT=halo``."""
    from satflow_tpu_torch.ops.fused_convlstm_step import step_variant

    return "K1h" if step_variant() == "halo" else "K1"


def require(kernel_launches: Dict[str, float], kernels: Iterable[str], device: torch.device,
            what: str) -> None:
    """On a card, raise where a kernel of ``kernels`` launched no time on
    the timed path ``what``; on the CPU the wrappers run their plain
    versions and count nothing."""
    if device.type != "cuda":
        return
    missing = [k for k in kernels if not kernel_launches.get(k)]
    if missing:
        raise RuntimeError(f"{what}: {', '.join(missing)} launched no time on the timed path "
                           f"({kernel_launches})")


def device_and_card(name: str) -> Tuple[torch.device, str]:
    """The device (``cuda`` raises without a card) and its stamp."""
    device = resolve_device(name)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device, card_name(device)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chain(body: Callable[[T], T], carry: T, iterations: int, device: torch.device
          ) -> Tuple[T, float, Dict[str, float]]:
    """``iterations`` calls of ``body``, each on the carry the last one
    returned: (the final carry, seconds an iteration, each kernel's launches
    an iteration). On a card the time is CUDA events' around the loop;
    elsewhere the host clock's."""
    synchronize(device)
    before = launches()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iterations):
            carry = body(carry)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(iterations):
            carry = body(carry)
        seconds = time.perf_counter() - t0
    return carry, seconds / iterations, per_iteration(before, iterations)


def emit(record: Dict) -> Dict:
    """Print ``record`` as one JSON line and return it."""
    print(json.dumps(record), flush=True)
    return record
