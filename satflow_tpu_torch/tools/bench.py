"""Benchmark: frames/s for the 24-step 256x256x12ch ConvLSTM rollout on one card.

The port's copy of the JAX package's ``bench.py``: a 24-step autoregressive
nowcast rollout at 256x256 with 12 input channels (EUMETSAT MSG geometry),
bf16 compute on f32 weights drawn from ``torch.Generator`` seed 0, through
``models/conv_lstm.py::ConvLSTMCore`` at hidden 64 with 7 frames in. The
rollouts are chained: each one's first 7 output frames are the next one's
input, so that no forward is skipped; one warm-up forward builds the kernels,
CUDA events time the chain and one scalar is fetched at the end.

Environment, as in the JAX tool: ``BENCH_BATCH`` (default 64, the best of
the H100 sweep b8-b64; ``PERF.md`` §5), ``BENCH_CELL_IMPL`` (``fused``; ``cmajor``,
``concat``, ``split``, ``hybrid``; any other name raises) and
``BENCH_HEAD_IN_SCAN`` (``1``). ``BENCH_UNROLL`` has no counterpart: the
port's rollout is a Python loop. Usage::

    python -m satflow_tpu_torch.tools.bench [--device cuda] [--iters 10]

Prints ONE JSON line: ``{"metric", "value", "unit", "card",
"kernel_launches"}`` (launches a forward: 62 K1 under ``fused``; 14 K1, 48
K6a and 24 K6b under ``cmajor``; 62 K3 under ``concat``, ``split`` and
``hybrid``).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from satflow_tpu_torch.tools import benchkit

HISTORY_STEPS = 7  # 30 min history + now
FORECAST_STEPS = 24
SIZE = 256
CHANNELS = 12
BATCH = 64  # the H100 sweep's best (b8-b64; flat within 0.4 % from b32 up)
HIDDEN = 64

# the kernels each cell formulation's forward must launch on a card
KERNELS = {"fused": ("K1",), "cmajor": ("K1", "K6a", "K6b"), "concat": ("K3",),
           "split": ("K3",), "hybrid": ("K3",)}


def build(cell_impl: str, hidden: int, channels: int, steps: int, head_in_scan: bool,
          dtype: Optional[torch.dtype], device: torch.device, seed: int = 0):
    """The rollout core on ``device``, its weights from ``seed``."""
    from satflow_tpu_torch.models.conv_lstm import ConvLSTMCore

    core = ConvLSTMCore(hidden_dim=hidden, in_channels=channels, out_channels=channels,
                        forecast_steps=steps, cell_impl=cell_impl, head_in_scan=head_in_scan,
                        dtype=dtype, generator=torch.Generator().manual_seed(seed))
    return core.to(device).eval()


def rollout(core, history: int):
    """One chained iteration: the rollout of ``x``, whose first ``history``
    output frames are the next input."""

    def body(x: torch.Tensor) -> torch.Tensor:
        return core(x)[:, :history].to(x.dtype)

    return body


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--size", type=int, default=SIZE)
    p.add_argument("--history", type=int, default=HISTORY_STEPS)
    p.add_argument("--steps", type=int, default=FORECAST_STEPS)
    p.add_argument("--channels", type=int, default=CHANNELS)
    p.add_argument("--hidden", type=int, default=HIDDEN)
    a = p.parse_args(argv)
    batch = int(os.environ.get("BENCH_BATCH", str(BATCH)))
    cell_impl = os.environ.get("BENCH_CELL_IMPL", "fused")
    head_in_scan = os.environ.get("BENCH_HEAD_IN_SCAN", "1") == "1"
    if a.history > a.steps:
        raise ValueError(f"--history {a.history} > --steps {a.steps}: the chain feeds the "
                         "first history output frames back")
    device, card = benchkit.device_and_card(a.device)

    core = build(cell_impl, a.hidden, a.channels, a.steps, head_in_scan, torch.bfloat16, device)
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(batch, a.history, a.size, a.size, a.channels, generator=gen
                   ).to(device, torch.bfloat16)
    body = rollout(core, a.history)
    with torch.inference_mode():
        body(x)  # warm-up: builds the kernels
        x_final, dt, per_forward = benchkit.chain(body, x, a.iters, device)
        float(x_final.float().sum())
    kernels = KERNELS[cell_impl]
    if cell_impl == "cmajor" and not core.runs_cmajor(a.size, a.size):
        kernels = ("K1",)
    benchkit.require(per_forward, [benchkit.step_kernel() if k == "K1" else k for k in kernels],
                     device, f"bench ({cell_impl})")
    frames_per_sec = batch * a.steps / dt
    return benchkit.emit({
        "metric": f"frames/sec/chip, {a.steps}-step {a.size}x{a.size}x{a.channels}ch ConvLSTM "
                  f"rollout (bf16, b{batch})",
        "value": round(frames_per_sec, 2),
        "unit": "frames/s",
        "card": card,
        "kernel_launches": per_forward,
    })


if __name__ == "__main__":
    main()
