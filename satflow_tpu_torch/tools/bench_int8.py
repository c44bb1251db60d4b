"""int8 serving-rollout bench: the int8 rollout against the bf16 one on one card.

The port's copy of the JAX package's ``tools/bench_int8.py``: the full
24-step 256px int8 rollout (``ops/fused_convlstm_int8.py::int8_rollout``:
quantize -> encoder / decoder through K5 -> bf16 head) on the weights
``quantize_convlstm_params`` packs once, against the bf16 rollout of the
same fused-cell ``ConvLSTMCore`` (K1) at the same geometry. Each rollout is
chained: its first ``--history`` output frames are the next input, one
warm-up rollout builds the kernels, CUDA events time the chain and one
scalar is fetched at the end. The JAX tool's ``--block-h`` sweep (its VMEM
tiling) and ``--unroll`` have no meaning on the card; one int8 line stands
for its arms. Usage::

    python -m satflow_tpu_torch.tools.bench_int8 [--batch 48] [--size 256] [--device cuda]

Prints one JSON line per arm: the bf16 line ``{"metric", "value", "unit"}``,
then the int8 line with ``"vs_bf16"``, each with ``card`` and
``kernel_launches`` (62 K1, then 62 K5, a rollout).
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import torch

from satflow_tpu_torch.tools import benchkit
from satflow_tpu_torch.tools.bench import build, rollout


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=48)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--history", type=int, default=7)
    p.add_argument("--channels", type=int, default=12)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    from satflow_tpu_torch.ops.fused_convlstm_int8 import int8_rollout, quantize_convlstm_params

    device, card = benchkit.device_and_card(a.device)
    b, t, s, c = a.batch, a.history, a.size, a.channels
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(b, t, s, s, c, generator=gen).to(device, torch.bfloat16)
    core = build("fused", a.hidden, c, a.steps, True, torch.bfloat16, device)

    def timed(body, what: str, kernel: str):
        with torch.inference_mode():
            body(x)  # warm-up: builds the kernels
            xf, dt, per = benchkit.chain(body, x, a.iters, device)
            float(xf.float().sum())
        benchkit.require(per, [kernel], device, what)
        return b * a.steps / dt, per

    bf16_fps, per = timed(rollout(core, t), "bench_int8 (bf16)", benchkit.step_kernel())
    out = [benchkit.emit({"metric": f"bf16 rollout {s}px b{b} F{a.steps}",
                          "value": round(bf16_fps, 1), "unit": "frames/s", "card": card,
                          "kernel_launches": per})]

    qparams = quantize_convlstm_params(core)

    def int8_body(xc: torch.Tensor) -> torch.Tensor:
        return int8_rollout(qparams, xc.float(), a.steps)[:, :t].to(xc.dtype)

    fps, per = timed(int8_body, "bench_int8 (int8)", "K5")
    out.append(benchkit.emit({"metric": f"int8 rollout {s}px b{b} F{a.steps}",
                              "value": round(fps, 1), "unit": "frames/s",
                              "vs_bf16": round(fps / bf16_fps, 3), "card": card,
                              "kernel_launches": per}))
    return out


if __name__ == "__main__":
    main()
