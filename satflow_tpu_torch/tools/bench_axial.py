"""Axial-attention kernel K4 against its plain version across head widths.

The port's copy of the JAX package's ``tools/bench_axial.py``: bf16 q, k, v of
(N, L, d) from ``torch.Generator`` seed 0 through
``ops/axial_attention.py::axial_attention`` (K4 on a card) and through
``axial_attention_ref`` (the plain version), each chained 20 times (the output
is the next q), one warm-up call first, CUDA events around the chain, one
scalar fetched at the end. Every shape must lie in ``kernel_takes``' domain
and every kernel call must be a counted launch. Usage::

    python -m satflow_tpu_torch.tools.bench_axial [--device cuda] [--iters 20]

Prints one JSON line a shape: ``{"N", "L", "d", "xla_ms", "pallas_ms",
"speedup"}`` under the JAX tool's names (``xla_ms`` the plain version,
``pallas_ms`` K4), with ``card`` and ``kernel_launches`` (one K4 a call).
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

import torch

from satflow_tpu_torch.tools import benchkit

# (N, L, d): the thin MetNet aggregator, mid, fat self-attention heads
SHAPES = ((98304, 64, 8), (16384, 64, 32), (4096, 64, 64), (2048, 128, 64), (1024, 64, 128),
          (2048, 256, 64))


def parse_shapes(text: str) -> Tuple[Tuple[int, int, int], ...]:
    """``"N,L,d;N,L,d"`` -> the shapes."""
    return tuple(tuple(int(v) for v in s.split(",")) for s in text.split(";") if s)


def bench(fn, q, k, v, iters: int, device: torch.device):
    """(ms a call, launches a call) of ``fn`` chained ``iters`` times."""

    def body(qc):
        return fn(qc, k, v).to(qc.dtype)

    with torch.inference_mode():
        body(q)  # warm-up: builds the kernel
        q_fin, dt, per = benchkit.chain(body, q, iters, device)
        float(q_fin.float().sum())
    return dt * 1e3, per


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--shapes", default=";".join(",".join(map(str, s)) for s in SHAPES),
                   help="N,L,d;N,L,d ... (default: the JAX tool's six)")
    a = p.parse_args(argv)
    from satflow_tpu_torch.ops.axial_attention import (
        axial_attention,
        axial_attention_ref,
        kernel_takes,
    )

    device, card = benchkit.device_and_card(a.device)
    gen = torch.Generator().manual_seed(0)
    out = []
    for n, length, d in parse_shapes(a.shapes):
        q, k, v = (torch.randn(n, length, d, generator=gen).to(device, torch.bfloat16)
                   for _ in range(3))
        if not kernel_takes(q, k, v):
            raise ValueError(f"(N, L, d) = {(n, length, d)} lies outside K4's domain")
        xla_ms, _ = bench(axial_attention_ref, q, k, v, a.iters, device)
        pallas_ms, per = bench(axial_attention, q, k, v, a.iters, device)
        if device.type == "cuda" and per["K4"] != 1:
            raise RuntimeError(f"bench_axial {(n, length, d)}: {per['K4']} K4 launches a call, "
                               "expected 1")
        out.append(benchkit.emit({"N": n, "L": length, "d": d, "xla_ms": xla_ms,
                                  "pallas_ms": pallas_ms, "speedup": round(xla_ms / pallas_ms, 3),
                                  "card": card, "kernel_launches": per}))
    return out


if __name__ == "__main__":
    main()
