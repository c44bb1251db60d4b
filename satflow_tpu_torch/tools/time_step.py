"""Time the fused ConvLSTM step (K1) and its backward (K2) per call on the card.

For each dtype and input width it prints the mean milliseconds per call of
``fused_convlstm_step`` and ``gate_bwd`` over back-to-back launches (CUDA
events), the TFLOP/s of the gate contraction, and the registers and spills
ptxas reported for the two sources. ``--root`` times another checkout of the
package (a directory that holds ``satflow_tpu_torch/``; by default the one
this file lies in), so that two commits can be timed on the same card one
after the other; run it by path::

    python satflow_tpu_torch/tools/time_step.py [--root DIR] [--batch 8]
        [--size 256] [--hidden 64] [--cx 12 64] [--dtypes float32 bfloat16]
        [--calls 20] [--repeats 3]

It needs a CUDA card and imports the package only after ``--root`` is known.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence


def mean_ms(torch, fn: Callable, calls: int, repeats: int) -> float:
    """The best of ``repeats`` means over ``calls`` back-to-back calls, after a
    warm-up of three."""
    for _ in range(3):
        fn()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def registers(log: str, dtype_tag: str, hidden: int) -> str:
    """ptxas' report for the instantiation of ``dtype_tag`` (``f`` for float,
    ``13__nv_bfloat16``) in a build log: "N registers, M bytes spilled"; the
    hidden width is matched where the kernel's name carries it."""
    found = []
    blocks = re.split(r"(?=ptxas info\s*:\s*Compiling entry function)", log)
    for block in blocks:
        name = re.search(r"Compiling entry function '(\w+)'", block)
        regs = re.search(r"Used (\d+) registers", block)
        if not (name and regs and f"kernelI{dtype_tag}" in name.group(1)):
            continue
        width = re.search(rf"kernelI{dtype_tag}Li(\d+)E", name.group(1))
        if width and int(width.group(1)) != hidden:
            continue
        spill = re.search(r"(\d+) bytes spill stores", block)
        found.append(f"{regs.group(1)} registers, {spill.group(1) if spill else '?'} bytes spilled")
    return "; ".join(found) or "not built by this process"


def main(root: Optional[str] = None, batch: int = 8, size: int = 256, hidden: int = 64,
         widths: Sequence[int] = (12, 64), dtypes: Sequence[str] = ("float32", "bfloat16"),
         calls: int = 20, repeats: int = 3) -> Dict[str, float]:
    # by default the checkout this file lies in (run by path, it is not on sys.path)
    sys.path.insert(0, root or str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_step needs a CUDA card")
    from satflow_tpu_torch.ops import _build
    from satflow_tpu_torch.ops import fused_convlstm_step as P

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    print(f"package: {P.__file__}; card: {torch.cuda.get_device_name(0)}", flush=True)
    P.build()  # the sources' nvcc runs side by side
    out = {}
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    for name in dtypes:
        dtype = getattr(torch, name)
        for cx in widths:
            bhw = (batch, size, size)
            args = (rand(*bhw, cx, dtype=dtype), rand(*bhw, hidden, scale=0.5, dtype=dtype),
                    rand(*bhw, hidden, dtype=dtype),
                    rand(3, 3, cx, 4 * hidden, scale=(9 * cx) ** -0.5, dtype=dtype),
                    rand(3, 3, hidden, 4 * hidden, scale=(9 * hidden) ** -0.5, dtype=dtype),
                    rand(4 * hidden, scale=0.1, dtype=dtype))
            cots = (rand(*bhw, hidden, dtype=dtype), rand(*bhw, hidden, dtype=dtype))
            flop = 2 * batch * size * size * 4 * hidden * 9 * (cx + hidden)
            with torch.no_grad():
                k1 = mean_ms(torch, lambda: P.fused_convlstm_step(*args), calls, repeats)
                k2 = mean_ms(torch, lambda: P.gate_bwd(*args, *cots), calls, repeats)
            out[f"k1.{name}.cx{cx}"], out[f"k2.{name}.cx{cx}"] = k1, k2
            print(f"{name} B={batch} {size}x{size} Cx={cx} Ch={hidden}: K1 {k1:.4f} ms "
                  f"({flop / k1 / 1e9:.1f} TFLOP/s), K2 {k2:.4f} ms ({flop / k2 / 1e9:.1f} TFLOP/s)",
                  flush=True)
    for source in ("fused_convlstm_step", "fused_convlstm_step_bwd"):
        log = _build.build_logs.get(source, "")
        for name, tag in (("float32", "f"), ("bfloat16", "13__nv_bfloat16")):
            if name in dtypes:
                print(f"{source} {name} Ch={hidden}: {registers(log, tag, hidden)}", flush=True)
    return out


def _cli(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=None, help="a directory that holds the package to time")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--cx", type=int, nargs="+", default=[12, 64])
    p.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"],
                   choices=("float32", "bfloat16"))
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--repeats", type=int, default=3)
    a = p.parse_args(argv)
    main(a.root, a.batch, a.size, a.hidden, a.cx, a.dtypes, a.calls, a.repeats)


if __name__ == "__main__":
    _cli()
