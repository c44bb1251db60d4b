"""Check and time the axial attention (K4), the channel-major 3x3 head (K6b)
and the zero-padded hidden widths of the fused step (K1, K2) on the card.

It builds the sources, prints ptxas' registers and spills and the HMMA / LDSM
counts in the SASS of K4's and K6b's kernels, holds each kernel against its
plain version at the listed shapes and at the edges of every regime, and then
(unless ``--check-only``) prints the mean milliseconds per call over
back-to-back launches (CUDA events) beside the plain version, the one library
call that computes the same function, and the bound. ``--root`` times another
checkout of the package, so that two commits can be read on one card one after
the other; run it by path::

    python satflow_tpu_torch/tools/time_redesign.py [--root DIR] [--check-only]
        [--calls 20] [--repeats 3]

It needs a CUDA card and imports the package only after ``--root`` is known.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, Optional

#: (N, L, D): MetNet's, the two shapes at the regimes' boundary, the long-axis three
K4_SHAPES = ((24576, 16, 8), (16384, 64, 32), (4096, 64, 64), (2048, 128, 64), (2048, 256, 64),
             (256, 512, 256))
#: the edges of every regime: L = 1, 17, 32, 33, 100, 512; D = 1, 8, 24, 32, 33, 100, 256;
#: N = 1 and an N that is no multiple of the batch rows per block
K4_EDGES = ((1, 1, 1), (7, 17, 8), (33, 17, 24), (5, 32, 32), (3, 33, 32), (3, 32, 33),
            (3, 100, 100), (2, 512, 1), (1, 512, 256), (37, 16, 8), (4, 100, 24), (3, 130, 24),
            (1001, 1, 8), (2, 64, 256), (5, 65, 16))
#: (B, H, W, Cin, Cout): the head's shape, then the edges
K6B_SHAPES = ((8, 256, 256, 64, 12), (2, 10, 18, 1, 1), (2, 10, 18, 12, 16), (1, 50, 72, 12, 1),
              (2, 33, 40, 128, 16), (1, 7, 5, 64, 12), (3, 16, 64, 20, 5))
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=1e-2, rtol=2 ** -7)}
TOL_HEAD = {"float32": dict(atol=1e-4, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
HBM_BYTES_PER_S = 3.35e12
PEAK = {"bfloat16": 989e12, "float32": 67e12}


def mean_ms(torch, fn, calls: int, repeats: int) -> float:
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


def ptxas_report(log: str) -> list:
    """(kernel name, registers, spilled bytes) for every entry function in a build log."""
    out = []
    for block in re.split(r"(?=ptxas info\s*:\s*Compiling entry function)", log):
        name = re.search(r"Compiling entry function '(\w+)'", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        if name and regs:
            out.append((name.group(1), int(regs.group(1)),
                        int(spill.group(1)) + int(spill.group(2)) if spill else -1))
    return out


def sass_counts(nvcc: str, library: str, fragment: str) -> Dict[str, Dict[str, int]]:
    """{function: {op: count}} for the functions of a built library whose
    mangled name contains ``fragment``."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out, function = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            function = line.split("Function :")[1].strip()
            function = function if fragment in function else None
            if function:
                out[function] = {"HMMA": 0, "LDSM": 0, "LDGSTS": 0, "FFMA": 0}
        elif function:
            for op in out[function]:
                if f" {op}" in line:
                    out[function][op] += 1
    return out


def max_err(torch, got, want, tol, what: str) -> float:
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if not bool((diff <= tol["atol"] + tol["rtol"] * want.float().abs()).all()):
        raise SystemExit(f"time_redesign: {what}: max|diff| {err:.3g} beyond {tol}")
    return err


def main(root: Optional[str] = None, check_only: bool = False, calls: int = 20,
         repeats: int = 3) -> Dict[str, float]:
    sys.path.insert(0, root or str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_redesign needs a CUDA card")
    from satflow_tpu_torch.ops import _build
    from satflow_tpu_torch.ops import axial_attention as A
    from satflow_tpu_torch.ops import cmajor_convlstm as CM
    from satflow_tpu_torch.ops import fused_convlstm_step as P

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"package: {A.__file__}; card: {card}", flush=True)
    libs = _build.load_all(["axial_attention", "cmajor_convlstm", "fused_convlstm_step",
                            "fused_convlstm_step_bwd"])
    for source, fragment in (("axial_attention", "axial_attention"),
                             ("cmajor_convlstm", "cmajor_conv")):
        for name, regs, spilled in ptxas_report(_build.build_logs.get(source, "")):
            if fragment in name:
                print(f"ptxas {source}: {name}: {regs} registers, {spilled} bytes spilled",
                      flush=True)
        for fn, ops in sass_counts(_build.find_nvcc(), libs[source]._name, fragment).items():
            print(f"SASS {source}: {fn}: " + ", ".join(f"{k} {v}" for k, v in ops.items()),
                  flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    out: Dict[str, float] = {}
    regime = getattr(A, "regime", lambda *a: "one kernel")
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        for shape in K4_SHAPES + K4_EDGES:
            q, k, v = (rand(*shape, dtype=dtype) for _ in range(3))
            before = A.axial_attention.launches
            got = A.axial_attention(q, k, v)
            torch.cuda.synchronize()
            assert A.axial_attention.launches == before + 1, shape
            err = max_err(torch, got, A.axial_attention_ref(q, k, v), TOL[name],
                          f"K4 {name} {shape}")
            print(f"K4 vs plain: {name} {shape} ({regime(shape[1], shape[2], dtype)}): "
                  f"max|diff| {err:.3g} ok", flush=True)
        for b, h, w, cin, cout in K6B_SHAPES:
            x = rand(b, cin, h * w, dtype=dtype)
            wt = rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5, dtype=dtype)
            bias = rand(cout, scale=0.1, dtype=dtype)
            before = CM.cmajor_conv3x3.launches
            got = CM.cmajor_conv3x3(x, wt, bias, h, w)
            torch.cuda.synchronize()
            assert CM.cmajor_conv3x3.launches == before + 1
            err = max_err(torch, got, CM.cmajor_conv3x3_ref(x, wt, bias, h, w), TOL_HEAD[name],
                          f"K6b {name} B={b} {h}x{w} {cin}->{cout}")
            print(f"K6b vs plain: {name} B={b} {h}x{w} {cin} -> {cout}: max|diff| {err:.3g} ok",
                  flush=True)
    if check_only:
        return out

    def sdpa(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(q[:, None], k[:, None],
                                                                v[:, None])[:, 0]

    with torch.no_grad():
        for name in ("bfloat16", "float32"):
            dtype = getattr(torch, name)
            for shape in K4_SHAPES:
                q, k, v = (rand(*shape, dtype=dtype) for _ in range(3))
                n, length, d = shape
                flop = 4 * n * length * length * d
                bound = max(4 * q.numel() * q.element_size() / HBM_BYTES_PER_S, flop / PEAK[name])
                t = {what: mean_ms(torch, lambda fn=fn: fn(q, k, v), calls, repeats)
                     for what, fn in (("kernel", A.attention_kernel),
                                      ("plain", A.axial_attention_ref), ("library", sdpa))}
                out[f"k4.{name}.{shape}"] = t["kernel"]
                print(f"K4 {name} {shape} ({regime(length, d, dtype)}): kernel "
                      f"{t['kernel'] * 1e3:.1f} us ({flop / t['kernel'] / 1e9:.1f} TFLOP/s), plain "
                      f"{t['plain'] * 1e3:.1f} us, scaled_dot_product_attention "
                      f"{t['library'] * 1e3:.1f} us, bound {bound * 1e6:.1f} us [{card}]",
                      flush=True)
            b, h, w, cin, cout = K6B_SHAPES[0]
            x = rand(b, cin, h * w, dtype=dtype)
            wt = rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5, dtype=dtype)
            bias = rand(cout, scale=0.1, dtype=dtype)

            def conv2d():
                return torch.nn.functional.conv2d(x.view(b, cin, h, w), wt.permute(3, 2, 0, 1),
                                                  bias, padding=1)

            t = {"kernel": mean_ms(torch, lambda: CM.cmajor_conv3x3(x, wt, bias, h, w), calls,
                                   repeats),
                 "plain": mean_ms(torch, lambda: CM.cmajor_conv3x3_ref(x, wt, bias, h, w), calls,
                                  repeats),
                 "library": mean_ms(torch, conv2d, calls, repeats)}
            moved = (x.numel() + b * cout * h * w + wt.numel() + cout) * x.element_size()
            bound = max(moved / HBM_BYTES_PER_S, 2 * b * h * w * cout * 9 * cin / PEAK[name])
            out[f"k6b.{name}"] = t["kernel"]
            print(f"K6b {name} B={b} {h}x{w} {cin} -> {cout}: kernel {t['kernel']:.4f} ms, plain "
                  f"{t['plain']:.4f} ms, conv2d {t['library']:.4f} ms, bound {bound * 1e3:.4f} ms "
                  f"[{card}]", flush=True)

        # the fused step at a hidden width that is padded, beside the width it is padded to
        for dtype in (torch.bfloat16, torch.float32):
            for cx, ch in ((12, 24), (12, 32), (24, 24), (32, 32), (12, 12), (12, 16)):
                bhw = (8, 256, 256)
                args = (rand(*bhw, cx, dtype=dtype), rand(*bhw, ch, scale=0.5, dtype=dtype),
                        rand(*bhw, ch, dtype=dtype),
                        rand(3, 3, cx, 4 * ch, scale=(9 * cx) ** -0.5, dtype=dtype),
                        rand(3, 3, ch, 4 * ch, scale=(9 * ch) ** -0.5, dtype=dtype),
                        rand(4 * ch, scale=0.1, dtype=dtype))
                cots = (rand(*bhw, ch, dtype=dtype), rand(*bhw, ch, dtype=dtype))
                try:
                    k1 = mean_ms(torch, lambda: P.fused_convlstm_step(*args), calls, repeats)
                    k2 = mean_ms(torch, lambda: P.gate_bwd(*args, *cots), calls, repeats)
                except ValueError as e:  # a checkout whose kernels refuse the width
                    print(f"K1 {str(dtype)[6:]} Cx={cx} Ch={ch}: refused ({str(e)[:60]}...)",
                          flush=True)
                    continue
                out[f"k1.{str(dtype)[6:]}.cx{cx}.ch{ch}"] = k1
                print(f"K1, K2 {str(dtype)[6:]} B=8 256x256 Cx={cx} Ch={ch}: K1 {k1:.4f} ms, K2 "
                      f"{k2:.4f} ms a call [{card}]", flush=True)
    return out


def _cli(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=None, help="a directory that holds the package to time")
    p.add_argument("--check-only", action="store_true", help="build and check, time nothing")
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--repeats", type=int, default=3)
    a = p.parse_args(argv)
    main(a.root, a.check_only, a.calls, a.repeats)


if __name__ == "__main__":
    _cli()
