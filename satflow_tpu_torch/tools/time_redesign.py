"""Check and time the axial attention (K4), the channel-major 3x3 head (K6b),
the LSTM gate tail (K3) and the zero-padded hidden widths of the fused step
(K1, K2) on the card.

It builds the sources, prints ptxas' registers and spills and the HMMA / LDSM
counts in the SASS of K4's and K6b's kernels, holds each kernel against its
plain version at the listed shapes and at the edges of every regime, and then
(unless ``--check-only``) prints the mean milliseconds per call over
back-to-back launches (CUDA events) beside the plain version, the one library
call that computes the same function, and the bound. K3's library call is
ATen's fused LSTM cell on the gates permuted once to its column order, with a
zero second gate input; it is held against K3's plain version as K3 is, and
its bytes add that input and the (N, 4C) workspace it writes. ``--root`` times another
checkout of the package, so that two commits can be read on one card one after
the other; run it by path::

    python satflow_tpu_torch/tools/time_redesign.py [--root DIR] [--check-only]
        [--k3-only] [--calls 20] [--repeats 3]

``--k3-only`` checks and times K3 alone. Both of its kernels (the vector one
and the per-element one, by ``ops/fused_lstm.py::vector_path``) are held
against the plain version at K3's shapes, at odd widths and on offset views,
each launch counted on its path. Then, for both dtypes and both shapes, it
prints K3's device time (torch.profiler), a bare launch and a launch through
the op ``satflow::fused_lstm_gates`` back to back (CUDA events; the median
and the least of the windows, the verdict from the medians), and ATen's
cell; and the host time of a launch taken apart piece by piece
(``perf_counter_ns`` over 10^4 calls each, at a 64-row shape whose kernel is
shorter than its launch). A checkout without the vector kernel skips what it
lacks.

It needs a CUDA card and imports the package only after ``--root`` is known.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys
import time
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
#: (N, C): K3's rows on MetNet's path, and on the concat forward's
K3_SHAPES = ((49152, 64), (524288, 64))
#: (N, C): widths on both sides of the vector kernel's rule (C % 8 in bf16, C % 4 in f32)
K3_ODD = ((1001, 1), (1001, 3), (777, 12), (513, 65), (300, 256))
#: back-to-back calls a K3 time is the mean of
K3_CALLS = 200
#: rows of the shape a launch's host time is taken apart at (its kernel is
#: short), beside MetNet's
K3_HOST_ROWS = 64
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


def lstm_tail_bytes(rows: int, channels: int, itemsize: int, aten: bool = False) -> int:
    """Bytes the gate tail moves, each tensor once: the 4C gates and c in, h'
    and c' out; ATen's cell also reads its zero second gate input and writes
    its (N, 4C) workspace."""
    return rows * channels * (7 + (8 if aten else 0)) * itemsize


def device_us(torch, fn, n: int = 50, kernels: int = 1) -> float:
    """Mean device microseconds per call of ``fn()``, which launches
    ``kernels`` kernels: their mean device time as torch.profiler read it
    over ``n`` warm calls, times ``kernels``. The profiler may drop a few
    events of a window, so the mean is over the kernels it saw, which must be
    at least 90 % of the launches. On the H100 it was measured on (torch
    2.11, CUDA 12.8) the profiler loses the later
    kernel events of every window that overlaps a short interval (up to
    three windows in a row, under 0.2 s) which comes back every ~10-12 s,
    for any kernel (``tools/profiler_drops.py``). A window where it saw fewer is
    said so and measured again after a 1-s pause, which clears that
    interval, up to three windows; then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for window in range(3):
        if window:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        seen = sum(e.count for e in events)
        if seen >= 0.9 * n * kernels:
            return sum(e.self_device_time_total for e in events) / seen * kernels
        print(f"time_redesign: the profiler saw {seen} kernels of {n * kernels} launches, "
              "fewer than 90 %", flush=True)
    raise SystemExit(f"time_redesign: the profiler saw fewer than 90 % of the {n * kernels} "
                     "launches in each of 3 windows")


def back_to_back(torch, fn, calls: int = 200, repeats: int = 3):
    """[(device, host)] microseconds a call, one pair for each of ``repeats``
    windows of ``calls`` back-to-back calls of ``fn()``: the device's from
    CUDA events around the loop, the host's from ``perf_counter_ns`` around
    the same loop (it equals the device's when the host sets the pace)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter_ns()
        end.record()
        end.synchronize()
        windows.append((start.elapsed_time(end) * 1e3 / calls, (t1 - t0) / 1e3 / calls))
    return windows


def host_us(torch, fn, n: int = 10_000, repeats: int = 3) -> float:
    """Host microseconds per call of ``fn()``: the best of ``repeats`` runs of
    ``n`` calls timed with ``perf_counter_ns``, the device synchronised after
    each run (outside the timing)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter_ns() - t0) / n / 1e3)
        torch.cuda.synchronize()
    return best


def k3_host_breakdown(torch, K3, _build, card: str, rows: int, n: int = 10_000
                      ) -> Dict[str, float]:
    """The host time of one K3 launch taken apart, at a (rows, 256) bf16
    shape: the whole paths (the public entry, the op, the bare launch) and
    each piece the launch is made of, alone; microseconds per call. Where the
    kernel is longer than a launch (MetNet's 49 152 rows), a whole path reads
    the device's pace instead: the launch queue fills."""
    dtype = torch.bfloat16
    g = torch.randn(rows, 256, device="cuda").to(dtype)
    c = torch.randn(rows, 64, device="cuda").to(dtype)
    dev = c.get_device()
    argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
    lib = _build.load_typed(K3._SOURCE, K3._ENTRY.values(), argtypes)
    h_out, c_out = torch.empty_like(c), torch.empty_like(c)
    args = (g.data_ptr(), c.data_ptr(), h_out.data_ptr(), c_out.data_ptr(), rows, 64,
            dev, torch.cuda.current_stream().cuda_stream)
    element = getattr(lib, K3._ENTRY[dtype])
    pieces = [
        ("public entry fused_lstm_gates (no grad)", lambda: K3.fused_lstm_gates(g, c)),
        ("the op satflow::fused_lstm_gates",
         lambda: torch.ops.satflow.fused_lstm_gates.default(g, c)),
        ("bare launch _launch", lambda: K3._launch(g, c)),
        ("_check", lambda: K3._check(g, c)),
        ("two .contiguous()", lambda: (g.contiguous(), c.contiguous())),
        ("two torch.empty_like", lambda: (torch.empty_like(c), torch.empty_like(c))),
        ("torch.cuda.current_stream(device).cuda_stream",
         lambda: torch.cuda.current_stream(c.device).cuda_stream),
        ("four data_ptr()", lambda: (g.data_ptr(), c.data_ptr(), h_out.data_ptr(),
                                     c_out.data_ptr())),
        ("_build.load_typed (typing the entry points)",
         lambda: _build.load_typed(K3._SOURCE, K3._ENTRY.values(), argtypes)),
        ("per-element entry point alone (ctypes, the C side, the launch)",
         lambda: element(*args)),
    ]
    if hasattr(torch._C, "_cuda_getCurrentRawStream"):
        pieces.append(("torch._C._cuda_getCurrentRawStream(device)",
                       lambda: torch._C._cuda_getCurrentRawStream(dev)))
    if hasattr(K3, "_entry"):
        vec = K3._entry(True, dtype)[1]
        pieces += [("cached entry lookup _entry", lambda: K3._entry(True, dtype)),
                   ("vector_path", lambda: K3.vector_path(g, c)),
                   ("vector entry point alone (ctypes, the C side, the launch)",
                    lambda: vec(*args))]
    out = {}
    with torch.no_grad():
        for what, fn in pieces:
            out[what] = host_us(torch, fn, n)
            print(f"K3 host time, {what}: {out[what]:.2f} us a call (perf_counter_ns over "
                  f"{n} calls, best of 3; bf16 ({rows}, 256)) [{card}]", flush=True)
    return out


def k3_times(torch, K3, gates, c, calls: int, repeats: int) -> Dict[str, float]:
    """K3 at one shape, microseconds a call: device time (profiler) of a bare
    launch and of ATen's cell, and, over windows of ``calls`` back-to-back
    calls (CUDA events, and the host's enqueue loop beside them,
    ``<what>_host``), the bare launch, the launch through the op, ATen's cell
    and the plain version, in turns, ``repeats`` windows a turn and two turns
    each: the median of the windows under ``<what>``, the least under
    ``<what>_min``. Where the host sets the pace the windows spread with the
    shared host, and the median is the one to compare."""
    aten_gates, zeros = K3.to_aten_order(gates), torch.zeros_like(gates)
    fns = {"kernel": lambda: K3._launch(gates, c),
           "op": lambda: torch.ops.satflow.fused_lstm_gates.default(gates, c),
           "library": lambda: torch.ops.aten._thnn_fused_lstm_cell(aten_gates, zeros, c),
           "plain": lambda: K3.fused_lstm_gates_ref(gates, c)}
    with torch.no_grad():
        t = {"device": device_us(torch, fns["kernel"]),
             "library_device": device_us(torch, fns["library"])}
        order = ["library", "op", "kernel", "plain"]
        runs = {k: [] for k in order}
        for what in order + order[::-1]:  # in turns
            runs[what] += back_to_back(torch, fns[what], calls, repeats)
    for k, v in runs.items():
        t[k] = statistics.median(d for d, _ in v)
        t[f"{k}_min"] = min(d for d, _ in v)
        t[f"{k}_host"] = statistics.median(h for _, h in v)
    return t


def k3_main(torch, K3, _build, card: str, check_only: bool, calls: int, repeats: int
            ) -> Dict[str, float]:
    """``--k3-only``: both of K3's kernels checked, then timed (see the
    module's docstring)."""
    out: Dict[str, float] = {}
    vector_rule = getattr(K3, "vector_path", None)
    counts = lambda: (K3.fused_lstm_gates.launches,  # noqa: E731
                      getattr(K3.fused_lstm_gates, "vector_launches", 0),
                      getattr(K3.fused_lstm_gates, "element_launches", 0))
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        for n, ch in K3_SHAPES + K3_ODD + ((4096, 64),):
            gates = torch.randn(n * 4 * ch + 8, device="cuda").mul_(2).to(dtype)
            c = torch.randn(n * ch + 8, device="cuda").to(dtype)
            views = [("", gates[:n * 4 * ch].view(n, 4 * ch), c[:n * ch].view(n, ch))]
            if (n, ch) == (4096, 64):  # offset views: one element, and 16 bytes
                views = [(" gates offset by one element", gates[1:1 + n * 4 * ch].view(n, 4 * ch),
                          c[:n * ch].view(n, ch)),
                         (" c offset by one element", gates[:n * 4 * ch].view(n, 4 * ch),
                          c[1:1 + n * ch].view(n, ch)),
                         (" both offset by 16 bytes", gates[16 // gates.element_size():][
                             :n * 4 * ch].view(n, 4 * ch),
                          c[16 // c.element_size():][:n * ch].view(n, ch))]
            for what, g, cc in views:
                before = counts()
                got = K3._launch(g, cc)
                torch.cuda.synchronize()
                after = counts()
                path = ("vector" if after[1] > before[1] else "element" if after[2] > before[2]
                        else "one kernel")
                if after[0] != before[0] + 1 or (vector_rule is not None and (
                        (path == "vector") != vector_rule(g, cc)
                        or after[1] + after[2] != before[1] + before[2] + 1)):
                    raise SystemExit(f"time_redesign: K3 {name} ({n}, {4 * ch}){what}: counts "
                                     f"{before} -> {after}")
                want = K3.fused_lstm_gates_ref(g, cc)
                err = max(max_err(torch, a, b, TOL[name], f"K3 {name} ({n}, {4 * ch}){what}")
                          for a, b in zip(got, want))
                print(f"K3 vs plain: {name} ({n}, {4 * ch}){what}: the {path} kernel, max|diff| "
                      f"{err:.3g} ok", flush=True)
    if check_only:
        return out
    for name in ("bfloat16", "float32"):
        dtype = getattr(torch, name)
        for n, ch in K3_SHAPES:
            gates = (torch.randn(n, 4 * ch, device="cuda") * 2).to(dtype)
            c = torch.randn(n, ch, device="cuda").to(dtype)
            t = k3_times(torch, K3, gates, c, K3_CALLS, repeats)
            moved = lstm_tail_bytes(n, ch, c.element_size())
            bound = max(moved / HBM_BYTES_PER_S, 30 * n * ch / PEAK["float32"]) * 1e6
            for k, v in t.items():
                out[f"k3.{name}.{n}.{k}"] = v
            print(f"K3 {name} ({n}, {4 * ch}): device {t['device']:.2f} us "
                  f"({100 * bound / t['device']:.1f} % of the {bound:.2f} us byte bound); "
                  f"{K3_CALLS} calls back to back, the median of {2 * repeats} windows (the "
                  f"least, and the host's loop's median, in brackets): bare launch "
                  f"{t['kernel']:.2f} us ({t['kernel_min']:.2f}; {t['kernel_host']:.2f}), "
                  f"through the op {t['op']:.2f} us ({t['op_min']:.2f}; {t['op_host']:.2f}), "
                  f"aten._thnn_fused_lstm_cell {t['library']:.2f} us ({t['library_min']:.2f}; "
                  f"{t['library_host']:.2f}; device {t['library_device']:.2f}), plain "
                  f"{t['plain']:.2f} us; by the medians the op "
                  f"{'wins' if t['op'] <= t['library'] else 'LOSES'} [{card}]", flush=True)
    for rows in (K3_HOST_ROWS, K3_SHAPES[0][0]):
        k3_host_breakdown(torch, K3, _build, card, rows)
    return out


def max_err(torch, got, want, tol, what: str) -> float:
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if not bool((diff <= tol["atol"] + tol["rtol"] * want.float().abs()).all()):
        raise SystemExit(f"time_redesign: {what}: max|diff| {err:.3g} beyond {tol}")
    return err


def main(root: Optional[str] = None, check_only: bool = False, calls: int = 20,
         repeats: int = 3, k3_only: bool = False) -> Dict[str, float]:
    sys.path.insert(0, root or str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_redesign needs a CUDA card")
    from satflow_tpu_torch.ops import _build
    from satflow_tpu_torch.ops import axial_attention as A
    from satflow_tpu_torch.ops import cmajor_convlstm as CM
    from satflow_tpu_torch.ops import fused_convlstm_step as P
    from satflow_tpu_torch.ops import fused_lstm as K3

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"package: {A.__file__}; card: {card}", flush=True)
    if k3_only:
        _build.load("fused_lstm_gates")
        print(_build.build_logs.get("fused_lstm_gates", "").strip(), flush=True)
        return k3_main(torch, K3, _build, card, check_only, calls, repeats)
    libs = _build.load_all(["axial_attention", "cmajor_convlstm", "fused_convlstm_step",
                            "fused_convlstm_step_bwd", "fused_lstm_gates"])
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
    aten_cell = torch.ops.aten._thnn_fused_lstm_cell
    k3_inputs = {}
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
        for n, ch in K3_SHAPES:
            gates, c = rand(n, 4 * ch, scale=2.0, dtype=dtype), rand(n, ch, dtype=dtype)
            aten_gates = K3.to_aten_order(gates)
            zeros = torch.zeros_like(gates)
            want = K3.fused_lstm_gates_ref(gates, c)
            for what, got in (("K3", K3._launch(gates, c)),
                              ("aten._thnn_fused_lstm_cell", aten_cell(aten_gates, zeros, c)[:2])):
                err = max(max_err(torch, a, b, TOL[name], f"{what} {name} ({n}, {4 * ch})")
                          for a, b in zip(got, want))
                print(f"{what} vs K3's plain version: {name} ({n}, {4 * ch}): max|diff| "
                      f"{err:.3g} ok", flush=True)
            k3_inputs[name, n] = gates, c, aten_gates, zeros
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
            for n, ch in K3_SHAPES:
                gates, c, aten_gates, zeros = k3_inputs[name, n]
                t = {what: mean_ms(torch, fn, calls, repeats) for what, fn in (
                    ("kernel", lambda: K3._launch(gates, c)),
                    ("plain", lambda: K3.fused_lstm_gates_ref(gates, c)),
                    ("library", lambda: aten_cell(aten_gates, zeros, c)))}
                moved, aten_moved = (lstm_tail_bytes(n, ch, c.element_size(), aten)
                                     for aten in (False, True))
                # ~30 f32 operations per state element: three sigmoids, two tanh, the sums
                bound = max(moved / HBM_BYTES_PER_S, 30 * n * ch / PEAK["float32"])
                out[f"k3.{name}.{n}"] = t["kernel"]
                print(f"K3 {name} ({n}, {4 * ch}): kernel {t['kernel'] * 1e3:.2f} us, plain "
                      f"{t['plain'] * 1e3:.2f} us, aten._thnn_fused_lstm_cell "
                      f"{t['library'] * 1e3:.2f} us ({aten_moved - moved} bytes more than K3's "
                      f"{moved}), bound {bound * 1e6:.2f} us [{card}]", flush=True)
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
    p.add_argument("--k3-only", action="store_true", help="check and time K3 alone")
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--repeats", type=int, default=3)
    a = p.parse_args(argv)
    main(a.root, a.check_only, a.calls, a.repeats, a.k3_only)


if __name__ == "__main__":
    _cli()
