"""Count the torch.profiler windows that lose kernel events, as
``time_redesign.device_us`` opens them: 50 calls under
``profile(activities=[CUDA])``, synchronised inside the window.

For K3's bare launch (``ops/fused_lstm.py::_launch``, ctypes into the
library nvcc built) and ATen's fused LSTM cell, both at MetNet's bf16
(49 152, 256), it opens windows in turns, with 200 calls between windows as
the timing makes them, until ``--seconds`` have passed. K3's windows come in
three kinds: as ``device_us`` opens them, with one ATen kernel launched after
the 50 calls, and with a 10-ms pause after the synchronisation. A window is
short when the profiler saw fewer than 90 % of its launches; for each one it
prints the seconds since the first window, how many kernels were seen, the
first and last seen kernel's start and the host's last launch (microseconds
from the window's start). Then, for another 60 s, it calls
``time_redesign.device_us`` on K3's launch again and again and counts its
short windows and the calls that raised. It ends with one JSON
line of the counts::

    python -m satflow_tpu_torch.tools.profiler_drops [--seconds 90]

It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import time
from typing import Dict


def window(torch, fn, tail, n: int = 50):
    """(kernels seen, their sorted start times, the host's launch times) of
    one profiled window of ``n`` calls of ``fn()``, ``tail()`` run after the
    synchronisation inside the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0, hosts = time.perf_counter(), []
        for _ in range(n):
            hosts.append((time.perf_counter() - t0) * 1e6)
            fn()
        tail()
        torch.cuda.synchronize()
    starts = sorted(e.time_range.start for e in prof.events() if e.device_type == DeviceType.CUDA)
    return len(starts), starts, hosts


def main(seconds: float = 90.0) -> Dict[str, Dict[str, int]]:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profiler_drops needs a CUDA card")
    from satflow_tpu_torch.ops import fused_lstm as K3
    from satflow_tpu_torch.tools.time_redesign import device_us

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; card: {card}", flush=True)
    gates = torch.randn(49152, 1024, device="cuda").mul_(2).to(torch.bfloat16)
    c = torch.randn(49152, 256, device="cuda").to(torch.bfloat16)
    aten_gates, zeros, tiny = K3.to_aten_order(gates), torch.zeros_like(gates), torch.zeros(
        1, device="cuda")
    kernel = lambda: K3._launch(gates, c)  # noqa: E731
    kinds = {"K3": (kernel, lambda: None),
             "K3, an ATen kernel after": (kernel, lambda: tiny.add_(1)),
             "K3, a 10-ms pause after": (kernel, lambda: (torch.cuda.synchronize(),
                                                           time.sleep(0.01))),
             "ATen's cell": (lambda: torch.ops.aten._thnn_fused_lstm_cell(aten_gates, zeros, c),
                             lambda: None)}
    counts = {k: {"windows": 0, "short": 0, "empty": 0} for k in kinds}
    with torch.no_grad():
        for fn, _ in kinds.values():
            fn()
        torch.cuda.synchronize()
        start, turn = time.time(), 0
        while time.time() - start < seconds:
            for kind, (fn, tail) in kinds.items():
                seen, starts, hosts = window(torch, fn, tail)
                counts[kind]["windows"] += 1
                if seen < 45:
                    counts[kind]["short"] += 1
                    counts[kind]["empty"] += seen == 0
                    span = f"{starts[0]:.1f}-{starts[-1]:.1f}" if starts else "none"
                    print(f"short window at {time.time() - start:.2f} s, {kind}, turn {turn}: "
                          f"{seen} of 50 seen, starts {span} "
                          f"us, the host's last launch {hosts[-1]:.1f} us [{card}]", flush=True)
                for _ in range(200):
                    fn()
                torch.cuda.synchronize()
            turn += 1
        windows_seconds = time.time() - start
        counts["device_us"] = {"calls": 0, "short_windows": 0, "raised": 0}
        start = time.time()
        while time.time() - start < 60.0:
            said = io.StringIO()
            with contextlib.redirect_stdout(said):
                try:
                    device_us(torch, kernel)
                except SystemExit:
                    counts["device_us"]["raised"] += 1
            counts["device_us"]["calls"] += 1
            counts["device_us"]["short_windows"] += said.getvalue().count("fewer than 90 %")
            print(said.getvalue(), end="", flush=True)
    print(json.dumps({"card": card, "seconds": windows_seconds, "counts": counts}), flush=True)
    return counts


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seconds", type=float, default=90.0)
    main(parser.parse_args().seconds)
