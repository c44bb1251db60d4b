"""Profiling: ``torch.profiler`` traces and a kernel-level breakdown.

Counterpart of ``satflow_tpu/train/profiling.py`` (there ``jax.profiler`` and
an xplane table by framework op):

- ``Trainer(profiler=...)`` records the whole fit under ``torch.profiler``
  and writes one chrome trace, ``<profile_dir>/trace.json`` (engine.py;
  ``Trainer.profile_path``).
- :func:`capture_trace` records one callable the same way.
- :func:`op_breakdown` reads a trace (or a finished profile) into rows by
  device kernel: its device time, launches and share of all device time,
  and the aten op that launched it, joined through the trace's correlation
  ids (each kernel's ``External id`` is that of the innermost op running on
  the host when it was launched), with the op that called that one (an
  ``aten::copy_`` under ``aten::_to_copy`` is a dtype cast, under
  ``aten::clone`` a layout copy). A trace with no device kernel (a CPU run)
  gives rows by aten op and host self time instead, marked ``"device":
  "cpu"``.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

TRACE_FILE = "trace.json"

# chrome-trace categories of work that runs on the device
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def make_profiler(device: Optional[torch.device] = None) -> torch.profiler.profile:
    """A ``torch.profiler.profile`` of the host ops and, for a CUDA
    ``device``, of the card's kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def write_trace(prof: torch.profiler.profile, out_dir: str) -> str:
    """Export a finished profile as ``<out_dir>/trace.json``; returns the path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


def capture_trace(fn: Callable[[], Any], out_dir: Optional[str] = None,
                  device: Optional[torch.device] = None) -> str:
    """Run ``fn`` under the profiler (and, on a CUDA ``device``, wait for
    the card); returns the directory holding ``trace.json``."""
    out_dir = out_dir or tempfile.mkdtemp(prefix="satflow_prof_")
    with make_profiler(device) as prof:
        fn()
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    write_trace(prof, out_dir)
    return out_dir


def _trace_events(trace_or_profile) -> List[Dict[str, Any]]:
    if isinstance(trace_or_profile, torch.profiler.profile):
        with tempfile.TemporaryDirectory() as tmp:
            path = write_trace(trace_or_profile, tmp)
            with open(path) as f:
                return json.load(f)["traceEvents"]
    path = str(trace_or_profile)
    if os.path.isdir(path):
        path = os.path.join(path, TRACE_FILE)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def op_breakdown(trace_or_profile, top_k: int = 20) -> List[Dict[str, Any]]:
    """The top ``top_k`` rows by time of a trace directory, a trace file or
    a finished ``torch.profiler.profile`` not exported yet (a profile's
    trace can be exported once).

    Each row: ``name`` (the kernel, or the op on the host), ``device``
    (``"cuda"`` or ``"cpu"``), ``us`` (total time), ``calls``, ``share`` (of
    the total over all rows of its kind), ``op`` (the aten op that launched
    the kernel; the op itself on the host) and ``caller`` (the op that
    encloses ``op``); ``"(none)"`` where there is none.
    """
    events = [e for e in _trace_events(trace_or_profile) if e.get("ph") == "X"]
    cpu_ops = [e for e in events if e.get("cat") == "cpu_op"]
    parents = _parents(cpu_ops)
    ops = {e["args"]["External id"]: e for e in cpu_ops if "External id" in e.get("args", {})}
    # a kernel without an External id of its own takes its launch's
    launches = {e["args"]["correlation"]: e["args"].get("External id") for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    device_events = [e for e in events if e.get("cat") in _DEVICE_CATEGORIES]
    totals: Dict[Tuple[str, str, str], List[float]] = defaultdict(lambda: [0.0, 0])

    def name_of(op) -> str:
        return "(none)" if op is None else op["name"]

    if device_events:
        kind = "cuda"
        for e in device_events:
            args = e.get("args", {})
            op = ops.get(args.get("External id") or launches.get(args.get("correlation")))
            row = totals[e["name"], name_of(op), name_of(op and parents[id(op)])]
            row[0] += float(e.get("dur", 0.0))
            row[1] += 1
    else:
        kind = "cpu"
        nested = defaultdict(float)
        for e in cpu_ops:
            if parents[id(e)] is not None:
                nested[id(parents[id(e)])] += e.get("dur", 0.0)
        for e in cpu_ops:
            row = totals[e["name"], e["name"], name_of(parents[id(e)])]
            row[0] += e.get("dur", 0.0) - nested[id(e)]
            row[1] += 1
    total = sum(us for us, _ in totals.values()) or 1.0
    rows = [{"name": name, "device": kind, "us": us, "calls": calls, "share": us / total,
             "op": op, "caller": caller}
            for (name, op, caller), (us, calls) in totals.items()]
    rows.sort(key=lambda r: -r["us"])
    return rows[:top_k]


def _parents(cpu_ops) -> Dict[int, Optional[Dict[str, Any]]]:
    """Each host op's directly enclosing op on its thread (None at the top),
    by ``id`` of the event."""
    parents: Dict[int, Optional[Dict[str, Any]]] = {}
    by_thread = defaultdict(list)
    for e in cpu_ops:
        by_thread[e.get("tid")].append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack: List[Dict[str, Any]] = []
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0.0) <= e["ts"]:
                stack.pop()
            parents[id(e)] = stack[-1] if stack else None
            stack.append(e)
    return parents


def profile_fn(fn: Callable[[], Any], top_k: int = 20, out_dir: Optional[str] = None,
               device: Optional[torch.device] = None) -> Tuple[str, List[Dict[str, Any]]]:
    """Capture and break down in one call; returns (trace directory, rows)."""
    trace_dir = capture_trace(fn, out_dir, device)
    return trace_dir, op_breakdown(trace_dir, top_k)
