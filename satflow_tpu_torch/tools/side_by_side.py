"""Run study tools side by side on one card, each process with its share of
the host's threads, all into one ``--out``.

    python -m satflow_tpu_torch.tools.side_by_side --out DIR [--logs DIR]
        [--poll SECONDS] [--stop-after SECONDS] SPEC [SPEC ...]

A SPEC is ``NAME:THREADS:[VAR=VALUE ...] TOOL [ARGS ...]``, for example
``D:1:SATFLOW_HORIZON_EPOCHS=300 horizon_gate --arms convlstm,unet``: the
tool ``satflow_tpu_torch.tools.TOOL`` runs in a process of its own with
``--out DIR`` appended, ``OMP_NUM_THREADS``, ``torch.set_num_threads`` and
OpenCV's threads at THREADS, the variables set, and logging at INFO (the
Trainer's line at the end of every epoch). Each process's output goes to
``LOGS/NAME.log``, every line prefixed with the seconds since the start, and
every ``--poll`` seconds ``nvidia-smi``'s reading of the card (utilization,
memory, power) goes to ``LOGS/card.log``. The tools merge their rows into
the shared results files when they save (``studies.save_results``), so none
is lost to another's. With ``--stop-after`` every process still running at
that time is killed, and its rows are never saved: a probe of the rates.

Prints each process's exit code and wall seconds; exits 1 if any process
failed or was stopped. Every process it starts is stopped before it exits.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import sys
import threading
import time
from typing import Dict, List, Sequence


def _child(threads: int, tool: str, args: Sequence[str]) -> None:
    """The tool's ``__main__`` with ``threads`` intra-op threads and INFO logs."""
    import logging
    import runpy

    import torch

    torch.set_num_threads(threads)
    try:
        import cv2
    except ImportError:
        pass
    else:
        cv2.setNumThreads(threads)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    sys.argv = [tool, *args]
    runpy.run_module(f"satflow_tpu_torch.tools.{tool}", run_name="__main__", alter_sys=True)


def parse_spec(spec: str, out: str) -> Dict:
    """``NAME:THREADS:[VAR=VALUE ...] TOOL [ARGS ...]`` as the process's
    name, command and environment."""
    name, threads, rest = spec.split(":", 2)
    words = shlex.split(rest)
    env = {"OMP_NUM_THREADS": threads, "MKL_NUM_THREADS": threads, "PYTHONUNBUFFERED": "1"}
    while words and "=" in words[0] and not words[0].startswith("-"):
        var, value = words.pop(0).split("=", 1)
        env[var] = value
    if not words:
        raise ValueError(f"{spec!r} names no tool")
    cmd = [sys.executable, "-m", "satflow_tpu_torch.tools.side_by_side", "--child", threads,
           words[0], *words[1:], "--out", out]
    return {"name": name, "cmd": cmd, "env": env}


def _copy_lines(stream, path: str, t0: float) -> None:
    with open(path, "w") as f:
        for line in stream:
            f.write(f"[{time.perf_counter() - t0:9.1f} s] {line}")
            f.flush()


def _poll_card(path: str, every: float, t0: float, done: threading.Event) -> None:
    query = ["nvidia-smi", "--query-gpu=utilization.gpu,memory.used,power.draw",
             "--format=csv,noheader"]
    with open(path, "w") as f:
        f.write("# utilization.gpu, memory.used, power.draw\n")
        while not done.wait(every):
            try:
                read = subprocess.run(query, capture_output=True, text=True)
            except OSError as e:  # no nvidia-smi: a run on the CPU
                f.write(f"{e}\n")
                return
            f.write(f"[{time.perf_counter() - t0:9.1f} s] {read.stdout.strip()}\n")
            f.flush()


def main(specs: List[str], out: str, logs: str, poll: float = 60.0,
         stop_after: float = 0.0) -> int:
    os.makedirs(out, exist_ok=True)
    os.makedirs(logs, exist_ok=True)
    runs = [parse_spec(s, out) for s in specs]
    t0 = time.perf_counter()
    done = threading.Event()
    poller = threading.Thread(target=_poll_card, daemon=True,
                              args=(os.path.join(logs, "card.log"), poll, t0, done))
    poller.start()
    copiers = []
    try:
        for run in runs:
            run["proc"] = subprocess.Popen(run["cmd"], env={**os.environ, **run["env"]},
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True)
            copiers.append(threading.Thread(target=_copy_lines, daemon=True, args=(
                run["proc"].stdout, os.path.join(logs, f"{run['name']}.log"), t0)))
            copiers[-1].start()
            print(f"[{time.perf_counter() - t0:9.1f} s] started {run['name']}: "
                  + " ".join(f"{k}={v}" for k, v in run["env"].items()) + " "
                  + shlex.join(run["cmd"][5:]), flush=True)
        while True:
            for run in runs:
                if "wall" not in run and run["proc"].poll() is not None:
                    run["wall"] = time.perf_counter() - t0
                    print(f"[{run['wall']:9.1f} s] {run['name']} exited "
                          f"{run['proc'].returncode}", flush=True)
            if all("wall" in run for run in runs) or (
                    stop_after and time.perf_counter() - t0 > stop_after):
                break
            time.sleep(1.0)
    finally:
        for run in runs:
            if "proc" in run and run["proc"].poll() is None:
                run["proc"].kill()
                run["stopped"] = True
            if "proc" in run:
                run["proc"].wait()
        done.set()
        for c in copiers:
            c.join()
    failed = False
    for run in runs:
        rc = run["proc"].returncode
        failed |= rc != 0
        wall = run.get("wall", time.perf_counter() - t0)
        print(f"{run['name']}: exit {rc}{' (stopped)' if run.get('stopped') else ''}, "
              f"{wall:.1f} s wall", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        _child(int(sys.argv[2]), sys.argv[3], sys.argv[4:])
        sys.exit(0)
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("specs", nargs="+", metavar="SPEC",
                   help="NAME:THREADS:[VAR=VALUE ...] TOOL [ARGS ...]")
    p.add_argument("--out", required=True, help="the tools' shared --out")
    p.add_argument("--logs", default=None, help="directory of the logs (default: --out)")
    p.add_argument("--poll", type=float, default=60.0,
                   help="seconds between two readings of the card")
    p.add_argument("--stop-after", type=float, default=0.0,
                   help="kill every process still running after this many seconds")
    a = p.parse_args()
    sys.exit(main(a.specs, a.out, a.logs or a.out, a.poll, a.stop_after))
