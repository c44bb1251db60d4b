"""Serving-path bench on one card: latency and micro-batched throughput.

The port's copy of the JAX package's ``tools/bench_serve.py``. It measures
the flagship ConvLSTM nowcast (24-step 256x256x12ch bf16 rollout, hidden
64, K1 a cell step; weights from ``torch.Generator`` seed 0) through
:mod:`satflow_tpu_torch.serve`:

- single-request latency through an ``InferenceSession`` (each request
  padded to ``--max-batch``): the median of 10 after one warm-up request
  that builds the kernels;
- sustained throughput with ``--clients`` concurrent client threads, each
  sending its share of ``--requests`` through one ``MicroBatcher``
  (``window_ms=10.0``): requests coalesce into one forward. Host clock
  around the whole run; every reply is a host copy, the one sync a request.

Usage::

    python -m satflow_tpu_torch.tools.bench_serve [--max-batch 8] [--clients 16] [--size 256]
        [--device cuda]

Prints one JSON line: the JAX tool's keys (``metric``,
``p50_single_request_ms``, ``concurrent_clients``, ``requests``,
``requests_per_sec``, ``frames_per_sec``, ``forwards_issued``,
``coalescing``), ``card`` and ``kernel_launches`` (a batcher forward's: 62
K1).
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from satflow_tpu_torch.tools import benchkit


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--history", type=int, default=7)
    p.add_argument("--channels", type=int, default=12)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--requests", type=int, default=48)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    from satflow_tpu_torch.core.registry import create_model
    import satflow_tpu_torch.models  # noqa: F401 - populate the registry
    from satflow_tpu_torch.serve import InferenceSession, MicroBatcher

    device, card = benchkit.device_and_card(a.device)
    model = create_model(
        "encoderdecoderconvlstm", input_channels=a.channels, out_channels=a.channels,
        forecast_steps=a.steps, hidden_dim=a.hidden, cell_impl="fused", remat=False,
        generator=torch.Generator().manual_seed(0),
    )
    session = InferenceSession(model, max_batch=a.max_batch,
                               state_dict=model.module.state_dict(), dtype=torch.bfloat16,
                               device=device)

    rng = np.random.default_rng(0)
    sample = rng.random((a.history, a.size, a.size, a.channels), dtype=np.float32)

    # -- latency: sequential single requests (padded to max_batch) -----------
    session.predict(sample)  # warm-up: builds the kernels
    lats = []
    for _ in range(10):
        t0 = time.perf_counter()
        session.predict(sample)
        lats.append(time.perf_counter() - t0)
    lats.sort()
    p50 = lats[len(lats) // 2] * 1000

    # -- throughput: concurrent clients through the micro-batcher ------------
    mb = MicroBatcher(session, window_ms=10.0)
    done = threading.Semaphore(0)
    errors = []

    def client(n_requests):
        try:
            for _ in range(n_requests):
                mb.submit(sample, timeout=300.0)
        except BaseException as e:  # noqa: BLE001 - raised below, in the main thread
            errors.append(e)
        finally:
            done.release()

    per_client = max(1, a.requests // a.clients)
    before = benchkit.launches()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(per_client,), daemon=True)
               for _ in range(a.clients)]
    for t in threads:
        t.start()
    for _ in threads:
        done.acquire()
    dt = time.perf_counter() - t0
    mb.close()
    if errors:
        raise errors[0]
    per_forward = benchkit.per_iteration(before, mb.batches_run)
    benchkit.require(per_forward, [benchkit.step_kernel()], device, "bench_serve")
    total = per_client * a.clients
    frames = total * a.steps
    return benchkit.emit({
        "metric": f"serving {a.size}px F{a.steps} max_batch={a.max_batch}",
        "p50_single_request_ms": round(p50, 1),
        "concurrent_clients": a.clients,
        "requests": total,
        "requests_per_sec": round(total / dt, 2),
        "frames_per_sec": round(frames / dt, 1),
        "forwards_issued": mb.batches_run,
        "coalescing": round(total / max(mb.batches_run, 1), 2),
        "card": card,
        "kernel_launches": per_forward,
    })


if __name__ == "__main__":
    main()
