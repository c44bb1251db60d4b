"""Time the b8 serving forwards and the split train step of the full-width
ConvLSTM and MetNet on the card.

The models at their shipped widths (``convlstm``: hidden 64, 12 channels,
24 steps, K1 a cell step; the same in ``cell_impl`` ``concat``, ``split``
and ``hybrid``: cuDNN gate convs and K3 a cell step; ``metnet``: hidden 64,
8 heads, 24 lead times, K3 and K4), bf16 compute on f32 weights drawn from
``torch.Generator`` seed 0, b8 x 7 x 256x256x12 in, through
``InferenceSession``'s forward on an input already on the card. For each it
prints one JSON line: the mean ms of a forward over back-to-back calls (CUDA
events, the best of ``--repeats`` means), the host's ms per forward (the
wall clock of enqueueing the same calls, before the wait for the card: what
the dispatch costs), the kernels' launches a forward, and a digest of the
reply. Then one line for the ``split`` model's train step (bf16,
``remat_chunk=6``, Adam, a b8 batch of 24 targets on the card): the mean ms
of a step (host clock, synchronised; the best of ``--repeats`` means of 3
steps) and its launches. ``--root`` times another checkout of the package
(a directory that holds ``satflow_tpu_torch/``), so that two commits are
timed on one card in turns; run it by path::

    python satflow_tpu_torch/tools/time_forwards.py [--root DIR] [--calls 10]
        [--repeats 3]

It needs a CUDA card and imports the package only after ``--root`` is known.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    p.add_argument("--calls", type=int, default=10)
    p.add_argument("--repeats", type=int, default=3)
    a = p.parse_args(argv)
    sys.path.insert(0, a.root)
    import torch

    import satflow_tpu_torch
    from satflow_tpu_torch.models import create_model
    from satflow_tpu_torch.ops.axial_attention import axial_attention
    from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates
    from satflow_tpu_torch.serve import InferenceSession

    if not torch.cuda.is_available():
        raise SystemExit("time_forwards needs a CUDA card")
    if not Path(satflow_tpu_torch.__file__).resolve().is_relative_to(Path(a.root).resolve()):
        raise SystemExit(f"imported {satflow_tpu_torch.__file__}, not the package under {a.root}")
    counters = (fused_convlstm_step, fused_lstm_gates, axial_attention)
    gen = torch.Generator().manual_seed(0)
    convlstm = dict(input_channels=12, out_channels=12, forecast_steps=24, hidden_dim=64,
                    generator=gen)
    models = {
        "convlstm": create_model("encoderdecoderconvlstm", **convlstm),
        **{impl: create_model("encoderdecoderconvlstm", cell_impl=impl, **convlstm)
           for impl in ("concat", "split", "hybrid")},
        "metnet": create_model("litmetnet", input_channels=12, output_channels=12,
                               hidden_dim=64, forecast_steps=24, generator=gen),
    }
    x = torch.rand(8, 7, 256, 256, 12, generator=gen)
    for name, model in models.items():
        model.materialize((x[:1], x[:1]))
        session = InferenceSession(model, max_batch=8, state_dict=model.module.state_dict(),
                                   dtype=torch.bfloat16, device="cuda")
        xd = x.to("cuda")
        for _ in range(3):
            session._forward(xd)
        for c in counters:
            c.launches = 0
        y = session._forward(xd)
        launches = [c.launches for c in counters]
        best, host = float("inf"), float("inf")
        for _ in range(a.repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            for _ in range(a.calls):
                session._forward(xd)
            end.record()
            host = min(host, (time.perf_counter() - t0) * 1e3 / a.calls)
            end.synchronize()
            best = min(best, start.elapsed_time(end) / a.calls)
        digest = hashlib.sha256(y.float().cpu().numpy().tobytes()).hexdigest()[:16]
        print(json.dumps({"model": name, "root": a.root, "forward_ms": best,
                          "host_ms_per_forward": host, "launches_k1_k3_k4": launches,
                          "reply_sha256": digest}), flush=True)
        del session, model
        torch.cuda.empty_cache()
    train_step(a, torch, create_model, convlstm, x, counters)


def train_step(a, torch, create_model, convlstm: dict, x, counters) -> None:
    """The ``split`` model's b8 train step: bf16 compute on f32 weights,
    ``remat_chunk=6``, Adam; one JSON line."""
    from satflow_tpu_torch.train.state import TrainState
    from satflow_tpu_torch.train.steps import make_train_step

    model = create_model("encoderdecoderconvlstm", cell_impl="split", remat=True,
                         remat_chunk=6, **convlstm)
    model.set_compute_dtype(torch.bfloat16)
    model.to("cuda")
    state = TrainState(model, model.make_optimizer())
    step = make_train_step(model)
    gen = torch.Generator().manual_seed(1)
    batch = (x.to("cuda"), torch.rand(8, 24, 256, 256, 12, generator=gen).to("cuda"))
    for _ in range(2):
        step(state, batch)
    for c in counters:
        c.launches = 0
    step(state, batch)
    launches = [c.launches for c in counters]
    best = float("inf")
    for _ in range(a.repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step(state, batch)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3 / 3)
    print(json.dumps({"model": "split train step", "root": a.root, "step_ms": best,
                      "launches_k1_k3_k4": launches}), flush=True)


if __name__ == "__main__":
    main()
