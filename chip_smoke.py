#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card.

Run from the root of the repository, with one card visible:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. the card's name and power limit (nvidia-smi); a CUDA card is required;
2. build the fused ConvLSTM-step kernel from ``satflow_tpu_torch/csrc``;
3. the kernel against its plain PyTorch version at the serving shapes
   (B=8, 256x256, Cx 12 and 64, Ch 64), in float32 and bfloat16, with the
   image's first and last rows and columns checked on their own;
4. the slice: the full-width ``EncoderDecoderConvLSTM`` (hidden 64, 12
   channels in and out, 24 forecast steps, weights from numpy seed 0 in the
   flax layout) behind ``NowcastServer`` answers 5 concurrent requests; the
   replies are checked, the kernel's launches counted, and one reply held
   against the same rollout through the plain step;
5. timings with CUDA events: the kernel against the plain version per call,
   and the b8 forward through each;
6. a JSON line of the kernels, and last a JSON line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.
"""

from __future__ import annotations

import http.client
import io
import json
import subprocess
import sys
import threading
import time

import numpy as np

B, T, H, W, CIN, HIDDEN, COUT, STEPS = 8, 7, 256, 256, 12, 64, 12, 24
DEVICE = "cuda"
LAUNCHES_PER_FORWARD = 2 * T + 2 * STEPS  # one kernel launch per cell step

# Tolerances, |kernel - plain| <= atol + rtol * |plain|:
# - float32, TF32 off on both sides: both sum the same 9*(Cx+Ch) products in
#   f32, only in another order (and with another algorithm in cuDNN), so they
#   agree to a few f32 rounding steps of gates of size ~1.
TOL_F32 = dict(atol=1e-4, rtol=1e-5)
# - bfloat16: both store h' and c' in bf16, whose step is 2^-8 relative; the
#   plain version also rounds each conv's output to bf16 before the gate
#   math, while the kernel keeps the sums in f32. So they may differ by a few
#   bf16 steps of the gates and of c'.
TOL_BF16 = dict(atol=2e-2, rtol=2e-2)
# - the served rollout (bf16, sigmoid outputs in [0, 1]) against the same
#   rollout through the plain step: 31 recurrent steps of the per-step
#   difference above; outputs near 1 have a bf16 step of 2^-8, and a CPU
#   emulation of the two numerics at 64x64 differs by at most one step.
TOL_ROLLOUT = 2e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def lecun_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """flax's lecun_normal for an HWIO kernel: a normal truncated at 2 sigma,
    rescaled to variance 1/fan_in."""
    z = rng.standard_normal(shape)
    while True:
        out = np.abs(z) > 2
        if not out.any():
            break
        z[out] = rng.standard_normal(int(out.sum()))
    fan_in = int(np.prod(shape[:-1]))
    return (z * np.sqrt(1.0 / fan_in) / 0.87962566103423978).astype(np.float32)


def flax_params(seed: int = 0) -> dict:
    """Random weights in the JAX model's flax tree: lecun-normal kernels,
    zero biases."""
    rng = np.random.default_rng(seed)

    def cell(cx):
        return {
            "x_gates_kernel": lecun_normal(rng, (3, 3, cx, 4 * HIDDEN)),
            "h_gates_kernel": lecun_normal(rng, (3, 3, HIDDEN, 4 * HIDDEN)),
            "bias": np.zeros(4 * HIDDEN, np.float32),
        }

    return {"params": {
        "encoder": {"encoder_1": cell(CIN), "encoder_2": cell(HIDDEN)},
        "decoder": {
            "decoder_1": cell(HIDDEN), "decoder_2": cell(HIDDEN),
            "head": {"kernel": lecun_normal(rng, (3, 3, HIDDEN, COUT)),
                     "bias": np.zeros(COUT, np.float32)},
        },
    }}


def cuda_ms(torch, fn, n: int) -> float:
    """Mean milliseconds of ``fn()`` over ``n`` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def within(torch, got, want, tol) -> bool:
    diff = (got.float() - want.float()).abs()
    return bool((diff <= tol["atol"] + tol["rtol"] * want.float().abs()).all())


def step_inputs(torch, cx: int, dtype, seed: int):
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rand(*shape, scale=1.0, normal=False):
        f = torch.randn if normal else torch.rand
        return (f(*shape, generator=g, device=DEVICE) * scale).to(dtype)

    x = rand(B, H, W, cx)                               # frames in [0, 1]
    h = rand(B, H, W, HIDDEN) * 2 - 1                   # h in (-1, 1)
    c = rand(B, H, W, HIDDEN, normal=True)
    wx = rand(3, 3, cx, 4 * HIDDEN, normal=True, scale=(9 * cx) ** -0.5)
    wh = rand(3, 3, HIDDEN, 4 * HIDDEN, normal=True, scale=(9 * HIDDEN) ** -0.5)
    b = rand(4 * HIDDEN, normal=True, scale=0.1)
    return x, h, c, wx, wh, b


def check_kernel(torch, step, step_ref, card) -> float:
    """Phase 3; returns the largest bf16 |kernel - plain|."""
    worst_bf16 = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        for cx in (CIN, HIDDEN):
            args = step_inputs(torch, cx, dtype, seed=cx)
            got = step(*args)
            want = step_ref(*args)
            torch.cuda.synchronize()
            regions = {
                "all": (slice(None),) * 3,
                "row0": (slice(None), 0), "rowH-1": (slice(None), -1),
                "col0": (slice(None), slice(None), 0),
                "colW-1": (slice(None), slice(None), -1),
            }
            errs = {}
            for name, idx in regions.items():
                for out_name, g_, w_ in (("h", got[0], want[0]), ("c", got[1], want[1])):
                    errs[f"{out_name}.{name}"] = (g_[idx].float() - w_[idx].float()).abs().max().item()
                    if not within(torch, g_[idx], w_[idx], tol):
                        fail(f"kernel != plain: {dtype} Cx={cx} {out_name} {name} "
                             f"max|diff|={errs[f'{out_name}.{name}']:.3g} tol={tol}")
            max_err = max(errs.values())
            if dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, max_err)
            print(f"kernel vs plain: {str(dtype)[6:]} B={B} {H}x{W} Cx={cx} Ch={HIDDEN}: "
                  f"max|diff| {max_err:.3g} (edges: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items() if "all" not in k)
                  + f") tol {tol} ok [{card}]", flush=True)
    return worst_bf16


def post(port: int, x: np.ndarray, out: list, i: int) -> None:
    buf = io.BytesIO()
    np.save(buf, x)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/predict", body=buf.getvalue(),
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        body = resp.read()
        out[i] = (resp.status, np.load(io.BytesIO(body)) if resp.status == 200 else body)
    except Exception as e:  # noqa: BLE001 - reported by the caller
        out[i] = (None, repr(e))
    finally:
        conn.close()


def serve_slice(torch, card):
    """Phase 4; returns (launches, forwards, rollout max|diff|, model)."""
    from satflow_tpu_torch.interop.jax_weights import params_from_flax
    from satflow_tpu_torch.models.conv_lstm import EncoderDecoderConvLSTM
    from satflow_tpu_torch.ops.fused_convlstm_step import (
        fused_convlstm_step,
        fused_convlstm_step_ref,
    )
    from satflow_tpu_torch.serve import InferenceSession, NowcastServer

    model = EncoderDecoderConvLSTM(hidden_dim=HIDDEN, input_channels=CIN,
                                   out_channels=COUT, forecast_steps=STEPS)
    session = InferenceSession(model, max_batch=B, state_dict=params_from_flax(flax_params(0)),
                               dtype=torch.bfloat16, device=DEVICE)
    server = NowcastServer(session, port=0, window_ms=200.0)
    server.start()
    rng = np.random.default_rng(1)
    requests = [rng.random((T, H, W, CIN), dtype=np.float32) for _ in range(4)]
    requests.append(rng.random((2, T, H, W, CIN), dtype=np.float32))
    replies = [None] * len(requests)
    try:
        fused_convlstm_step.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(server.port, x, replies, i))
                   for i, x in enumerate(requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = fused_convlstm_step.launches
        forwards = server.batcher.batches_run
    finally:
        server.close()
    if any(t.is_alive() for t in threads):
        fail("a request did not finish")
    for x, (status, y) in zip(requests, replies):
        if status != 200:
            fail(f"request of shape {x.shape} answered {status}: {y!r}"[:500])
        want = (STEPS, H, W, COUT) if x.ndim == 4 else (x.shape[0], STEPS, H, W, COUT)
        if y.shape != want:
            fail(f"reply shape {y.shape}, expected {want}")
        if not np.isfinite(y).all() or y.min() < 0 or y.max() > 1:
            fail(f"reply not finite in [0, 1]: min {y.min()}, max {y.max()}")
    if forwards < 1 or launches != LAUNCHES_PER_FORWARD * forwards:
        fail(f"kernel launches {launches} != {LAUNCHES_PER_FORWARD} x {forwards} forwards")
    print(f"served {len(requests)} requests (6 samples) in {forwards} forward(s) of b{B}, "
          f"{wall:.3f} s wall; kernel launches {launches} = {LAUNCHES_PER_FORWARD} x {forwards} "
          f"[{card}]", flush=True)

    with torch.inference_mode():
        x0 = torch.from_numpy(requests[0][None]).to(DEVICE, torch.bfloat16)
        ref = model(x0, step=fused_convlstm_step_ref).float().cpu().numpy()[0]
    diff = float(np.abs(ref - replies[0][1]).max())
    if not diff <= TOL_ROLLOUT:
        fail(f"served rollout vs plain-step rollout: max|diff| {diff:.3g} > {TOL_ROLLOUT}")
    print(f"served rollout vs plain-step rollout (bf16, {STEPS} steps): max|diff| {diff:.3g} "
          f"<= {TOL_ROLLOUT} ok [{card}]", flush=True)
    return launches, forwards, diff, model


def timings(torch, step, step_ref, model, card) -> dict:
    """Phase 5: per-call and per-forward times, kernel and plain in turns."""
    per_call = {}
    for cx in (CIN, HIDDEN):
        args = step_inputs(torch, cx, torch.bfloat16, seed=100 + cx)
        for fn in (step, step_ref):
            cuda_ms(torch, lambda: fn(*args), 3)  # warm-up
        runs = {"plain": [], "kernel": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            fn = step if name == "kernel" else step_ref
            runs[name].append(cuda_ms(torch, lambda: fn(*args), 20))
        per_call[cx] = {k: sum(v) / len(v) for k, v in runs.items()}
        flop = 2 * B * H * W * 4 * HIDDEN * 9 * (cx + HIDDEN)
        print(f"time per step call, bf16 B={B} {H}x{W} Cx={cx} Ch={HIDDEN}: "
              f"kernel {per_call[cx]['kernel']:.4f} ms ({flop / per_call[cx]['kernel'] / 1e9:.1f} TFLOP/s), "
              f"plain {per_call[cx]['plain']:.4f} ms ({flop / per_call[cx]['plain'] / 1e9:.1f} TFLOP/s) "
              f"[{card}]", flush=True)

    x = torch.from_numpy(np.random.default_rng(2).random((B, T, H, W, CIN), dtype=np.float32))
    x = x.to(DEVICE, torch.bfloat16)
    per_forward = {"plain": [], "kernel": []}
    with torch.inference_mode():
        for fn in (step, step_ref):
            model(x, step=fn)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        for name in ("kernel", "plain", "plain", "kernel"):
            fn = step if name == "kernel" else step_ref
            per_forward[name].append(cuda_ms(torch, lambda: model(x, step=fn), 2))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for name, runs in per_forward.items():
        ms = sum(runs) / len(runs)
        print(f"b{B} forward ({T} in, {STEPS} out, {H}x{W}x{CIN}, bf16) through the {name} step: "
              f"{ms:.2f} ms, {B * STEPS / (ms / 1e3):.1f} frames/s (runs {', '.join(f'{r:.2f}' for r in runs)} ms); "
              f"peak device memory {peak_gib:.2f} GiB [{card}]", flush=True)
    return per_call


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    try:
        from satflow_tpu_torch.ops import _build
        from satflow_tpu_torch.ops.fused_convlstm_step import (
            build,
            fused_convlstm_step,
            fused_convlstm_step_ref,
        )
    except ImportError as e:
        fail(f"satflow_tpu_torch is not importable beside this script: {e}")

    # phase 1
    card = card_line()
    print(f"card (name, power limit): {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # phase 2
    t0 = time.perf_counter()
    build()
    built = _build.build_seconds.get("fused_convlstm_step")
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({'nvcc ' + format(built, '.2f') + ' s' if built else 'already built'})", flush=True)
    for line in _build.build_logs.get("fused_convlstm_step", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  {line.strip()}", flush=True)

    # phase 3
    max_err = check_kernel(torch, fused_convlstm_step, fused_convlstm_step_ref, card)
    # phase 4
    launches, _, _, model = serve_slice(torch, card)
    # phase 5
    per_call = timings(torch, fused_convlstm_step, fused_convlstm_step_ref, model, card)

    # phase 6
    print(json.dumps({"kernels": [{
        "name": "fused_convlstm_step",
        "route": "cuda",
        "source": "satflow_tpu_torch/csrc/fused_convlstm_step.cu",
        "replaces": "satflow_tpu/ops/pallas/fused_convlstm_step.py:453",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": per_call[HIDDEN]["kernel"],
        "plain_ms": per_call[HIDDEN]["plain"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
