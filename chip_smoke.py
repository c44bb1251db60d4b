#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one CUDA card.

Run from the root of the repository, with one card visible:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. the card's name and power limit (nvidia-smi); a CUDA card is required;
2. build the four kernels from ``satflow_tpu_torch/csrc`` (one nvcc each, run
   together): K1, the fused ConvLSTM step; K2, its backward's gate chain;
   K3, the LSTM gate tail; K4, the axial attention;
3. K1 against its plain PyTorch version at the serving shapes (B=8,
   256x256, Cx 12 and 64, Ch 64), in float32 and bfloat16, with the image's
   first and last rows and columns checked on their own;
4. K2 against its plain version at the same shapes, dh' and dc' random;
5. the six gradients of ``FusedConvLSTMStep`` (K1 forward, K2 backward)
   against torch autograd of the plain step, float32, same shapes;
6. serving: the full-width ``EncoderDecoderConvLSTM`` (hidden 64, 12
   channels in and out, 24 forecast steps, weights from numpy seed 0 in the
   flax layout) behind ``NowcastServer`` answers 5 concurrent requests; the
   replies are checked, K1's launches counted, and one reply held against
   the same rollout through the plain step;
7. timings with CUDA events: K1 and K2 against their plain versions per
   call, and the b8 forward through each step;
8. training: the same model trains 3 Adam steps through
   ``Trainer(precision="bf16").fit`` on fake b8 256x256 data with sqrt remat
   (``remat_chunk=6``); the losses are checked, the K1 and K2 launches of
   each step counted against the remat schedule, every parameter's
   gradient held nonzero and against the same step through the plain
   versions, the train step timed through the kernels and through the plain
   step, and one step profiled;
9. K3 against its plain version at MetNet's shape (49 152 rows x C=64) and
   at an odd one, float32 and bfloat16, and ``FusedLSTMGates``' two
   gradients against autograd of the plain version; K4 against its plain
   version at (24 576, 16, 8), (2048, 128, 64), (2048, 256, 64) and (256,
   512, 256), float32 and bfloat16, and ``AxialAttention``'s three gradients;
10. MetNet serving: the full-width ``LitMetNet`` (metnet.yaml: hidden 64, one
   axial-attention layer of 8 heads, kernel 3, 24 lead times, 12 channels;
   bf16 compute on f32 weights; weights from numpy seed 0 in the flax
   layout, converted by the bridge) behind ``NowcastServer`` answers 5
   concurrent requests of 7 x 256x256x12; 7 K3 and 2 K4 launches per
   forward, and one reply held against the same forward through the plain
   versions;
11. MetNet timings: K3 and K4 per call against their plain versions, the b8
   forward both ways, and one forward profiled;
12. MetNet training: 3 bf16 Adam steps under ``warmup_cosine`` through
   ``Trainer.fit`` on fake b8 256x256 data (23 input channels); losses
   finite, launches counted, every parameter's gradient nonzero and held
   against the same step through the plain versions, the step timed both
   ways and profiled;
13. a JSON line of the kernels, and last a JSON line
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
# Training with remat (per step or chunked, the JAX package's 256 px setting
# remat_chunk=6): every cell step runs forward once and once more when its
# checkpoint is recomputed in the backward (the chunked encoder and each
# decoder chunk are recomputed whole), and its backward once.
REMAT_CHUNK = 6
K1_PER_TRAIN_STEP = 2 * LAUNCHES_PER_FORWARD
K2_PER_TRAIN_STEP = LAUNCHES_PER_FORWARD
TRAIN_STEPS = 3

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
# - the step's six gradients (float32, TF32 off) through K1 + K2 against
#   torch autograd of the plain step: dgates agree to f32 rounding (K2 vs
#   autograd's gate chain); the linear grads are cuDNN convs on both sides,
#   merged over [x | h] here and separate there, so they sum in another
#   order: a weight-grad element sums B*H*W = 5e5 products, which puts its
#   rounding near 1e-5 x max|grad| (measured 3.8e-5, see PERF.md).
TOL_GRAD_F32 = 1e-4  # x max|grad| of each tensor
# - one bf16 train step's parameter gradients through K1 + K2 against the
#   same step through the plain versions: the plain step rounds each conv's
#   output to bf16 before the gate math, the kernels keep f32 sums; that
#   one-bf16-step difference per cell step compounds over the 62 steps of
#   the rollout and into sums over 8 x 256 x 256 pixels. A CPU emulation of
#   the two numerics at full depth on 32x32 images differs by at most
#   5.0e-3 x max|grad| per tensor, cosine > 0.99999 (see PERF.md).
TOL_TRAIN_GRAD = 5e-2  # x max|grad| of each tensor
MIN_TRAIN_GRAD_COS = 0.999

# MetNet (satflow_tpu/configs/model/metnet.yaml at the zoo's geometry: b8,
# 7 history frames of 256x256, 24 lead times, bf16 compute on f32 weights)
MN_HIDDEN, MN_HEADS, MN_F, MN_COUT, MN_CIN = 64, 8, 24, 12, 12
MN_TRAIN_CIN = 23  # the fake datamodule: 12 satellite + 1 topography + 10 NWP
MN_EH = H // 16  # 16: the temporal encoder's and the attention's grid
MN_ROWS = MN_F * B * MN_EH * MN_EH  # K3's rows per call: 49 152
MN_K3_PER_FORWARD = T  # one gate tail per history frame
MN_K4_PER_FORWARD = 2  # one attention along H, one along W
K4_SHAPES = ((MN_F * B * MN_EH * MN_HEADS, MN_EH, MN_HIDDEN // MN_HEADS),  # MetNet's
             (2048, 128, 64), (2048, 256, 64), (256, 512, 256))  # the long-axis regime
# Tolerances, |kernel - plain| <= atol + rtol * |plain|:
# - K3 and K4, float32: the same f32 arithmetic (K4's online softmax sums the
#   keys in tiles, in another order): a few f32 rounding steps.
TOL_K34_F32 = dict(atol=1e-5, rtol=1e-5)
# - K3 and K4, bfloat16: both keep f32 inside and round only the stored
#   output; an f32 difference at a rounding boundary flips one bf16 step.
TOL_K34_BF16 = dict(atol=1e-2, rtol=2 ** -7)
# - the served MetNet reply (bf16 compute, f32 head) against the same forward
#   through the plain versions: one-step bf16 flips in h' and in the
#   attention output carried through the MLP and the head.
TOL_MN_REPLY = 5e-2  # x max|plain|
# MetNet's parameters whose gradient is zero in exact arithmetic (c0's bias
# is a per-channel shift that the max-pool passes on and the train-mode
# BatchNorm removes; a key bias shifts every score of a row alike, which the
# softmax removes): both sides are rounding noise, held to be small against
# the same layer's weight gradient instead.
MN_ZERO_GRAD = ("image_encoder.c0.bias", "axial0.attn0.k.bias", "axial0.attn1.k.bias")


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


REGIONS = {
    "all": (slice(None),) * 3,
    "row0": (slice(None), 0), "rowH-1": (slice(None), -1),
    "col0": (slice(None), slice(None), 0),
    "colW-1": (slice(None), slice(None), -1),
}


def check_kernel(torch, step, step_ref, card) -> float:
    """Phase 3; returns the largest bf16 |K1 - plain|."""
    worst_bf16 = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        for cx in (CIN, HIDDEN):
            args = step_inputs(torch, cx, dtype, seed=cx)
            got = step(*args)
            want = step_ref(*args)
            torch.cuda.synchronize()
            errs = {}
            for name, idx in REGIONS.items():
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


def cotangents(torch, dtype, seed: int):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return tuple(torch.randn(B, H, W, HIDDEN, generator=g, device=DEVICE).to(dtype)
                 for _ in range(2))


def check_gate_bwd(torch, gate_bwd, gate_bwd_ref, card) -> float:
    """Phase 4; returns the largest bf16 |K2 - plain|."""
    worst_bf16 = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        for cx in (CIN, HIDDEN):
            args = step_inputs(torch, cx, dtype, seed=cx) + cotangents(torch, dtype, seed=cx + 1)
            got = gate_bwd(*args)
            want = gate_bwd_ref(*args)
            torch.cuda.synchronize()
            errs = {}
            for name, idx in REGIONS.items():
                for out_name, g_, w_ in (("dgates", got[0], want[0]), ("dc_prev", got[1], want[1])):
                    key = f"{out_name}.{name}"
                    errs[key] = (g_[idx].float() - w_[idx].float()).abs().max().item()
                    if not within(torch, g_[idx], w_[idx], tol):
                        fail(f"K2 != plain: {dtype} Cx={cx} {key} max|diff|={errs[key]:.3g} tol={tol}")
            max_err = max(errs.values())
            if dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, max_err)
            print(f"K2 vs plain: {str(dtype)[6:]} B={B} {H}x{W} Cx={cx} Ch={HIDDEN}: "
                  f"max|diff| {max_err:.3g} (edges: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items() if "all" not in k)
                  + f") tol {tol} ok [{card}]", flush=True)
    return worst_bf16


def check_function_grads(torch, step, step_ref, card) -> None:
    """Phase 5: dx, dh, dc, dWx, dWh, db through FusedConvLSTMStep (K1 + K2)
    against torch autograd of the plain step, float32."""
    for cx in (CIN, HIDDEN):
        args = step_inputs(torch, cx, torch.float32, seed=200 + cx)
        dh, dc = cotangents(torch, torch.float32, seed=300 + cx)

        def grads(fn):
            ts = [a.clone().requires_grad_() for a in args]
            h_next, c_next = fn(*ts)
            ((h_next * dh).sum() + (c_next * dc).sum()).backward()
            return [t.grad for t in ts], h_next

        got, h_next = grads(step)
        if type(h_next.grad_fn).__name__ != "FusedConvLSTMStepBackward":
            fail(f"the step under autograd is {h_next.grad_fn}, not FusedConvLSTMStep")
        want, _ = grads(step_ref)
        torch.cuda.synchronize()
        rel = {}
        for name, g_, w_ in zip(("dx", "dh", "dc", "dWx", "dWh", "db"), got, want):
            scale = w_.abs().max().item()
            rel[name] = (g_ - w_).abs().max().item() / scale
            if not rel[name] <= TOL_GRAD_F32:
                fail(f"step gradient {name} (Cx={cx}) through K1+K2 vs plain autograd: "
                     f"max|diff| / max|grad| {rel[name]:.3g} > {TOL_GRAD_F32}")
        print(f"step gradients through K1+K2 vs plain autograd, float32 B={B} {H}x{W} Cx={cx}: "
              "max|diff| / max|grad| " + ", ".join(f"{k} {v:.2g}" for k, v in rel.items())
              + f" <= {TOL_GRAD_F32} ok [{card}]", flush=True)


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
    """Phase 6; returns (launches, forwards, rollout max|diff|, model)."""
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


def per_call_ms(torch, kernel, plain, args) -> dict:
    """Mean ms per call of a kernel and its plain version, in turns."""
    with torch.no_grad():
        for fn in (kernel, plain):
            cuda_ms(torch, lambda: fn(*args), 3)  # warm-up
        runs = {"plain": [], "kernel": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            fn = kernel if name == "kernel" else plain
            runs[name].append(cuda_ms(torch, lambda: fn(*args), 20))
    return {k: sum(v) / len(v) for k, v in runs.items()}


def timings(torch, step, step_ref, bwd, bwd_ref, model, card):
    """Phase 7: per-call times of K1 and K2 and per-forward times, kernel
    and plain in turns. Returns ({Cx: K1 times}, {Cx: K2 times})."""
    per_call, per_call_bwd = {}, {}
    for cx in (CIN, HIDDEN):
        args = step_inputs(torch, cx, torch.bfloat16, seed=100 + cx)
        flop = 2 * B * H * W * 4 * HIDDEN * 9 * (cx + HIDDEN)  # the gate contraction
        per_call[cx] = per_call_ms(torch, step, step_ref, args)
        per_call_bwd[cx] = per_call_ms(torch, bwd, bwd_ref,
                                       args + cotangents(torch, torch.bfloat16, seed=150 + cx))
        for name, t in (("K1 (step)", per_call[cx]), ("K2 (gate backward)", per_call_bwd[cx])):
            print(f"time per {name} call, bf16 B={B} {H}x{W} Cx={cx} Ch={HIDDEN}: "
                  f"kernel {t['kernel']:.4f} ms ({flop / t['kernel'] / 1e9:.1f} TFLOP/s), "
                  f"plain {t['plain']:.4f} ms ({flop / t['plain'] / 1e9:.1f} TFLOP/s) "
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
    return per_call, per_call_bwd


class LaunchesPerStep:
    """Trainer callback: the K1 and K2 launches of each train step."""

    def __init__(self, k1, k2):
        self.counters = (k1, k2)
        self.per_step = []
        self._last = (0, 0)

    def on_train_start(self, engine) -> None:
        self._last = tuple(c.launches for c in self.counters)

    def on_train_batch_end(self, engine, metrics, step) -> None:
        now = tuple(c.launches for c in self.counters)
        self.per_step.append(tuple(n - l for n, l in zip(now, self._last)))
        self._last = now

    def on_validation_end(self, engine, metrics, epoch) -> None:
        self._last = tuple(c.launches for c in self.counters)

    def on_preemption(self, engine) -> None: ...

    def on_train_end(self, engine) -> None: ...


def profile_step(torch, train_step, state, batch, card) -> None:
    """One train step through the kernels under torch.profiler: device time
    by kernel class, the device's idle share of the step's wall time, and
    the head's convs among the library convs."""
    result = device_time_by_class(torch, lambda: train_step(state, batch), CONVLSTM_CLASSES)
    # the head's convs (weight (COUT, HIDDEN, 3, 3)), from the device time of
    # the aten ops that launched them
    head = sum(evt.device_time_total / 1e3
               for evt in result[-1].key_averages(group_by_input_shape=True)
               if evt.key in ("aten::cudnn_convolution", "aten::convolution_backward")
               and [COUT, HIDDEN, 3, 3] in (evt.input_shapes or []))
    print_profile(f"train step (bf16 b{B} {H}x{W}, {T} in / {STEPS} out, remat_chunk "
                  f"{REMAT_CHUNK})", result, card,
                  f"; of the library convs, the head's {head:.2f} ms")


def train_slice(torch, card):
    """Phase 8; returns (K1 launches, K2 launches, max rel grad diff,
    train-step ms {"kernel", "plain"})."""
    from satflow_tpu_torch.data import SatFlowDataModule
    from satflow_tpu_torch.data.datamodule import to_device
    from satflow_tpu_torch.interop.jax_weights import params_from_flax
    from satflow_tpu_torch.models.conv_lstm import EncoderDecoderConvLSTM
    from satflow_tpu_torch.ops.fused_convlstm_step import (
        fused_convlstm_step,
        fused_convlstm_step_ref,
        gate_bwd,
    )
    from satflow_tpu_torch.train import Trainer
    from satflow_tpu_torch.train.steps import make_train_step

    model = EncoderDecoderConvLSTM(hidden_dim=HIDDEN, input_channels=CIN, out_channels=COUT,
                                   forecast_steps=STEPS, remat=True, remat_chunk=REMAT_CHUNK)
    model.module.load_state_dict(params_from_flax(flax_params(0)))
    # FakeDataset: TRAIN_STEPS train batches and one val batch of b8 256x256
    dm = SatFlowDataModule(fake_data=True, num_workers=0, n_train_data=TRAIN_STEPS,
                           n_val_data=1, history_minutes=5 * (T - 1),
                           forecast_minutes=5 * STEPS,  # 5-minute frames
                           fake_kwargs=dict(batch_size=B, width=W, height=H))
    counter = LaunchesPerStep(fused_convlstm_step, gate_bwd)
    trainer = Trainer(max_steps=TRAIN_STEPS, precision="bf16", log_every_n_steps=1,
                      device=DEVICE, callbacks=[counter])
    fused_convlstm_step.launches = gate_bwd.launches = 0
    t0 = time.perf_counter()
    trainer.fit(model, dm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = fused_convlstm_step.launches, gate_bwd.launches
    losses = [e["train/loss"] for e in trainer.history.history if "train/loss" in e]
    val_loss = trainer.callback_metrics.get("val/loss", float("nan"))
    if trainer.global_step != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        fail(f"fit took {trainer.global_step} steps and logged {len(losses)} losses, "
             f"not {TRAIN_STEPS}")
    if not all(np.isfinite(losses + [val_loss])):
        fail(f"non-finite losses: train {losses}, val {val_loss}")
    want_step = (K1_PER_TRAIN_STEP, K2_PER_TRAIN_STEP)
    if counter.per_step != [want_step] * TRAIN_STEPS:
        fail(f"(K1, K2) launches per train step {counter.per_step}, expected {want_step} "
             f"(forward + remat recompute, backward) x {TRAIN_STEPS}")
    # the epoch's validation batch is one forward
    if (k1, k2) != (TRAIN_STEPS * K1_PER_TRAIN_STEP + LAUNCHES_PER_FORWARD,
                    TRAIN_STEPS * K2_PER_TRAIN_STEP):
        fail(f"fit launched K1 {k1} and K2 {k2} times")
    print(f"trained {TRAIN_STEPS} steps (bf16, b{B} {H}x{W}, {T} in / {STEPS} out, remat_chunk "
          f"{REMAT_CHUNK}) in {wall:.2f} s wall with data generation: losses "
          + ", ".join(f"{v:.6f}" for v in losses) + f", val {val_loss:.6f}; launches per step "
          f"K1 {K1_PER_TRAIN_STEP} (forward + recompute) and K2 {K2_PER_TRAIN_STEP}; fit total "
          f"K1 {k1} (with one validation forward), K2 {k2} [{card}]", flush=True)

    batch = to_device(next(iter(dm.train_dataloader())), torch.device(DEVICE))

    def step_grads(step):
        model.zero_grad(set_to_none=True)
        loss, _ = model.loss(batch, step=step)
        loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return grads

    got, want = step_grads(fused_convlstm_step), step_grads(fused_convlstm_step_ref)
    worst = 0.0
    for name, g in got.items():
        w = want[name]
        if g is None or not bool(torch.isfinite(g).all()) or not g.abs().sum().item() > 0:
            fail(f"parameter {name} has no finite nonzero gradient through the kernels")
        rel = (g - w).abs().max().item() / w.abs().max().item()
        cos = torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0).item()
        worst = max(worst, rel)
        if not (rel <= TOL_TRAIN_GRAD and cos >= MIN_TRAIN_GRAD_COS):
            fail(f"gradient of {name} through K1+K2 vs plain: max|diff| / max|grad| {rel:.3g} "
                 f"(tol {TOL_TRAIN_GRAD}), cosine {cos:.6f} (min {MIN_TRAIN_GRAD_COS})")
    print(f"one train step's gradients through K1+K2 vs the plain step (bf16): all "
          f"{len(got)} parameters nonzero; max|diff| / max|grad| {worst:.3g} <= "
          f"{TOL_TRAIN_GRAD}, cosine >= {MIN_TRAIN_GRAD_COS} ok [{card}]", flush=True)

    state = trainer.state
    steps = {"kernel": make_train_step(model),
             "plain": make_train_step(model, step=fused_convlstm_step_ref)}
    for fn in steps.values():
        fn(state, batch)  # warm-up
    runs = {"plain": [], "kernel": []}
    peaks = {"plain": 0.0, "kernel": 0.0}
    for name in ("plain", "kernel", "kernel", "plain"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        steps[name](state, batch)
        torch.cuda.synchronize()
        runs[name].append((time.perf_counter() - t0) * 1e3)
        peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated() / 2**30)
    step_ms = {k: sum(v) / len(v) for k, v in runs.items()}
    for name in ("kernel", "plain"):
        print(f"b{B} train step (bf16, {T} in / {STEPS} out, {H}x{W}x{CIN}, remat_chunk "
              f"{REMAT_CHUNK}, Adam) through the {name} step: {step_ms[name]:.2f} ms, "
              f"{B * STEPS / (step_ms[name] / 1e3):.1f} frames/s (runs "
              f"{', '.join(f'{r:.2f}' for r in runs[name])} ms); peak device memory "
              f"{peaks[name]:.2f} GiB [{card}]", flush=True)
    profile_step(torch, steps["kernel"], state, batch, card)
    return k1, k2, worst, step_ms


def _randn(torch, *shape, seed: int, scale: float = 1.0):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=DEVICE) * scale


def _max_err(torch, got, want, tol, what: str) -> float:
    err = (got.float() - want.float()).abs().max().item()
    if not within(torch, got, want, tol):
        fail(f"{what}: max|diff| {err:.3g} beyond tol {tol}")
    return err


def check_gate_tail(torch, card) -> float:
    """Phase 9a: K3 vs its plain version and FusedLSTMGates' gradients;
    returns the largest bf16 |K3 - plain| at MetNet's shape."""
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates, fused_lstm_gates_ref

    worst = 0.0
    for rows, ch in ((MN_ROWS, MN_HIDDEN), (1001, 3)):
        for dtype, tol in ((torch.float32, TOL_K34_F32), (torch.bfloat16, TOL_K34_BF16)):
            gates = _randn(torch, rows, 4 * ch, seed=rows, scale=2.0).to(dtype)
            c = _randn(torch, rows, ch, seed=rows + 1).to(dtype)
            got, want = fused_lstm_gates(gates, c), fused_lstm_gates_ref(gates, c)
            torch.cuda.synchronize()
            err = max(_max_err(torch, g_, w_, tol, f"K3 {name} {str(dtype)[6:]} ({rows}, {4 * ch})")
                      for name, g_, w_ in zip(("h", "c"), got, want))
            if dtype == torch.bfloat16 and rows == MN_ROWS:
                worst = err
            print(f"K3 vs plain: {str(dtype)[6:]} gates ({rows}, {4 * ch}): max|diff| {err:.3g} "
                  f"tol {tol} ok [{card}]", flush=True)
    gates, c = _randn(torch, 4096, 4 * MN_HIDDEN, seed=5, scale=2.0), _randn(torch, 4096, MN_HIDDEN, seed=6)
    dh, dc = _randn(torch, 4096, MN_HIDDEN, seed=7), _randn(torch, 4096, MN_HIDDEN, seed=8)

    def grads(fn):
        ts = [t.clone().requires_grad_() for t in (gates, c)]
        h, c_next = fn(*ts)
        ((h * dh).sum() + (c_next * dc).sum()).backward()
        return [t.grad for t in ts], h

    (got, h) = grads(fused_lstm_gates)
    if type(h.grad_fn).__name__ != "FusedLSTMGatesBackward":
        fail(f"the gate tail under autograd is {h.grad_fn}, not FusedLSTMGates")
    want, _ = grads(fused_lstm_gates_ref)
    errs = [_max_err(torch, g_, w_, TOL_K34_F32, f"FusedLSTMGates {n}")
            for n, g_, w_ in zip(("dgates", "dc"), got, want)]
    print(f"FusedLSTMGates gradients (K3 forward) vs plain autograd, float32 (4096, 256): "
          f"max|diff| dgates {errs[0]:.3g}, dc {errs[1]:.3g} tol {TOL_K34_F32} ok [{card}]",
          flush=True)
    return worst


def check_attention(torch, card) -> float:
    """Phase 9b: K4 vs its plain version at every listed shape and
    AxialAttention's gradients; returns the largest bf16 |K4 - plain| at
    MetNet's shape."""
    from satflow_tpu_torch.ops.axial_attention import axial_attention, axial_attention_ref

    worst = 0.0
    for shape in K4_SHAPES:
        for dtype, tol in ((torch.float32, TOL_K34_F32), (torch.bfloat16, TOL_K34_BF16)):
            q, k, v = (_randn(torch, *shape, seed=shape[1] + i).to(dtype) for i in range(3))
            before = axial_attention.launches
            got = axial_attention(q, k, v)
            torch.cuda.synchronize()
            if axial_attention.launches != before + 1:
                fail(f"K4 did not launch at {shape}")
            err = _max_err(torch, got, axial_attention_ref(q, k, v), tol,
                           f"K4 {str(dtype)[6:]} {shape}")
            if dtype == torch.bfloat16 and shape == K4_SHAPES[0]:
                worst = err
            print(f"K4 vs plain: {str(dtype)[6:]} (N, L, d) {shape}: max|diff| {err:.3g} "
                  f"tol {tol} ok [{card}]", flush=True)
    q, k, v, g = (_randn(torch, *K4_SHAPES[0], seed=40 + i) for i in range(4))

    def grads(fn):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ts)
        (out * g).sum().backward()
        return [t.grad for t in ts], out

    got, out = grads(axial_attention)
    if type(out.grad_fn).__name__ != "AxialAttentionBackward":
        fail(f"the attention under autograd is {out.grad_fn}, not AxialAttention")
    want, _ = grads(axial_attention_ref)
    errs = [_max_err(torch, g_, w_, TOL_K34_F32, f"AxialAttention d{n}")
            for n, g_, w_ in zip("qkv", got, want)]
    print(f"AxialAttention gradients (K4 forward) vs plain autograd, float32 {K4_SHAPES[0]}: "
          "max|diff| " + ", ".join(f"d{n} {e:.3g}" for n, e in zip("qkv", errs))
          + f" tol {TOL_K34_F32} ok [{card}]", flush=True)
    return worst


def metnet_flax_variables(in_channels: int, seed: int = 0) -> dict:
    """Random weights in the JAX LitMetNet's flax tree, as flax initialises
    them: lecun-normal kernels, zero biases, unit scales, pos_emb normal(0.02),
    running statistics (0, 1)."""
    rng = np.random.default_rng(seed)
    h, heads = MN_HIDDEN, MN_HEADS

    def conv(k, cin, cout):
        return {"kernel": lecun_normal(rng, (k, k, cin, cout)), "bias": np.zeros(cout, np.float32)}

    def norm(c):
        return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}

    def dense_general(cout_shape, fan_in, shape):
        kernel = lecun_normal(rng, (fan_in, int(np.prod(shape)) // fan_in)).reshape(shape)
        return {"kernel": kernel, "bias": np.zeros(cout_shape, np.float32)}

    def attn():
        qkv = {n: dense_general((heads, h // heads), h, (h, heads, h // heads)) for n in "qkv"}
        return {"pos_emb": (rng.standard_normal((MN_EH, h)) * 0.02).astype(np.float32), **qkv,
                "out": dense_general((h,), h, (heads, h // heads, h))}

    params = {
        "image_encoder": {"c0": conv(3, in_channels, 160), "bn0": norm(160),
                          "c1": conv(3, 160, 256), "c2": conv(3, 256, 256), "bn1": norm(256),
                          "c3": conv(3, 256, 256)},
        "temporal_encoder": {"cell": {"gates": conv(3, 256 + h, 4 * h)}},
        "axial0": {"ln0": norm(h), "attn0": attn(), "ln1": norm(h), "attn1": attn(),
                   "ln_mlp": norm(h), "mlp_in": conv(1, h, 2 * h), "mlp_out": conv(1, 2 * h, h)},
        "head": conv(1, h, MN_COUT),
    }
    for name in ("mlp_in", "mlp_out"):  # Dense kernels are (in, out)
        params["axial0"][name]["kernel"] = params["axial0"][name]["kernel"][0, 0]
    stats = {"image_encoder": {f"bn{i}": {"mean": np.zeros(c, np.float32),
                                          "var": np.ones(c, np.float32)}
                               for i, c in ((0, 160), (1, 256))}}
    return {"params": params, "batch_stats": stats}


def _metnet(torch, **kw):
    from satflow_tpu_torch.core.registry import create_model
    import satflow_tpu_torch.models  # noqa: F401 - populate the registry

    return create_model("litmetnet", image_encoder="downsampler", input_channels=MN_CIN,
                        sat_channels=12, input_size=64, output_channels=MN_COUT,
                        hidden_dim=MN_HIDDEN, kernel_size=3, num_layers=1, num_att_layers=1,
                        forecast_steps=MN_F, temporal_dropout=0.2, lr=1e-3, loss="mse", **kw)


def metnet_serve_slice(torch, card):
    """Phase 10; returns (K3 launches, K4 launches, model)."""
    from satflow_tpu_torch.ops.axial_attention import axial_attention, axial_attention_ref
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates, fused_lstm_gates_ref
    from satflow_tpu_torch.serve import InferenceSession, NowcastServer

    model = _metnet(torch)
    session = InferenceSession(model, max_batch=B, variables=metnet_flax_variables(4 * MN_CIN + MN_F),
                               dtype=torch.bfloat16, device=DEVICE)
    server = NowcastServer(session, port=0, window_ms=200.0)
    server.start()
    rng = np.random.default_rng(3)
    requests = [rng.random((T, H, W, MN_CIN), dtype=np.float32) for _ in range(4)]
    requests.append(rng.random((2, T, H, W, MN_CIN), dtype=np.float32))
    replies = [None] * len(requests)
    try:
        fused_lstm_gates.launches = axial_attention.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(server.port, x, replies, i))
                   for i, x in enumerate(requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        k3, k4 = fused_lstm_gates.launches, axial_attention.launches
        forwards = server.batcher.batches_run
    finally:
        server.close()
    if any(t.is_alive() for t in threads):
        fail("a MetNet request did not finish")
    for x, (status, y) in zip(requests, replies):
        if status != 200:
            fail(f"MetNet request of shape {x.shape} answered {status}: {y!r}"[:500])
        want = (MN_F, MN_EH, MN_EH, MN_COUT)
        want = want if x.ndim == 4 else (x.shape[0],) + want
        if y.shape != want:
            fail(f"MetNet reply shape {y.shape}, expected {want}")
        if not np.isfinite(y).all():
            fail("MetNet reply not finite")
    if forwards < 1 or (k3, k4) != (MN_K3_PER_FORWARD * forwards, MN_K4_PER_FORWARD * forwards):
        fail(f"MetNet launches K3 {k3}, K4 {k4} != ({MN_K3_PER_FORWARD}, {MN_K4_PER_FORWARD}) "
             f"x {forwards} forwards")
    print(f"MetNet served {len(requests)} requests (6 samples) in {forwards} forward(s) of b{B}, "
          f"{wall:.3f} s wall; launches K3 {k3} = {MN_K3_PER_FORWARD} x {forwards}, K4 {k4} = "
          f"{MN_K4_PER_FORWARD} x {forwards} [{card}]", flush=True)

    with torch.inference_mode():
        x0 = torch.from_numpy(requests[0][None]).to(DEVICE, torch.bfloat16)
        ref = model(x0, gate_tail=fused_lstm_gates_ref,
                    attention=axial_attention_ref).float().cpu().numpy()[0]
    diff = float(np.abs(ref - replies[0][1]).max())
    scale = float(np.abs(ref).max())
    if not diff <= TOL_MN_REPLY * scale:
        fail(f"MetNet reply vs plain-version forward: max|diff| {diff:.3g} > "
             f"{TOL_MN_REPLY} x max|plain| {scale:.3g}")
    print(f"MetNet reply vs the plain versions' forward (bf16): max|diff| {diff:.3g} <= "
          f"{TOL_MN_REPLY} x max|plain| {scale:.3g} ok [{card}]", flush=True)
    return k3, k4, model


def device_time_by_class(torch, fn, classes):
    """Run ``fn()`` once under torch.profiler; returns (wall ms, {class: device
    ms}, busy ms, the 6 largest kernels of "other" as (name, ms), the
    profile), a kernel going to the first class one of whose name fragments
    it contains, else to "other"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = {name: 0.0 for name in classes}
    out["other"] = 0.0
    others = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:  # a CPU op's row repeats its kernels' time
            continue
        key = evt.key.lower()
        name = next((n for n, frags in classes.items() if any(f in key for f in frags)), "other")
        ms = evt.self_device_time_total / 1e3
        out[name] += ms
        if name == "other":
            others.append((evt.key[:70], ms))
    return wall_ms, out, sum(out.values()), sorted(others, key=lambda e: -e[1])[:6], prof


# kernel classes of a profile, by name fragments (the first match wins)
LIBRARY_CONVS = ("conv", "cudnn", "xmma", "dgrad", "wgrad", "cutlass", "implicit", "sm90_")
OPTIMIZER = ("adam", "multi_tensor")
CONVLSTM_CLASSES = {"K1": ("fused_convlstm_step_kernel",), "K2": ("gate_bwd_kernel",),
                    "library convs": LIBRARY_CONVS, "optimizer": OPTIMIZER}
MN_CLASSES = {"K3": ("fused_lstm_gates_kernel",), "K4": ("axial_attention_kernel",),
              "library convs": LIBRARY_CONVS, "optimizer": OPTIMIZER}


def print_profile(what, result, card, extra: str = "") -> None:
    """Print a :func:`device_time_by_class` result."""
    wall_ms, classes, busy, others, _ = result
    if busy <= 0:
        print(f"{what} profile: the profiler saw no device time; not measured [{card}]", flush=True)
        return
    print(f"{what} profile: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, idle "
          f"{100 * (1 - busy / wall_ms):.1f} %; "
          + ", ".join(f"{k} {v:.2f} ms ({100 * v / busy:.1f} %)" for k, v in classes.items())
          + "; largest of other: " + "; ".join(f"{n} {ms:.2f} ms" for n, ms in others)
          + f"{extra} [{card}]", flush=True)


def metnet_timings(torch, model, card):
    """Phase 11: K3 and K4 per call against their plain versions at the
    path's shapes, the b8 forward both ways, one forward profiled. Returns
    (K3 ms {"kernel", "plain"}, {K4 shape: ms})."""
    from satflow_tpu_torch.ops.axial_attention import attention_kernel, axial_attention_ref
    from satflow_tpu_torch.ops.fused_lstm import _gates, fused_lstm_gates_ref

    gates = _randn(torch, MN_ROWS, 4 * MN_HIDDEN, seed=50, scale=2.0).to(torch.bfloat16)
    c = _randn(torch, MN_ROWS, MN_HIDDEN, seed=51).to(torch.bfloat16)
    k3 = per_call_ms(torch, _gates, fused_lstm_gates_ref, (gates, c))
    k3_bytes = gates.numel() * 2 + c.numel() * 2 * 3
    print(f"time per K3 call, bf16 ({MN_ROWS}, {4 * MN_HIDDEN}): kernel {k3['kernel'] * 1e3:.2f} us "
          f"({k3_bytes / k3['kernel'] / 1e6:.0f} GB/s), plain {k3['plain'] * 1e3:.2f} us [{card}]",
          flush=True)
    k4 = {}
    for shape in K4_SHAPES:
        q, k, v = (_randn(torch, *shape, seed=60 + i).to(torch.bfloat16) for i in range(3))
        k4[shape] = per_call_ms(torch, attention_kernel, axial_attention_ref, (q, k, v))
        n, length, d = shape
        flop = 4 * n * length * length * d
        print(f"time per K4 call, bf16 (N, L, d) {shape}: kernel {k4[shape]['kernel'] * 1e3:.2f} us "
              f"({flop / k4[shape]['kernel'] / 1e9:.1f} TFLOP/s), plain "
              f"{k4[shape]['plain'] * 1e3:.2f} us ({flop / k4[shape]['plain'] / 1e9:.1f} TFLOP/s) "
              f"[{card}]", flush=True)

    x = torch.from_numpy(np.random.default_rng(4).random((B, T, H, W, MN_CIN), dtype=np.float32))
    x = x.to(DEVICE, torch.bfloat16)
    plain = dict(gate_tail=fused_lstm_gates_ref, attention=axial_attention_ref)
    runs = {"plain": [], "kernel": []}
    with torch.inference_mode():
        for kw in ({}, plain):
            model(x, **kw)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        for name in ("kernel", "plain", "plain", "kernel"):
            kw = plain if name == "plain" else {}
            runs[name].append(cuda_ms(torch, lambda: model(x, **kw), 3))
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        for name, r in runs.items():
            ms = sum(r) / len(r)
            print(f"MetNet b{B} forward ({T} x {H}x{W}x{MN_CIN} in, {MN_F} lead times, bf16) "
                  f"through the {name} versions: {ms:.2f} ms, {B * MN_F / (ms / 1e3):.1f} "
                  f"forecast frames/s (runs {', '.join(f'{v:.2f}' for v in r)} ms); peak device "
                  f"memory {peak_gib:.2f} GiB [{card}]", flush=True)
        print_profile(f"MetNet b{B} forward",
                      device_time_by_class(torch, lambda: model(x), MN_CLASSES), card)
    return k3, k4


def metnet_train_slice(torch, card):
    """Phase 12; returns (K3 launches, K4 launches)."""
    from satflow_tpu_torch.data import SatFlowDataModule
    from satflow_tpu_torch.data.datamodule import to_device
    from satflow_tpu_torch.ops.axial_attention import axial_attention, axial_attention_ref
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates, fused_lstm_gates_ref
    from satflow_tpu_torch.train import Trainer
    from satflow_tpu_torch.train.steps import make_train_step

    gen = torch.Generator()
    model = _metnet(torch, generator=gen, warmup_steps=1000, total_steps=100_000)
    model.module.load_state_dict(model.state_dict_from_flax(
        metnet_flax_variables(4 * MN_TRAIN_CIN + MN_F, seed=1)))
    dm = SatFlowDataModule(fake_data=True, num_workers=0, n_train_data=TRAIN_STEPS, n_val_data=1,
                           history_minutes=5 * (T - 1), forecast_minutes=5 * MN_F,
                           fake_kwargs=dict(batch_size=B, width=W, height=H))
    counter = LaunchesPerStep(fused_lstm_gates, axial_attention)
    trainer = Trainer(max_steps=TRAIN_STEPS, precision="bf16", log_every_n_steps=1,
                      device=DEVICE, callbacks=[counter])
    gen.manual_seed(0)
    fused_lstm_gates.launches = axial_attention.launches = 0
    t0 = time.perf_counter()
    trainer.fit(model, dm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3, k4 = fused_lstm_gates.launches, axial_attention.launches
    losses = [e["train/loss"] for e in trainer.history.history if "train/loss" in e]
    lrs = [model.lr_schedule(i) for i in range(TRAIN_STEPS)]
    val_loss = trainer.callback_metrics.get("val/loss", float("nan"))
    if trainer.global_step != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        fail(f"MetNet fit took {trainer.global_step} steps and logged {len(losses)} losses")
    if not all(np.isfinite(losses + [val_loss])):
        fail(f"MetNet non-finite losses: train {losses}, val {val_loss}")
    want_step = (MN_K3_PER_FORWARD, MN_K4_PER_FORWARD)  # forward kernels; plain backward chains
    if counter.per_step != [want_step] * TRAIN_STEPS:
        fail(f"MetNet (K3, K4) launches per train step {counter.per_step}, expected {want_step}")
    if (k3, k4) != ((TRAIN_STEPS + 1) * MN_K3_PER_FORWARD, (TRAIN_STEPS + 1) * MN_K4_PER_FORWARD):
        fail(f"MetNet fit launched K3 {k3} and K4 {k4} times")
    if model.dtype != torch.bfloat16 or not model.module.image_encoder.bn0.mean.abs().sum() > 0:
        fail("MetNet did not train in bf16 with moving BatchNorm statistics")
    print(f"MetNet trained {TRAIN_STEPS} steps (bf16, b{B} {H}x{W}x{MN_TRAIN_CIN}, {T} in / {MN_F} "
          f"lead times) in {wall:.2f} s wall with data generation: losses "
          + ", ".join(f"{v:.6f}" for v in losses) + f", val {val_loss:.6f}; Adam learning rates "
          + ", ".join(f"{v:.3g}" for v in lrs) + f" (warmup_cosine); launches per step K3 "
          f"{want_step[0]}, K4 {want_step[1]}; fit total K3 {k3}, K4 {k4} (with one validation "
          f"forward) [{card}]", flush=True)

    batch = to_device(next(iter(dm.train_dataloader())), torch.device(DEVICE))
    plain = dict(gate_tail=fused_lstm_gates_ref, attention=axial_attention_ref)

    def step_grads(**kw):
        model.train()
        model.zero_grad(set_to_none=True)
        gen.manual_seed(1)  # the same temporal-dropout mask both ways
        loss, _ = model.loss(batch, **kw)
        loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in model.module.named_parameters()}
        model.zero_grad(set_to_none=True)
        return grads

    got, want = step_grads(), step_grads(**plain)
    worst, worst_cos = 0.0, 1.0
    for name, g in got.items():
        w = want[name]
        if g is None or not bool(torch.isfinite(g).all()):
            fail(f"MetNet parameter {name} has no finite gradient through the kernels")
        if name in MN_ZERO_GRAD:
            scale = want[name.replace(".bias", ".weight")].abs().max().item()
            if not (g.abs().max().item() <= 1e-3 * scale and w.abs().max().item() <= 1e-3 * scale):
                fail(f"MetNet {name}: gradient not negligible against its layer's weight's")
            continue
        if not g.abs().sum().item() > 0:
            fail(f"MetNet parameter {name} has a zero gradient through the kernels")
        rel = (g - w).abs().max().item() / w.abs().max().item()
        cos = torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0).item()
        worst, worst_cos = max(worst, rel), min(worst_cos, cos)
        if not (rel <= TOL_TRAIN_GRAD and cos >= MIN_TRAIN_GRAD_COS):
            fail(f"MetNet gradient of {name} through K3+K4 vs plain: max|diff| / max|grad| "
                 f"{rel:.3g} (tol {TOL_TRAIN_GRAD}), cosine {cos:.6f} (min {MIN_TRAIN_GRAD_COS})")
    print(f"MetNet train step's gradients through K3+K4 vs the plain versions (bf16): "
          f"{len(got) - len(MN_ZERO_GRAD)} parameters nonzero (and {len(MN_ZERO_GRAD)} zero in "
          f"exact arithmetic, negligible both ways); max|diff| / max|grad| {worst:.3g} <= "
          f"{TOL_TRAIN_GRAD}, cosine >= {worst_cos:.6f} ok [{card}]", flush=True)

    state = trainer.state
    steps = {"kernel": make_train_step(model), "plain": make_train_step(model, **plain)}
    for fn in steps.values():
        fn(state, batch)  # warm-up
    runs = {"plain": [], "kernel": []}
    peaks = {"plain": 0.0, "kernel": 0.0}
    for name in ("plain", "kernel", "kernel", "plain"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        steps[name](state, batch)
        torch.cuda.synchronize()
        runs[name].append((time.perf_counter() - t0) * 1e3)
        peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated() / 2**30)
    for name in ("kernel", "plain"):
        ms = sum(runs[name]) / len(runs[name])
        print(f"MetNet b{B} train step (bf16, {T} in / {MN_F} lead times, {H}x{W}x{MN_TRAIN_CIN}, "
              f"Adam) through the {name} versions: {ms:.2f} ms, {B * MN_F / (ms / 1e3):.1f} "
              f"frames/s (runs {', '.join(f'{r:.2f}' for r in runs[name])} ms); peak device "
              f"memory {peaks[name]:.2f} GiB [{card}]", flush=True)
    print_profile(f"MetNet b{B} train step",
                  device_time_by_class(torch, lambda: steps["kernel"](state, batch), MN_CLASSES),
                  card)
    return k3, k4


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
            fused_convlstm_step,
            fused_convlstm_step_ref,
            gate_bwd,
            gate_bwd_ref,
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
    _build.load_all(["fused_convlstm_step", "fused_convlstm_step_bwd", "fused_lstm_gates",
                     "axial_attention"])
    print(f"kernel build: {time.perf_counter() - t0:.2f} s wall, nvcc in parallel ("
          + ", ".join(f"{k} {v:.2f} s" for k, v in _build.build_seconds.items())
          + (")" if _build.build_seconds else "already built)"), flush=True)
    for name, log in _build.build_logs.items():
        dtype = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:  # the mangled name carries the type
                dtype = "bf16" if "bfloat16" in line else "f32"
            elif "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name} ({dtype}): {line.strip()}", flush=True)

    # phases 3-5: each kernel against its plain version
    k1_err = check_kernel(torch, fused_convlstm_step, fused_convlstm_step_ref, card)
    k2_err = check_gate_bwd(torch, gate_bwd, gate_bwd_ref, card)
    check_function_grads(torch, fused_convlstm_step, fused_convlstm_step_ref, card)
    # phase 6: serving (counts set to 0 inside, just before the requests)
    serve_k1, _, _, model = serve_slice(torch, card)
    # phase 7
    per_call, per_call_bwd = timings(torch, fused_convlstm_step, fused_convlstm_step_ref,
                                     gate_bwd, gate_bwd_ref, model, card)
    del model
    # phase 8: training (counts set to 0 inside, just before fit)
    train_k1, train_k2, _, _ = train_slice(torch, card)

    # phase 9: K3 and K4 against their plain versions
    k3_err = check_gate_tail(torch, card)
    k4_err = check_attention(torch, card)
    # phase 10: MetNet serving (counts set to 0 inside, just before the requests)
    serve_k3, serve_k4, mn_model = metnet_serve_slice(torch, card)
    # phase 11
    k3_ms, k4_ms = metnet_timings(torch, mn_model, card)
    del mn_model
    # phase 12: MetNet training (counts set to 0 inside, just before fit)
    train_k3, train_k4 = metnet_train_slice(torch, card)

    # phase 13
    print(json.dumps({"kernels": [{
        "name": "fused_convlstm_step",
        "route": "cuda",
        "source": "satflow_tpu_torch/csrc/fused_convlstm_step.cu",
        "replaces": "satflow_tpu/ops/pallas/fused_convlstm_step.py:453",
        "launches": serve_k1 + train_k1,  # serving + training runs
        "max_abs_err": k1_err,
        "ms": per_call[HIDDEN]["kernel"],
        "plain_ms": per_call[HIDDEN]["plain"],
    }, {
        "name": "gate_bwd",
        "route": "cuda",
        "source": "satflow_tpu_torch/csrc/fused_convlstm_step_bwd.cu",
        "replaces": "satflow_tpu/ops/pallas/fused_convlstm_step.py:896",
        "launches": train_k2,
        "max_abs_err": k2_err,
        "ms": per_call_bwd[HIDDEN]["kernel"],
        "plain_ms": per_call_bwd[HIDDEN]["plain"],
    }, {
        "name": "fused_lstm_gates",
        "route": "cuda",
        "source": "satflow_tpu_torch/csrc/fused_lstm_gates.cu",
        "replaces": "satflow_tpu/ops/pallas/fused_lstm.py:75",
        "launches": serve_k3 + train_k3,  # MetNet serving + training runs
        "max_abs_err": k3_err,
        "ms": k3_ms["kernel"],
        "plain_ms": k3_ms["plain"],
    }, {
        "name": "axial_attention",
        "route": "cuda",
        "source": "satflow_tpu_torch/csrc/axial_attention.cu",
        "replaces": "satflow_tpu/ops/pallas/axial_attention.py:60",
        "launches": serve_k4 + train_k4,
        "max_abs_err": k4_err,
        "ms": k4_ms[K4_SHAPES[0]]["kernel"],
        "plain_ms": k4_ms[K4_SHAPES[0]]["plain"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
