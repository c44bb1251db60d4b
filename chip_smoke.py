#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one CUDA card.

Run from the root of the repository, with one card visible:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. the card's name and power limit (nvidia-smi); a CUDA card is required;
2. build both kernels from ``satflow_tpu_torch/csrc`` (one nvcc each, run
   together): K1, the fused ConvLSTM step, and K2, its backward's gate chain;
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
9. a JSON line of the kernels, and last a JSON line
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
    by kernel class and the device's idle share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    classes = {"K1": 0.0, "K2": 0.0, "library convs": 0.0, "optimizer": 0.0, "other": 0.0}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:  # a CPU op's row repeats its kernels' time
            continue
        ms = evt.self_device_time_total / 1e3
        name = evt.key.lower()
        if "fused_convlstm_step_kernel" in name:
            classes["K1"] += ms
        elif "gate_bwd_kernel" in name:
            classes["K2"] += ms
        elif any(k in name for k in ("conv", "cudnn", "xmma", "dgrad", "wgrad", "cutlass", "implicit")):
            classes["library convs"] += ms
        elif "adam" in name or "multi_tensor" in name:
            classes["optimizer"] += ms
        else:
            classes["other"] += ms
    busy = sum(classes.values())
    if busy <= 0:
        print(f"train step profile: the profiler saw no device time; not measured [{card}]",
              flush=True)
        return
    # the head's convs (weight (COUT, HIDDEN, 3, 3)) among the library convs,
    # from the device time of the aten ops that launched them
    head = sum(evt.device_time_total / 1e3
               for evt in prof.key_averages(group_by_input_shape=True)
               if evt.key in ("aten::cudnn_convolution", "aten::convolution_backward")
               and [COUT, HIDDEN, 3, 3] in (evt.input_shapes or []))
    print(f"train step profile (bf16 b{B} {H}x{W}, {T} in / {STEPS} out, remat_chunk "
          f"{REMAT_CHUNK}): wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, idle "
          f"{100 * (1 - busy / wall_ms):.1f} %; "
          + ", ".join(f"{k} {v:.2f} ms ({100 * v / busy:.1f} %)" for k, v in classes.items())
          + f"; of the library convs, the head's {head:.2f} ms [{card}]", flush=True)


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
    build()
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

    # phase 9
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
