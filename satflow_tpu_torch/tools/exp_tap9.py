"""Kernel study: two other formulations of the fused ConvLSTM step.

Counterpart of ``tools/exp_tap9.py``. The JAX study asked whether the main
step kernel's window assembly or its gate math holds it back; this module
asks the same of the port's K1 on an NVIDIA card, with two hand-written CUDA
kernels (``csrc/exp_tap9.cu``):

- :func:`step_tap9` (T1): ONE channel concat ``[x | h]``, then nine per-tap
  contractions of depth Cx+Ch against ``w9`` (9, Cx+Ch, 4Ch), tap loop
  outermost, against K1's two contractions per tap;
- :func:`step_nogate` (T2): K1's contraction and bias on ``w3`` (3, 3Cx+3Ch,
  4Ch), with the sigmoid/tanh state update replaced by adds;
- :func:`step_padded` (K1p), their yardstick, as the JAX tool's is its main
  kernel in the same layout: K1's contraction order on ``w3`` and K1's LSTM
  epilogue behind the same staging as T1 and T2. K1p's time minus T2's is
  what the transcendental epilogue costs, K1p against T1 what the tap order
  does, and K1p against K1 what the W-padded staging does.

All three keep the JAX main path's W-padded I/O: ``xp`` (B, H, W+2, Cx) and ``hp``
(B, H, W+2, Ch) come with one halo column on either side, which the kernel
reads as given (callers keep it zero); ``c`` is (B, H, W, Ch); the result is
``(h' (B, H, W+2, Ch), c' (B, H, W, Ch))`` with the halo columns of h' written
as zeros. Each wrapper runs its plain version (``*_ref``) for CPU tensors and
launches its kernel for CUDA tensors, or raises.

Run on the card (verifies, then times a chained rollout of K1, K1p, T1, T2)::

    python -m satflow_tpu_torch.tools.exp_tap9 [--batch 8] [--size 256]
        [--channels 64] [--block-h 8] [--steps 20] [--verify-only]

``EXP_NOGATE=1`` times T2 alone, as in the JAX tool. With ``--device cpu`` it
verifies the plain versions against the main step's plain version and stops.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from satflow_tpu_torch.ops import _build
from satflow_tpu_torch.ops import fused_convlstm_step as K1

_SOURCE = "exp_tap9"
_TAP9_ENTRY = {
    torch.float32: "satflow_step_tap9_f32",
    torch.bfloat16: "satflow_step_tap9_bf16",
}
_NOGATE_ENTRY = {
    torch.float32: "satflow_step_nogate_f32",
    torch.bfloat16: "satflow_step_nogate_bf16",
}
_PADDED_ENTRY = {
    torch.float32: "satflow_step_padded_f32",
    torch.bfloat16: "satflow_step_padded_bf16",
}


def pad_w(a: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W+2, C): one zero column on either side."""
    return F.pad(a, (0, 0, 1, 1))


def weights_tap9(wx: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Cx, 4Ch) + (3, 3, Ch, 4Ch) -> w9 (9, Cx+Ch, 4Ch): per
    (dy, dx) tap, x's input channels then h's."""
    return torch.cat([wx, wh], dim=2).reshape(9, -1, wx.shape[-1]).contiguous()


def weights_rows3(wx: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """HWIO weights -> w3 (3, 3Cx+3Ch, 4Ch): per dy, x's three dx taps then
    h's three, the main JAX kernel's im2col order."""
    c4 = wx.shape[-1]
    return torch.cat([wx.reshape(3, -1, c4), wh.reshape(3, -1, c4)], dim=1).contiguous()


def _window(ap: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """The (dy, dx) tap's view of a W-padded tensor, zero rows beyond the
    image: (B, H, W, C), f32."""
    height, width = ap.shape[1], ap.shape[2] - 2
    rows = F.pad(ap.float(), (0, 0, 0, 0, 1, 1))  # one zero row above and below
    return rows[:, dy:dy + height, dx:dx + width]


def step_tap9_ref(xp, hp, c, wx, wh, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """T1's plain version: the nine per-tap products of the channel concat
    with ``w9``, summed in f32, then the f32 gate math."""
    w9 = weights_tap9(wx, wh).float()
    xh = torch.cat([xp, hp], dim=-1)
    acc = b.float() + sum(_window(xh, dy, dx) @ w9[dy * 3 + dx]
                          for dy in range(3) for dx in range(3))
    h_next, c_next = K1.lstm_gates(acc, c)
    return pad_w(h_next.to(xp.dtype)).contiguous(), c_next.to(xp.dtype).contiguous()


def step_padded_ref(xp, hp, c, wx, wh, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1p's plain version, ``_step_ref_padded``: the main step's plain version
    on the interior, h' padded back with zero columns."""
    h_next, c_next = K1.fused_convlstm_step_ref(
        xp[:, :, 1:-1].contiguous(), hp[:, :, 1:-1].contiguous(), c, wx, wh, b)
    return pad_w(h_next).contiguous(), c_next


def step_nogate_ref(xp, hp, c, wx, wh, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """T2's plain version: per dy one product of the six-slice im2col window
    with ``w3[dy]``, summed in f32; ``c' = acc[:Ch] + c``, ``h' = acc[Ch:2Ch]
    + c'``."""
    ch = c.shape[-1]
    w3 = weights_rows3(wx, wh).float()
    acc = b.float()
    for dy in range(3):
        win = torch.cat([_window(a, dy, dx) for a in (xp, hp) for dx in range(3)], dim=-1)
        acc = acc + win @ w3[dy]
    c_next = acc[..., :ch] + c.float()
    h_next = acc[..., ch:2 * ch] + c_next
    return pad_w(h_next.to(xp.dtype)).contiguous(), c_next.to(xp.dtype).contiguous()


def _check(xp, hp, c, wx, wh, b, block_h: int) -> None:
    """Raise on anything the kernels do not take (the device type last, so
    that the shape checks can be exercised without a card)."""
    for name, t in dict(xp=xp, hp=hp, c=c, wx=wx, wh=wh, b=b).items():
        if t.device != xp.device:
            raise ValueError(f"{name} is on {t.device}, xp on {xp.device}")
        if t.dtype != xp.dtype:
            raise TypeError(f"{name} is {t.dtype}, xp is {xp.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xp.dtype not in _TAP9_ENTRY:
        raise TypeError(f"the kernels take float32 or bfloat16, not {xp.dtype}")
    if xp.dim() != 4 or hp.dim() != 4 or xp.shape[2] < 3:
        raise ValueError(f"xp and hp must be (B, H, W+2, C), got {tuple(xp.shape)}, "
                         f"{tuple(hp.shape)}")
    bsz, height, wp2, cx = xp.shape
    ch = hp.shape[-1]
    if hp.shape[:3] != xp.shape[:3] or tuple(c.shape) != (bsz, height, wp2 - 2, ch):
        raise ValueError(
            f"xp {tuple(xp.shape)} and hp {tuple(hp.shape)} must share (B, H, W+2), and c "
            f"{tuple(c.shape)} be (B, H, W, Ch)")
    if (tuple(wx.shape) != (3, 3, cx, 4 * ch) or tuple(wh.shape) != (3, 3, ch, 4 * ch)
            or tuple(b.shape) != (4 * ch,)):
        raise ValueError(
            f"weights must be wx (3,3,{cx},{4 * ch}), wh (3,3,{ch},{4 * ch}), "
            f"b ({4 * ch},); got {tuple(wx.shape)}, {tuple(wh.shape)}, {tuple(b.shape)}")
    if block_h <= 0 or height % block_h:
        raise ValueError(f"H % block_h must be 0, got H={height}, block_h={block_h}")
    if ch != K1.KERNEL_HIDDEN:
        raise ValueError(f"the kernels are built for hidden width {K1.KERNEL_HIDDEN}, got {ch}")
    if cx % 4 or not 0 < cx <= K1.KERNEL_MAX_CX:
        raise ValueError(
            f"the kernels take Cx a multiple of 4 in [4, {K1.KERNEL_MAX_CX}], got {cx}")
    if min(bsz, height) <= 0 or bsz > 65535:
        raise ValueError(f"the kernels take 1 <= B <= 65535 and H, W >= 1, got {tuple(xp.shape)}")
    if xp.device.type != "cuda":
        raise ValueError(f"the study steps run on cpu or cuda tensors, not {xp.device}")


def _library() -> ctypes.CDLL:
    """The kernels' library with its three entry-point families typed: 7 pointers,
    then (B, H, W, Cx, Ch, device), then the stream."""
    return _build.load_typed(
        _SOURCE, [*_TAP9_ENTRY.values(), *_NOGATE_ENTRY.values(), *_PADDED_ENTRY.values()],
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def build() -> None:
    """Build (or load) the kernels' library now rather than at first launch."""
    _build.load(_SOURCE)


def _launch(entries, counter, weights: Callable, xp, hp, c, wx, wh, b, block_h):
    _check(xp, hp, c, wx, wh, b, block_h)
    lib = _library()
    w = weights(wx, wh)
    hp_out = torch.empty_like(hp)
    c_out = torch.empty_like(c)
    bsz, height, wp2, cx = xp.shape
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    err = getattr(lib, entries[xp.dtype])(
        xp.data_ptr(), hp.data_ptr(), c.data_ptr(), w.data_ptr(), b.data_ptr(),
        hp_out.data_ptr(), c_out.data_ptr(),
        bsz, height, wp2 - 2, cx, hp.shape[-1], xp.device.index, stream,
    )
    _build.raise_on(err, lib, counter.__name__)
    counter.launches += 1
    return hp_out, c_out


def step_tap9(xp, hp, c, wx, wh, b, block_h: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """T1: one ConvLSTM step, tap-major, W-padded I/O: (xp, hp, c, Wx, Wh, b)
    -> (h' padded, c').

    CPU tensors take :func:`step_tap9_ref`; CUDA tensors launch the kernel on
    the current stream, counted in ``step_tap9.launches``. ``block_h`` is the
    JAX function's row block: H must be a multiple of it; the CUDA kernel
    tiles the image by itself.
    """
    if all(t.device.type == "cpu" for t in (xp, hp, c, wx, wh, b)):
        return step_tap9_ref(xp, hp, c, wx, wh, b)
    return _launch(_TAP9_ENTRY, step_tap9, weights_tap9, xp, hp, c, wx, wh, b, block_h)


def step_nogate(xp, hp, c, wx, wh, b, block_h: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """T2: the step's contraction with an add-only epilogue, W-padded I/O.

    CPU tensors take :func:`step_nogate_ref`; CUDA tensors launch the kernel
    on the current stream, counted in ``step_nogate.launches``.
    """
    if all(t.device.type == "cpu" for t in (xp, hp, c, wx, wh, b)):
        return step_nogate_ref(xp, hp, c, wx, wh, b)
    return _launch(_NOGATE_ENTRY, step_nogate, weights_rows3, xp, hp, c, wx, wh, b, block_h)


def step_padded(xp, hp, c, wx, wh, b, block_h: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1p: the main step (K1's contraction order and epilogue) in the study
    kernels' W-padded layout, their yardstick.

    CPU tensors take :func:`step_padded_ref`; CUDA tensors launch the kernel
    on the current stream, counted in ``step_padded.launches``.
    """
    if all(t.device.type == "cpu" for t in (xp, hp, c, wx, wh, b)):
        return step_padded_ref(xp, hp, c, wx, wh, b)
    return _launch(_PADDED_ENTRY, step_padded, weights_rows3, xp, hp, c, wx, wh, b, block_h)


step_tap9.launches = 0
step_nogate.launches = 0
step_padded.launches = 0


# ---------------------------------------------------------------------------
# verify + time
# ---------------------------------------------------------------------------


def step_inputs(bsz, size, cx, ch, dtype, device, seed: int, w_scale: float = 0.05):
    """(xp, hp, c, wx, wh, b): uniform states with zero halo columns, normal
    weights, from a torch seed."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, normal=False, scale=1.0):
        f = torch.randn if normal else torch.rand
        return (f(*shape, generator=g) * scale).to(device, dtype)

    xp = pad_w(rand(bsz, size, size, cx)).contiguous()
    hp = pad_w(rand(bsz, size, size, ch)).contiguous()
    c = rand(bsz, size, size, ch)
    wx = rand(3, 3, cx, 4 * ch, normal=True, scale=w_scale)
    wh = rand(3, 3, ch, 4 * ch, normal=True, scale=w_scale)
    b = rand(4 * ch, normal=True, scale=w_scale)
    return xp, hp, c, wx, wh, b


@contextlib.contextmanager
def full_f32():
    """float32 convs and products in full float32 on the card (no TF32) for
    the duration, so that an f32 comparison means what it says."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def verify(device: str, bsz: int = 2, size: int = 16, cx: int = 8, ch: Optional[int] = None,
           block_h: int = 8) -> float:
    """T1 and K1p against the main step's plain version (1e-4), and T2 against
    its own arithmetic written with library convs; returns the largest |diff|.
    The JAX tool's small shape; on the card the hidden width is the kernels' 64."""
    on_card = device != "cpu"
    ch = ch or (K1.KERNEL_HIDDEN if on_card else 8)
    xp, hp, c, wx, wh, b = step_inputs(bsz, size, cx, ch, torch.float32, device, seed=0,
                                       w_scale=0.1)
    x, h = xp[:, :, 1:-1].contiguous(), hp[:, :, 1:-1].contiguous()
    with full_f32():
        h_ref, c_ref = K1.fused_convlstm_step_ref(x, h, c, wx, wh, b)
        gates = (K1.conv3x3(x, wx) + K1.conv3x3(h, wh) + b).float()
    err = 0.0
    for name, fn in (("tap9", step_tap9), ("padded", step_padded)):
        h9, c9 = fn(xp, hp, c, wx, wh, b, block_h=block_h)
        e = max((h9[:, :, 1:-1] - h_ref).abs().max().item(), (c9 - c_ref).abs().max().item(),
                h9[:, :, (0, -1)].abs().max().item())
        print(f"{name} correctness max err: {e:.2e}", flush=True)
        if not e < 1e-4:
            raise AssertionError(f"step_{name} differs from the main step's plain version: {e}")
        err = max(err, e)
    c_want = gates[..., :ch] + c
    h_want = gates[..., ch:2 * ch] + c_want
    hn, cn = step_nogate(xp, hp, c, wx, wh, b, block_h=block_h)
    err_n = max((hn[:, :, 1:-1] - h_want).abs().max().item(), (cn - c_want).abs().max().item(),
                hn[:, :, (0, -1)].abs().max().item())
    print(f"nogate correctness max err: {err_n:.2e}", flush=True)
    if not err_n < 1e-4:
        raise AssertionError(f"step_nogate differs from conv + adds: {err_n}")
    return max(err, err_n)


def time_chain(step_fn: Callable, carry, steps: int = 20, repeats: int = 3) -> float:
    """Milliseconds per step of a chained rollout on the card: the carry is
    ``(x, h, c)`` and each step's h' is fed back as the next x and h, so that
    successive steps depend on each other as the decoder's do. CUDA events
    around ``steps`` steps, the best of ``repeats`` after one warm-up."""

    def chain():
        x, h, c = carry
        for _ in range(steps):
            h, c = step_fn(x, h, c)
            x = h
        return h

    with torch.no_grad():
        chain()
        best = float("inf")
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / steps)
    return best


def _report(name: str, ms: float, flops: float) -> None:
    print(f"{name:28s} {ms:8.3f} ms  {flops / ms / 1e9:6.1f} TF/s", flush=True)


def time_steps(device: str, bsz: int, size: int, ch: int, block_h: int, steps: int,
               which: Sequence[str] = ("k1", "k1_padded", "tap9", "nogate")) -> dict:
    """Chained-rollout ms per step at (bsz, size, size), Cx = Ch = ``ch``,
    bf16, of the kernels named in ``which``; prints each with its TFLOP/s."""
    flops = bsz * size * size * (9 * (ch + ch)) * 4 * ch * 2
    out = {}
    xp, hp, c, wx, wh, b = step_inputs(bsz, size, ch, ch, torch.bfloat16, device, seed=1)
    if "k1" in which:
        carry = (xp[:, :, 1:-1].contiguous(), hp[:, :, 1:-1].contiguous(), c)
        out["k1"] = time_chain(lambda x, h, c_: K1.fused_convlstm_step(x, h, c_, wx, wh, b),
                               carry, steps)
        _report("K1 (the main step)", out["k1"], flops)
    if "k1_padded" in which:
        out["k1_padded"] = time_chain(
            lambda x, h, c_: step_padded(x, h, c_, wx, wh, b, block_h=block_h), (xp, hp, c),
            steps)
        _report("K1p (K1, W-padded I/O)", out["k1_padded"], flops)
    if "tap9" in which:
        out["tap9"] = time_chain(
            lambda x, h, c_: step_tap9(x, h, c_, wx, wh, b, block_h=block_h), (xp, hp, c), steps)
        _report("tap9 (9 taps of K=Cx+Ch)", out["tap9"], flops)
    if "nogate" in which:
        # as the JAX tool: small weights and c handed back unchanged, so that
        # the unbounded sums stay finite over the chain
        wxs, whs = wx * 0.02, wh * 0.02
        out["nogate"] = time_chain(
            lambda x, h, c_: (step_nogate(x, h, c_, wxs, whs, b, block_h=block_h)[0], c_),
            (xp, hp, c * 1e-3), steps)
        _report("nogate (contraction only)", out["nogate"], flops)
    return out


def _device(name: Optional[str]) -> str:
    if name in (None, "cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card is available; pass --device cpu to verify the plain "
                             "versions on the CPU")
        return "cuda"
    return name


def main(bsz: int = 8, size: int = 256, ch: int = 64, block_h: int = 8, steps: int = 20,
         verify_only: bool = False, device: Optional[str] = None) -> dict:
    """Verify T1, T2 and K1p, then (on the card) time K1, K1p, T1 and T2."""
    device = _device(device)
    verify(device, block_h=min(block_h, 8))
    if device == "cpu":
        print("no card asked for; stopping after the plain versions' check", flush=True)
        return {}
    if verify_only:
        print("verify-only: OK", flush=True)
        return {}
    return time_steps(device, bsz, size, ch, block_h, steps)


def main_nogate(bsz: int = 8, size: int = 256, ch: int = 64, block_h: int = 8,
                steps: int = 20, device: Optional[str] = None) -> dict:
    """Time T2 alone on the card."""
    return time_steps(_device(device), bsz, size, ch, block_h, steps, which=("nogate",))


def _cli(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--verify-only", action="store_true")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--block-h", type=int, default=8)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (the default; fails without a card) or cpu (verify only)")
    a = p.parse_args(argv)
    if os.environ.get("EXP_NOGATE"):
        main_nogate(a.batch, a.size, a.channels, a.block_h, a.steps, a.device)
    else:
        main(a.batch, a.size, a.channels, a.block_h, a.steps, a.verify_only, a.device)


if __name__ == "__main__":
    _cli()
