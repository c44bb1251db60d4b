"""Channel-major carry layout prototype.

Counterpart of ``tools/exp_cmajor.py``: the ConvLSTM step with its carries
stored channel-major and the image flattened, x, h, c as (B, C, SP) with
``SP = (H + 2·block_h)·W``: ``block_h`` zero pad rows above and below the
image. The step reads the pad rows in place of any bounds test on rows and
writes them back as zeros, so its outputs are the next step's carries as they
stand; the W boundary is masked. The weights are ``w9`` (9, 4C, Cx+Ch): per
(dy, dx) tap a gate-major matrix with the contraction axis ``[x ; h]`` fastest,
and ``b`` is (4C, 1).

:func:`cmajor_step` is the hand-written CUDA kernel T3 (``csrc/exp_cmajor.cu``)
for CUDA tensors and its plain version :func:`cmajor_step_ref` for CPU tensors.
It differs from the served channel-major step (K6a,
``ops/cmajor_convlstm.py``) in both layouts: K6a's carry has no pad rows and
its weights stay HWIO. In bfloat16 T3 contracts on the tensor cores through
the served steps' contraction (``csrc/convlstm_mma.cuh``), its window staged
from the pad-row planes (``convlstm_source.cuh::PadRows``) and ``w9`` read as
given, K-major; in float32 it keeps f32 FMAs on the CUDA cores. The kernel is
built for the channel widths ``KERNEL_CHANNEL_WIDTHS`` = 8, 16, 32, 64, 128;
any C from 1 to 128 launches it, zero-padded to the next of them (channels,
gate rows and contraction columns of ``w9``) and the outputs sliced back.

Run on the card: verifies against the NHWC plain step (the JAX tool's float32
shapes, C = 8 and 16, then bfloat16 at ``--channels``), then times a chained
rollout (x fed back from h') of K6a and T3::

    python -m satflow_tpu_torch.tools.exp_cmajor [--batch 8] [--size 256]
        [--channels 64] [--block-h 8] [--steps 24] [--verify-only]

With ``--device cpu`` it verifies the plain version and stops.
"""

from __future__ import annotations

import argparse
import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from satflow_tpu_torch.ops import _build
from satflow_tpu_torch.ops import cmajor_convlstm as K6
from satflow_tpu_torch.ops import fused_convlstm_step as K1
from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step_ref, lstm_gates
from satflow_tpu_torch.tools.exp_tap9 import _device, full_f32, time_chain

#: channel widths (of x, h and c alike) the kernel is compiled for
KERNEL_CHANNEL_WIDTHS = (8, 16, 32, 64, 128)
#: the float32 kernel's tile height: block_h must be a multiple of it (the
#: bfloat16 kernel's tiles of 8 rows may straddle pad and image rows)
KERNEL_TILE_H = 4

_SOURCE = "exp_cmajor"
_ENTRY = {
    torch.float32: "satflow_exp_cmajor_step_f32",
    torch.bfloat16: "satflow_exp_cmajor_step_bf16",
}


# ---------------------------------------------------------------------------
# layout changes (outside the rollout's loop; amortised over its horizon)
# ---------------------------------------------------------------------------


def to_cmajor(a: torch.Tensor, block_h: int) -> torch.Tensor:
    """(B, H, W, C) NHWC -> (B, C, SP) flat channel-major with ``block_h``
    zero pad rows above and below (SP = (H + 2·block_h)·W)."""
    b, _, _, c = a.shape
    ap = F.pad(a, (0, 0, 0, 0, block_h, block_h))
    return ap.permute(0, 3, 1, 2).reshape(b, c, -1).contiguous()


def from_cmajor(a: torch.Tensor, height: int, width: int, block_h: int) -> torch.Tensor:
    """(B, C, SP) -> (B, H, W, C)."""
    b, c, _ = a.shape
    g = a.reshape(b, c, height + 2 * block_h, width)[:, :, block_h:block_h + height]
    return g.permute(0, 2, 3, 1).contiguous()


def weights_cmajor(wx: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """(3,3,Cx,4C) + (3,3,Ch,4C) HWIO -> (9, 4C, Cx+Ch): per-tap gate-major
    weights, tap index dy*3+dx, contraction over [x ; h] channels."""
    w = torch.cat([wx, wh], dim=2)  # (3, 3, Cx+Ch, 4C)
    return w.permute(0, 1, 3, 2).reshape(9, w.shape[3], w.shape[2]).contiguous()


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def cmajor_step_ref(x, h, c, w9, b, block_h: int, height: int, width: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """T3's plain version, in the kernel's own formulation: nine products
    ``w9[tap] @ xh`` shifted by (dy-1)·W + (dx-1) along SP, the W boundary
    zeroed, summed in f32; f32 gate math; the pad rows of h' and c' zeroed."""
    bsz, ch, sp = c.shape
    rows = height + 2 * block_h
    xh = torch.cat([x, h], dim=1).float().reshape(bsz, -1, rows, width)
    xh = F.pad(xh, (1, 1, 1, 1))  # zero W halo; the rows beyond the pad rows feed pad rows only
    acc = b.float().reshape(1, -1, 1)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        win = xh[:, :, dy:dy + rows, dx:dx + width].reshape(bsz, -1, sp)
        acc = acc + torch.einsum("gk,bks->bgs", w9[tap].float(), win)
    h_next, c_next = lstm_gates(acc.transpose(1, 2), c.transpose(1, 2))  # gates last
    real = torch.zeros(rows, 1, dtype=torch.bool, device=c.device)
    real[block_h:block_h + height] = True
    real = real.expand(rows, width).reshape(1, sp, 1)
    h_next = torch.where(real, h_next, torch.zeros_like(h_next))
    c_next = torch.where(real, c_next, torch.zeros_like(c_next))
    return (h_next.transpose(1, 2).to(x.dtype).contiguous(),
            c_next.transpose(1, 2).to(x.dtype).contiguous())


def _check(x, h, c, w9, b, block_h, height, width) -> None:
    """Raise on anything the kernel does not take (the device type last, so
    that the other checks can be exercised without a card)."""
    for name, t in dict(x=x, h=h, c=c, w9=w9, b=b).items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if x.dtype not in _ENTRY:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {x.dtype}")
    if block_h <= 0 or block_h % KERNEL_TILE_H or height <= 0 or height % block_h or width <= 0:
        raise ValueError(
            f"the kernel needs block_h % {KERNEL_TILE_H} == 0 and H % block_h == 0, got "
            f"block_h={block_h}, H={height}, W={width}")
    sp = (height + 2 * block_h) * width
    if c.dim() != 3 or c.shape[2] != sp or x.shape != c.shape or h.shape != c.shape:
        raise ValueError(
            f"x {tuple(x.shape)}, h {tuple(h.shape)} and c {tuple(c.shape)} must all be "
            f"(B, C, SP) with SP = (H + 2*block_h)*W = {sp}")
    bsz, ch, _ = c.shape
    if tuple(w9.shape) != (9, 4 * ch, 2 * ch) or tuple(b.shape) != (4 * ch, 1):
        raise ValueError(
            f"weights must be w9 (9, {4 * ch}, {2 * ch}) and b ({4 * ch}, 1); got "
            f"{tuple(w9.shape)}, {tuple(b.shape)}")
    if not 1 <= ch <= KERNEL_CHANNEL_WIDTHS[-1]:
        raise ValueError(f"the kernel takes 1 <= C <= {KERNEL_CHANNEL_WIDTHS[-1]} (built for "
                         f"{KERNEL_CHANNEL_WIDTHS}, other widths zero-padded to the next of "
                         f"them), got {ch}")
    groups = 2 if ch > 64 else 1  # blocks of 64 channels an image along the grid's z
    if not 0 < bsz * groups <= 65535 or (height + 2 * block_h) // KERNEL_TILE_H > 65535:
        raise ValueError(f"the kernel takes 1 <= B <= {65535 // groups} and H + 2*block_h <= "
                         f"262140, got B={bsz}, H={height}")
    if x.device.type != "cuda":
        raise ValueError(f"the prototype step runs on cpu or cuda tensors, not {x.device}")


def pad_operands(x, h, c, w9, b, ch_to: int):
    """(x, h, c, w9, b) at channel width ``ch_to`` >= C: zero channels of the
    carries, zero gate rows (per gate) and zero contraction columns (per x
    and h) of ``w9``, zero bias rows: the step computes the same h', c' in the
    first C channels and zeros in the rest."""
    ch = c.shape[1]
    w = F.pad(w9.reshape(9, 4, ch, 2, ch), (0, ch_to - ch, 0, 0, 0, ch_to - ch))
    carries = (F.pad(t, (0, 0, 0, ch_to - ch)) for t in (x, h, c))
    return (*carries, w.reshape(9, 4 * ch_to, 2 * ch_to).contiguous(),
            F.pad(b.reshape(4, ch, 1), (0, 0, 0, ch_to - ch)).reshape(4 * ch_to, 1))


def _library() -> ctypes.CDLL:
    """The kernel's library, entry points typed: 7 pointers, then (B, H, W,
    C, block_h, device), then the stream."""
    return _build.load_typed(_SOURCE, _ENTRY.values(),
                             [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def build() -> None:
    """Build (or load) the kernel's library now rather than at first launch."""
    _build.load(_SOURCE)


def cmajor_step(x, h, c, w9, b, block_h: int, height: int, width: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """T3: one ConvLSTM step, all operands in the prototype's flat
    channel-major layout.

    x, h, c: (B, C, SP); w9: (9, 4C, 2C); b: (4C, 1). Returns (h', c') in the
    same layout, pad rows zero. CPU tensors take :func:`cmajor_step_ref`; CUDA
    tensors launch the kernel on the current stream, counted in
    ``cmajor_step.launches``.
    """
    if all(t.device.type == "cpu" for t in (x, h, c, w9, b)):
        return cmajor_step_ref(x, h, c, w9, b, block_h, height, width)
    _check(x, h, c, w9, b, block_h, height, width)
    ch = c.shape[1]
    if ch not in KERNEL_CHANNEL_WIDTHS:
        x, h, c, w9, b = pad_operands(x, h, c, w9, b,
                                      K1.padded_hidden(ch, KERNEL_CHANNEL_WIDTHS))
    lib = _library()
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, _ENTRY[x.dtype])(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), w9.data_ptr(), b.data_ptr(),
        h_out.data_ptr(), c_out.data_ptr(),
        c.shape[0], height, width, c.shape[1], block_h, x.device.index, stream,
    )
    _build.raise_on(err, lib, "cmajor_step")
    cmajor_step.launches += 1
    if ch != c.shape[1]:
        return h_out[:, :ch].contiguous(), c_out[:, :ch].contiguous()
    return h_out, c_out


cmajor_step.launches = 0


# ---------------------------------------------------------------------------
# verify + time
# ---------------------------------------------------------------------------


def _rand(g: torch.Generator, shape, dtype, device) -> torch.Tensor:
    return (torch.randn(*shape, generator=g) * 0.1).to(device, dtype)


def step_inputs(bsz, height, width, ch, dtype, device, seed: int):
    """(x, h, c, wx, wh, b) in NHWC / HWIO, normal * 0.1, from a torch seed."""
    g = torch.Generator().manual_seed(seed)
    state = (bsz, height, width, ch)
    return (_rand(g, state, dtype, device), _rand(g, state, dtype, device),
            _rand(g, state, dtype, device), _rand(g, (3, 3, ch, 4 * ch), dtype, device),
            _rand(g, (3, 3, ch, 4 * ch), dtype, device), _rand(g, (4 * ch,), dtype, device))


def verify(device: str = "cpu", bsz=2, height=32, width=32, ch=8, block_h=4,
           dtype=torch.float32) -> Tuple[float, float]:
    """:func:`cmajor_step` between the layout helpers against the NHWC plain
    step: f32 2e-5, bf16 2e-2; the pad rows of h' and c' exactly zero."""
    x, h, c, wx, wh, b = step_inputs(bsz, height, width, ch, dtype, device, seed=0)
    with full_f32():
        h_ref, c_ref = fused_convlstm_step_ref(x, h, c, wx, wh, b)
    h2p, c2p = cmajor_step(
        to_cmajor(x, block_h), to_cmajor(h, block_h), to_cmajor(c, block_h),
        weights_cmajor(wx, wh), b.reshape(-1, 1), block_h, height, width)
    h2 = from_cmajor(h2p, height, width, block_h)
    c2 = from_cmajor(c2p, height, width, block_h)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    err_h = (h2.float() - h_ref.float()).abs().max().item()
    err_c = (c2.float() - c_ref.float()).abs().max().item()
    pads = torch.cat([t.reshape(bsz, ch, -1, width)[:, :, rows]
                      for t in (h2p, c2p) for rows in (slice(0, block_h), slice(-block_h, None))])
    print(f"verify {height}x{width} C={ch} bh={block_h} dtype={str(dtype)[6:]} device={device}: "
          f"max|dh|={err_h:.2e} max|dc|={err_c:.2e}", flush=True)
    if not (err_h < tol and err_c < tol):
        raise AssertionError(f"cmajor_step differs from the NHWC plain step: {err_h}, {err_c}")
    if pads.abs().max().item() != 0:
        raise AssertionError("cmajor_step left nonzero pad rows")
    return err_h, err_c


def main(bsz=8, height=256, width=256, ch=64, block_h=8, steps=24, verify_only=False,
         device: Optional[str] = None) -> dict:
    """Verify T3, then (on the card) time chained rollouts of K6a and T3."""
    device = _device(device)
    # the JAX tool's float32 shapes, through the plain version on the CPU
    verify(device)
    verify(device, bsz=1, height=64, width=128, ch=16, block_h=8)
    if device == "cpu":
        print("no card asked for; stopping after the plain version's check", flush=True)
        return {}
    verify(device, bsz=2, height=64, width=256, ch=ch, block_h=8, dtype=torch.bfloat16)
    if verify_only:
        print("verify-only: OK", flush=True)
        return {}

    x, h, c, wx, wh, b = step_inputs(bsz, height, width, ch, torch.bfloat16, device, seed=1)
    flops = bsz * height * width * (9 * (ch + ch)) * 4 * ch * 2

    # --- the served channel-major step (K6a): no pad rows, HWIO weights -----
    ms_k6a = time_chain(
        lambda xc, hc, cc: K6.cmajor_convlstm_step(xc, hc, cc, wx, wh, b, height, width),
        (K6.to_cmajor(x), K6.to_cmajor(h), K6.to_cmajor(c)), steps)

    # --- the prototype (T3): pad rows, per-tap gate-major weights ------------
    w9, b2 = weights_cmajor(wx, wh), b.reshape(-1, 1)
    ms_t3 = time_chain(
        lambda xc, hc, cc: cmajor_step(xc, hc, cc, w9, b2, block_h, height, width),
        (to_cmajor(x, block_h), to_cmajor(h, block_h), to_cmajor(c, block_h)), steps)

    print(f"\nshape B={bsz} {height}x{width} C={ch} bh={block_h} T={steps} "
          "(chained, feedback x=h')", flush=True)
    print(f"K6a, channel-major step      : {ms_k6a:8.3f} ms/step  "
          f"{flops / ms_k6a / 1e9:6.1f} TF/s", flush=True)
    print(f"T3, pad-row prototype step   : {ms_t3:8.3f} ms/step  "
          f"{flops / ms_t3 / 1e9:6.1f} TF/s", flush=True)
    print(f"K6a / T3                     : {ms_k6a / ms_t3:8.3f}x", flush=True)
    return {"k6a": ms_k6a, "t3": ms_t3}


def _cli(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--verify-only", action="store_true")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--block-h", type=int, default=8)
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (the default; fails without a card) or cpu (verify only)")
    a = p.parse_args(argv)
    main(a.batch, a.size, a.size, a.channels, a.block_h, a.steps, a.verify_only, a.device)


if __name__ == "__main__":
    _cli()
