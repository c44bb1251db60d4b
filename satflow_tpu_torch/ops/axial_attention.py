"""Batched single-axis attention: the CUDA kernel's wrapper, its plain PyTorch
version, the dispatch rule and the autograd Function.

Counterpart of ``satflow_tpu/ops/pallas/axial_attention.py``: the TPU kernel
``_attention_pallas``, ported as K4 (``csrc/axial_attention.cu``). Per batch
row of (N, L, D) operands it computes ``softmax((q·D^-0.5) kᵀ) v`` with f32
math and returns it in q's dtype.

Dispatch (:func:`kernel_takes`): the kernel takes the domain the JAX
dispatcher admits, q, k and v of one shape with L <= 512 and D <= 256, and on
a CUDA tensor every such shape launches it. The JAX package's further rule
(the kernel only when L >= 128 and D >= 64) is tuning for its TPU and is not
carried over. Shapes outside the domain take the plain version on every
device. Under autograd the op is :class:`AxialAttention`, whose backward
recomputes through the plain version, as the JAX ``_bwd`` does.

K4 is three kernels in one source, chosen by :func:`regime` on (L, D, dtype);
the source's entry points apply the same rule:

- ``"rows"``, L <= 32 and D <= 32, float32 and bfloat16 (MetNet's (24 576,
  16, 8)): a block takes 256 // L consecutive batch rows and one thread owns
  one (n, query row), scores in registers, one-pass softmax;
- ``"mma"``, bfloat16 outside ``"rows"``: both products on the tensor cores
  (``mma.sync`` m16n8k16), online softmax on the accumulator fragments, D
  padded to 16, 32, 64, 128 or 256;
- ``"tile"``, float32 outside ``"rows"``: f32 FMAs on the CUDA cores (the
  float32 tolerance, 1e-5, allows nothing else) as two register-tiled
  products: a block takes 64 query rows against staged tiles of 64 keys, a
  thread 4 x 4 scores and 4 x 4 outputs of each 64-column chunk of D.
"""

from __future__ import annotations

import ctypes

import torch

from satflow_tpu_torch.ops import _build

_SOURCE = "axial_attention"
_ENTRY = {
    torch.float32: "satflow_axial_attention_f32",
    torch.bfloat16: "satflow_axial_attention_bf16",
}
#: the kernel's domain: the JAX dispatcher's caps
MAX_LEN = 512
MAX_DIM = 256
#: the "rows" regime: a query row's scores and a head's width fit in registers
ROWS_MAX_LEN = 32
ROWS_MAX_DIM = 32


def axial_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain version, ``_attention_ref``: q scaled by D^-0.5 in its own
    dtype, then the scores, softmax and product in f32, cast to q's dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("nld,nmd->nlm", (q * scale).float(), k.float())
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("nlm,nmd->nld", weights, v.float()).to(q.dtype)


def kernel_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether (N, L, D) operands lie in the kernel's domain: one shape for
    q, k and v, 1 <= L <= 512, 1 <= D <= 256 (the JAX package's caps)."""
    return (q.dim() == 3 and q.shape == k.shape == v.shape and q.numel() > 0
            and q.shape[1] <= MAX_LEN and q.shape[2] <= MAX_DIM)


def regime(length: int, dim: int, dtype: torch.dtype) -> str:
    """Which of K4's kernels an (N, L, D) call of ``dtype`` launches: ``"rows"``
    for L <= 32 and D <= 32, else ``"mma"`` for bfloat16 and ``"tile"`` for
    float32. Outside the domain (or another dtype) it raises."""
    if not (1 <= length <= MAX_LEN and 1 <= dim <= MAX_DIM):
        raise ValueError(f"L={length}, D={dim} lie outside the kernel's domain "
                         f"(1 <= L <= {MAX_LEN}, 1 <= D <= {MAX_DIM})")
    if dtype not in _ENTRY:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {dtype}")
    if length <= ROWS_MAX_LEN and dim <= ROWS_MAX_DIM:
        return "rows"
    return "mma" if dtype == torch.bfloat16 else "tile"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernel does not take beyond its shape domain (the
    device type last, so that the checks can be exercised without a card)."""
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _ENTRY:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {q.dtype}")
    if q.shape[0] > 2**31 - 1:
        raise ValueError(f"the kernel takes N < 2^31, got {q.shape[0]}")
    if q.device.type != "cuda":
        raise ValueError(f"axial attention runs on cpu or cuda tensors, not {q.device}")


def _library() -> ctypes.CDLL:
    """The kernel's library, entry points typed: q, k, v, out pointers, then
    (N, L, D, scale, device), then the stream."""
    return _build.load_typed(_SOURCE, _ENTRY.values(), [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p])


def attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K4 on CUDA tensors in its domain (the kernel :func:`regime` names),
    counted in ``axial_attention.launches``."""
    if not kernel_takes(q, k, v):
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} lie outside the "
            f"kernel's domain (one (N, L, D) shape, L <= {MAX_LEN}, D <= {MAX_DIM})"
        )
    _check(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lib = _library()
    out = torch.empty_like(q)
    n, length, dim = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        n, length, dim, dim ** -0.5, q.device.index, stream,
    )
    _build.raise_on(err, lib, "axial_attention")
    axial_attention.launches += 1
    return out


# K4 as the dispatcher op ``satflow::axial_attention``, so that torch.export
# records it and an exported program runs it (with satflow_tpu_torch.ops
# imported): attention_kernel for CUDA tensors, the plain version for CPU
# ones, no autograd of its own (AxialAttention wraps it).
_LIB = torch.library.Library("satflow", "FRAGMENT")
_LIB.define("axial_attention(Tensor q, Tensor k, Tensor v) -> Tensor")
# (each looked up when called, so that the module's names can be patched)
_LIB.impl("axial_attention", lambda *a: attention_kernel(*a), "CUDA")
_LIB.impl("axial_attention", lambda *a: axial_attention_ref(*a), "CPU")


@torch.library.register_fake("satflow::axial_attention", lib=_LIB)
def _attention_fake(q, k, v):
    return torch.empty_like(q)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Without autograd: the plain version for shapes outside the kernel's
    domain, else K4's op (the plain version for CPU tensors, the kernel for
    CUDA ones). Tensors on another device take the kernel's checks here,
    which refuse them."""
    if not kernel_takes(q, k, v):
        return axial_attention_ref(q, k, v)
    if any(t.device.type not in ("cpu", "cuda") for t in (q, k, v)):
        _check(q, k, v)
    return torch.ops.satflow.axial_attention.default(q, k, v)


class AxialAttention(torch.autograd.Function):
    """The op under autograd, ``axial_attention``'s ``custom_vjp``: forward as
    :func:`axial_attention`, saving (q, k, v); backward recomputes through
    :func:`axial_attention_ref` and takes its vector-Jacobian product."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _attention(q, k, v)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = axial_attention_ref(q, k, v)
        return torch.autograd.grad(out, (q, k, v), g)


def axial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched single-axis attention: (N, L, D) q/k/v -> (N, L, D).

    CPU tensors, and shapes outside :func:`kernel_takes`, take
    :func:`axial_attention_ref`; CUDA tensors in the domain launch K4 on the
    current stream. With grad mode on and an input that requires grad it runs
    as :class:`AxialAttention`.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return AxialAttention.apply(q, k, v)
    return _attention(q, k, v)


axial_attention.launches = 0


def build() -> None:
    """Build (or load) the kernel's library now rather than at first launch."""
    _build.load(_SOURCE)
