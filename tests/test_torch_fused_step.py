"""PyTorch port, fused ConvLSTM step: the port's step on the CPU (its plain
version) against the JAX Pallas kernel run in interpret mode.

Tolerance: float32 atol 2e-5, as ``tests/test_fused_step.py`` holds the JAX
kernel to its own reference — both sides sum the same f32 products, in
another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import satflow_tpu.ops.pallas.fused_convlstm_step as F
from satflow_tpu_torch.ops import fused_convlstm_step as P

ATOL = 2e-5


def _inputs(seed=0, b=2, hgt=16, wdt=16, cx=4, ch=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, hgt, wdt, cx)).astype(np.float32)
    h = rng.normal(size=(b, hgt, wdt, ch)).astype(np.float32)
    c = rng.normal(size=(b, hgt, wdt, ch)).astype(np.float32)
    wx = (rng.normal(size=(3, 3, cx, 4 * ch)) * 0.1).astype(np.float32)
    wh = (rng.normal(size=(3, 3, ch, 4 * ch)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(4 * ch,)) * 0.1).astype(np.float32)
    return x, h, c, wx, wh, bias


def _jax_step(args, padded):
    """The JAX kernel in interpret mode, unpadded or padded-IO (halo stripped)."""
    x, h, c, wx, wh, bias = (jnp.asarray(a) for a in args)
    if not padded:
        h_k, c_k = F.fused_convlstm_step(x, h, c, wx, wh, bias, use_pallas=True)
        return np.asarray(h_k), np.asarray(c_k)
    hp_k, c_k = F.fused_convlstm_step_padded(F._pad_w(x), F._pad_w(h), c, wx, wh,
                                             bias, use_pallas=True)
    hp_k = np.asarray(hp_k)
    assert hp_k.shape[2] == x.shape[2] + 2
    np.testing.assert_array_equal(hp_k[:, :, 0], 0.0)
    np.testing.assert_array_equal(hp_k[:, :, -1], 0.0)
    return hp_k[:, :, 1:-1], np.asarray(c_k)


def _port_step(args):
    h, c = P.fused_convlstm_step(*(torch.from_numpy(a) for a in args))
    return h.numpy(), c.numpy()


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded_io"])
def test_port_step_matches_jax_kernel(monkeypatch, padded):
    monkeypatch.setattr(F, "_INTERPRET", True)
    args = _inputs()
    h_j, c_j = _jax_step(args, padded)
    launches = P.fused_convlstm_step.launches
    h_t, c_t = _port_step(args)
    assert P.fused_convlstm_step.launches == launches  # the CPU path launches nothing
    np.testing.assert_allclose(h_t, h_j, atol=ATOL)
    np.testing.assert_allclose(c_t, c_j, atol=ATOL)


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded_io"])
def test_port_step_boundary_rows(monkeypatch, padded):
    """Single row-block image: the top and bottom rows see the zero padding."""
    monkeypatch.setattr(F, "_INTERPRET", True)
    args = _inputs(seed=1, b=1, hgt=8, wdt=8, cx=3, ch=8)
    h_j, c_j = _jax_step(args, padded)
    h_t, c_t = _port_step(args)
    for row in (0, -1):
        np.testing.assert_allclose(h_t[0, row], h_j[0, row], atol=ATOL)
        np.testing.assert_allclose(c_t[0, row], c_j[0, row], atol=ATOL)
    for col in (0, -1):
        np.testing.assert_allclose(h_t[0, :, col], h_j[0, :, col], atol=ATOL)


def test_plain_step_matches_jax_reference_bf16():
    """bf16: the port's plain step against the JAX XLA reference step.
    Tolerance 3e-2: both round gates and outputs to bf16 (step 2^-8
    relative), at different points."""
    args = _inputs(seed=2)
    h_j, c_j = F._step_ref(*(jnp.asarray(a, jnp.bfloat16) for a in args))
    h_t, c_t = P.fused_convlstm_step(*(torch.from_numpy(a).bfloat16() for a in args))
    assert h_t.dtype == c_t.dtype == torch.bfloat16
    np.testing.assert_allclose(h_t.float().numpy(), np.asarray(h_j, np.float32), atol=3e-2)
    np.testing.assert_allclose(c_t.float().numpy(), np.asarray(c_j, np.float32), atol=3e-2)


def _meta(cx=12, ch=64, dtype=torch.float32, b=2, hgt=8, wdt=8):
    def t(*shape):
        return torch.empty(*shape, dtype=dtype, device="meta")

    return (t(b, hgt, wdt, cx), t(b, hgt, wdt, ch), t(b, hgt, wdt, ch),
            t(3, 3, cx, 4 * ch), t(3, 3, ch, 4 * ch), t(4 * ch))


@pytest.mark.parametrize(
    "args, error, match",
    [
        # widths outside kernel_takes (the widths it takes: test_torch_widths.py)
        (_meta(ch=264), ValueError, "1 <= Ch <= 256"),
        (_meta(cx=0), ValueError, "1 <= Cx <= 256"),
        (_meta(cx=260), ValueError, "1 <= Cx <= 256"),
        (_meta(dtype=torch.float16), TypeError, "float32 or bfloat16"),
        (_meta()[:3] + (torch.empty(3, 3, 12, 255, device="meta"),) + _meta()[4:],
         ValueError, "weights must be"),
        (_meta(), ValueError, "cpu or cuda tensors, not meta"),
    ],
    ids=["hidden", "cx", "cx_max", "dtype", "weights", "device"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(args, error, match):
    """Tensors off the CPU never reach the plain version: they pass the
    kernel's checks or raise (meta tensors stand in for a card here)."""
    with pytest.raises(error, match=match):
        P.fused_convlstm_step(*args)


def test_wrapper_rejects_mixed_devices():
    x, h, c, wx, wh, b = _meta()
    with pytest.raises(ValueError, match="is on cpu"):
        P.fused_convlstm_step(x, h, c, torch.zeros(wx.shape), wh, b)
