"""PyTorch port, the fused step's backward: K2's plain version
(``gate_bwd_ref``), the ``FusedConvLSTMStep`` autograd Function and the
cell's parameter gradients, against the JAX package on the same inputs.

Inputs come from numpy seeds. The JAX side runs the Pallas kernels in
interpret mode (as ``tests/test_fused_step.py`` does) or its XLA reference.

Tolerances:
- gate_bwd_ref vs ``_gate_bwd_pallas``, float32, atol 2e-5: both recompute
  the gates from the same f32 products in another order and run the same
  f32 chain; the outputs are O(1).
- the Function's six gradients vs ``jax.grad``, float32, atol 1e-4: the
  weight and bias gradients are sums of B*H*W*9 = 4608 products of O(1)
  terms (values up to ~30), summed in another order (measured 1.5e-5).
- vs torch autograd of the plain step, float32, atol 1e-5: the same convs
  on the same library, only the gate chain differs (hand-written vs
  autograd; measured 3.8e-6).
- bfloat16, atol 2e-2 x max|grad|: both sides round dgates and the conv
  grads to bf16 (step 2^-8 relative) at different points (measured one
  bf16 step of the largest gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import satflow_tpu.ops.pallas.fused_convlstm_step as F
from satflow_tpu.nn.recurrent import FusedConvLSTMCell as JaxCell
from satflow_tpu_torch.nn.recurrent import FusedConvLSTMCell
from satflow_tpu_torch.ops import fused_convlstm_step as P

B, H, W, CX, CH = 2, 16, 16, 4, 8
NAMES = ("x", "h", "c", "wx", "wh", "b")


def _inputs(seed=0, b=B, hgt=H, wdt=W, cx=CX, ch=CH):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, hgt, wdt, cx)).astype(np.float32)
    h = rng.normal(size=(b, hgt, wdt, ch)).astype(np.float32)
    c = rng.normal(size=(b, hgt, wdt, ch)).astype(np.float32)
    wx = (rng.normal(size=(3, 3, cx, 4 * ch)) * 0.1).astype(np.float32)
    wh = (rng.normal(size=(3, 3, ch, 4 * ch)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(4 * ch,)) * 0.1).astype(np.float32)
    return x, h, c, wx, wh, bias


def _cotangents(seed=1, b=B, hgt=H, wdt=W, ch=CH):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hgt, wdt, ch)).astype(np.float32),
            rng.normal(size=(b, hgt, wdt, ch)).astype(np.float32))


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded_interior"])
def test_gate_bwd_ref_matches_jax_kernel(monkeypatch, padded):
    """K2's plain version against the JAX kernel in interpret mode; the
    padded form (x, h, dh' in the (W+2) layout, dh' with nonzero halo
    columns that the kernel must drop) against the port on the interior."""
    monkeypatch.setattr(F, "_INTERPRET", True)
    args = _inputs()
    dh, dc = _cotangents()
    x, h, c, wx, wh, b = (jnp.asarray(a) for a in args)
    if padded:
        dh_p = np.random.default_rng(2).normal(size=(B, H, W + 2, CH)).astype(np.float32)
        dh_p[:, :, 1:-1] = dh
        dg_j, dc_j = F._gate_bwd_pallas(F._pad_w(x), F._pad_w(h), c, wx, wh, b,
                                        jnp.asarray(dh_p), jnp.asarray(dc), padded=True)
    else:
        dg_j, dc_j = F._gate_bwd_pallas(x, h, c, wx, wh, b, jnp.asarray(dh), jnp.asarray(dc))
    launches = P.gate_bwd.launches
    dg_t, dc_t = P.gate_bwd(*(torch.from_numpy(a) for a in (*args, dh, dc)))
    assert P.gate_bwd.launches == launches  # the CPU path launches nothing
    assert dg_t.shape == (B, H, W, 4 * CH) and dc_t.shape == (B, H, W, CH)
    np.testing.assert_allclose(dg_t.numpy(), np.asarray(dg_j), atol=2e-5)
    np.testing.assert_allclose(dc_t.numpy(), np.asarray(dc_j), atol=2e-5)


def test_gate_bwd_math_matches_jax():
    """The f32 chain alone, on the same pre-activations."""
    rng = np.random.default_rng(3)
    gates = rng.normal(size=(B, H, W, 4 * CH)).astype(np.float32) * 2
    c, dh, dc = (rng.normal(size=(B, H, W, CH)).astype(np.float32) for _ in range(3))
    want = F._gate_bwd_math(*(jnp.asarray(a) for a in (gates, c, dh, dc)))
    got = P.gate_bwd_math(*(torch.from_numpy(a) for a in (gates, c, dh, dc)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def _torch_grads(step, args, dh, dc, dtype=torch.float32):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in args]
    h_next, c_next = step(*ts)
    loss = (h_next.float() * torch.from_numpy(dh)).sum() + (c_next.float() * torch.from_numpy(dc)).sum()
    loss.backward()
    return [t.grad.float().numpy() for t in ts], h_next


def _jax_grads(args, dh, dc, use_pallas, dtype=jnp.float32):
    def loss(*a):
        h_next, c_next = F.fused_convlstm_step(*a, use_pallas=use_pallas)
        return (jnp.sum(h_next.astype(jnp.float32) * dh)
                + jnp.sum(c_next.astype(jnp.float32) * dc))

    grads = jax.grad(loss, argnums=tuple(range(6)))(*(jnp.asarray(a, dtype) for a in args))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def test_function_grads_match_jax_kernel(monkeypatch):
    """dx, dh, dc, dWx, dWh, db through FusedConvLSTMStep (plain K1 and K2
    on the CPU) against jax.grad through the Pallas forward and backward."""
    monkeypatch.setattr(F, "_INTERPRET", True)
    args, (dh, dc) = _inputs(seed=4), _cotangents(seed=5)
    got, h_next = _torch_grads(P.fused_convlstm_step, args, dh, dc)
    assert type(h_next.grad_fn).__name__ == "FusedConvLSTMStepBackward"
    want = _jax_grads(args, dh, dc, use_pallas=True)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, err_msg=name)


def test_function_grads_match_plain_autograd():
    args, (dh, dc) = _inputs(seed=6), _cotangents(seed=7)
    got, _ = _torch_grads(P.fused_convlstm_step, args, dh, dc)
    want, _ = _torch_grads(P.fused_convlstm_step_ref, args, dh, dc)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)


def test_function_grads_bf16_match_jax():
    """bfloat16 against jax.grad of the JAX step in bf16 (XLA reference)."""
    args, (dh, dc) = _inputs(seed=8), _cotangents(seed=9)
    got, h_next = _torch_grads(P.fused_convlstm_step, args, dh, dc, torch.bfloat16)
    assert h_next.dtype == torch.bfloat16
    want = _jax_grads(args, dh, dc, use_pallas=False, dtype=jnp.bfloat16)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, atol=2e-2 * np.abs(w).max(), err_msg=name)


def test_step_saves_nothing_without_grad():
    """Serving path: under inference_mode / no_grad, or with no input that
    requires grad, the step is the bare forward (no autograd node)."""
    args = [torch.from_numpy(a) for a in _inputs(seed=10)]
    weights = [a.clone().requires_grad_() for a in args[3:]]
    with torch.inference_mode():
        h_next, _ = P.fused_convlstm_step(*args[:3], *weights)
    assert h_next.grad_fn is None and not h_next.requires_grad
    with torch.no_grad():
        h_next, _ = P.fused_convlstm_step(*args[:3], *weights)
    assert h_next.grad_fn is None
    h_next, _ = P.fused_convlstm_step(*args)
    assert h_next.grad_fn is None
    h_next, _ = P.fused_convlstm_step(*args[:3], *weights)
    assert type(h_next.grad_fn).__name__ == "FusedConvLSTMStepBackward"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cell_parameter_grads_match_jax(dtype):
    """Every parameter of the cell gets a nonzero gradient, in f32 through
    the per-call cast to the compute dtype, equal to jax.grad of the JAX
    cell on the same weights."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, H, W, CX)).astype(np.float32)
    h, c, dh, dc = (rng.normal(size=(B, H, W, CH)).astype(np.float32) for _ in range(4))
    jcell = JaxCell(CH, dtype=getattr(jnp, dtype))
    params = jcell.init(jax.random.PRNGKey(0), (h, c), x)
    params = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.3).astype(np.float32), params)

    def jloss(p):
        (h2, c2), _ = jcell.apply(p, (h, c), x)
        return jnp.sum(h2.astype(jnp.float32) * dh) + jnp.sum(c2.astype(jnp.float32) * dc)

    want = jax.grad(jloss)(params)["params"]
    cell = FusedConvLSTMCell(CX, CH, dtype=getattr(torch, dtype))
    cell.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params["params"].items()})
    (h2, c2), _ = cell((torch.from_numpy(h), torch.from_numpy(c)), torch.from_numpy(x))
    ((h2.float() * torch.from_numpy(dh)).sum() + (c2.float() * torch.from_numpy(dc)).sum()).backward()
    tol = 1e-4 if dtype == "float32" else None
    for name, p in cell.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert p.grad.abs().sum() > 0, name
        w = np.asarray(want[name], np.float32)
        np.testing.assert_allclose(p.grad.numpy(), w, atol=tol or 2e-2 * np.abs(w).max(),
                                   err_msg=name)


def _meta(cx=12, ch=64, dtype=torch.float32, b=2, hgt=8, wdt=8):
    def t(*shape):
        return torch.empty(*shape, dtype=dtype, device="meta")

    return (t(b, hgt, wdt, cx), t(b, hgt, wdt, ch), t(b, hgt, wdt, ch),
            t(3, 3, cx, 4 * ch), t(3, 3, ch, 4 * ch), t(4 * ch), t(b, hgt, wdt, ch),
            t(b, hgt, wdt, ch))


@pytest.mark.parametrize(
    "args, error, match",
    [
        # widths outside kernel_takes (the widths it takes: test_torch_widths.py)
        (_meta(ch=264), ValueError, "1 <= Ch <= 256"),
        (_meta(cx=260), ValueError, "1 <= Cx <= 256"),
        (_meta(dtype=torch.float16), TypeError, "float32 or bfloat16"),
        (_meta()[:6] + (torch.empty(2, 8, 9, 64, device="meta"),) + _meta()[7:],
         ValueError, "dh_next"),
        (_meta(), ValueError, "cpu or cuda tensors, not meta"),
    ],
    ids=["hidden", "cx", "dtype", "dh_shape", "device"],
)
def test_gate_bwd_rejects_what_the_kernel_does_not_take(args, error, match):
    """Tensors off the CPU never reach the plain version: they pass the
    kernel's checks or raise (meta tensors stand in for a card here)."""
    with pytest.raises(error, match=match):
        P.gate_bwd(*args)
