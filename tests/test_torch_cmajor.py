"""PyTorch port, the channel-major ConvLSTM decoder on the CPU: the layout
changes, the step's and the head's plain versions, their autograd Functions,
the geometry gate and ``ConvLSTMCore(cell_impl="cmajor")`` against the JAX
package on the same numpy-seeded weights and inputs.

The JAX side runs as its own tests run it on the CPU: its Pallas kernels in
interpret mode, on its (H + 2·block_h)-row padded layout, which the port
drops (the JAX ``from_cmajor`` strips it here). The port's wrappers take
their plain versions for CPU tensors.

Tolerances:
- step and head, float32: 2e-5 (the JAX package's own bar against its
  reference: the same f32 sums in another order).
- Function gradients against autograd of the NHWC plain step: 1e-4 (the JAX
  package's bar for its VJP); they repeat the same operations between two
  layout changes, so they agree far closer.
- core, float32: 2e-5 against the fused rollout and the JAX core; bfloat16:
  2e-2 on sigmoid outputs (both round states and the head to bf16, step 2^-8
  relative, at different points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import satflow_tpu.ops.pallas.cmajor_convlstm as JCM
from satflow_tpu.models.conv_lstm import ConvLSTMCore as JaxCore
from satflow_tpu_torch.interop.jax_weights import params_from_flax
from satflow_tpu_torch.models import conv_lstm as port_conv_lstm
from satflow_tpu_torch.models.conv_lstm import ConvLSTMCore
from satflow_tpu_torch.ops import cmajor_convlstm as CM
from satflow_tpu_torch.ops.fused_convlstm_step import conv3x3, fused_convlstm_step_ref

HGT, WDT = 16, 128


def _t(a):
    return torch.from_numpy(np.array(a))


def _cell_inputs(seed, b=2, hgt=HGT, wdt=WDT, cx=8, ch=8):
    rng = np.random.default_rng(seed)
    shapes = [((b, hgt, wdt, cx), 1.0), ((b, hgt, wdt, ch), 1.0), ((b, hgt, wdt, ch), 1.0),
              ((3, 3, cx, 4 * ch), 0.1), ((3, 3, ch, 4 * ch), 0.1), ((4 * ch,), 0.1)]
    return [(rng.normal(size=s) * scale).astype(np.float32) for s, scale in shapes]


def test_layout_round_trip_and_the_jax_frames():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, WDT, 8)).astype(np.float32)
    xc = CM.to_cmajor(_t(x))
    assert tuple(xc.shape) == (2, 8, 8 * WDT) and xc.is_contiguous()
    np.testing.assert_array_equal(CM.from_cmajor(xc, 8, WDT).numpy(), x)
    # the JAX layout is this one between block_h rows of zeros
    for bh in (2, 4):
        jc = np.asarray(JCM.to_cmajor(jnp.asarray(x), bh)).reshape(2, 8, 8 + 2 * bh, WDT)
        np.testing.assert_array_equal(jc[:, :, bh:-bh].reshape(2, 8, -1), xc.numpy())
    seq = rng.normal(size=(2, 3, 8, WDT, 8)).astype(np.float32)
    flat = torch.stack([CM.to_cmajor(_t(seq[:, t])) for t in range(3)], dim=1)
    got = CM.from_cmajor_seq(flat, 8, WDT)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), seq)
    jflat = jnp.stack([JCM.to_cmajor(jnp.asarray(seq[:, t]), 4) for t in range(3)], axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JCM.from_cmajor_seq(jflat, 8, WDT, 4)))


@pytest.mark.parametrize("cx", [8, 16])
def test_step_matches_jax_interpret_kernel(monkeypatch, cx):
    monkeypatch.setattr(JCM, "_INTERPRET", True)
    args = _cell_inputs(1, cx=cx)
    bh = 4
    jx, jh, jc = (JCM.to_cmajor(jnp.asarray(a), bh) for a in args[:3])
    h_j, c_j = JCM.cmajor_convlstm_step(jx, jh, jc, *map(jnp.asarray, args[3:]), bh, HGT, WDT)
    xc, hc, cc = (CM.to_cmajor(_t(a)) for a in args[:3])
    h_t, c_t = CM.cmajor_convlstm_step(xc, hc, cc, *map(_t, args[3:]), HGT, WDT)
    assert tuple(h_t.shape) == tuple(c_t.shape) == (2, 8, HGT * WDT)
    np.testing.assert_allclose(CM.from_cmajor(h_t, HGT, WDT).numpy(),
                               np.asarray(JCM.from_cmajor(h_j, HGT, WDT, bh)), atol=2e-5)
    np.testing.assert_allclose(CM.from_cmajor(c_t, HGT, WDT).numpy(),
                               np.asarray(JCM.from_cmajor(c_j, HGT, WDT, bh)), atol=2e-5)
    # and the NHWC plain step, which the plain version wraps
    h_n, c_n = fused_convlstm_step_ref(*map(_t, args))
    torch.testing.assert_close(CM.from_cmajor(h_t, HGT, WDT), h_n, rtol=0, atol=0)
    torch.testing.assert_close(CM.from_cmajor(c_t, HGT, WDT), c_n, rtol=0, atol=0)


@pytest.mark.parametrize("cout", [12, 4])
def test_conv_head_matches_jax_interpret_kernel(monkeypatch, cout):
    monkeypatch.setattr(JCM, "_INTERPRET", True)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, HGT, WDT, 8)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 8, cout)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    out_j = JCM.cmajor_conv3x3(JCM.to_cmajor(jnp.asarray(x), 4), jnp.asarray(w),
                               jnp.asarray(b), 4, HGT, WDT)
    out = CM.cmajor_conv3x3(CM.to_cmajor(_t(x)), _t(w), _t(b), HGT, WDT)
    assert tuple(out.shape) == (2, cout, HGT * WDT)
    np.testing.assert_allclose(CM.from_cmajor(out, HGT, WDT).numpy(),
                               np.asarray(JCM.from_cmajor(out_j, HGT, WDT, 4)), atol=2e-5)


def test_step_function_gradients_match_the_nhwc_step():
    args = _cell_inputs(3, b=1, hgt=8)
    rng = np.random.default_rng(4)
    gh, gc = (_t(rng.normal(size=(1, 8, WDT, 8)).astype(np.float32)) for _ in range(2))

    def grads(step_in_cmajor):
        leaves = [_t(a).requires_grad_() for a in args]
        if step_in_cmajor:
            xc, hc, cc = (CM.to_cmajor(t) for t in leaves[:3])
            h2, c2 = CM.cmajor_convlstm_step(xc, hc, cc, *leaves[3:], 8, WDT)
            assert h2.grad_fn is not None and type(h2.grad_fn).__name__.startswith(
                "CMajorConvLSTMStep")
            h2, c2 = CM.from_cmajor(h2, 8, WDT), CM.from_cmajor(c2, 8, WDT)
        else:
            h2, c2 = fused_convlstm_step_ref(*leaves)
        return torch.autograd.grad((h2 * gh).sum() + (c2 * gc).sum(), leaves)

    for got, want in zip(grads(True), grads(False)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)

    # and the JAX VJP on the same numbers
    def f_jax(*a):
        xc, hc, cc = (JCM.to_cmajor(t, 4) for t in a[:3])
        h2, c2 = JCM.cmajor_convlstm_step(xc, hc, cc, *a[3:], 4, 8, WDT)
        return (jnp.sum(JCM.from_cmajor(h2, 8, WDT, 4) * gh.numpy())
                + jnp.sum(JCM.from_cmajor(c2, 8, WDT, 4) * gc.numpy()))

    g_j = jax.grad(f_jax, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    for got, want in zip(grads(True), g_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_conv_function_gradients_match_a_plain_conv():
    rng = np.random.default_rng(5)
    vals = [rng.normal(size=(1, 8, WDT, 8)).astype(np.float32),
            (rng.normal(size=(3, 3, 8, 12)) * 0.1).astype(np.float32),
            (rng.normal(size=(12,)) * 0.1).astype(np.float32)]
    g = _t(rng.normal(size=(1, 8, WDT, 12)).astype(np.float32))

    def grads(in_cmajor):
        x, w, b = (_t(a).requires_grad_() for a in vals)
        if in_cmajor:
            out = CM.cmajor_conv3x3(CM.to_cmajor(x), w, b, 8, WDT)
            assert type(out.grad_fn).__name__.startswith("CMajorConv3x3")
            out = CM.from_cmajor(out, 8, WDT)
        else:
            out = conv3x3(x, w) + b
        return torch.autograd.grad((out * g).sum(), (x, w, b))

    for got, want in zip(grads(True), grads(False)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_no_graph_without_grad():
    args = [_t(a) for a in _cell_inputs(6, b=1, hgt=8)]
    args[3].requires_grad_()
    xc, hc, cc = (CM.to_cmajor(t) for t in args[:3])
    with torch.no_grad():
        h2, _ = CM.cmajor_convlstm_step(xc, hc, cc, *args[3:], 8, WDT)
    assert h2.grad_fn is None and not h2.requires_grad


@pytest.mark.parametrize("geometry", [(256, 256, 64, 64), (256, 100, 64), (256, 256, 12),
                                      (250, 128, 8), (8, 128, 8, 12), (16, 64, 8)])
def test_geometry_gate_is_the_jax_one(geometry):
    assert CM.cmajor_supported(*geometry) == JCM.cmajor_supported(*geometry)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks that precede a launch, reached here with CPU tensors (the
    device type is checked last)."""
    args = [_t(a) for a in _cell_inputs(7, b=1, hgt=8, cx=64, ch=64)]
    cm = [CM.to_cmajor(t) for t in args[:3]] + args[3:]
    with pytest.raises(ValueError, match="cpu or cuda"):
        CM._check_cell(*cm, 8, WDT)
    with pytest.raises(ValueError, match=r"\(B, C, H\*W\)"):
        CM._check_cell(*cm, 8, WDT // 2)
    with pytest.raises(TypeError, match="h is torch.bfloat16"):
        CM._check_cell(cm[0], cm[1].bfloat16(), *cm[2:], 8, WDT)
    with pytest.raises(ValueError, match="contiguous"):
        CM._check_cell(cm[0], cm[1], cm[2], cm[3].transpose(0, 1), *cm[4:], 8, WDT)
    with pytest.raises(ValueError, match="weights must be"):
        CM._check_cell(*cm[:4], cm[4][..., :8].contiguous(), cm[5], 8, WDT)
    small = [_t(a) for a in _cell_inputs(7, b=1, hgt=8)]
    small = [CM.to_cmajor(t) for t in small[:3]] + small[3:]
    with pytest.raises(ValueError, match="hidden width 64"):
        CM._check_cell(*small, 8, WDT)
    x, w, b = cm[0], torch.zeros(3, 3, 64, 12), torch.zeros(12)
    with pytest.raises(ValueError, match="cpu or cuda"):
        CM._check_conv(x, w, b, 8, WDT)
    with pytest.raises(ValueError, match="Cout <= 16"):
        CM._check_conv(x, torch.zeros(3, 3, 64, 24), torch.zeros(24), 8, WDT)
    with pytest.raises(ValueError, match="weights must be"):
        CM._check_conv(x, torch.zeros(3, 3, 32, 12), b, 8, WDT)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

KW = dict(hidden_dim=8, out_channels=4, forecast_steps=3)


def _flax(steps=3, width=WDT, seed=0, **kw):
    core = JaxCore(cell_impl="fused", **{**KW, "forecast_steps": steps, **kw})
    v = core.init(jax.random.PRNGKey(0), np.zeros((1, 2, 8, width, 4), np.float32))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.2).astype(np.float32), v)


def _port(v, cell_impl, **kw):
    core = ConvLSTMCore(in_channels=4, cell_impl=cell_impl, **{**KW, **kw})
    core.load_state_dict(params_from_flax(v))
    return core.eval()


def _count_cmajor_calls(monkeypatch):
    calls = {"step": 0, "conv": 0}

    def step(*a):
        calls["step"] += 1
        return CM.cmajor_convlstm_step(*a)

    def conv(*a):
        calls["conv"] += 1
        return CM.cmajor_conv3x3(*a)

    monkeypatch.setattr(port_conv_lstm, "cmajor_convlstm_step", step)
    monkeypatch.setattr(port_conv_lstm, "cmajor_conv3x3", conv)
    return calls


@pytest.mark.parametrize("dtype, atol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_core_cmajor_matches_fused_and_jax(monkeypatch, dtype, atol):
    """The same fused parameter tree serves both formulations."""
    v = _flax()
    x = np.random.default_rng(1).random((1, 2, 8, WDT, 4)).astype(np.float32)
    tdtype = getattr(torch, dtype)
    calls = _count_cmajor_calls(monkeypatch)
    m_c, m_f = _port(v, "cmajor", dtype=tdtype), _port(v, "fused", dtype=tdtype)
    assert list(m_c.state_dict()) == list(m_f.state_dict())
    with torch.inference_mode():
        y_c = m_c(_t(x))
        assert calls == {"step": 6, "conv": 3}
        y_f = m_f(_t(x))
    assert calls == {"step": 6, "conv": 3}
    assert tuple(y_c.shape) == (1, 3, 8, WDT, 4) and y_c.dtype == tdtype
    np.testing.assert_allclose(y_c.float().numpy(), y_f.float().numpy(), atol=atol)
    y_j = JaxCore(cell_impl="cmajor", dtype=getattr(jnp, dtype), **KW).apply(v, jnp.asarray(x))
    np.testing.assert_allclose(y_c.float().numpy(), np.asarray(y_j.astype(jnp.float32)),
                               atol=atol)


def test_core_cmajor_takes_a_step_count_per_call(monkeypatch):
    v = _flax()
    x = _t(np.random.default_rng(2).random((1, 2, 8, WDT, 4)).astype(np.float32))
    calls = _count_cmajor_calls(monkeypatch)
    with torch.inference_mode():
        y = _port(v, "cmajor")(x, forecast_steps=5)
        want = _port(v, "fused")(x, forecast_steps=5)
    assert calls == {"step": 10, "conv": 5} and tuple(y.shape) == (1, 5, 8, WDT, 4)
    torch.testing.assert_close(y, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("case", ["width", "head_in_scan", "chunked_remat"])
def test_core_cmajor_degrades_to_fused(monkeypatch, case):
    """Where the JAX model declines the channel-major rollout (a width the
    geometry gate refuses, the head outside the scan, the chunked remat
    layout), ``"cmajor"`` runs the fused decoder: the same outputs, no
    channel-major call, no error."""
    width = 64 if case == "width" else WDT
    kw = {"head_in_scan": dict(head_in_scan=False),
          "chunked_remat": dict(remat=True, remat_chunk=3)}.get(case, {})
    v = _flax(width=width, **kw)  # the flax tree nests by these options; the bridge flattens it
    x = np.random.default_rng(3).random((1, 2, 8, width, 4)).astype(np.float32)
    calls = _count_cmajor_calls(monkeypatch)
    m_c = _port(v, "cmajor", **kw)
    assert not m_c.runs_cmajor(8, width)
    with torch.inference_mode():
        y_c, y_f = m_c(_t(x)), _port(v, "fused", **kw)(_t(x))
    assert calls == {"step": 0, "conv": 0}
    torch.testing.assert_close(y_c, y_f, rtol=0, atol=0)
    y_j = JaxCore(cell_impl="cmajor", **{**KW, **kw}).apply(v, jnp.asarray(x))
    np.testing.assert_allclose(y_c.numpy(), np.asarray(y_j), atol=2e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_core_cmajor_gradients_match_fused(remat):
    """Training through the channel-major decoder (its backward goes through
    the plain NHWC step) gives the fused model's gradients; per-step remat
    changes memory, not values."""
    v = _flax()
    x = _t(np.random.default_rng(4).random((1, 2, 8, WDT, 4)).astype(np.float32))
    grads = {}
    for impl in ("cmajor", "fused"):
        m = _port(v, impl, remat=remat).train()
        m(x).square().mean().backward()
        grads[impl] = {k: p.grad for k, p in m.named_parameters()}
    assert all(g is not None for g in grads["cmajor"].values())
    for k, g in grads["fused"].items():
        torch.testing.assert_close(grads["cmajor"][k], g, rtol=0, atol=1e-4 * float(g.abs().max()))


def test_model_hparam_reaches_the_core():
    import satflow_tpu_torch.models  # noqa: F401 - populate the registry
    from satflow_tpu_torch.core.registry import create_model

    model = create_model("encoderdecoderconvlstm", input_channels=4, out_channels=4,
                         forecast_steps=2, hidden_dim=8, cell_impl="cmajor",
                         head_in_scan=False)
    assert model.module.cell_impl == "cmajor" and model.module.head_in_scan is False
    assert model.hparams()["cell_impl"] == "cmajor"
    for impl in ("concat", "split", "hybrid"):  # ported since: they reach the core too
        core = create_model("encoderdecoderconvlstm", hidden_dim=8, cell_impl=impl).module
        assert core.cell_impl == impl and not core.is_fused
    with pytest.raises(ValueError, match="Unknown cell_impl"):
        ConvLSTMCore(cell_impl="cmajor2")
