"""PyTorch port, int8 serving on the CPU: the quantizers, the int8 step's
plain version, the int8 rollout and the int8 session against the JAX
package on the same numpy-seeded weights and inputs.

The JAX side runs as its own tests run it on the CPU: its exact XLA
reference ``_step_ref_int8`` and its Pallas kernel in interpret mode, on the
(W+2)-padded layout that the port drops (padded on the way in, stripped on
the way out here). The port's wrapper takes its plain version for CPU
tensors.

Tolerances:
- ``w3q`` and ``xq`` are bit-equal: the same f32 division, product and
  round-half-even on both sides. ``dequant``: 1e-7 relative.
- the integer gate sums are exact on every side (|acc| <= 9·(Cx+Ch)·127²
  < 2^31), so after them only ``exp``/``tanh`` differ, by an ulp, between
  XLA and ATen. ``h'q = rint(h'·127)`` may then flip by one step at a
  rounding boundary: max |diff| <= 1 on at most 0.1 % of elements. c' is
  held to one step of its dtype at |c'| < 2 (bf16: 2^-7; f32: 1e-6).
- rollouts and sessions: 2e-2 on the sigmoid outputs, the JAX package's own
  int8-vs-bf16 bar (``tests/test_int8.py``); the per-lead-time MSE bars are
  those of ``test_int8_per_lead_time_error_bounded``.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import satflow_tpu.models  # noqa: F401 - populate the JAX registry
import satflow_tpu.ops.pallas.fused_convlstm_int8 as J8
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu.core.registry import create_model as jax_create_model
from satflow_tpu.models.conv_lstm import ConvLSTMCore as JaxCore
from satflow_tpu.serve.session import InferenceSession as JaxSession
from satflow_tpu_torch.core.registry import create_model
from satflow_tpu_torch.interop.jax_weights import params_from_flax
from satflow_tpu_torch.models.conv_lstm import ConvLSTMCore
from satflow_tpu_torch.ops import fused_convlstm_int8 as P8
from satflow_tpu_torch.serve import InferenceSession, MicroBatcher

B, H, W, CX, CH = 2, 16, 16, 8, 8
BF16_STEP = 2.0 ** -7  # one bf16 step for 1 <= |c'| < 2


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cell_weights(seed, cx=CX, ch=CH):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(3, 3, cx, 4 * ch)) * 0.1).astype(np.float32),
            (rng.normal(size=(3, 3, ch, 4 * ch)) * 0.1).astype(np.float32),
            (rng.normal(size=(4 * ch,)) * 0.1).astype(np.float32))


def _step_inputs(seed, c_dtype, cx=CX, ch=CH, h=H, w=W):
    """Quantized weights from the JAX quantizer and int8 x, h plus c, numpy."""
    rng = np.random.default_rng(seed)
    w3q, dq, bf = (np.asarray(a) for a in J8.quantize_weights(*_cell_weights(seed, cx, ch)))
    xq = np.asarray(J8.quantize_activations(rng.random((B, h, w, cx)).astype(np.float32)))
    hq = np.asarray(J8.quantize_activations(
        (rng.random((B, h, w, ch)) * 2 - 1).astype(np.float32)))
    c = (rng.random((B, h, w, ch)) * 2 - 1).astype(np.float32)
    c_j = jnp.asarray(c).astype(c_dtype)
    return xq, hq, c_j, w3q, dq, bf


def _pad_w(a):
    return jnp.pad(jnp.asarray(a), ((0, 0), (0, 0), (1, 1), (0, 0)))


def _torch_c(c_j):
    if c_j.dtype == jnp.bfloat16:
        return _t(np.asarray(c_j.astype(jnp.float32))).to(torch.bfloat16)
    return _t(c_j)


def _assert_step_close(hq_t, c_t, hq_j, c_j, c_step):
    diff = np.abs(hq_t.numpy().astype(np.int32) - np.asarray(hq_j, np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() <= 1e-3
    np.testing.assert_allclose(c_t.float().numpy(), np.asarray(c_j.astype(jnp.float32)),
                               atol=c_step, rtol=0)


@pytest.mark.parametrize("cx, ch", [(4, 8), (12, 64), (64, 64)])
def test_quantize_weights_matches_jax(cx, ch):
    wx, wh, b = _cell_weights(0, cx, ch)
    w3q_j, dq_j, b_j = J8.quantize_weights(wx, wh, b)
    w3q, dq, bf = P8.quantize_weights(_t(wx), _t(wh), _t(b))
    assert w3q.dtype == torch.int8 and tuple(w3q.shape) == (3, 3 * cx + 3 * ch, 4 * ch)
    np.testing.assert_array_equal(w3q.numpy(), np.asarray(w3q_j))
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_j), rtol=1e-7, atol=0)
    np.testing.assert_array_equal(bf.numpy(), np.asarray(b_j))
    assert dq.shape == bf.shape == (1, 4 * ch)


def test_quantize_weights_of_a_zero_column_stay_finite():
    wx, wh, b = (_t(a) for a in _cell_weights(1))
    wx[..., 3] = 0
    wh[..., 3] = 0
    w3q, dq, _ = P8.quantize_weights(wx, wh, b)
    assert int(w3q[..., 3].abs().max()) == 0 and torch.isfinite(dq).all() and float(dq[0, 3]) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_matches_jax(dtype):
    rng = np.random.default_rng(2)
    a = np.concatenate([rng.random(4096) * 2 - 1,
                        (np.arange(-127, 128) + 0.5) / 127.0,  # the halves
                        [-1.5, 1.5, -1.0, 1.0, 0.0]]).astype(np.float32)
    aq_j = J8.quantize_activations(jnp.asarray(a).astype(dtype))
    aq = P8.quantize_activations(_t(a).to(getattr(torch, dtype)))
    assert aq.dtype == torch.int8
    np.testing.assert_array_equal(aq.numpy(), np.asarray(aq_j))
    back = P8.dequantize_activations(aq)
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.float().numpy(),
                                  np.asarray(J8.dequantize_activations(aq_j), np.float32))


@pytest.mark.parametrize("cx, ch", [(8, 8), (12, 64)])
def test_int8_accumulate_is_exact(cx, ch):
    """The float64 conv gives the integer sums of a direct int64 loop, also
    at the extreme values, where float32 would round."""
    rng = np.random.default_rng(3)
    xq = rng.integers(-127, 128, size=(1, 5, 6, cx)).astype(np.int8)
    hq = rng.integers(-127, 128, size=(1, 5, 6, ch)).astype(np.int8)
    w3q = rng.integers(-127, 128, size=(3, 3 * cx + 3 * ch, 4 * ch)).astype(np.int8)
    xq[0, 2, 2], hq[0, 2, 2] = 127, 127
    xq[0, 1:4, 1:4], hq[0, 1:4, 1:4] = 127, 127
    w3q[..., 0] = 127
    acc = P8.int8_accumulate(_t(xq), _t(hq), _t(w3q)).numpy()
    assert acc.dtype == np.int32 and acc[0, 2, 2, 0] == 9 * (cx + ch) * 127 * 127
    xp = np.pad(xq.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    hp = np.pad(hq.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = np.zeros((1, 5, 6, 4 * ch), np.int64)
    for dy in range(3):
        win = np.concatenate([xp[:, dy:dy + 5, dx:dx + 6] for dx in range(3)]
                             + [hp[:, dy:dy + 5, dx:dx + 6] for dx in range(3)], axis=-1)
        want += win @ w3q[dy].astype(np.int64)
    np.testing.assert_array_equal(acc, want)


@pytest.mark.parametrize("c_dtype, c_step", [("bfloat16", BF16_STEP), ("float32", 1e-6)])
@pytest.mark.parametrize("cx, ch", [(8, 8), (12, 64)])
def test_step_matches_jax_reference(cx, ch, c_dtype, c_step):
    xq, hq, c_j, w3q, dq, bf = _step_inputs(4, c_dtype, cx, ch)
    hq_j, c_next_j = J8._step_ref_int8(_pad_w(xq), _pad_w(hq), c_j, jnp.asarray(w3q),
                                       jnp.asarray(dq), jnp.asarray(bf))
    hq_t, c_t = P8.fused_convlstm_step_int8(_t(xq), _t(hq), _torch_c(c_j), _t(w3q), _t(dq),
                                            _t(bf))
    assert hq_t.dtype == torch.int8 and c_t.dtype == getattr(torch, c_dtype)
    assert float(jnp.abs(hq_j[:, :, 0]).max()) == float(jnp.abs(hq_j[:, :, -1]).max()) == 0
    _assert_step_close(hq_t, c_t, hq_j[:, :, 1:-1], c_next_j, c_step)


def test_step_matches_jax_interpret_kernel(monkeypatch):
    """The Pallas kernel body in interpret mode, W halo padded in and out."""
    monkeypatch.setattr(J8, "_INTERPRET", True)
    xq, hq, c_j, w3q, dq, bf = _step_inputs(5, "bfloat16")
    hq_j, c_next_j = J8.fused_convlstm_step_int8(
        _pad_w(xq), _pad_w(hq), c_j, jnp.asarray(w3q), jnp.asarray(dq), jnp.asarray(bf),
        use_pallas=True)
    hq_t, c_t = P8.fused_convlstm_step_int8(_t(xq), _t(hq), _torch_c(c_j), _t(w3q), _t(dq),
                                            _t(bf))
    _assert_step_close(hq_t, c_t, hq_j[:, :, 1:-1], c_next_j, BF16_STEP)


@pytest.mark.parametrize("ch", [8, 16, 24, 32])
def test_step_at_the_small_hidden_widths_matches_jax(monkeypatch, ch):
    """K5's plain version at hidden 8, 16 and 32 (widths K5 is built for) and
    24 (which it runs at 32), Cx = 12, against JAX's ``_step_ref_int8`` and its
    Pallas kernel in interpret mode: h'q bit-equal; c' within one bf16 step
    (the integer sums agree exactly, but exp and tanh differ by an ulp between
    XLA and ATen, which moves c' by one bf16 step on about 1 element in 6000)."""
    monkeypatch.setattr(J8, "_INTERPRET", True)
    xq, hq, c_j, w3q, dq, bf = _step_inputs(20 + ch, "bfloat16", 12, ch)
    hq_t, c_t = P8.fused_convlstm_step_int8(_t(xq), _t(hq), _torch_c(c_j), _t(w3q), _t(dq),
                                            _t(bf))
    weights = (jnp.asarray(w3q), jnp.asarray(dq), jnp.asarray(bf))
    for hq_j, c_next_j in (J8._step_ref_int8(_pad_w(xq), _pad_w(hq), c_j, *weights),
                           J8.fused_convlstm_step_int8(_pad_w(xq), _pad_w(hq), c_j, *weights,
                                                      use_pallas=True)):
        np.testing.assert_array_equal(hq_t.numpy(), np.asarray(hq_j[:, :, 1:-1]))
        np.testing.assert_allclose(c_t.float().numpy(), np.asarray(c_next_j.astype(jnp.float32)),
                                   atol=BF16_STEP, rtol=0)


@pytest.mark.parametrize("cx", [4, 12, 64, 1, 13])
def test_pack_weights_holds_every_weight_where_the_kernel_reads_it(cx):
    """K-major int8 (9, 4Ch, Kp): per tap and gate column x's Cx weights, zeros
    up to a multiple of 32, h's Ch weights, zeros up to a multiple of 32 (the
    byte order of K5's staged window), at every hidden width K5 is built for."""
    for ch in P8.KERNEL_HIDDEN_WIDTHS:
        rng = np.random.default_rng(6 + ch)
        w3q = _t(rng.integers(-127, 128, size=(3, 3 * cx + 3 * ch, 4 * ch)).astype(np.int8))
        packed = P8.pack_weights(w3q, cx)
        cxp, chp = -(-cx // 32) * 32, -(-ch // 32) * 32
        assert P8.packed_depth(cx, ch) == cxp + chp
        assert packed.dtype == torch.int8 and tuple(packed.shape) == (9, 4 * ch, cxp + chp)
        assert packed.is_contiguous()
        for tap, k, col in [(0, 0, 0), (4, cx - 1, 17 % (4 * ch)), (8, cxp, 4 * ch - 1),
                            (5, cxp + ch - 1, 4 * ch // 2), (2, cxp + ch // 2, 3)]:
            dy, dx = divmod(tap, 3)
            row = dx * cx + k if k < cx else 3 * cx + dx * ch + (k - cxp)
            assert int(packed[tap, col, k]) == int(w3q[dy, row, col])
        # every weight once, in place: the packed tensor without its zero bytes
        x_part = packed[:, :, :cx].reshape(3, 3, 4 * ch, cx).permute(0, 1, 3, 2)
        h_part = packed[:, :, cxp:cxp + ch].reshape(3, 3, 4 * ch, ch).permute(0, 1, 3, 2)
        assert torch.equal(x_part.reshape(3, 3 * cx, 4 * ch), w3q[:, :3 * cx])
        assert torch.equal(h_part.reshape(3, 3 * ch, 4 * ch), w3q[:, 3 * cx:])
        assert not packed[:, :, cx:cxp].any() and not packed[:, :, cxp + ch:].any()


@pytest.mark.parametrize("cx, ch, takes", [(12, 64, True), (64, 64, True), (256, 64, True),
                                           (4, 64, True), (6, 64, True), (0, 64, False),
                                           (260, 64, False), (8, 8, True), (64, 128, True),
                                           (13, 24, True), (1, 1, True), (12, 129, False),
                                           (12, 136, False), (12, 0, False), (12, 16, True),
                                           (12, 32, True), (12, 33, True), (12, 100, True)])
def test_kernel_dispatch_rule(cx, ch, takes):
    """Every hidden width from 1 to 128 and Cx from 1 to 256 launches K5 on
    the card, padded to the next width it is built for (8, 16, 32, 64, 128:
    hidden 24 runs at 32, not 64) and Cx to a multiple of 4; any other raises."""
    assert P8.KERNEL_HIDDEN_WIDTHS == (8, 16, 32, 64, 128)
    assert P8.kernel_takes(cx, ch) is takes
    if takes:
        cx_to, ch_to = P8.kernel_widths(cx, ch)
        assert ch_to in P8.KERNEL_HIDDEN_WIDTHS and ch_to >= ch and cx_to % 4 == 0
        assert cx <= cx_to < cx + 4
        assert ch_to == min(w for w in P8.KERNEL_HIDDEN_WIDTHS if w >= ch)
    else:
        with pytest.raises(ValueError, match=r"1 <= Ch <= 128 and 1 <= Cx <= 256"):
            P8.kernel_widths(cx, ch)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """The checks that precede a launch, reached here with CPU tensors (the
    device type is checked last)."""
    xq, hq, c_j, w3q, dq, bf = _step_inputs(7, "bfloat16", 12, 64)
    args = [_t(xq), _t(hq), _torch_c(c_j), _t(w3q), _t(dq), _t(bf)]
    packed = P8.pack_weights(args[3], 12)
    with pytest.raises(ValueError, match="cpu or cuda"):
        P8._check(*args, packed)
    with pytest.raises(TypeError, match="hq must be torch.int8"):
        P8._check(args[0], args[1].to(torch.int32), *args[2:], packed)
    with pytest.raises(TypeError, match="c must be"):
        P8._check(args[0], args[1], args[2].half(), *args[3:], packed)
    with pytest.raises(ValueError, match="contiguous"):
        P8._check(args[0].transpose(1, 2), *args[1:], packed)
    with pytest.raises(ValueError, match="w_packed"):
        P8._check(*args, packed[:, :-1].contiguous())
    with pytest.raises(TypeError, match="w_packed must be torch.int8"):  # the __dp4a layout
        P8._check(*args, packed.view(torch.int32))
    wide = _step_inputs(7, "bfloat16", 8, 136, h=4, w=4)
    wide = [_t(wide[0]), _t(wide[1]), _torch_c(wide[2]), *(_t(a) for a in wide[3:])]
    with pytest.raises(ValueError, match=r"1 <= Ch <= 128 and 1 <= Cx <= 256"):
        P8._check(*wide, P8.pack_weights(wide[3], 8))


# ---------------------------------------------------------------------------
# rollout and session
# ---------------------------------------------------------------------------

RB, RT, RS, RC, RHID = 2, 3, 16, 4, 8


def _flax_core(steps, seed=0):
    core = JaxCore(hidden_dim=RHID, out_channels=RC, forecast_steps=steps, cell_impl="fused")
    v = core.init(jax.random.PRNGKey(0), np.zeros((1, RT, RS, RS, RC), np.float32))
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.15).astype(np.float32), v)
    return core, v


def _port_core(variables, steps):
    core = ConvLSTMCore(hidden_dim=RHID, in_channels=RC, out_channels=RC, forecast_steps=steps)
    core.load_state_dict(params_from_flax(variables))
    return core.eval()


def _rollout_x(seed=1):
    return np.random.default_rng(seed).random((RB, RT, RS, RS, RC)).astype(np.float32)


def test_quantized_params_match_jax_bit_for_bit():
    """flax params -> port -> quantized equals JAX's quantize_convlstm_params."""
    _, v = _flax_core(4)
    qp_j = J8.quantize_convlstm_params(v["params"])
    qp = P8.quantize_convlstm_params(_port_core(v, 4))
    for name in ("encoder_1", "encoder_2", "decoder_1", "decoder_2"):
        w3q_j, dq_j, b_j = qp_j[name]
        np.testing.assert_array_equal(qp[name].w3q.numpy(), np.asarray(w3q_j))
        np.testing.assert_allclose(qp[name].dequant.numpy(), np.asarray(dq_j), rtol=1e-7, atol=0)
        np.testing.assert_array_equal(qp[name].bias.numpy(), np.asarray(b_j))
        assert qp[name].w_packed.dtype == torch.int8  # K5's K-major layout
        cx = qp[name].w3q.shape[1] // 3 - RHID
        assert torch.equal(qp[name].w_packed, P8.pack_weights(qp[name].w3q, cx))
    head_j = np.asarray(qp_j["head"]["kernel"].astype(jnp.float32))  # HWIO
    np.testing.assert_array_equal(
        qp["head"]["kernel"].float().permute(2, 3, 1, 0).numpy(), head_j)
    assert qp["head"]["bias"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="fused-cell"):
        P8.quantize_convlstm_params(torch.nn.Linear(2, 2))


@pytest.mark.parametrize("steps", [6, 24])
def test_int8_rollout_matches_jax(steps):
    core_j, v = _flax_core(steps)
    x = _rollout_x()
    y_j = np.asarray(J8.int8_rollout(J8.quantize_convlstm_params(v["params"]),
                                     jnp.asarray(x), steps).astype(jnp.float32))
    with torch.inference_mode():
        y = P8.int8_rollout(P8.quantize_convlstm_params(_port_core(v, steps)), _t(x), steps)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (RB, steps, RS, RS, RC)
    assert float(np.abs(y.float().numpy() - y_j).max()) <= 2e-2


def test_int8_rollout_close_to_f32():
    """The bars of the JAX package's ``test_int8_rollout_close_to_bf16``:
    small absolute deviation and a near-zero SSIM loss against the port's own
    f32 rollout."""
    from satflow_tpu.nn.losses import get_loss

    steps = 6
    _, v = _flax_core(steps)
    core = _port_core(v, steps)
    x = _rollout_x(2)
    with torch.inference_mode():
        y_ref = core(_t(x)).numpy()
        y_i8 = P8.int8_rollout(P8.quantize_convlstm_params(core), _t(x), steps).float().numpy()
    assert y_i8.shape == y_ref.shape
    assert float(np.abs(y_ref - y_i8).max()) < 0.02
    ssim = get_loss("ssim", convert_range=False)
    a = jnp.asarray(y_ref).reshape(RB * steps, RS, RS, RC)
    b = jnp.asarray(y_i8).reshape(RB * steps, RS, RS, RC)
    assert float(ssim(a, b)) < 0.01


def test_int8_per_lead_time_error_bounded():
    """24 autoregressive steps: the int8-vs-f32 MSE per lead time stays small
    and does not compound (the JAX package's bars). The weights are the flax
    initialisation's scale, as there."""
    steps = 24
    core_j = JaxCore(hidden_dim=RHID, out_channels=RC, forecast_steps=steps, cell_impl="fused")
    x = _rollout_x(3)
    v = jax.tree_util.tree_map(np.asarray, core_j.init(jax.random.PRNGKey(7), jnp.asarray(x)))
    core = _port_core(v, steps)
    with torch.inference_mode():
        y_ref = core(_t(x)).numpy()
        y_i8 = P8.int8_rollout(P8.quantize_convlstm_params(core), _t(x), steps).float().numpy()
    err = ((y_ref - y_i8) ** 2).mean(axis=(0, 2, 3, 4))
    assert err.shape == (steps,)
    assert float(err.max()) < 5e-6
    assert float(err[-1]) <= 2.0 * float(err[:3].max())
    assert float(err[steps // 2:].max()) <= 2.0 * float(err[: steps // 2].max())


def test_rollout_takes_another_step_implementation():
    calls = []

    def counting(*args):
        calls.append(args[0].shape[-1])
        return P8.fused_convlstm_step_int8_ref(*args)

    _, v = _flax_core(2)
    qp = P8.quantize_convlstm_params(_port_core(v, 2))
    with torch.inference_mode():
        y = P8.int8_rollout(qp, _t(_rollout_x()), 2, step=counting)
        want = P8.int8_rollout(qp, _t(_rollout_x()), 2)
    assert calls == [RC, RHID] * RT + [RHID, RHID] * 2
    torch.testing.assert_close(y, want, rtol=0, atol=0)


SKW = dict(input_channels=RC, out_channels=RC, forecast_steps=4, hidden_dim=RHID,
           cell_impl="fused")


@pytest.fixture(scope="module")
def served():
    jmodel = jax_create_model("encoderdecoderconvlstm", **SKW)
    x = _rollout_x(4)
    v = jax.tree_util.tree_map(np.asarray, jmodel.module.init(jax.random.PRNGKey(0),
                                                              jnp.asarray(x)))
    return jmodel, v, x


def _session(v, **kw):
    return InferenceSession(create_model("encoderdecoderconvlstm", **SKW), max_batch=2,
                            variables=v, device="cpu", **kw)


def test_int8_session_close_to_bf16_and_to_jax(served):
    jmodel, v, x = served
    y_i8 = _session(v, quantize="int8").predict(x)
    y_bf = _session(v, dtype=torch.bfloat16).predict(x)
    y_f32 = _session(v).predict(x)
    assert y_i8.shape == y_bf.shape == (RB, 4, RS, RS, RC) and y_i8.dtype == np.float32
    assert float(np.abs(y_bf - y_i8).max()) < 0.02
    assert float(np.abs(y_f32 - y_i8).max()) < 0.02
    y_j = JaxSession(jmodel, max_batch=2, variables=v, quantize="int8").predict(x)
    assert float(np.abs(y_j - y_i8).max()) <= 2e-2


def test_int8_session_reply_dtype_and_padding(served):
    _, v, x = served
    s = _session(v, quantize="int8", out_dtype=torch.float16)
    y = s.predict(x[:1])
    assert y.dtype == np.float16 and y.shape == (1, 4, RS, RS, RC)
    full = s.predict(x)
    np.testing.assert_array_equal(y, full[:1])  # pad rows do not leak into a sample


def test_int8_session_refusals(served):
    _, v, _ = served
    with pytest.raises(ValueError, match="unknown quantize mode"):
        _session(v, quantize="int4")
    with pytest.raises(ValueError, match="dtype does not apply"):
        _session(v, quantize="int8", dtype=torch.bfloat16)
    gan = create_model("encoderdecoderconvlstm", **SKW)
    gan.is_gan = True
    with pytest.raises(ValueError, match="forward models only"):
        InferenceSession(gan, variables=v, quantize="int8")
    cmajor = create_model("encoderdecoderconvlstm", **{**SKW, "cell_impl": "cmajor"})
    with pytest.raises(ValueError, match="requires a fused-cell ConvLSTM"):
        InferenceSession(cmajor, variables=v, quantize="int8")


def test_int8_session_refuses_metnet():
    metnet = create_model("litmetnet", forecast_steps=2, hidden_dim=8, output_channels=4)
    with torch.no_grad():
        metnet.eval()(torch.zeros(1, 2, 32, 32, 4))  # creates the lazy parameters
    with pytest.raises(ValueError, match="requires a fused-cell ConvLSTM"):
        InferenceSession(metnet, state_dict=metnet.module.state_dict(), quantize="int8")


def test_int8_range_check_is_per_request(served):
    """An out-of-range request fails alone, in ``predict`` and through the
    ``MicroBatcher``, which checks before pooling."""
    _, v, x = served
    s = _session(v, quantize="int8")
    with pytest.raises(ValueError, match="int8"):
        s.predict(x * 3.0)
    s.check_input_range(x * (1.0 + 5e-4))  # inside the 1e-3 slack
    _session(v).check_input_range(x * 3.0)  # a no-op without int8
    mb = MicroBatcher(s, window_ms=200.0)
    results = {}

    def client(name, sample):
        try:
            results[name] = mb.submit(sample, timeout=120.0)
        except ValueError as e:
            results[name] = e

    try:
        threads = [threading.Thread(target=client, args=("bad", x[0] * 3.0)),
                   threading.Thread(target=client, args=("good", x[1]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads)
    finally:
        mb.close()
    assert isinstance(results["bad"], ValueError) and "int8" in str(results["bad"])
    assert results["good"].shape == (4, RS, RS, RC) and np.isfinite(results["good"]).all()
    np.testing.assert_array_equal(results["good"], s.predict(x[1:2])[0])


def test_time_int8_needs_a_card_and_bounds_by_the_larger_time(monkeypatch):
    """The timing tool refuses to run without a card (it measures nothing on
    the CPU), and its bound is the larger of the bytes at 3.35 TB/s and the
    operations at the type's peak."""
    from satflow_tpu_torch.tools import time_int8

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        time_int8.main()
    t = torch.zeros(1000, dtype=torch.int8)  # 1 kB: 3e-7 ms at the memory rate
    assert time_int8.bound_ms([t], 1979e12, "int8") == pytest.approx(1e3)
    assert time_int8.bound_ms([t] * 3350, 0.0, "bf16") == pytest.approx(1e-3)

