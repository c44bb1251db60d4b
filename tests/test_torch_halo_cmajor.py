"""PyTorch port, on the CPU: the width rules of the halo step (K1h), the
channel-major step (K6a), the int8 step (K5), the fused step and its backward
(K1, K2) and the study kernels (T1, T2, K1p, T3); the padding that lets each
take every width up to its limit; and the plain versions at hidden widths
other than 64 against the JAX package's Pallas kernels in interpret mode, on
the same numpy-seeded inputs. The kernels' own checks on the card are in
``tests/test_torch_gpu.py``.

Run: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_halo_cmajor.py -q``.

Tolerances, stated where used:
- width rules and the int8 padding: exact (booleans, integers, bits).
- K1h and K6a, float32, against ``_step_pallas_halo`` / ``_cell_pallas`` in
  interpret mode: atol 2e-5, the JAX package's own bar against its
  reference (the same f32 products summed in another order). Zero-padded and
  sliced back, against the unpadded plain version: 2e-5 as well.
- K5 against ``fused_convlstm_step_int8`` in interpret mode: the integer sums
  are exact, so h'q may flip by one step on at most 0.1 % of elements and c'
  differs by at most one step of its dtype (``tests/test_torch_int8.py``).
- the channel-major core at hidden 32 against the JAX core: float32 2e-5.
- the study tools' own ``verify``: their stated bars (1e-4; T3 2e-5).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import satflow_tpu.ops.pallas.cmajor_convlstm as JCM
import satflow_tpu.ops.pallas.fused_convlstm_int8 as J8
import satflow_tpu.ops.pallas.fused_convlstm_step as F
from satflow_tpu.models.conv_lstm import ConvLSTMCore as JaxCore
from satflow_tpu_torch.interop.jax_weights import params_from_flax
from satflow_tpu_torch.models.conv_lstm import ConvLSTMCore
from satflow_tpu_torch.ops import cmajor_convlstm as CM
from satflow_tpu_torch.ops import fused_convlstm_int8 as P8
from satflow_tpu_torch.ops import fused_convlstm_step as P
from satflow_tpu_torch.tools import exp_cmajor as XC
from satflow_tpu_torch.tools import exp_tap9 as XT

CSRC = Path(P.__file__).resolve().parent.parent / "csrc"
BF16_STEP = 2.0 ** -7  # one bf16 step for 1 <= |c'| < 2


def _inputs(seed, cx, ch, b=2, hgt=16, wdt=16):
    rng = np.random.default_rng(seed)
    shapes = [((b, hgt, wdt, cx), 1.0), ((b, hgt, wdt, ch), 1.0), ((b, hgt, wdt, ch), 1.0),
              ((3, 3, cx, 4 * ch), 0.1), ((3, 3, ch, 4 * ch), 0.1), ((4 * ch,), 0.1)]
    return [(rng.normal(size=s) * scale).astype(np.float32) for s, scale in shapes]


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the width rules, on meta tensors (they stand in for a card) -----------------

def _meta(*shapes, dtypes=None):
    dtypes = dtypes or [torch.float32] * len(shapes)
    return [torch.empty(*s, dtype=d, device="meta") for s, d in zip(shapes, dtypes)]


def _nhwc(cx, ch, hgt=16):
    return _meta((2, hgt, 16, cx), (2, hgt, 16, ch), (2, hgt, 16, ch), (3, 3, cx, 4 * ch),
                 (3, 3, ch, 4 * ch), (4 * ch,))


def _call(kernel, cx, ch):
    """Hand ``kernel``'s wrapper checks meta tensors of widths (Cx, Ch)."""
    if kernel == "K1h":
        return P.fused_convlstm_step_halo(*_nhwc(cx, ch))
    if kernel == "K1":
        return P._step(*_nhwc(cx, ch))
    if kernel == "K2":
        return P.gate_bwd(*_nhwc(cx, ch), *_meta((2, 16, 16, ch), (2, 16, 16, ch)))
    if kernel == "K6a":
        x, h, c, wx, wh, b = _nhwc(cx, ch)
        return CM._check_cell(*_meta((2, cx, 256), (2, ch, 256), (2, ch, 256)), wx, wh, b, 16, 16)
    if kernel == "K5":
        i8, f32 = torch.int8, torch.float32
        return P8._check(*_meta((2, 8, 8, cx), (2, 8, 8, ch), (2, 8, 8, ch),
                                (3, 3 * cx + 3 * ch, 4 * ch), (4 * ch,), (4 * ch,),
                                dtypes=[i8, i8, f32, i8, f32, f32]))
    if kernel in ("T1", "T2", "K1p"):
        fn = {"T1": XT.step_tap9, "T2": XT.step_nogate, "K1p": XT.step_padded}[kernel]
        x, h, c, wx, wh, b = _nhwc(cx, ch)
        return fn(*_meta((2, 16, 18, cx), (2, 16, 18, ch)), c, wx, wh, b, block_h=8)
    assert kernel == "T3" and cx == ch
    sp = (16 + 2 * 8) * 32
    return XC.cmajor_step(*_meta((1, ch, sp), (1, ch, sp), (1, ch, sp), (9, 4 * ch, 2 * ch),
                                 (4 * ch, 1)), 8, 16, 32)


# (kernel, widest hidden width it takes, the rule's words when it refuses)
RULES = [("K1h", 256, r"1 <= Ch <= 256 \(built for \(8, 16, 32, 64, 128, 256\)"),
         ("K1", 256, r"1 <= Ch <= 256 \(built for \(8, 16, 32, 64, 128, 256\)"),
         ("K2", 256, r"1 <= Ch <= 256 \(built for \(8, 16, 32, 64, 128, 256\)"),
         ("K6a", 128, r"1 <= Ch <= 128 \(built for \(8, 16, 32, 64, 128\)"),
         ("K5", 128, r"1 <= Ch <= 128 and 1 <= Cx <= 256"),
         ("T1", 128, r"1 <= Ch <= 128 \(built for \(8, 16, 32, 64, 128\)"),
         ("T2", 128, r"1 <= Ch <= 128 \(built for \(8, 16, 32, 64, 128\)"),
         ("K1p", 128, r"1 <= Ch <= 128 \(built for \(8, 16, 32, 64, 128\)"),
         ("T3", 128, r"1 <= C <= 128 \(built for \(8, 16, 32, 64, 128\)")]


@pytest.mark.parametrize("kernel, widest, rule", RULES, ids=[r[0] for r in RULES])
@pytest.mark.parametrize("ch", [1, 8, 13, 24, 32, 64, 100, 128, 136, 192, 256, 264])
def test_width_rule(kernel, widest, rule, ch):
    """Every hidden width up to the kernel's widest passes every check up to
    the device type (a width it is not built for is zero-padded on the card);
    a wider one raises and names the rule. T3 takes C for x and h alike."""
    cx = ch if kernel == "T3" else 12
    if ch <= widest:
        with pytest.raises(ValueError, match="cpu or cuda tensors, not meta"):
            _call(kernel, cx, ch)
    else:
        with pytest.raises(ValueError, match=rule):
            _call(kernel, cx, ch)


@pytest.mark.parametrize("kernel", ["K1h", "K1", "K2", "K6a", "K5", "T1", "T2", "K1p"])
@pytest.mark.parametrize("cx, takes", [(1, True), (13, True), (256, True), (257, False)])
def test_input_width_rule(kernel, cx, takes):
    """Every input width from 1 to 256 passes (K5 and the study kernels pad
    it to a multiple of 4 on the card); 257 raises."""
    if takes:
        with pytest.raises(ValueError, match="cpu or cuda tensors, not meta"):
            _call(kernel, cx, 24)
    else:
        with pytest.raises(ValueError, match="1 <= Cx <= 256"):
            _call(kernel, cx, 24)


@pytest.mark.parametrize("ch, want", [(1, 8), (8, 8), (9, 16), (24, 32), (100, 128), (128, 128),
                                      (129, 256), (136, 256), (192, 256), (256, 256)])
def test_padded_hidden_widths(ch, want):
    """K1, K2 and K1h run a width at the next they are built for (129-255 in
    two groups of 128, the last one partly zeros); K6a, K5 and the study
    kernels share the rule up to 128 (K5's Cx goes to a multiple of 4)."""
    assert P.padded_hidden(ch) == want
    if ch <= 128:
        assert P.padded_hidden(ch, CM.CELL_HIDDEN_WIDTHS) == want
        assert P.padded_hidden(ch, XT.KERNEL_HIDDEN_WIDTHS) == want
        assert P.padded_hidden(ch, XC.KERNEL_CHANNEL_WIDTHS) == want
        assert P.padded_hidden(ch, P8.KERNEL_HIDDEN_WIDTHS) == want
        assert P8.kernel_widths(13, ch) == (16, want)


# -- K5's padding: exact at the real channels -------------------------------------

@pytest.mark.parametrize("cx, ch", [(12, 16), (13, 24), (12, 32), (1, 8), (12, 40), (5, 100)])
def test_padded_quantized_weights_are_jax_quantized_padded_weights(cx, ch):
    """Quantizing the zero-padded float weights with the JAX quantizer gives,
    on the real rows and columns, ``pad_quantized``'s bits: w3q equal, the
    dequant scales equal; the padded rows and columns of w3q are zeros, as
    are pad_quantized's dequant and bias there, so a padded column's integer
    sum is 0 and its gates exact zeros whatever its scale."""
    wx, wh, bias = _inputs(40 + cx + ch, cx, ch)[3:]
    cx_to, ch_to = P8.kernel_widths(cx, ch)
    w3q, dq, b = P8.quantize_weights(_t(wx), _t(wh), _t(bias))
    w3q_p, dq_p, b_p = P8.pad_quantized(w3q, dq, b, cx, cx_to, ch_to)
    assert w3q_p.shape == (3, 3 * cx_to + 3 * ch_to, 4 * ch_to) and dq_p.numel() == 4 * ch_to

    wxp, whp, bp = P.pad_step_weights(_t(wx), _t(wh), _t(bias), ch_to)
    wxp = torch.nn.functional.pad(wxp, (0, 0, 0, cx_to - cx))
    jw3q, jdq, jb = (np.asarray(a) for a in J8.quantize_weights(
        jnp.asarray(wxp.numpy()), jnp.asarray(whp.numpy()), jnp.asarray(bp.numpy())))
    real = np.concatenate([g * ch_to + np.arange(ch) for g in range(4)])
    pad = np.setdiff1d(np.arange(4 * ch_to), real)
    np.testing.assert_array_equal(w3q_p.numpy(), jw3q)
    np.testing.assert_array_equal(dq_p.numpy().ravel()[real], jdq.ravel()[real])
    np.testing.assert_array_equal(b_p.numpy().ravel(), jb.ravel())
    assert not w3q_p.numpy()[..., pad].any()
    assert not dq_p.numpy().ravel()[pad].any() and not b_p.numpy().ravel()[pad].any()


@pytest.mark.parametrize("c_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("cx, ch", [(12, 16), (13, 24), (12, 32), (1, 8), (12, 40), (5, 100)])
def test_padded_int8_step_is_bit_equal_at_the_real_channels(cx, ch, c_dtype):
    """On operands padded as the card pads them (channels of xq, hq, c;
    ``pad_quantized`` weights) the integer sums and the dequantized gate
    pre-activations are, at the real channels, the very bits of the unpadded
    step's, and exact zeros at the padded ones; so are h'q. c' is held to one
    step of its dtype: ATen's vectorised sigmoid and tanh differ by an ulp
    between the vector body and the tail of a loop, and the padding moves
    elements between the two (|c'| < 2 here: one step is 2^-7 in bf16, 2^-22
    in f32)."""
    rng = np.random.default_rng(50 + ch)
    wx, wh, bias = (_t(a) for a in _inputs(50 + cx, cx, ch)[3:])
    w3q, dq, b = P8.quantize_weights(wx, wh, bias)
    xq = P8.quantize_activations(_t(rng.random((2, 8, 12, cx), np.float32)))
    hq = P8.quantize_activations(_t(rng.random((2, 8, 12, ch), np.float32) * 2 - 1))
    c = _t(rng.normal(size=(2, 8, 12, ch)).astype(np.float32)).to(c_dtype)
    cx_to, ch_to = P8.kernel_widths(cx, ch)
    padded = (P.pad_channels(xq, cx_to), P.pad_channels(hq, ch_to), P.pad_channels(c, ch_to),
              *P8.pad_quantized(w3q, dq, b, cx, cx_to, ch_to))

    def pre_activations(xq, hq, w3q, dq, b):
        return P8.int8_accumulate(xq, hq, w3q), (P8.int8_accumulate(xq, hq, w3q).float() * dq
                                                 + b)

    acc, accf = pre_activations(xq, hq, w3q, dq, b)
    acc_p, accf_p = pre_activations(padded[0], padded[1], *padded[3:])
    assert torch.equal(P.slice_gate_columns(acc_p, ch), acc)
    assert torch.equal(P.slice_gate_columns(accf_p, ch), accf)
    assert not (acc_p - P.pad_gate_columns(acc, ch_to)).any()
    assert not (accf_p - P.pad_gate_columns(accf, ch_to)).any()
    want_h, want_c = P8.fused_convlstm_step_int8(xq, hq, c, w3q, dq, b)
    got_h, got_c = P8.fused_convlstm_step_int8(*padded)
    assert torch.equal(got_h[..., :ch], want_h) and not got_h[..., ch:].any()
    assert not got_c[..., ch:].any()
    step = BF16_STEP if c_dtype == torch.bfloat16 else 2.0 ** -22  # one step at |c'| < 2
    torch.testing.assert_close(got_c[..., :ch], want_c, atol=step, rtol=0)


@pytest.mark.parametrize("hidden", [16, 24])
def test_padded_int8_rollout_is_bit_equal(hidden):
    """``quantize_convlstm_params(pad=True)`` (what a core on the card does)
    and the rollout at the padded widths give the unpadded rollout's bits."""
    core = ConvLSTMCore(hidden_dim=hidden, in_channels=5, out_channels=3, forecast_steps=2,
                        generator=torch.Generator().manual_seed(hidden)).eval()
    x = torch.rand(1, 2, 8, 16, 5, generator=torch.Generator().manual_seed(1))
    padded = P8.quantize_convlstm_params(core, pad=True)
    ch_to = 32 if hidden > 16 else 16  # built for 16; 24 runs at 32
    assert padded["encoder_1"].w3q.shape == (3, 3 * 8 + 3 * ch_to, 4 * ch_to)
    assert padded["encoder_2"].w3q.shape == (3, 3 * ch_to + 3 * ch_to, 4 * ch_to)
    with torch.inference_mode():
        got = P8.int8_rollout(padded, x, 2)
        want = P8.int8_rollout(P8.quantize_convlstm_params(core), x, 2)
    assert got.shape == (1, 2, 8, 16, 3) and torch.equal(got, want)


# -- the plain versions at other widths against the JAX kernels --------------------

WIDTHS = [(12, 16), (8, 24), (12, 32)]


@pytest.mark.parametrize("cx, ch", WIDTHS)
def test_halo_step_matches_jax_kernel(monkeypatch, cx, ch):
    """K1h's plain version against ``_step_pallas_halo`` in interpret mode at
    hidden 16, 24, 32 (three row blocks), and K1h's padded operands (what the
    card runs at 24) sliced back: float32 atol 2e-5."""
    monkeypatch.setattr(F, "_INTERPRET", True)
    args = _inputs(60 + ch, cx, ch, hgt=24)
    h_j, c_j = (np.asarray(a) for a in F._step_pallas_halo(*map(jnp.asarray, args)))
    x, h, c, wx, wh, b = map(_t, args)
    h_t, c_t = P.fused_convlstm_step_halo(x, h, c, wx, wh, b)
    np.testing.assert_allclose(h_t.numpy(), h_j, atol=2e-5)
    np.testing.assert_allclose(c_t.numpy(), c_j, atol=2e-5)
    chp = P.padded_hidden(ch)
    h_p, c_p = P.fused_convlstm_step_halo_ref(x, *P.pad_step_operands(h, c, wx, wh, b, chp))
    assert not h_p[..., ch:].any() and not c_p[..., ch:].any()
    np.testing.assert_allclose(h_p[..., :ch].numpy(), h_j, atol=2e-5)
    np.testing.assert_allclose(c_p[..., :ch].numpy(), c_j, atol=2e-5)


@pytest.mark.parametrize("cx, ch", WIDTHS)
def test_cmajor_step_matches_jax_kernel(monkeypatch, cx, ch):
    """K6a's plain version against ``_cell_pallas`` in interpret mode at
    hidden 16, 24, 32 (the JAX layout's pad rows stripped), and the padded
    operands the card runs sliced back: float32 atol 2e-5."""
    monkeypatch.setattr(JCM, "_INTERPRET", True)
    hgt, wdt, bh = 8, 128, 4
    args = _inputs(70 + ch, cx, ch, hgt=hgt, wdt=wdt)
    jx, jh, jc = (JCM.to_cmajor(jnp.asarray(a), bh) for a in args[:3])
    w9 = JCM.weights_cmajor(jnp.asarray(args[3]), jnp.asarray(args[4]))
    h_j, c_j = JCM._cell_pallas(jx, jh, jc, w9, jnp.asarray(args[5]).reshape(-1, 1), bh, hgt,
                                wdt)
    want_h, want_c = (np.asarray(JCM.from_cmajor(a, hgt, wdt, bh)) for a in (h_j, c_j))
    xc, hc, cc = (CM.to_cmajor(_t(a)) for a in args[:3])
    wx, wh, b = map(_t, args[3:])
    h_t, c_t = CM.cmajor_convlstm_step(xc, hc, cc, wx, wh, b, hgt, wdt)
    np.testing.assert_allclose(CM.from_cmajor(h_t, hgt, wdt).numpy(), want_h, atol=2e-5)
    np.testing.assert_allclose(CM.from_cmajor(c_t, hgt, wdt).numpy(), want_c, atol=2e-5)
    chp = P.padded_hidden(ch, CM.CELL_HIDDEN_WIDTHS)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, chp - ch))  # noqa: E731
    h_p, c_p = CM.cmajor_convlstm_step_ref(xc, pad(hc), pad(cc),
                                           *P.pad_step_weights(wx, wh, b, chp), hgt, wdt)
    assert not h_p[:, ch:].any() and not c_p[:, ch:].any()
    np.testing.assert_allclose(CM.from_cmajor(h_p[:, :ch], hgt, wdt).numpy(), want_h, atol=2e-5)
    np.testing.assert_allclose(CM.from_cmajor(c_p[:, :ch], hgt, wdt).numpy(), want_c, atol=2e-5)


@pytest.mark.parametrize("cx, ch", WIDTHS)
def test_int8_step_matches_jax_kernel(monkeypatch, cx, ch):
    """The int8 step's plain version against the JAX Pallas kernel in
    interpret mode at hidden 16, 24, 32 (W halo padded in and out there): h'q
    within one step on at most 0.1 % of elements, c' within one bf16 step."""
    monkeypatch.setattr(J8, "_INTERPRET", True)
    rng = np.random.default_rng(80 + ch)
    wx, wh, bias = _inputs(80 + ch, cx, ch)[3:]
    w3q, dq, bf = (np.asarray(a) for a in J8.quantize_weights(wx, wh, bias))
    xq = np.asarray(J8.quantize_activations(rng.random((2, 8, 16, cx)).astype(np.float32)))
    hq = np.asarray(J8.quantize_activations((rng.random((2, 8, 16, ch)) * 2 - 1)
                                            .astype(np.float32)))
    c = jnp.asarray((rng.random((2, 8, 16, ch)) * 2 - 1).astype(np.float32)).astype(jnp.bfloat16)
    pad_w = lambda a: jnp.pad(jnp.asarray(a), ((0, 0), (0, 0), (1, 1), (0, 0)))  # noqa: E731
    hq_j, c_j = J8.fused_convlstm_step_int8(pad_w(xq), pad_w(hq), c, jnp.asarray(w3q),
                                            jnp.asarray(dq), jnp.asarray(bf), use_pallas=True)
    hq_t, c_t = P8.fused_convlstm_step_int8(
        _t(xq), _t(hq), _t(np.asarray(c.astype(jnp.float32))).to(torch.bfloat16), _t(w3q),
        _t(dq), _t(bf))
    diff = np.abs(hq_t.numpy().astype(np.int32) - np.asarray(hq_j[:, :, 1:-1], np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3
    np.testing.assert_allclose(c_t.float().numpy(), np.asarray(c_j.astype(jnp.float32)),
                               atol=BF16_STEP, rtol=0)


def test_cmajor_core_at_hidden_32_matches_jax():
    """``cell_impl="cmajor"`` at hidden 32, one of the hparam search's
    widths: the port's core against the JAX core on the same weights,
    float32 2e-5, through 6 channel-major steps and 3 heads."""
    kw = dict(hidden_dim=32, out_channels=4, forecast_steps=3)
    v = JaxCore(cell_impl="fused", **kw).init(jax.random.PRNGKey(0),
                                               np.zeros((1, 2, 8, 128, 4), np.float32))
    rng = np.random.default_rng(3)
    v = jax.tree_util.tree_map(lambda a: (rng.normal(size=a.shape) * 0.1).astype(np.float32), v)
    core = ConvLSTMCore(in_channels=4, cell_impl="cmajor", **kw)
    core.load_state_dict(params_from_flax(v))
    assert core.eval().runs_cmajor(8, 128)
    x = np.random.default_rng(4).random((1, 2, 8, 128, 4)).astype(np.float32)
    with torch.inference_mode():
        got = core(_t(x)).numpy()
    want = np.asarray(JaxCore(cell_impl="cmajor", **kw).apply(v, jnp.asarray(x)))
    assert got.shape == (1, 3, 8, 128, 4)
    np.testing.assert_allclose(got, want, atol=2e-5)


# -- the study tools at the JAX tool's width -----------------------------------------

def test_tap9_tool_verifies_at_the_jax_width():
    """``verify`` at the JAX tool's shape, Cx = Ch = 8: T1, K1p and T2 (their
    plain versions here) within the tool's 1e-4."""
    assert XT.verify("cpu", cx=8, ch=8) < 1e-4


@pytest.mark.parametrize("ch", [8, 16])
def test_cmajor_tool_verifies_at_the_jax_widths(ch):
    """T3's ``verify`` at the JAX tool's channel widths, float32 2e-5."""
    err_h, err_c = XC.verify("cpu", ch=ch)
    assert err_h < 2e-5 and err_c < 2e-5


@pytest.mark.parametrize("cx, ch", [(13, 24), (8, 8)])
def test_study_padding_is_exact(cx, ch):
    """The study kernels' padding (Ch to the next built width, Cx to a
    multiple of 4) leaves T1's plain step unchanged at the real channels and
    zeros elsewhere; T3's pads C alike for x and h."""
    x, h, c, wx, wh, b = map(_t, _inputs(90 + ch, cx, ch))
    xp, hp = XT.pad_w(x).contiguous(), XT.pad_w(h).contiguous()
    want = XT.step_tap9_ref(xp, hp, c, wx, wh, b)
    padded = XT.pad_operands(xp, hp, c, wx, wh, b)
    assert padded[0].shape[-1] % 4 == 0 and padded[1].shape[-1] in XT.KERNEL_HIDDEN_WIDTHS
    got = XT.step_tap9_ref(*padded)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[..., :ch].numpy(), w.numpy(), atol=2e-5)
        assert not g[..., ch:].any()
    if cx != ch:
        return
    bh, hgt, wdt = 8, 16, 16
    carry = [XC.to_cmajor(t, bh) for t in (x, h, c)]
    w9, b2 = XC.weights_cmajor(wx, wh), b.reshape(-1, 1)
    want = XC.cmajor_step_ref(*carry, w9, b2, bh, hgt, wdt)
    got = XC.cmajor_step_ref(*XC.pad_operands(*carry, w9, b2, 16), bh, hgt, wdt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:, :ch].numpy(), w.numpy(), atol=2e-5)
        assert not g[:, ch:].any()


# -- the sources: the two redesigned kernels contract on the tensor cores --------------

def _code(name: str) -> str:
    text = (CSRC / name).read_text()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


@pytest.mark.parametrize("name, source", [("fused_convlstm_step_halo.cu", "HaloRows"),
                                          ("cmajor_convlstm.cu", "CmajorRows")])
def test_bf16_instantiation_reaches_the_tensor_core_contraction(name, source):
    """The bf16 entry point launches the kernel on ``__nv_bfloat16``; for that
    type the shared contraction is ``convlstm_mma::gate_preactivations``, whose
    inner loop is ``mma_bf16`` (mma.sync); the kernel's window comes from its
    own source in ``convlstm_source.cuh``, not from a copy of the loop."""
    code = _code(name)
    assert '#include "convlstm_gates.cuh"' in code and f"{source}<T>" in code
    assert re.search(r"_bf16\([^)]*\)\s*\{[^}]*<__nv_bfloat16>", code, flags=re.S)
    # the step kernel holds no contraction loop of its own (K6b's head, in the
    # same source, has its own mma loop after it)
    step = code.split("cmajor_conv_mma_kernel")[0]
    assert "mma_bf16(" not in step
    assert re.search(r"convlstm_(mma|gates)::(gate_preactivations|for_each_gate_pair)<", step) \
        or "for_each_gate_pair<T, CH>" in step
    gates = _code("convlstm_gates.cuh")
    assert re.search(r"if constexpr \(kTensorCores<T>\)\s*\{[^}]*convlstm_mma::gate_preactivations",
                     gates, flags=re.S)
    mma = _code("convlstm_mma.cuh")
    loop = mma.split("gate_preactivations(")[1]
    assert "mma_bf16(acc" in loop and "src.template stage_bf16<CH>" in loop
    assert f"struct {source}" in _code("convlstm_source.cuh")


@pytest.mark.parametrize("name", ["fused_convlstm_step_halo.cu", "cmajor_convlstm.cu",
                                  "convlstm_source.cuh", "convlstm_mma.cuh",
                                  "fused_convlstm_int8.cu", "exp_cmajor.cu"])
def test_no_library_call_in_the_contraction(name):
    """No cuBLAS, cuDNN, CUTLASS or PyTorch call stands in for the
    contraction; the only library the sources reach is the CUDA runtime."""
    code = _code(name).lower()
    for word in ("cublas", "cudnn", "cutlass", "torch", "at::", "gemm("):
        assert word not in code, (name, word)


def test_int8_step_contracts_on_the_int8_tensor_cores():
    """K5 contracts on mma.sync m16n8k32 .s8 (IMMA), through the shared
    contraction in its S8 type with K-major weights read by a plain ldmatrix,
    its window from ImageRows; no __dp4a and no copy of the contraction's loop
    is left in its source."""
    code = _code("fused_convlstm_int8.cu")
    assert "__dp4a" not in code and "mma_s8(" not in code and "ldmatrix" not in code
    assert '#include "convlstm_gates.cuh"' in code
    assert re.search(r"convlstm_mma::gate_preactivations<CH, S8>\(", code)
    assert "KMajorWeights<CH>" in code and "ImageRows<int8_t>" in code
    mma = _code("convlstm_mma.cuh")
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in mma
    assert ".satfinite" not in mma
    loop = mma.split("gate_preactivations(")[1]
    assert "mma_s8(acc" in loop and "src.template stage_s8<CH>" in loop
    kmajor = mma.split("struct KMajorWeights")[1].split("};")[0]
    assert "ldmatrix_x4(r, addr)" in kmajor and "trans" not in kmajor
    assert "stage_s8" in _code("convlstm_source.cuh").split("struct ImageRows")[1]


def test_prototype_step_reaches_the_tensor_core_contraction_through_pad_rows():
    """T3's bfloat16 entry launches a kernel whose contraction is the shared
    one (convlstm_mma.cuh, Bf16) on a PadRows window with w9 read K-major as
    given, and whose epilogue is K6a's; the float32 kernel keeps its FMAs and
    holds no tensor-core instruction."""
    code = _code("exp_cmajor.cu")
    assert '#include "convlstm_gates.cuh"' in code
    bf16 = code.split("exp_cmajor_mma_kernel(")[1].split("inline bool geometry_ok")[0]
    assert "convlstm_source::PadRows<__nv_bfloat16>" in bf16
    assert re.search(r"convlstm_mma::gate_preactivations<C, convlstm_mma::Bf16>\(", bf16)
    assert "convlstm_mma::KMajorWeights<C>" in bf16 and "cmajor_lstm_bf16<C>" in bf16
    assert "exp_cmajor_mma_kernel<C><<<" in code.split("struct Step<__nv_bfloat16, C>")[1]
    f32 = code.split("exp_cmajor_step_kernel(")[1].split("exp_cmajor_mma_kernel(")[0]
    assert "fmaf(" in f32 and "mma" not in f32 and "ldmatrix" not in f32
    assert re.search(r"struct PadRows\s*:\s*CmajorRows<T>", _code("convlstm_source.cuh"))

