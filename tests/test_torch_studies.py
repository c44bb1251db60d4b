"""PyTorch port, the halo step variant and the two kernel studies, on the CPU
(the kernels' plain versions) against the JAX package's Pallas kernels run in
interpret mode and its XLA references, on the same numpy-seeded inputs.

Tolerances, stated where used:
- ``build_halo`` and the layout helpers are gathers and transposes: exact.
- the halo step (K1h) against ``_step_pallas_halo`` and ``_step_ref``: float32
  atol 2e-5, as ``tests/test_fused_step.py`` holds the JAX kernels: the same
  f32 products summed in another order.
- T1 against ``step_tap9(interpret=True)`` and ``_step_ref_padded``, T2 against
  ``step_nogate``: float32 atol 1e-4, the JAX tool's own bar. K1p, the tool's
  yardstick, against the JAX yardstick ``fused_convlstm_step_padded`` in
  interpret mode: atol 2e-5 (the main kernel's bar).
- T3 against ``cmajor_step(interpret=True)``: float32 atol 2e-5, bfloat16
  2e-2, the JAX tool's bars; pad rows exactly zero.
- the six gradients under ``halo`` against ``jax.grad`` of the JAX step:
  atol 1e-5 x max|grad| (as ``tests/test_torch_gate_bwd.py``).
"""

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import satflow_tpu.ops.pallas.fused_convlstm_step as F
from satflow_tpu_torch.ops import fused_convlstm_step as P
from satflow_tpu_torch.tools import exp_cmajor as XC
from satflow_tpu_torch.tools import exp_tap9 as XT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    """A JAX study tool, loaded by file path (``tools/`` is no package)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tap9():
    return _load_tool("exp_tap9")


@pytest.fixture(scope="module")
def jax_cmajor():
    return _load_tool("exp_cmajor")


def _inputs(seed=0, b=2, hgt=16, wdt=16, cx=4, ch=8, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, hgt, wdt, cx)) * scale).astype(np.float32)
    h = (rng.normal(size=(b, hgt, wdt, ch)) * scale).astype(np.float32)
    c = (rng.normal(size=(b, hgt, wdt, ch)) * scale).astype(np.float32)
    wx = (rng.normal(size=(3, 3, cx, 4 * ch)) * 0.1).astype(np.float32)
    wh = (rng.normal(size=(3, 3, ch, 4 * ch)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(4 * ch,)) * 0.1).astype(np.float32)
    return x, h, c, wx, wh, bias


def _t(args, dtype=None):
    out = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)
    return tuple(a.to(dtype) for a in out) if dtype else out


def _pad_w(a):
    return np.pad(a, ((0, 0), (0, 0), (1, 1), (0, 0)))


# --------------------------------------------------------------------------- K1h


@pytest.mark.parametrize("hgt, block_h", [(16, 8), (8, 8), (16, 4), (24, 8), (6, 1)])
def test_build_halo_matches_jax_exactly(hgt, block_h):
    """The port's side tensor is the JAX one on the unpadded layout: the JAX
    function takes the W-padded input, whose halo columns it carries along."""
    a = np.random.default_rng(hgt).normal(size=(2, hgt, 5, 3)).astype(np.float32)
    want = np.asarray(F._build_halo(jnp.asarray(_pad_w(a)), block_h))
    got = P.build_halo(torch.from_numpy(a), block_h).numpy()
    assert got.shape == (2, hgt // block_h, 2, 5, 3)
    np.testing.assert_array_equal(got, want[:, :, :, 1:-1])
    np.testing.assert_array_equal(want[:, :, :, (0, -1)], 0.0)
    # against plain slicing: the row above / below every block, zeros at the edges
    for r in range(hgt // block_h):
        top = a[:, r * block_h - 1] if r else np.zeros_like(a[:, 0])
        bot = a[:, (r + 1) * block_h] if (r + 1) * block_h < hgt else np.zeros_like(a[:, 0])
        np.testing.assert_array_equal(got[:, r, 0], top)
        np.testing.assert_array_equal(got[:, r, 1], bot)


def test_build_halo_rejects_a_ragged_height():
    with pytest.raises(ValueError, match="H % block_h == 0"):
        P.build_halo(torch.zeros(1, 12, 4, 2), 8)


@pytest.mark.parametrize("shape", [dict(), dict(b=1, hgt=8, wdt=8, cx=3), dict(hgt=24, wdt=12)],
                         ids=["two_blocks", "one_block", "three_blocks"])
def test_halo_step_matches_jax_kernel_and_reference(monkeypatch, shape):
    """float32 atol 2e-5 against ``_step_pallas_halo`` in interpret mode and
    against ``_step_ref``; H = block_h (one block: both halo rows are the
    image's edge zeros) and the rows on either side of every block boundary
    on their own."""
    monkeypatch.setattr(F, "_INTERPRET", True)
    args = _inputs(seed=3, **shape)
    jargs = tuple(jnp.asarray(a) for a in args)
    h_k, c_k = (np.asarray(a) for a in F._step_pallas_halo(*jargs))
    h_r, c_r = (np.asarray(a) for a in F._step_ref(*jargs))
    before = P.fused_convlstm_step_halo.launches
    h_t, c_t = (a.numpy() for a in P.fused_convlstm_step_halo(*_t(args)))
    assert P.fused_convlstm_step_halo.launches == before  # the CPU path launches nothing
    for want_h, want_c in ((h_k, c_k), (h_r, c_r)):
        np.testing.assert_allclose(h_t, want_h, atol=2e-5)
        np.testing.assert_allclose(c_t, want_c, atol=2e-5)
    hgt = args[0].shape[1]
    rows = sorted({0, hgt - 1} | {r for b in range(8, hgt, 8) for r in (b - 1, b)})
    for row in rows:
        np.testing.assert_allclose(h_t[:, row], h_k[:, row], atol=2e-5)
        np.testing.assert_allclose(c_t[:, row], c_k[:, row], atol=2e-5)


def test_halo_plain_version_reads_the_side_tensor(monkeypatch):
    """The plain version goes through ``build_halo``: with the side tensor
    zeroed, rows next to a block boundary change and the others do not."""
    args = _t(_inputs(seed=4))
    want_h, _ = P.fused_convlstm_step_halo_ref(*args)
    monkeypatch.setattr(P, "build_halo", lambda a, bh: torch.zeros(
        a.shape[0], a.shape[1] // bh, 2, *a.shape[2:], dtype=a.dtype))
    got_h, _ = P.fused_convlstm_step_halo_ref(*args)
    differs = (got_h - want_h).abs().amax(dim=(0, 2, 3)) > 1e-3
    assert differs.nonzero().flatten().tolist() == [7, 8]


@pytest.mark.parametrize("value, variant", [(None, "3pass"), ("", "3pass"), ("3pass", "3pass"),
                                            ("halo", "halo")])
def test_step_variant_switch(monkeypatch, value, variant):
    """``SATFLOW_STEP_VARIANT`` is read at call time: unset or ``3pass`` runs
    K1's path, ``halo`` K1h's; both compute the same step."""
    if value is None:
        monkeypatch.delenv("SATFLOW_STEP_VARIANT", raising=False)
    else:
        monkeypatch.setenv("SATFLOW_STEP_VARIANT", value)
    assert P.step_variant() == variant
    calls = []
    for name in ("fused_convlstm_step_ref", "fused_convlstm_step_halo_ref"):
        monkeypatch.setattr(P, name, lambda *a, _n=name, _f=getattr(P, name): calls.append(_n)
                            or _f(*a))
    args = _t(_inputs(seed=5))
    h_t, c_t = P.fused_convlstm_step(*args)
    assert calls == ["fused_convlstm_step_halo_ref" if variant == "halo"
                     else "fused_convlstm_step_ref"]
    h_r, c_r = F._step_ref(*(jnp.asarray(a.numpy()) for a in args))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_r), atol=2e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_r), atol=2e-5)


def test_step_variant_unknown_raises(monkeypatch):
    monkeypatch.setenv("SATFLOW_STEP_VARIANT", "2pass")
    with pytest.raises(ValueError, match="SATFLOW_STEP_VARIANT='2pass'"):
        P.fused_convlstm_step(*_t(_inputs()))


def test_halo_variant_refuses_a_ragged_height(monkeypatch):
    """H % block_h != 0 raises; it does not slide to K1 or to its plain version."""
    monkeypatch.setenv("SATFLOW_STEP_VARIANT", "halo")
    with pytest.raises(ValueError, match="H % block_h == 0"):
        P.fused_convlstm_step(*_t(_inputs(hgt=12)))


def _halo_meta(hgt=16, ch=64, cx=12):
    def t(*shape):
        return torch.empty(*shape, device="meta")

    return (t(2, hgt, 8, cx), t(2, hgt, 8, ch), t(2, hgt, 8, ch), t(3, 3, cx, 4 * ch),
            t(3, 3, ch, 4 * ch), t(4 * ch))


@pytest.mark.parametrize("args, kw, match", [
    (_halo_meta(ch=264), {}, r"1 <= Ch <= 256 \(built for"),
    (_halo_meta(hgt=12), {}, "H % block_h == 0"),
    (_halo_meta(), dict(block_h=4), "row blocks of 8"),
    (_halo_meta(), {}, "cpu or cuda tensors, not meta"),
], ids=["hidden", "height", "block_h", "device"])
def test_halo_wrapper_rejects_what_the_kernel_does_not_take(args, kw, match):
    """Tensors off the CPU never reach the plain version (meta tensors stand
    in for a card here)."""
    with pytest.raises(ValueError, match=match):
        P.fused_convlstm_step_halo(*args, **kw)


def test_step_grads_under_halo_match_jax(monkeypatch):
    """The six gradients with the forward through the halo variant (backward:
    K2's plain version and the merged library convs) against ``jax.grad`` of
    the JAX step: atol 1e-5 x max|grad|."""
    monkeypatch.setenv("SATFLOW_STEP_VARIANT", "halo")
    args = _inputs(seed=6)
    rng = np.random.default_rng(7)
    dh, dc = (rng.normal(size=args[2].shape).astype(np.float32) for _ in range(2))

    def jloss(*a):
        h2, c2 = F._step_ref(*a)
        return jnp.sum(h2 * dh) + jnp.sum(c2 * dc)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in args))
    leaves = [t.requires_grad_() for t in _t(args)]
    h2, c2 = P.fused_convlstm_step(*leaves)
    assert type(h2.grad_fn).__name__ == "FusedConvLSTMStepBackward"
    ((h2 * torch.from_numpy(dh)).sum() + (c2 * torch.from_numpy(dc)).sum()).backward()
    for name, t, w in zip(("dx", "dh", "dc", "dwx", "dwh", "db"), leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, atol=1e-5 * np.abs(w).max(), err_msg=name)


# --------------------------------------------------------------------------- T1, T2


def _padded_inputs(seed=0, **kw):
    x, h, c, wx, wh, b = _inputs(seed=seed, **kw)
    return _pad_w(x), _pad_w(h), c, wx, wh, b


@pytest.mark.parametrize("shape", [dict(cx=8), dict(b=1, hgt=8, wdt=24, cx=4)],
                         ids=["tool_shape", "one_block"])
def test_tap9_matches_jax_kernel_and_reference(jax_tap9, shape):
    """T1's plain version against ``step_tap9(interpret=True)`` and against
    ``_step_ref_padded``: float32 atol 1e-4; the halo columns of h' zero."""
    args = _padded_inputs(seed=8, **shape)
    jargs = tuple(jnp.asarray(a) for a in args)
    h_k, c_k = (np.asarray(a) for a in jax_tap9.step_tap9(*jargs, block_h=8, interpret=True))
    h_r, c_r = (np.asarray(a) for a in F._step_ref_padded(*jargs))
    before = XT.step_tap9.launches
    h_t, c_t = (a.numpy() for a in XT.step_tap9(*_t(args)))
    assert XT.step_tap9.launches == before
    assert h_t.shape == args[1].shape and c_t.shape == args[2].shape
    for want_h, want_c in ((h_k, c_k), (h_r, c_r)):
        np.testing.assert_allclose(h_t, want_h, atol=1e-4)
        np.testing.assert_allclose(c_t, want_c, atol=1e-4)
    np.testing.assert_array_equal(h_t[:, :, (0, -1)], 0.0)


def test_padded_yardstick_matches_jax_kernel(monkeypatch):
    """K1p's plain version against the JAX tool's yardstick, the padded-IO
    main kernel in interpret mode: float32 atol 2e-5; halo columns zero."""
    monkeypatch.setattr(F, "_INTERPRET", True)
    args = _padded_inputs(seed=15, cx=8)
    h_k, c_k = (np.asarray(a) for a in F.fused_convlstm_step_padded(
        *(jnp.asarray(a) for a in args), use_pallas=True))
    before = XT.step_padded.launches
    h_t, c_t = (a.numpy() for a in XT.step_padded(*_t(args)))
    assert XT.step_padded.launches == before and h_t.shape == h_k.shape
    np.testing.assert_allclose(h_t, h_k, atol=2e-5)
    np.testing.assert_allclose(c_t, c_k, atol=2e-5)
    np.testing.assert_array_equal(h_t[:, :, (0, -1)], 0.0)


def test_nogate_matches_jax_kernel(jax_tap9, monkeypatch):
    """T2's plain version against ``step_nogate``, which has no interpret
    argument: ``pallas_call`` is patched to interpret for the test. float32
    atol 1e-4; the halo columns of h' zero."""
    pl = jax_tap9.pl
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    args = _padded_inputs(seed=9, cx=8)
    h_k, c_k = (np.asarray(a) for a in jax_tap9.step_nogate(*(jnp.asarray(a) for a in args)))
    h_t, c_t = (a.numpy() for a in XT.step_nogate(*_t(args)))
    assert h_k.shape == h_t.shape == (2, 16, 18, 8)
    np.testing.assert_allclose(h_t, h_k, atol=1e-4)
    np.testing.assert_allclose(c_t, c_k, atol=1e-4)
    np.testing.assert_array_equal(h_t[:, :, (0, -1)], 0.0)


def test_study_weight_layouts_match_jax():
    """w9 and w3 as the JAX wrappers build them (exact)."""
    _, _, _, wx, wh, _ = _inputs(seed=10, cx=4, ch=8)
    w9 = np.concatenate([wx, wh], axis=2).reshape(9, 12, 32)
    w3 = np.concatenate([wx.reshape(3, 12, 32), wh.reshape(3, 24, 32)], axis=1)
    np.testing.assert_array_equal(XT.weights_tap9(*_t((wx, wh))).numpy(), w9)
    np.testing.assert_array_equal(XT.weights_rows3(*_t((wx, wh))).numpy(), w3)


def test_study_steps_read_their_halo_columns_as_given():
    """The inputs' halo columns are not masked: a nonzero halo changes the
    columns next to it and no other."""
    args = list(_t(_padded_inputs(seed=11)))
    want, _ = XT.step_tap9(*args)
    args[1] = args[1].clone()
    args[1][:, :, 0] = 1.0
    got, _ = XT.step_tap9(*args)
    differs = (got - want).abs().amax(dim=(0, 1, 3)) > 1e-4
    assert differs.nonzero().flatten().tolist() == [1]


def _padded_meta(hgt=16, ch=64, cx=12):
    def t(*shape):
        return torch.empty(*shape, device="meta")

    return (t(2, hgt, 10, cx), t(2, hgt, 10, ch), t(2, hgt, 8, ch), t(3, 3, cx, 4 * ch),
            t(3, 3, ch, 4 * ch), t(4 * ch))


@pytest.mark.parametrize("fn", [XT.step_tap9, XT.step_nogate, XT.step_padded],
                         ids=["tap9", "nogate", "padded"])
@pytest.mark.parametrize("args, kw, match", [
    (_padded_meta(ch=136), {}, r"1 <= Ch <= 128 \(built for \(8, 16, 32, 64, 128\)"),
    (_padded_meta(cx=260), {}, "1 <= Cx <= 256"),
    (_padded_meta(hgt=12), {}, "H % block_h"),
    (_padded_meta()[:2] + (torch.empty(2, 16, 10, 64, device="meta"),) + _padded_meta()[3:], {},
     r"c .* be \(B, H, W, Ch\)"),
    (_padded_meta(), {}, "cpu or cuda tensors, not meta"),
], ids=["hidden", "cx", "height", "c_shape", "device"])
def test_study_wrappers_reject_what_the_kernels_do_not_take(fn, args, kw, match):
    with pytest.raises(ValueError, match=match):
        fn(*args, **kw)


# --------------------------------------------------------------------------- T3


@pytest.mark.parametrize("block_h", [4, 8])
def test_cmajor_layout_helpers_match_jax_exactly(jax_cmajor, block_h):
    x, _, _, wx, wh, _ = _inputs(seed=12, cx=8)
    xc = XC.to_cmajor(torch.from_numpy(x), block_h)
    np.testing.assert_array_equal(xc.numpy(), np.asarray(jax_cmajor.to_cmajor(jnp.asarray(x),
                                                                              block_h)))
    assert xc.shape == (2, 8, (16 + 2 * block_h) * 16) and xc.is_contiguous()
    np.testing.assert_array_equal(XC.from_cmajor(xc, 16, 16, block_h).numpy(), x)
    np.testing.assert_array_equal(
        XC.from_cmajor(xc, 16, 16, block_h).numpy(),
        np.asarray(jax_cmajor.from_cmajor(jnp.asarray(xc.numpy()), 16, 16, block_h)))
    np.testing.assert_array_equal(
        XC.weights_cmajor(*_t((wx, wh))).numpy(),
        np.asarray(jax_cmajor.weights_cmajor(jnp.asarray(wx), jnp.asarray(wh))))


@pytest.mark.parametrize("dtype, atol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape, block_h", [(dict(hgt=32, wdt=32, cx=8), 4),
                                            (dict(b=1, hgt=16, wdt=128, cx=16, ch=16), 8),
                                            (dict(hgt=32, wdt=32, cx=8), 8),
                                            (dict(b=1, hgt=16, wdt=128, cx=16, ch=16), 4),
                                            (dict(hgt=12, wdt=40, cx=24, ch=24), 4)],
                         ids=["tool_shape", "wide", "tool_shape_bh8", "wide_bh4", "c24_bh4"])
def test_cmajor_step_matches_jax_kernel(jax_cmajor, dtype, atol, shape, block_h):
    """T3's plain version against ``cmajor_step(interpret=True)`` on the same
    channel-major carries, and against the NHWC reference through the layout
    helpers; pad rows of h' and c' exactly zero."""
    args = _inputs(seed=13, scale=0.1, **shape)
    bsz, hgt, wdt, ch = args[2].shape
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jh, jc, jwx, jwh, jb = (jnp.asarray(a, jdt) for a in args)
    jcarry = [jax_cmajor.to_cmajor(a, block_h) for a in (jx, jh, jc)]
    h_k, c_k = jax_cmajor.cmajor_step(*jcarry, jax_cmajor.weights_cmajor(jwx, jwh),
                                      jb.reshape(-1, 1), block_h, hgt, wdt, interpret=True)
    tx, th, tc, twx, twh, tb = _t(args, tdt)
    carry = [XC.to_cmajor(a, block_h) for a in (tx, th, tc)]
    before = XC.cmajor_step.launches
    h_t, c_t = XC.cmajor_step(*carry, XC.weights_cmajor(twx, twh), tb.reshape(-1, 1), block_h,
                              hgt, wdt)
    assert XC.cmajor_step.launches == before and h_t.dtype == tdt
    np.testing.assert_allclose(h_t.float().numpy(), np.asarray(h_k, np.float32), atol=atol)
    np.testing.assert_allclose(c_t.float().numpy(), np.asarray(c_k, np.float32), atol=atol)
    for t in (h_t, c_t):
        rows = t.float().reshape(bsz, ch, hgt + 2 * block_h, wdt)
        assert float(rows[:, :, :block_h].abs().max()) == 0
        assert float(rows[:, :, -block_h:].abs().max()) == 0
    h_r, c_r = F._step_ref(jx, jh, jc, jwx, jwh, jb)
    np.testing.assert_allclose(XC.from_cmajor(h_t, hgt, wdt, block_h).float().numpy(),
                               np.asarray(h_r, np.float32), atol=atol)
    np.testing.assert_allclose(XC.from_cmajor(c_t, hgt, wdt, block_h).float().numpy(),
                               np.asarray(c_r, np.float32), atol=atol)


def test_cmajor_step_is_scan_stable(jax_cmajor):
    """Three chained steps on their own outputs (x fed back from h') equal
    three NHWC reference steps: the zero pad rows survive every step."""
    args = _inputs(seed=14, hgt=16, wdt=16, cx=8, scale=0.1)
    x, h, c, wx, wh, b = _t(args)
    carry = [XC.to_cmajor(a, 4) for a in (x, h, c)]
    w9, b2 = XC.weights_cmajor(wx, wh), b.reshape(-1, 1)
    jx, jh, jc, jwx, jwh, jb = (jnp.asarray(a) for a in args)
    for _ in range(3):
        hc, cc = XC.cmajor_step(*carry, w9, b2, 4, 16, 16)
        carry = [hc, hc, cc]
        jh, jc = F._step_ref(jx, jh, jc, jwx, jwh, jb)
        jx = jh
    np.testing.assert_allclose(XC.from_cmajor(carry[1], 16, 16, 4).numpy(), np.asarray(jh),
                               atol=5e-5)
    np.testing.assert_allclose(XC.from_cmajor(carry[2], 16, 16, 4).numpy(), np.asarray(jc),
                               atol=5e-5)


@pytest.mark.parametrize("kw, match", [
    (dict(block_h=2, hgt=8), "block_h % 4"),
    (dict(block_h=8, hgt=12), "H % block_h"),
    (dict(ch=136), r"1 <= C <= 128 \(built for \(8, 16, 32, 64, 128\)"),
    (dict(sp_off=1), r"\(B, C, SP\)"),
    (dict(), "cpu or cuda tensors, not meta"),
], ids=["block_h", "height", "channels", "sp", "device"])
def test_cmajor_wrapper_rejects_what_the_kernel_does_not_take(kw, match):
    block_h, hgt, ch = kw.get("block_h", 4), kw.get("hgt", 8), kw.get("ch", 64)
    sp = (hgt + 2 * block_h) * 32 + kw.get("sp_off", 0)
    z = torch.empty(1, ch, sp, device="meta")
    w9, b2 = torch.empty(9, 4 * ch, 2 * ch, device="meta"), torch.empty(4 * ch, 1, device="meta")
    with pytest.raises(ValueError, match=match):
        XC.cmajor_step(z, z, z, w9, b2, block_h, hgt, 32)


# --------------------------------------------------------------------------- the entry points


@pytest.mark.parametrize("tool", ["exp_tap9", "exp_cmajor"])
def test_study_tools_verify_on_the_cpu(tool, capsys):
    """``--device cpu``: the entry points verify through the plain versions
    and stop, as the JAX mains do off the TPU."""
    mod = XT if tool == "exp_tap9" else XC
    mod._cli(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "stopping after" in out
    if tool == "exp_tap9":
        assert all(f"{k} correctness max err" in out for k in ("tap9", "padded", "nogate"))
    else:
        assert "verify 32x32" in out


@pytest.mark.parametrize("tool", ["exp_tap9", "exp_cmajor"])
def test_study_tools_need_a_card_by_default(tool, monkeypatch):
    """Without ``--device cpu`` the entry points run on the card or fail."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = XT if tool == "exp_tap9" else XC
    with pytest.raises(SystemExit, match="no CUDA card"):
        mod._cli([])


def test_study_tools_import_no_jax():
    import subprocess

    code = (
        "import sys\n"
        "import satflow_tpu_torch.tools.exp_tap9, satflow_tpu_torch.tools.exp_cmajor\n"
        "import satflow_tpu_torch.models  # noqa: F401\n"
        "from satflow_tpu_torch.core.registry import create_model\n"
        "import torch\n"
        "m = create_model('encoderdecoderconvlstm', hidden_dim=8, input_channels=4,\n"
        "                 out_channels=2, forecast_steps=2, cell_impl='split')\n"
        "assert m(torch.zeros(1, 2, 8, 8, 4)).shape == (1, 2, 8, 8, 2)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'satflow_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=180, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
