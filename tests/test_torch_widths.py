"""PyTorch port, every hidden width the reference runs: the dispatch rule of
the fused step's kernels (K1, K2), what their wrappers accept and refuse, the
step, its backward and the whole ``cell_impl="fused"`` rollout against the JAX
package at hidden 8, 16, 32 with 1 and 12 input channels, the source guards of
the tensor-core contraction, and the session's and the base model's names that
the JAX package has.

Inputs come from numpy seeds and go to both packages. On the CPU the JAX step
runs its Pallas kernels in interpret mode (as ``tests/test_fused_step.py``
does) or its XLA reference, and the port its plain versions.

Tolerances:
- the step and ``gate_bwd``, float32, atol 2e-5: both sides sum the same f32
  products in another order (as ``tests/test_torch_fused_step.py``);
- the six gradients, float32, atol 2e-4: weight and bias gradients sum
  B*H*W*9 products of O(1) terms in another order (measured 3e-5);
- the rollout, float32, atol 1e-5 on sigmoid outputs (measured 3e-7).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import satflow_tpu.models  # noqa: F401 - populate the JAX registry
import satflow_tpu.ops.pallas.fused_convlstm_step as F
import satflow_tpu_torch
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu.core import registry as jax_registry
from satflow_tpu.serve.session import InferenceSession as JaxSession
from satflow_tpu_torch.core import registry
from satflow_tpu_torch.interop.jax_weights import params_from_flax
from satflow_tpu_torch.ops import fused_convlstm_step as P
from satflow_tpu_torch.serve import InferenceSession

CSRC = Path(satflow_tpu_torch.__file__).resolve().parent / "csrc"
WIDTHS = [(cx, ch) for ch in (8, 16, 32) for cx in (1, 12)]


# -- the dispatch rule ---------------------------------------------------------

@pytest.mark.parametrize(
    "cx, ch, takes",
    [(cx, ch, True) for ch in (8, 16, 32, 64, 128) for cx in (1, 12, ch, 256)]
    + [(12, 24, True), (12, 48, True), (12, 12, True), (12, 4, True), (1, 1, True),
       (12, 96, True), (12, 127, True), (12, 129, True), (12, 136, True), (12, 256, True),
       (256, 192, True), (12, 257, False), (12, 264, False),
       (257, 64, False), (0, 64, False), (12, 0, False)],
)
def test_kernel_takes(cx, ch, takes):
    """Every hidden width from 1 to 256 launches K1 and K2 (one they are not
    instantiated for at the next width that is, zero-padded; 129-255 at 256);
    a wider one is refused on the card. The padded width is the least
    instantiated one that holds Ch."""
    assert P.kernel_takes(cx, ch) is takes
    if takes:
        chp = P.padded_hidden(ch)
        assert chp in P.KERNEL_HIDDEN_WIDTHS and chp >= ch
        assert all(w < ch for w in P.KERNEL_HIDDEN_WIDTHS if w < chp)
        assert (chp == ch) == (ch in P.KERNEL_HIDDEN_WIDTHS)
    elif ch > 256:
        with pytest.raises(ValueError, match="above the kernels' largest, 256"):
            P.padded_hidden(ch)


def test_dispatch_rule_is_stated():
    doc = P.__doc__
    assert "kernel_takes" in doc and "8, 16, 32, 64, 128, 256" in doc
    assert "raise" in doc and "Ch % 8" in doc and "step=fused_convlstm_step_ref" in doc


def _meta(cx=12, ch=64, dtype=torch.float32, b=2, hgt=8, wdt=8, backward=False):
    def t(*shape):
        return torch.empty(*shape, dtype=dtype, device="meta")

    args = (t(b, hgt, wdt, cx), t(b, hgt, wdt, ch), t(b, hgt, wdt, ch),
            t(3, 3, cx, 4 * ch), t(3, 3, ch, 4 * ch), t(4 * ch))
    return args + ((t(b, hgt, wdt, ch), t(b, hgt, wdt, ch)) if backward else ())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cx, ch", [(1, 8), (12, 8), (6, 16), (12, 16), (1, 32), (12, 32),
                                    (128, 128), (256, 64), (255, 8), (3, 128),
                                    (12, 24), (12, 48), (12, 12), (12, 4), (1, 1), (64, 96)])
def test_wrappers_accept_every_width(cx, ch, dtype):
    """The widths of the rule are refused no more: tensors off the CPU pass
    every check up to the device type (meta tensors stand in for a card)."""
    for fn, backward in ((P.fused_convlstm_step, False), (P.gate_bwd, True)):
        with pytest.raises(ValueError, match="cpu or cuda tensors, not meta"):
            fn(*_meta(cx=cx, ch=ch, dtype=dtype, backward=backward))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cx, ch", [(12, 264), (12, 257), (12, 300), (0, 24), (12, 512),
                                    (260, 64)])
def test_wrappers_refuse_other_widths(cx, ch, dtype):
    """Off the CPU a width outside the rule raises and names the rule: no
    wrapper gives way to the plain version there. The same tensors on the CPU
    take the plain version, whatever their width."""
    for fn, backward in ((P.fused_convlstm_step, False), (P.gate_bwd, True)):
        with pytest.raises(ValueError, match=r"1 <= Ch <= 256 \(built for \(8, 16, 32, 64, "
                                             r"128, 256\).*\) and 1 <= Cx <= 256"):
            fn(*_meta(cx=cx, ch=ch, dtype=dtype, backward=backward))
    if cx == 0:
        return
    args = [torch.zeros(a.shape, dtype=dtype) for a in _meta(cx=cx, ch=ch, dtype=dtype,
                                                             hgt=4, wdt=4, backward=True)]
    assert P.fused_convlstm_step(*args[:6])[0].shape == (2, 4, 4, ch)
    assert P.gate_bwd(*args)[0].shape == (2, 4, 4, 4 * ch)


def test_halo_variant_keeps_its_one_width():
    """K1h keeps one row-block height (8) and takes K1's widths: every hidden
    width to 256 and any Cx to 256 pass its checks up to the device type; a
    wider one raises and names the rule."""
    for cx, ch in ((6, 8), (12, 24), (1, 136), (256, 256)):
        with pytest.raises(ValueError, match="cpu or cuda tensors, not meta"):
            P.fused_convlstm_step_halo(*_meta(cx=cx, ch=ch))
    with pytest.raises(ValueError, match=r"1 <= Ch <= 256 \(built for"):
        P.fused_convlstm_step_halo(*_meta(ch=264))
    with pytest.raises(ValueError, match="row blocks of 8"):
        P.fused_convlstm_step_halo(*_meta(), block_h=4)


# -- the step, its backward and the rollout against the JAX package ------------

def _inputs(cx, ch, seed, b=2, hgt=9, wdt=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, hgt, wdt, cx)).astype(np.float32)
    h = rng.normal(size=(b, hgt, wdt, ch)).astype(np.float32)
    c = rng.normal(size=(b, hgt, wdt, ch)).astype(np.float32)
    wx = (rng.normal(size=(3, 3, cx, 4 * ch)) * 0.1).astype(np.float32)
    wh = (rng.normal(size=(3, 3, ch, 4 * ch)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(4 * ch,)) * 0.1).astype(np.float32)
    dh, dc = (rng.normal(size=(b, hgt, wdt, ch)).astype(np.float32) for _ in range(2))
    return (x, h, c, wx, wh, bias), (dh, dc)


@pytest.mark.parametrize("cx, ch", WIDTHS)
def test_step_matches_jax_kernel(monkeypatch, cx, ch):
    """The port's step against the JAX Pallas kernel in interpret mode, on an
    image that is no multiple of any tile."""
    monkeypatch.setattr(F, "_INTERPRET", True)
    args, _ = _inputs(cx, ch, seed=cx + ch)
    h_j, c_j = F.fused_convlstm_step(*(jnp.asarray(a) for a in args), use_pallas=True)
    h_t, c_t = P.fused_convlstm_step(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=2e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=2e-5)


@pytest.mark.parametrize("cx, ch", WIDTHS)
def test_gate_bwd_matches_jax_kernel(monkeypatch, cx, ch):
    monkeypatch.setattr(F, "_INTERPRET", True)
    args, cots = _inputs(cx, ch, seed=100 + cx + ch)
    dg_j, dc_j = F._gate_bwd_pallas(*(jnp.asarray(a) for a in args + cots))
    dg_t, dc_t = P.gate_bwd(*(torch.from_numpy(a) for a in args + cots))
    assert dg_t.shape == args[1].shape[:3] + (4 * ch,)
    np.testing.assert_allclose(dg_t.numpy(), np.asarray(dg_j), atol=2e-5)
    np.testing.assert_allclose(dc_t.numpy(), np.asarray(dc_j), atol=2e-5)


@pytest.mark.parametrize("cx, ch", WIDTHS)
def test_function_grads_match_jax(cx, ch):
    """dx, dh, dc, dWx, dWh, db through FusedConvLSTMStep against jax.grad of
    the JAX step (its XLA reference: the interpret-mode backward is held to it
    by the JAX package's own tests)."""
    args, (dh, dc) = _inputs(cx, ch, seed=200 + cx + ch)

    def loss(*a):
        h_next, c_next = F.fused_convlstm_step(*a, use_pallas=False)
        return jnp.sum(h_next * dh) + jnp.sum(c_next * dc)

    want = jax.grad(loss, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    h_next, c_next = P.fused_convlstm_step(*ts)
    assert type(h_next.grad_fn).__name__ == "FusedConvLSTMStepBackward"
    ((h_next * torch.from_numpy(dh)).sum() + (c_next * torch.from_numpy(dc)).sum()).backward()
    for name, t, w in zip(("x", "h", "c", "wx", "wh", "b"), ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=2e-4, err_msg=name)


@pytest.mark.parametrize("cx, ch", WIDTHS)
def test_fused_rollout_matches_jax(cx, ch):
    """The whole default (``cell_impl="fused"``) model at this width."""
    kw = dict(input_channels=cx, out_channels=cx, forecast_steps=3, hidden_dim=ch)
    t_in, hgt, wdt = 3, 10, 12
    jmodel = jax_registry.create_model("encoderdecoderconvlstm", **kw)
    variables = jmodel.module.init(jax.random.PRNGKey(0),
                                   np.zeros((1, t_in, hgt, wdt, cx), np.float32))
    rng = np.random.default_rng(300 + cx + ch)
    variables = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.3).astype(np.float32), variables)
    x = rng.random((2, t_in, hgt, wdt, cx)).astype(np.float32)
    want = np.asarray(jmodel.forward(variables, jnp.asarray(x)))
    model = registry.create_model("encoderdecoderconvlstm", **kw)
    model.module.load_state_dict(params_from_flax(variables))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3, hgt, wdt, cx)
    np.testing.assert_allclose(got, want, atol=1e-5)


# -- hidden widths the kernels are not built for: zero-padded to the next ------

PADDED = [(cx, ch) for ch in (24, 40, 12) for cx in (1, 12)]


@pytest.mark.parametrize("cx, ch", PADDED)
def test_padded_step_equals_the_plain_step_and_jax(cx, ch):
    """pad -> plain step -> slice is the plain step at the unpadded width (the
    padded channels of h' and c' are exact zeros), and that is the JAX step;
    float32 at 2e-5."""
    args, _ = _inputs(cx, ch, seed=400 + cx + ch)
    x, h, c, wx, wh, b = (torch.from_numpy(a) for a in args)
    chp = P.padded_hidden(ch)
    assert chp == {24: 32, 40: 64, 12: 16}[ch]
    hp, cp, wxp, whp, bp = P.pad_step_operands(h, c, wx, wh, b, chp)
    assert hp.shape[-1] == cp.shape[-1] == chp and bp.shape == (4 * chp,)
    assert wxp.shape == (3, 3, cx, 4 * chp) and whp.shape == (3, 3, chp, 4 * chp)
    # each gate block keeps its columns, at the block's new offset
    for g in range(4):
        assert torch.equal(wxp[..., g * chp:g * chp + ch], wx[..., g * ch:(g + 1) * ch])
        assert torch.equal(whp[:, :, :ch, g * chp:g * chp + ch], wh[..., g * ch:(g + 1) * ch])
        assert not whp[:, :, :, g * chp + ch:(g + 1) * chp].any()
    assert not whp[:, :, ch:].any()
    h2p, c2p = P.fused_convlstm_step_ref(x, hp, cp, wxp, whp, bp)
    assert not h2p[..., ch:].any() and not c2p[..., ch:].any()
    h2, c2 = P.fused_convlstm_step_ref(x, h, c, wx, wh, b)
    np.testing.assert_allclose(h2p[..., :ch].numpy(), h2.numpy(), atol=2e-5)
    np.testing.assert_allclose(c2p[..., :ch].numpy(), c2.numpy(), atol=2e-5)
    h_j, c_j = F._step_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(h2.numpy(), np.asarray(h_j), atol=2e-5)
    np.testing.assert_allclose(c2.numpy(), np.asarray(c_j), atol=2e-5)
    # a second step on the padded state: the zeros stay zeros
    h3p, c3p = P.fused_convlstm_step_ref(x, h2p, c2p, wxp, whp, bp)
    assert not h3p[..., ch:].any() and not c3p[..., ch:].any()


@pytest.mark.parametrize("cx, ch", PADDED)
def test_padded_gate_bwd_equals_the_plain_one_and_jax(cx, ch):
    """pad (cotangents with zeros) -> plain gate backward -> slice is the
    plain one at the unpadded width, and that is the JAX reference's; float32
    at 1e-4 x max|grad|."""
    args, cots = _inputs(cx, ch, seed=500 + cx + ch)
    x, h, c, wx, wh, b, dh, dc = (torch.from_numpy(a) for a in args + cots)
    chp = P.padded_hidden(ch)
    padded = P.pad_step_operands(h, c, wx, wh, b, chp)
    dgp, dcp = P.gate_bwd_ref(x, *padded, P.pad_channels(dh, chp), P.pad_channels(dc, chp))
    assert dgp.shape[-1] == 4 * chp and dcp.shape[-1] == chp
    dg, dcv = P.gate_bwd_ref(x, h, c, wx, wh, b, dh, dc)
    got_dg = P.slice_gate_columns(dgp, ch)
    assert got_dg.shape == dg.shape
    assert torch.equal(P.slice_gate_columns(P.pad_gate_columns(dg, chp), ch), dg)
    for got, want in ((got_dg, dg), (dcp[..., :ch], dcv)):
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=1e-4 * float(want.abs().max()))
    dg_j, dc_j = F._gate_bwd_ref(*(jnp.asarray(a) for a in args + cots))
    for got, want in ((dg, dg_j), (dcv, dc_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("cx, ch", PADDED)
def test_padded_widths_pass_the_wrappers_checks(cx, ch):
    """Off the CPU these widths pass every check up to the device type, with
    unaligned views too: the kernels see the padded copies."""
    for fn, backward in ((P.fused_convlstm_step, False), (P.gate_bwd, True)):
        with pytest.raises(ValueError, match="cpu or cuda tensors, not meta"):
            fn(*_meta(cx=cx, ch=ch, backward=backward))


# -- the sources ----------------------------------------------------------------

def _code(path: Path) -> str:
    """A CUDA source without its comments."""
    text = path.read_text()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def test_tensor_core_contraction_is_written_here():
    code = _code(CSRC / "convlstm_mma.cuh")
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in code
    assert "ldmatrix.sync.aligned" in code and "cp.async" in code
    gates = _code(CSRC / "convlstm_gates.cuh")
    assert '#include "convlstm_mma.cuh"' in gates
    for name in ("fused_convlstm_step.cu", "fused_convlstm_step_bwd.cu"):
        assert '#include "convlstm_gates.cuh"' in _code(CSRC / name)


@pytest.mark.parametrize("path", sorted(CSRC.glob("*.cu*")), ids=lambda p: p.name)
def test_no_library_header_in_the_kernels(path):
    """No cuDNN, cuBLAS, CUTLASS device GEMM or PyTorch header: the kernels are
    this repository's own and build in seconds with a plain C interface."""
    includes = re.findall(r'#include\s*[<"]([^>"]+)[>"]', _code(path))
    assert includes
    for inc in includes:
        low = inc.lower()
        assert not any(word in low for word in ("cudnn", "cublas", "torch", "aten", "c10",
                                                "cutlass/gemm/device")), (path.name, inc)


# -- the timing tool ------------------------------------------------------------

def test_time_step_reads_the_ptxas_report():
    from satflow_tpu_torch.tools import time_step

    log = (
        "ptxas info    : Compiling entry function '_ZN3abc15gate_bwd_kernelIfLi64EEEvPKT_' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 187 registers, 468 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN3abc15gate_bwd_kernelIfLi8EEEvPKT_' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 468 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN3abc15gate_bwd_kernelI13__nv_bfloat16EEvPKT_' for 'sm_90a'\n"
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 213 registers, 468 bytes cmem[0]\n")
    assert time_step.registers(log, "f", 64) == "187 registers, 0 bytes spilled"
    assert time_step.registers(log, "f", 8) == "40 registers, 0 bytes spilled"
    # a kernel whose name carries no width (one instantiation) matches any
    assert time_step.registers(log, "13__nv_bfloat16", 64) == "213 registers, 8 bytes spilled"
    assert time_step.registers("", "f", 64) == "not built by this process"


@pytest.mark.skipif(torch.cuda.is_available(), reason="refuses only without a card")
def test_time_step_needs_a_card():
    from satflow_tpu_torch.tools import time_step

    with pytest.raises(SystemExit, match="needs a CUDA card"):
        time_step.main()


# -- names the JAX package has (session, base model, packaging) -----------------

SKW = dict(input_channels=4, out_channels=4, forecast_steps=2, hidden_dim=8)


@pytest.fixture(scope="module")
def served():
    jmodel = jax_registry.create_model("encoderdecoderconvlstm", **SKW)
    v = jmodel.module.init(jax.random.PRNGKey(0), np.zeros((1, 3, 16, 16, 4), np.float32))
    rng = np.random.default_rng(0)
    return jmodel, jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.3).astype(np.float32), v)


def test_session_forecast_steps_and_donate(served):
    jmodel, v = served
    want = JaxSession(jmodel, max_batch=2, variables=v, donate=True)
    model = registry.create_model("encoderdecoderconvlstm", **SKW)
    got = InferenceSession(model, max_batch=2, variables=v, donate=True, device="cpu")
    assert got.forecast_steps == want.forecast_steps == 2
    x = np.random.default_rng(1).random((2, 3, 16, 16, 4)).astype(np.float32)
    np.testing.assert_allclose(got.predict(x), want.predict(x), atol=1e-5)
    bare = InferenceSession.__new__(InferenceSession)
    bare.model = object()
    assert bare.forecast_steps == 0  # a model without the attribute, as in JAX


def test_session_int8_refuses_donate(served):
    jmodel, v = served
    with pytest.raises(ValueError, match="donate"):
        JaxSession(jmodel, variables=v, quantize="int8", donate=True)
    model = registry.create_model("encoderdecoderconvlstm", **SKW)
    with pytest.raises(ValueError, match="donate does not apply"):
        InferenceSession(model, variables=v, quantize="int8", donate=True)


def test_base_model_eval_batch_and_from_config():
    # the ConvLSTM reads the reference's keys, in both packages
    cfg = dict(num_hidden=8, in_channels=4, out_channels=4, forecast_steps=2, lr=3e-4)
    jmodel = jax_registry.get_model("encoderdecoderconvlstm").from_config(cfg)
    model = registry.get_model("encoderdecoderconvlstm").from_config(cfg)
    assert model.lr == jmodel.lr == 3e-4
    hp, jhp = model.hparams(), jmodel.hparams()
    for key, value in dict(SKW, lr=3e-4).items():
        assert hp[key] == jhp[key] == value, key
    assert model.forecast_steps == jmodel.forecast_steps == 2
    assert model.module.hidden_dim == jmodel.module.hidden_dim == 8
    # a model without its own from_config takes the base's: cls(**config)
    mcfg = dict(hidden_dim=16, forecast_steps=3, output_channels=2, lr=2e-4, warmup_steps=7)
    jmet = jax_registry.get_model("litmetnet").from_config(mcfg)
    met = registry.get_model("litmetnet").from_config(mcfg)
    for key, value in mcfg.items():
        assert met.hparams()[key] == jmet.hparams()[key] == value, key
    rng = np.random.default_rng(2)
    x, y = rng.random((2, 3, 8, 8, 4), dtype=np.float32), rng.random((2, 2, 8, 8, 4), dtype=np.float32)
    jx, jy = jmodel.eval_batch(({"sat_data": x}, {"sat_data": y}))
    tx, ty = model.eval_batch(({"sat_data": torch.from_numpy(x)}, {"sat_data": torch.from_numpy(y)}))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    px, py = model.prepare_batch((torch.from_numpy(x), torch.from_numpy(y)))
    assert torch.equal(px, tx) and torch.equal(py, ty)


def test_package_text_is_current():
    doc = satflow_tpu_torch.__doc__
    assert "LitMetNet" in doc and "adapter over the JAX" not in doc
    assert "loader of the JAX package" not in doc
    setup_py = (Path(satflow_tpu_torch.__file__).resolve().parents[1] / "setup.py").read_text()
    extras = setup_py[setup_py.index("extras_require"):]
    assert re.search(r'"torch":\s*\[[^\]]*"torch"', extras)
