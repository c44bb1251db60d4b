"""PyTorch port, the concat / split / hybrid ConvLSTM cells and the conv
types, on the CPU against the flax modules on carried-across weights.

Weights are drawn with numpy in the flax tree and reach the port through the
bridge (``interop/jax_weights.py``); inputs are numpy and go to both. On the
CPU both packages run the LSTM gate tail (K3) through its plain version.

Tolerances:
- a module's or the core's forward, float32: atol 1e-5 (the same f32 convs and
  gate math, summed in another order); bfloat16: atol 2e-2 (both round every
  conv output and state to bf16, step 2^-8, at different points). A bare
  conv's outputs are not range-bound, so in bfloat16 they get two bf16 steps
  relative (rtol 2^-6) beside the absolute slack.
- model gradients, float32: atol 1e-5 x max|grad| per tensor; bfloat16: 3e-2
  x max|grad| (as ``tests/test_torch_train.py``). In bfloat16 XLA on the CPU
  sums a conv's bias gradient over B·T·H·W elements in bf16 and lands 5-23 %
  off the f32 gradient (the port sums in f32 and lands within 1 %), so the
  bf16 bias gradients are held to the JAX model's float32 gradient instead.
- remat against no remat (the port alone): 1e-6 x max|grad|.
- Adam: as ``tests/test_torch_train.py`` (metrics 1e-5 relative; updates to
  2e-4 x lr where |g| > 1e-6, see ``test_train_step_matches_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import satflow_tpu.models  # noqa: F401 - populate the JAX registry
import satflow_tpu.nn.conv as JC
import satflow_tpu.nn.recurrent as JR
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu.core import registry as jax_registry
from satflow_tpu.serve.session import InferenceSession as JaxSession
from satflow_tpu.train.state import TrainState as JaxTrainState
from satflow_tpu.train.steps import make_train_step as jax_make_train_step
from satflow_tpu_torch.core import registry
from satflow_tpu_torch.interop import jax_weights as BR
from satflow_tpu_torch.interop.jax_weights import load_npz, params_from_flax, save_npz
from satflow_tpu_torch.models.conv_lstm import ConvLSTMCore
from satflow_tpu_torch.nn import conv as TC
from satflow_tpu_torch.nn import recurrent as TR
from satflow_tpu_torch.ops import fused_lstm as G
from satflow_tpu_torch.serve import InferenceSession
from satflow_tpu_torch.train import TrainState
from satflow_tpu_torch.train.steps import make_train_step

B, T, H, W, CIN, HID, COUT, STEPS = 2, 3, 16, 16, 4, 8, 3, 4
KW = dict(input_channels=CIN, out_channels=COUT, forecast_steps=STEPS, hidden_dim=HID)
CONFIGS = {
    "concat": dict(cell_impl="concat"),
    "split": dict(cell_impl="split"),
    "hybrid": dict(cell_impl="hybrid"),
    "coord": dict(cell_impl="fused", conv_type="coord"),  # a conv type forces the concat steps
    "antialiased": dict(cell_impl="split", conv_type="antialiased"),
    "3d": dict(cell_impl="concat", conv_type="3d"),
}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CONV_RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -6}  # outputs that are not range-bound


def _randomise(tree, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32), tree)


def _flax_init(module, *inputs, seed=0):
    variables = module.init(jax.random.PRNGKey(0), *inputs)
    return {"params": _randomise(jax.device_get(variables["params"]), seed)}


def _np(a):
    return np.asarray(a, np.float32)


def _f(a):
    return a.detach().float().numpy()


# --------------------------------------------------------------------------- modules


@pytest.mark.parametrize("with_r", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_coord_conv_matches_flax(with_r, dtype):
    x = np.random.default_rng(0).normal(size=(2, 7, 9, 3)).astype(np.float32)
    jmod = JC.CoordConv(features=5, with_r=with_r, dtype=getattr(jnp, dtype))
    params = _flax_init(jmod, x)
    port = TC.CoordConv(3, 5, with_r=with_r, dtype=getattr(torch, dtype))
    port.load_state_dict(dict(BR._conv_leaves("Conv_0", params["params"]["Conv_0"], "Conv_0")))
    want = jmod.apply(params, jnp.asarray(x))
    got = port(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 7, 9, 5)
    np.testing.assert_allclose(_f(got), _np(want), atol=TOL[dtype], rtol=CONV_RTOL[dtype])
    coords = TC.AddCoords(with_r)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(coords, _np(JC.AddCoords(with_r).apply({}, jnp.asarray(x))),
                               atol=1e-7)


@pytest.mark.parametrize("filter_size, stride, hw", [(4, 2, (8, 10)), (3, 2, (9, 7)),
                                                     (5, 3, (11, 8)), (4, 1, (6, 6))])
def test_blur_pool_matches_flax(filter_size, stride, hw):
    """No parameters: the same binomial kernel, padding and stride (1e-6)."""
    x = np.random.default_rng(1).normal(size=(2, *hw, 3)).astype(np.float32)
    want = JC.BlurPool(filter_size, stride).apply({}, jnp.asarray(x))
    got = TC.BlurPool(filter_size, stride)(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)
    assert not list(TC.BlurPool(filter_size, stride).state_dict())


@pytest.mark.parametrize("strides", [1, 2])
def test_antialiased_conv_matches_flax(strides):
    x = np.random.default_rng(2).normal(size=(2, 8, 8, 3)).astype(np.float32)
    jmod = JC.AntialiasedConv(features=6, strides=strides)
    params = _flax_init(jmod, x)
    port = TC.AntialiasedConv(3, 6, strides=strides)
    port.load_state_dict(dict(BR._conv_leaves("Conv_0", params["params"]["Conv_0"], "Conv_0")))
    want = jmod.apply(params, jnp.asarray(x))
    got = port(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 8 // strides, 8 // strides, 6)
    np.testing.assert_allclose(_f(got), _np(want), atol=1e-5)


@pytest.mark.parametrize("kernel, strides, padding", [(3, 1, "SAME"), (4, 2, "SAME"),
                                                      (3, 2, "SAME"), (3, 1, "VALID"),
                                                      ((1, 3), 1, 1)])
def test_conv_matches_flax(kernel, strides, padding):
    """The port's ``Conv`` is flax's ``nn.Conv``: SAME with even kernels and
    strides puts the odd row or column last."""
    from flax import linen as fnn

    x = np.random.default_rng(3).normal(size=(2, 9, 10, 3)).astype(np.float32)
    ks = (kernel, kernel) if isinstance(kernel, int) else kernel
    jmod = fnn.Conv(5, ks, strides=(strides, strides),
                    padding=padding if isinstance(padding, str) else (padding, padding))
    params = _flax_init(jmod, x)
    port = TC.Conv(3, 5, kernel, strides, padding)
    port.load_state_dict({k[2:]: v for k, v in BR._conv_leaves("c", params["params"], "c")})
    want = jmod.apply(params, jnp.asarray(x))
    got = port(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f(got), _np(want), atol=1e-5)


def test_get_conv_layer_names():
    assert TC.get_conv_layer("standard") is TC.Conv and TC.get_conv_layer("3d") is TC.Conv
    assert TC.get_conv_layer("coord") is TC.CoordConv
    assert TC.get_conv_layer("antialiased") is TC.AntialiasedConv
    with pytest.raises(ValueError, match="Unknown conv_type 'nope'"):
        TC.get_conv_layer("nope")


def _cell_io(seed, cx, ch=HID, gates=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, 4 * ch if gates else cx)).astype(np.float32)
    h = rng.normal(size=(B, H, W, ch)).astype(np.float32)
    c = rng.normal(size=(B, H, W, ch)).astype(np.float32)
    return x, h, c


def _check_cell(jcell, port, params, x, h, c, dtype, x_dtype=None):
    port.load_state_dict({k[5:]: v for k, v in BR._cell_leaves("cell", params["params"], "cell")})
    (h_j, c_j), out_j = jcell.apply(params, (jnp.asarray(h), jnp.asarray(c)),
                                    jnp.asarray(x, x_dtype and getattr(jnp, x_dtype)))
    (h_t, c_t), out_t = port(tuple(torch.from_numpy(a) for a in (h, c)),
                             torch.from_numpy(x).to(getattr(torch, x_dtype or "float32")))
    assert out_t is h_t and h_t.dtype == c_t.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f(h_t), _np(h_j), atol=TOL[dtype])
    # c' is not range-bound (c is a unit normal here)
    np.testing.assert_allclose(_f(c_t), _np(c_j), atol=TOL[dtype], rtol=CONV_RTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("conv_type", ["standard", "coord", "antialiased", "3d"])
def test_conv_lstm_cell_conv_types_match_flax(conv_type, dtype):
    x, h, c = _cell_io(4, CIN)
    jcell = JR.ConvLSTMCell(HID, conv_type=conv_type, dtype=getattr(jnp, dtype))
    params = _flax_init(jcell, (h, c), x)
    port = TR.ConvLSTMCell(CIN, HID, conv_type=conv_type, dtype=getattr(torch, dtype))
    _check_cell(jcell, port, params, x, h, c, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_precomputed", [False, True])
def test_split_cell_matches_flax(x_precomputed, dtype):
    x, h, c = _cell_io(5, CIN, gates=x_precomputed)
    if x_precomputed and dtype == "bfloat16":  # the hoisted conv hands over bf16 gates
        x = _np(jnp.asarray(x, jnp.bfloat16))
    jcell = JR.SplitConvLSTMCell(HID, x_precomputed=x_precomputed, dtype=getattr(jnp, dtype))
    params = _flax_init(jcell, (h, c), x)
    assert sorted(params["params"]) == (["h_gates"] if x_precomputed else ["h_gates", "x_gates"])
    assert "bias" not in params["params"]["h_gates"]
    port = TR.SplitConvLSTMCell(CIN, HID, x_precomputed=x_precomputed,
                                dtype=getattr(torch, dtype))
    _check_cell(jcell, port, params, x, h, c, dtype, x_dtype=dtype if x_precomputed else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_input_gate_conv_matches_flax(dtype):
    x = np.random.default_rng(6).normal(size=(B, T, H, W, CIN)).astype(np.float32)
    jmod = JR.InputGateConv(HID, dtype=getattr(jnp, dtype))
    params = _flax_init(jmod, x)
    port = TR.InputGateConv(CIN, HID, dtype=getattr(torch, dtype))
    port.load_state_dict({k[2:]: v for k, v in BR._cell_leaves("m", params["params"], "m")})
    got = port(torch.from_numpy(x))
    assert got.shape == (B, T, H, W, 4 * HID)
    np.testing.assert_allclose(_f(got), _np(jmod.apply(params, jnp.asarray(x))), atol=TOL[dtype],
                               rtol=CONV_RTOL[dtype])


def test_cells_run_the_gate_tail_wrapper(monkeypatch):
    """Both new cells reach K3's wrapper with c in the gates' dtype."""
    seen = []

    def tail(gates, c):
        seen.append((gates.dtype, c.dtype))
        return G.fused_lstm_gates_ref(gates, c)

    x, h, c = (torch.from_numpy(a) for a in _cell_io(7, CIN))
    for cell in (TR.ConvLSTMCell(CIN, HID, dtype=torch.bfloat16),
                 TR.SplitConvLSTMCell(CIN, HID, dtype=torch.bfloat16)):
        cell((h, c), x, tail)
        cell.dtype = None  # re-types every conv below
        cell((h, c), x, tail)
    assert seen == [(torch.bfloat16,) * 2, (torch.float32,) * 2] * 2


# --------------------------------------------------------------------------- the core


def _flax_params(config, seed=0, **kw):
    model = jax_registry.create_model("encoderdecoderconvlstm", **{**KW, **CONFIGS[config], **kw})
    tree = model.module.init(jax.random.PRNGKey(0), np.zeros((1, T, H, W, CIN), np.float32))
    return {"params": _randomise(jax.device_get(tree["params"]), seed)}


def _port(params, config, **kw):
    model = registry.create_model("encoderdecoderconvlstm", **{**KW, **CONFIGS[config], **kw})
    model.module.load_state_dict(params_from_flax(params))
    return model


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.random((B, T, H, W, CIN), dtype=np.float32),
            rng.random((B, STEPS, H, W, CIN), dtype=np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_core_forward_matches_jax(config, dtype):
    params = _flax_params(config)
    jmodel = jax_registry.create_model("encoderdecoderconvlstm", dtype=getattr(jnp, dtype),
                                       **KW, **CONFIGS[config])
    x = _batch()[0]
    want = jmodel.module.apply(params, jnp.asarray(x))
    model = _port(params, config, dtype=getattr(torch, dtype)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        short = model(torch.from_numpy(x), forecast_steps=2)
    assert got.shape == (B, STEPS, H, W, COUT) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f(got), _np(want), atol=TOL[dtype])
    np.testing.assert_allclose(_f(short), _f(got[:, :2]), atol=0)


@pytest.mark.parametrize("config, keys", [
    ("concat", {"encoder.encoder_1.gates.weight", "decoder.decoder_2.gates.bias"}),
    ("split", {"encoder_input_gates.x_gates.bias", "encoder.encoder_1.h_gates.weight",
               "encoder.encoder_2.x_gates.weight", "decoder.decoder_1.h_gates.weight"}),
    ("hybrid", {"encoder_input_gates.x_gates.weight", "encoder.encoder_2.h_gates.weight",
                "decoder.decoder_1.gates.weight"}),
    ("coord", {"encoder.encoder_1.gates.Conv_0.weight", "decoder.decoder_2.gates.Conv_0.bias"}),
    ("antialiased", {"encoder.encoder_2.gates.Conv_0.weight"}),
    ("3d", {"decoder.decoder_1.gates.weight"}),
])
def test_parameters_sit_where_the_flax_tree_has_them(config, keys):
    sd = params_from_flax(_flax_params(config))
    core = ConvLSTMCore(hidden_dim=HID, in_channels=CIN, out_channels=COUT, forecast_steps=STEPS,
                        **CONFIGS[config])
    assert set(sd) == set(core.state_dict()) and keys <= set(sd)
    assert "encoder.encoder_1.x_gates.weight" not in sd  # hoisted, or no split cell at all
    for k, v in core.state_dict().items():
        assert sd[k].shape == v.shape, k
    assert not core.is_fused


@pytest.mark.parametrize("config", ["concat", "split", "hybrid", "coord"])
@pytest.mark.parametrize("layout", [dict(remat=True, remat_chunk=2), dict(head_in_scan=False),
                                    dict(remat=True, remat_chunk=2, head_in_scan=False)],
                         ids=["steps", "top_head", "steps_top_head"])
def test_bridge_normalises_nested_layouts(config, layout, tmp_path):
    """``encoder/steps``, ``decoder/steps`` and a top-level ``head`` convert
    to what the flat tree converts to; the ``.npz`` round trip keeps it."""
    tree = _flax_params(config, **layout)
    p = tree["params"]
    if layout.get("remat_chunk"):
        assert "steps" in p["decoder"] and "steps" in p["encoder"]
    if layout.get("head_in_scan") is False:
        assert "head" in p
    default = jax_registry.create_model("encoderdecoderconvlstm", **KW, **CONFIGS[config])
    flat = default.adapt_restored_params(dict(p))
    got, want = params_from_flax(tree), params_from_flax({"params": flat})
    assert list(got) == list(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    save_npz(tmp_path / "w.npz", tree)
    again = load_npz(tmp_path / "w.npz")
    assert list(again) == list(got) and all(torch.equal(again[k], got[k]) for k in got)
    _port(tree, config, **layout)  # loads strictly


@pytest.mark.parametrize("path", [("encoder", "encoder_1", "gates", "extra"),
                                  ("decoder", "decoder_2", "extra"),
                                  ("decoder", "head", "scale")])
def test_bridge_rejects_unknown_leaves(path):
    tree = _flax_params("concat")
    node = tree["params"]
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match=path[-1]):
        params_from_flax(tree)


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("config, remat, remat_chunk", [
    ("concat", False, 0), ("concat", True, 2), ("split", False, 0), ("split", True, 0),
    ("split", True, 2), ("hybrid", True, 2), ("hybrid", False, 0), ("coord", True, 0),
])
def test_model_grads_match_jax(config, remat, remat_chunk, dtype, tol):
    """loss.backward() on the port against jax.grad(model.loss) of the JAX
    model with the same formulation, remat schedule, weights and batch."""
    kw = dict(remat=remat, remat_chunk=remat_chunk)
    params = _flax_params(config, **kw)
    jmodel = jax_registry.create_model("encoderdecoderconvlstm", dtype=getattr(jnp, dtype),
                                       **KW, **CONFIGS[config], **kw)
    batch = _batch()

    def jax_grads(m):
        return params_from_flax({"params": jax.grad(
            lambda p: m.loss(p, {}, batch, jax.random.PRNGKey(0))[0])(params["params"])})

    want = jax_grads(jmodel)
    if dtype == "bfloat16":  # see the module docstring: XLA's bf16 bias sums
        f32 = jax_grads(jax_registry.create_model("encoderdecoderconvlstm", **KW,
                                                  **CONFIGS[config], **kw))
        want.update({k: v for k, v in f32.items() if k.endswith(".bias")})
    model = _port(params, config, dtype=getattr(torch, dtype), **kw)
    loss, _ = model.loss(tuple(torch.from_numpy(a) for a in batch))
    loss.backward()
    got = {name: p.grad for name, p in model.module.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        assert g.abs().sum() > 0, name
        np.testing.assert_allclose(g.numpy(), w, atol=tol * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("config", ["concat", "split", "hybrid"])
@pytest.mark.parametrize("remat, remat_chunk", [(True, 0), (True, 2), (True, 3)])
def test_remat_changes_no_gradient(config, remat, remat_chunk):
    params = _flax_params(config)
    batch = tuple(torch.from_numpy(a) for a in _batch(seed=2))

    def grads(**kw):
        model = _port(params, config, **kw)
        model.loss(batch)[0].backward()
        return {n: p.grad for n, p in model.module.named_parameters()}

    want, got = grads(), grads(remat=remat, remat_chunk=remat_chunk)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=1e-6 * want[name].abs().max().item(), err_msg=name)


def test_input_gates_stay_outside_the_encoder_remat(monkeypatch):
    """With a split encoder under sqrt remat the hoisted conv runs once per
    forward and once in the backward's... never: it is outside the checkpoint."""
    import satflow_tpu_torch.models.conv_lstm as M

    model = _port(_flax_params("split"), "split", remat=True, remat_chunk=2)
    calls = []
    gates = model.module.encoder_input_gates
    monkeypatch.setattr(gates, "forward", lambda x, _f=gates.forward: calls.append(1) or _f(x))
    regions = []
    monkeypatch.setattr(M, "_remat", lambda fn, *a, _r=M._remat: regions.append(fn.__name__)
                        or _r(fn, *a))
    model.loss(tuple(torch.from_numpy(a) for a in _batch()))[0].backward()
    assert calls == [1]
    assert regions == ["_encode"] + ["_decode"] * (STEPS // 2)


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_flax({"params": tree}).items()}


@pytest.mark.parametrize("config", ["split", "concat"])
def test_train_step_matches_jax(config):
    """One Adam step through ``make_train_step`` against the JAX one. An
    update read back from f32 parameters of size up to ~1.3 carries their
    rounding, 2^-23 x 1.3 = 1.5e-7, i.e. 1.5e-4 x lr at lr 1e-3: atol 2e-4 x lr."""
    params = _flax_params(config)
    batch = _batch(seed=3)
    jmodel = jax_registry.create_model("encoderdecoderconvlstm", **KW, **CONFIGS[config])
    jstate = JaxTrainState.create(params["params"], {}, jmodel.make_optimizer())
    g_ref = _flat(jax.grad(lambda p: jmodel.loss(p, {}, batch, jax.random.PRNGKey(0))[0])(
        params["params"]))
    old = _flat(params["params"])
    jstate, jm = jax_make_train_step(jmodel)(jstate, batch, jax.random.PRNGKey(0))
    model = _port(params, config)
    state = TrainState(model, model.make_optimizer())
    metrics = make_train_step(model)(state, tuple(torch.from_numpy(a) for a in batch))
    assert state.step == 1 and bool(metrics["finite"])
    for key in ("loss", "grad_norm", "frame_loss"):
        np.testing.assert_allclose(metrics[key].numpy(), np.asarray(jm[key]), rtol=1e-5,
                                   err_msg=key)
    want = _flat(jstate.params)
    for name, p in model.module.named_parameters():
        d_got = (p.detach().numpy() - old[name]) / model.lr
        d_want = (want[name] - old[name]) / model.lr
        big = np.abs(g_ref[name]) > 1e-6
        np.testing.assert_allclose(d_got[big], d_want[big], atol=2e-4, err_msg=name)
        assert np.all(np.abs(d_got) <= 1 + 2e-4)


# --------------------------------------------------------------------------- serving


@pytest.mark.parametrize("config", ["concat", "split", "hybrid"])
def test_session_serves_like_the_jax_session(config):
    """A request through ``InferenceSession`` on the CPU (padded to the
    session's batch) against the JAX session on the same weights: 1e-5."""
    params = _flax_params(config)
    x = _batch(seed=4)[0][:1]
    jmodel = jax_registry.create_model("encoderdecoderconvlstm", **KW, **CONFIGS[config])
    want = JaxSession(jmodel, max_batch=2, variables=params).predict(x)
    model = registry.create_model("encoderdecoderconvlstm", **KW, **CONFIGS[config])
    session = InferenceSession(model, max_batch=2, variables=params, device="cpu")
    got = session.predict(x)
    assert got.shape == (1, STEPS, H, W, COUT)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("config", ["concat", "split", "hybrid", "coord"])
def test_int8_refuses_a_model_without_fused_cells(config):
    """The JAX session's rule and message."""
    params = _flax_params(config)
    model = registry.create_model("encoderdecoderconvlstm", **KW, **CONFIGS[config])
    with pytest.raises(ValueError, match="int8 serving requires a fused-cell ConvLSTM model"):
        InferenceSession(model, variables=params, quantize="int8", device="cpu")
    if config == "coord":  # cell_impl says fused there; the conv type runs concat cells
        return
    jmodel = jax_registry.create_model("encoderdecoderconvlstm", **KW, **CONFIGS[config])
    with pytest.raises(ValueError, match="int8 serving requires a fused-cell ConvLSTM model"):
        JaxSession(jmodel, variables=params, quantize="int8")


def test_hparams_match_jax():
    for config in CONFIGS.values():
        jmodel = jax_registry.create_model("encoderdecoderconvlstm", **KW, **config)
        model = registry.create_model("encoderdecoderconvlstm", **KW, **config)
        assert model.hparams() == jmodel.hparams()
