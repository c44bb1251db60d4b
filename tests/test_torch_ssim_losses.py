"""PyTorch port, losses: SSIM and MS-SSIM (``ops/ssim.py``), every factory of
the loss registry (``nn/losses.py``) and ``LitMetNet(loss="ssim")`` against
the JAX package on the same numpy-seeded inputs, values and gradients.

Tolerances (each test says which it uses):
- float32 values: atol 1e-5 (SSIM: the same f32 statistics, the blur summed
  by another conv; the other losses: the same elementwise math, the means
  summed in another order);
- float32 gradients: atol 1e-5 x max|grad| per tensor;
- bfloat16 inputs: SSIM / MS-SSIM upcast to f32 before any statistic, so the
  same f32 tolerance holds except where the range conversion or MS-SSIM's
  2x2 pooling rounds in bf16 first (one bf16 step, 2^-8 relative, of a
  pixel in [0, 1]; measured below 1e-3 of the index): atol 2e-3; the
  elementwise losses computed in bf16 on both sides: atol 2e-2 x |value|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satflow_tpu.core import registry as jax_registry
from satflow_tpu.nn import losses as jax_losses
from satflow_tpu.ops import ssim as jax_ssim
import satflow_tpu.models  # noqa: F401 - populate the JAX registry
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.core import registry
from satflow_tpu_torch.interop.jax_weights import metnet_state_dict_from_flax
from satflow_tpu_torch.nn import losses
from satflow_tpu_torch.ops import ssim as S

ATOL_F32 = 1e-5
ATOL_BF16_SSIM = 2e-3


def _pair(shape, seed, dtype="float32", signed=False):
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    y = np.clip(x + 0.2 * rng.standard_normal(shape, dtype=np.float32), 0, 1)
    if signed:  # [-1, 1], the range convert_range maps from
        x, y = 2 * x - 1, 2 * y - 1
    return x.astype(np.float32), y.astype(np.float32)


def _t(a, dtype="float32", grad=False):
    t = torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    return t.requires_grad_(grad)


def _j(a, dtype="float32"):
    return jnp.asarray(a, dtype=getattr(jnp, dtype))


# -- SSIM / MS-SSIM -----------------------------------------------------------

# 8x8: the window clamps to 7 and MS-SSIM keeps one level; 32x32: 11 and
# two levels; 64x64: three; 13x21: odd sizes floored by the 2x2 pool;
# 5-D inputs fold the time axis into the batch
SHAPES = [(2, 8, 8, 2), (2, 32, 32, 3), (1, 64, 64, 1), (2, 13, 21, 2), (2, 3, 32, 32, 2)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [{}, dict(nonnegative=True), dict(per_channel=True)])
def test_ssim_matches_jax(shape, dtype, kw):
    x, y = _pair(shape, seed=sum(shape))
    want = np.asarray(jax_ssim.ssim(_j(x, dtype), _j(y, dtype), **kw))
    got = S.ssim(_t(x, dtype), _t(y, dtype), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_channel", [False, True])
def test_ms_ssim_matches_jax(shape, dtype, per_channel):
    x, y = _pair(shape, seed=7 + sum(shape))
    want = np.asarray(jax_ssim.ms_ssim(_j(x, dtype), _j(y, dtype), per_channel=per_channel))
    got = S.ms_ssim(_t(x, dtype), _t(y, dtype), per_channel=per_channel)
    assert tuple(got.shape) == want.shape
    atol = ATOL_F32 if dtype == "float32" else ATOL_BF16_SSIM
    np.testing.assert_allclose(got.numpy(), want, atol=atol)


def test_ssim_helpers_match_jax():
    """The window clamp (odd, >= 1), the Gaussian window, the range
    conversion and the VALID 2x2 pool that floors odd sizes: exact."""
    for win, dim in ((11, 64), (11, 11), (11, 10), (11, 8), (11, 2), (11, 1), (4, 3)):
        assert S._clamp_win(win, dim) == jax_ssim._clamp_win(win, dim)
    np.testing.assert_array_equal(S._gaussian_kernel1d(7, 1.5),
                                  jax_ssim._gaussian_kernel1d(7, 1.5))
    x, _ = _pair((2, 5, 7, 3), seed=3, signed=True)
    np.testing.assert_array_equal(S.convert_range(_t(x)).numpy(),
                                  np.asarray(jax_ssim.convert_range(_j(x))))
    pooled = S._avg_pool2(_t(x))
    assert tuple(pooled.shape) == (2, 2, 3, 3)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jax_ssim._avg_pool2(_j(x))),
                               atol=1e-7)
    with pytest.raises(ValueError, match="NHWC"):
        S.ssim(_t(x[0]), _t(x[0]))


@pytest.mark.parametrize("fn", ["ssim", "ms_ssim"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 2), (2, 64, 64, 1)])
def test_ssim_gradients_match_jax(fn, shape):
    """d(index)/d(x), float32: atol 1e-5 x max|grad|."""
    x, y = _pair(shape, seed=11)
    want = np.asarray(jax.grad(lambda a: getattr(jax_ssim, fn)(a, _j(y)))(_j(x)))
    xt = _t(x, grad=True)
    getattr(S, fn)(xt, _t(y)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=ATOL_F32 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 8, 8, 2), (2, 4, 32, 32, 3), (1, 2, 13, 21, 2)])
def test_frame_curves_match_per_frame_calls(shape, dtype):
    """``ssim_frames`` / ``ms_ssim_frames`` (one pass over B·T images) equal
    T calls of ``ssim`` / ``ms_ssim`` on the frames (atol 1e-6: the means
    summed in another order), and the JAX ``vmap`` over the time axis
    (atol 1e-5; bf16 MS-SSIM 2e-3, as above)."""
    x, y = _pair(shape, seed=len(shape) + shape[1])
    xt, yt = _t(x, dtype), _t(y, dtype)
    for frames, single, jfn, kw in ((S.ssim_frames, S.ssim, jax_ssim.ssim, dict(nonnegative=True)),
                                    (S.ms_ssim_frames, S.ms_ssim, jax_ssim.ms_ssim, {})):
        got = frames(xt, yt, **kw)
        loop = torch.stack([single(xt[:, f], yt[:, f], **kw) for f in range(shape[1])])
        np.testing.assert_allclose(got.numpy(), loop.numpy(), atol=1e-6)
        want = jax.vmap(lambda a, b: jfn(a, b, **kw), in_axes=(1, 1))(_j(x, dtype), _j(y, dtype))
        atol = ATOL_BF16_SSIM if dtype == "bfloat16" and single is S.ms_ssim else ATOL_F32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


@pytest.mark.parametrize("name, kw", [("ssim", {}), ("ssim", dict(convert_range_flag=True)),
                                      ("ms_ssim", dict(convert_range_flag=True))])
def test_loss_per_frame_matches_jax_vmap(name, kw):
    """The SSIM losses' ``per_frame`` (what ``frame_metrics`` logs) against
    the JAX ``vmap`` of the criterion over the time axis: atol 1e-5."""
    pred, target = _pair((2, 3, 32, 32, 2), seed=9, signed=kw.get("convert_range_flag", False))
    jfn = jax_losses.get_loss(name, **kw)
    want = jax.vmap(jfn, in_axes=(1, 1))(_j(pred), _j(target))
    got = losses.get_loss(name, **kw).per_frame(_t(pred), _t(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32)


def test_identical_images_score_one():
    x, _ = _pair((2, 32, 32, 2), seed=5)
    assert abs(S.ssim(_t(x), _t(x)).item() - 1.0) < 1e-5
    assert abs(S.ms_ssim(_t(x), _t(x)).item() - 1.0) < 1e-5


# -- the loss registry --------------------------------------------------------

FACTORIES = [
    ("mse", {}), ("l2", {}), ("l1", {}), ("mae", {}),
    ("huber", {}), ("huber", dict(delta=0.1)),
    ("bce", {}), ("bce", dict(with_logits=False)),
    ("focal", {}), ("focal", dict(alpha=0.5, gamma=1.0)), ("focal", dict(with_logits=False)),
    ("ssim", {}), ("ssim", dict(convert_range_flag=True, nonnegative=False)),
    ("ssim", dict(data_range=2.0)),
    ("ms_ssim", {}), ("msssim", dict(convert_range_flag=True)),
]


def _loss_inputs(name, kw, seed):
    """Predictions and targets in the range each loss reads: logits or
    probabilities against {0, 1} labels for bce / focal, [-1, 1] where the
    range is converted, else [0, 1]."""
    rng = np.random.default_rng(seed)
    shape = (2, 3, 32, 32, 2)
    if name in ("bce", "focal"):
        target = (rng.random(shape) > 0.5).astype(np.float32)
        pred = (rng.standard_normal(shape) * 2).astype(np.float32)
        if not kw.get("with_logits", True):
            pred = 1 / (1 + np.exp(-pred)).astype(np.float32)
        return pred, target
    if name == "huber":
        pred, target = _pair(shape, seed)
        return pred * 3, target
    return _pair(shape, seed, signed=kw.get("convert_range_flag", False))


@pytest.mark.parametrize("name, kw", FACTORIES)
def test_loss_factory_matches_jax(name, kw):
    """Value and gradient of every factory with its keywords, float32:
    atol 1e-5 (value) and 1e-5 x max|grad| (gradient)."""
    pred, target = _loss_inputs(name, kw, seed=len(name) + len(kw))
    jfn = jax_losses.get_loss(name, channel=2, **kw)  # channel= is ignored by both
    want, want_grad = jax.value_and_grad(lambda p: jfn(p, _j(target)))(_j(pred))
    fn = losses.get_loss(name, channel=2, **kw)
    p = _t(pred, grad=True)
    got = fn(p, _t(target))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL_F32, rtol=1e-6)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(p.grad.numpy(), want_grad,
                               atol=ATOL_F32 * max(np.abs(want_grad).max(), 1e-12))


@pytest.mark.parametrize("name", ["mse", "l1", "huber", "bce", "ssim", "ms_ssim"])
def test_loss_factory_bf16_matches_jax(name):
    """The same losses on bf16 predictions and targets (the dtype a bf16
    model hands its criterion): mse and SSIM upcast, the rest compute in
    bf16 on both sides; atol 2e-2 x |value| (2e-3 for the SSIM family)."""
    kw = dict(convert_range_flag=True) if "ssim" in name else {}
    pred, target = _loss_inputs(name, kw, seed=3)
    want = float(jax_losses.get_loss(name, **kw)(_j(pred, "bfloat16"), _j(target, "bfloat16")))
    got = losses.get_loss(name, **kw)(_t(pred, "bfloat16"), _t(target, "bfloat16")).float().item()
    atol = ATOL_BF16_SSIM if "ssim" in name else 2e-2 * abs(want)
    np.testing.assert_allclose(got, want, atol=atol)


def test_nll_takes_integer_targets():
    """Log-probabilities over the last axis against int64 / int32 class
    indices: value and gradient, atol 1e-6."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    logp = np.asarray(jax.nn.log_softmax(logits, axis=-1))
    idx = rng.integers(0, 4, size=(2, 5, 6))
    jfn = jax_losses.get_loss("nll")
    want, want_grad = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(idx)))(jnp.asarray(logp))
    for dtype in (torch.int64, torch.int32):
        p = _t(logp, grad=True)
        got = losses.get_loss("nll")(p, torch.from_numpy(idx).to(dtype))
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), atol=1e-6)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), atol=1e-6)


def test_get_loss_registry():
    """The JAX registry's names, keywords passed on, unknown keywords
    swallowed, callables passed through; the GAN objectives' names are not
    in either registry (``GANLoss`` and ``gradient_penalty`` are built
    directly) and, as any unknown name, a KeyError."""
    want = set(jax_losses.LOSSES.names())
    assert set(losses.LOSSES.names()) == want
    x, y = _t(np.full((1, 4), 3.0)), _t(np.zeros((1, 4)))
    assert losses.get_loss("huber", delta=0.5, unused=1)(x, y).item() == pytest.approx(1.375)
    assert losses.get_loss("huber")(x, y).item() == pytest.approx(2.5)
    fn = losses.get_loss("mse")
    assert losses.get_loss(fn) is fn
    for name in ("lsgan", "vanilla", "wgangp", "gradient_penalty", "no_such_loss"):
        with pytest.raises(KeyError):
            jax_losses.get_loss(name)
        with pytest.raises(KeyError):
            losses.get_loss(name)
    assert callable(losses.GANLoss("lsgan")) and callable(losses.gradient_penalty)


# -- LitMetNet with the SSIM loss ---------------------------------------------

MN_KW = dict(forecast_steps=2, hidden_dim=16, output_channels=2, temporal_dropout=0.0)
# gradients that are zero in exact arithmetic (test_torch_metnet.py says why)
ZERO_GRAD = ("image_encoder.c0.bias", "axial0.attn0.k.bias", "axial0.attn1.k.bias")


def _randomise(tree, seed):
    """Random flax leaves: kernels normal / sqrt(fan_in), scales near 1,
    running variances in [0.5, 1.5], the rest small."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        shape = np.shape(a)
        if name.endswith("['kernel']"):
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith("['scale']"):
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name.endswith("['var']"):
            v = rng.uniform(0.5, 1.5, size=shape)
        else:
            v = 0.1 * rng.normal(size=shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, tree))


def _metnet_batch(seed, b=2, t=3, hw=64, c=3, f=2):
    """The fake datamodule's schema (``test_torch_metnet.py``'s batch), the
    targets in [-1, 1], the range the criterion converts from."""
    rng = np.random.default_rng(seed)
    x = {"sat_data": rng.random((b, t, hw, hw, c), dtype=np.float32),
         "topo_data": rng.random((b, hw, hw), dtype=np.float32),
         "nwp": rng.random((b, 4, t, 3, 5), dtype=np.float32)}
    y = {"sat_data": 2 * rng.random((b, f, hw, hw, c), dtype=np.float32) - 1}
    return x, y


@pytest.mark.parametrize("loss", ["ssim", "ms_ssim"])
def test_metnet_ssim_loss_and_grads_match_jax(loss):
    """``LitMetNet(loss=...)`` builds the channel-aware, nonnegative,
    range-converting criterion and keeps the name; one train-mode loss on
    the same weights: value atol 1e-5, every gradient atol 1e-4 x max|grad|
    (the MetNet train-step tolerance of ``test_torch_metnet.py``). The
    MetNet output grid is 4x4: the window clamps to 3 and MS-SSIM keeps one
    level."""
    batch = _metnet_batch(seed=3)
    jmodel = jax_registry.create_model("litmetnet", loss=loss, **MN_KW)
    assert jmodel.loss_name == loss
    x, _ = jmodel.prepare_batch(batch)
    variables = _randomise(jmodel.module.init(jax.random.PRNGKey(0), x), seed=4)
    params, state = jmodel.split_variables(variables)
    (want, (want_metrics, _)), grads = jax.value_and_grad(
        lambda p: jmodel.loss(p, state, batch, jax.random.PRNGKey(0)), has_aux=True)(params)
    want_grads = metnet_state_dict_from_flax({"params": grads})

    model = registry.create_model("litmetnet", loss=loss, **MN_KW)
    model.module.load_state_dict(metnet_state_dict_from_flax(variables))
    assert model.loss_name == loss and model.hparams()["loss"] == loss
    model.train()
    got, metrics = model.loss(batch)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL_F32)
    np.testing.assert_allclose(metrics["frame_loss"].numpy(),
                               np.asarray(want_metrics["frame_loss"]), atol=ATOL_F32)
    for name, p in model.module.named_parameters():
        w = want_grads[name].numpy()
        if name in ZERO_GRAD:  # rounding noise on both sides, against the layer's weight grad
            scale = np.abs(want_grads[name.replace(".bias", ".weight")].numpy()).max()
            assert np.abs(w).max() <= 1e-4 * scale and p.grad.abs().max() <= 1e-4 * scale, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-4 * np.abs(w).max(), err_msg=name)
