"""PyTorch port, the channels-stacked zoo: the U-Net family (``unet``,
``runet``, ``attentionunet``, ``attentionrunet``), ``fcn`` and ``deeplabv3``
on ResNet, and ``pixelcnn``, against the JAX package on the same weights;
their blocks (the ResNet backbone at every output stride, the bilinear
resize, flax's SAME pools), and the PredRNN-v2 cell under ``scan_cell`` and
``TimeDistributed``.

Weights and inputs come from numpy seeds and go to both packages; flax
variables reach the port through ``zoo_state_dict_from_flax`` (one tree
walk for every model). Nothing here has a kernel: both sides run library
convs on the CPU.

Tolerances (each test says which it uses):
- float32 forwards (eval and train mode) and the running statistics a train
  forward leaves: atol 1e-4 x max|ref|, the same f32 convs summed in
  another order, a few layers deep;
- one train step's loss and frame metrics in float32: rtol 1e-4, through up
  to 20 train-mode BatchNorms whose variance flax takes as E[x²] - E[x]²
  and the port as E[(x - E[x])²] (measured 1.8e-5);
- every parameter's gradient, in float64 on both sides: atol 1e-7 x
  max|grad| of that tensor (the resize's weights keep some float32
  rounding in JAX: 3e-9 measured). In float32 the two packages' forwards differ by
  rounding, which can flip a ReLU mask at a pixel whose input sits at zero
  and move every gradient below it by that pixel's term (measured: one
  element of DeepLabV3's ASPP bias gradient 6 % off); in float64 no mask
  flips. A bias is held at its layer's weight gradient's scale where that
  is larger (a conv bias before train-mode BatchNorm has a zero gradient in
  exact arithmetic: rounding noise);
- the blocks (resize, pools, the cell, the backbone): atol 1e-5 x max|ref|.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satflow_tpu.core import registry as jax_registry
from satflow_tpu.models.pixel_cnn import PixelCNNCore as JaxPixelCNNCore
from satflow_tpu.nn.misc import TimeDistributed as JaxTimeDistributed
from satflow_tpu.nn.recurrent import SpatioTemporalLSTMCell as JaxSTCell
from satflow_tpu.nn.recurrent import scan_cell as jax_scan_cell
from satflow_tpu.nn.resnet import ResNetBackbone as JaxResNetBackbone
import satflow_tpu.models  # noqa: F401 - populate the JAX registry
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.core import registry
from satflow_tpu_torch.interop.jax_weights import zoo_state_dict_from_flax
from satflow_tpu_torch.models.pixel_cnn import PixelCNNCore
from satflow_tpu_torch.models.segmentation import resize_bilinear
from satflow_tpu_torch.nn import TimeDistributed, time_distributed
from satflow_tpu_torch.nn.misc import max_pool
from satflow_tpu_torch.nn.recurrent import SpatioTemporalLSTMCell, scan_cell
from satflow_tpu_torch.nn.resnet import ResNetBackbone

B, T, H, W, C, F = 2, 3, 16, 16, 2, 2
SMALL = dict(features_start=4, depth=3)
# (registry name, constructor keywords, image size): the U-Net family at
# depth 3 on 16², R2U-Net in its three conv types, the segmentation models on
# a small backbone (stages (1, 1, 1, 1), width 4, see _small_backbones) at
# 64² (output stride 16: a 4x4 C5, so that train-mode BatchNorm sees 32
# values a channel), PixelCNN at hidden 8
MODELS = {
    "unet": ("unet", SMALL, 16),
    "runet": ("runet", SMALL, 16),
    "runet_coord": ("runet", dict(SMALL, conv_type="coord"), 16),
    "runet_antialiased": ("runet", dict(SMALL, conv_type="antialiased"), 16),
    "attentionunet": ("attentionunet", SMALL, 16),
    "attentionrunet": ("attentionrunet", SMALL, 16),
    "fcn": ("fcn", {}, 64),
    "deeplabv3": ("deeplabv3", {}, 64),
    "pixelcnn": ("pixelcnn", dict(hidden_channels=8, num_blocks=2), 16),
}


@pytest.fixture(autouse=True)
def _small_backbones(monkeypatch):
    """FCN and DeepLabV3 on a ResNet of stages (1, 1, 1, 1) and width 4 in
    both packages (their cores pick ResNet-50 / -101 by name; those at
    width 64 cost the JAX side minutes on the CPU). The backbone itself is
    held at every output stride below."""
    import satflow_tpu.models.segmentation as jax_seg
    import satflow_tpu_torch.models.segmentation as seg

    monkeypatch.setattr(jax_seg, "ResNetBackbone", lambda stages, **kw: JaxResNetBackbone(
        (1, 1, 1, 1), width=4, **kw))
    monkeypatch.setattr(seg, "ResNetBackbone", lambda stages, **kw: ResNetBackbone(
        (1, 1, 1, 1), width=4, **kw))


def _randomise(tree, seed):
    """Random flax leaves of the tree's shapes (arrays or ``jax.eval_shape``'s
    structs): kernels normal / sqrt(fan_in),
    scales near 1, running variances in [0.5, 1.5], the rest small."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        shape = tuple(a.shape)
        if name.endswith("['kernel']"):
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith("['scale']"):
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name.endswith("['var']"):
            v = rng.uniform(0.5, 1.5, size=shape)
        else:
            v = 0.1 * rng.normal(size=shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, rel, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


def _batch(size, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, T, size, size, C)).astype(np.float32)
    y = rng.uniform(0, 1, (B, F, size, size, C)).astype(np.float32)
    return x, y


@functools.lru_cache(maxsize=None)
def _jax_side(key, seed):
    """The JAX model, numpy-seeded flax variables of its tree's shapes
    (``jax.eval_shape`` of its init: nothing compiles) and a batch at the
    model's size; shared by the tests of one model."""
    name, kw, size = MODELS[key]
    x, y = _batch(size, seed)
    jmodel = jax_registry.create_model(name, input_channels=C, forecast_steps=F, **kw)
    variables = _randomise(jax.eval_shape(jmodel.init_variables, jax.random.PRNGKey(0), (x, y)),
                           seed + 1)
    return jmodel, variables, (x, y)


def _pair(key, seed=0):
    """The JAX side and the port's model with the same weights."""
    jmodel, variables, batch = _jax_side(key, seed)
    name, kw, _ = MODELS[key]
    model = registry.create_model(name, input_channels=C, forecast_steps=F, **kw)
    model.module.load_state_dict(model.state_dict_from_flax(variables))
    return jmodel, variables, model, batch


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("key", list(MODELS))
def test_zoo_forward_matches_jax(key, train):
    """The forward on the same weights, in eval mode (running statistics)
    and in train mode (batch statistics; then the running statistics the
    step leaves against flax's updated ``batch_stats``): atol 1e-4 x max|ref|."""
    jmodel, variables, model, (x, y) = _pair(key)
    xs, _ = jmodel.prepare_batch((x, y))
    model.train(train)
    with torch.no_grad():
        got = model(_t(x))
    if not train:
        want = jax.jit(jmodel.forward)(variables, x)
    else:
        mutable = [k for k in variables if k != "params"]
        out, new_state = jax.jit(functools.partial(jmodel.module.apply, train=True,
                                                   mutable=mutable))(variables, xs)
        want = jmodel._unstack(out)
        stats = zoo_state_dict_from_flax({"params": {}, **new_state})
        params = dict(model.module.named_parameters())
        buffers = {k: v for k, v in model.module.state_dict().items() if k not in params}
        assert set(stats) == set(buffers)
        for k, v in stats.items():
            _close(buffers[k], v, 1e-4, k)
    assert tuple(got.shape) == (B, F, x.shape[2], x.shape[3], 1)
    _close(got, want, 1e-4, key)


@pytest.mark.parametrize("key", list(MODELS))
def test_zoo_train_step_grads_match_jax(key):
    """One train step: the loss and frame metrics of ``model.loss`` in
    float32 (rtol 1e-4), then every parameter's gradient of that MSE through
    the train-mode core in float64 on both sides (``jax.enable_x64``), where
    no ReLU mask can flip between the two: atol 1e-7 x max|grad| per tensor,
    a bias at its layer's weight gradient's scale where that is larger."""
    jmodel, variables, model, (x, y) = _pair(key, seed=3)
    params, state = jmodel.split_variables(variables)
    jloss, (jmetrics, _) = jax.jit(functools.partial(jmodel.loss, train=True))(
        params, state, (x, y), jax.random.PRNGKey(0))
    model.train()
    with torch.no_grad():
        loss, metrics = model.loss((_t(x), _t(y)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    _close(metrics["frame_loss"], jmetrics["frame_loss"], 1e-4, "frame_loss")

    xs, ys = (np.asarray(a, np.float64) for a in jmodel.prepare_batch((x, y)))
    with jax.enable_x64(True):
        p64, s64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), (params, state))

        def loss_fn(p):
            out, _ = jmodel.module.apply({"params": p, **s64}, xs, train=True,
                                         mutable=list(s64))
            return jnp.mean(jnp.square(jmodel._unstack(out) - ys))

        grads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(p64))
    model = model.double()
    torch.mean(torch.square(model(torch.from_numpy(xs)) - torch.from_numpy(ys))).backward()
    want = zoo_state_dict_from_flax({"params": grads}, dtype=np.float64)
    got = dict(model.module.named_parameters())
    assert set(want) == set(got)
    for k, g in want.items():
        assert got[k].grad is not None, k
        # a conv bias followed by train-mode BatchNorm has a zero gradient in
        # exact arithmetic (the mean removes it): rounding noise on both
        # sides, held at the scale of its layer's weight gradient
        scale = g.abs().max().item()
        if k.endswith(".bias") and k[: -len("bias")] + "weight" in want:
            scale = max(scale, want[k[: -len("bias")] + "weight"].abs().max().item())
        np.testing.assert_allclose(got[k].grad.numpy(), g.numpy(),
                                   rtol=0, atol=1e-7 * scale, err_msg=k)


def test_zoo_hparams_and_registry_match_jax():
    """The eleven registered names, and each zoo model's hparams equal to the
    JAX model's (what ``hparams.json`` holds)."""
    assert registry.list_models() == [
        "attentionrunet", "attentionunet", "deeplabv3", "encoderdecoderconvlstm", "fcn",
        "huggingfaceperceiver", "litmetnet", "perceiver", "pixelcnn", "runet", "unet"]
    for key, (name, kw, _) in MODELS.items():
        want = jax_registry.create_model(name, input_channels=C, forecast_steps=F, **kw).hparams()
        assert registry.create_model(name, input_channels=C, forecast_steps=F,
                                     **kw).hparams() == want, key


ZOO_CONFIGS = ["unet", "runet", "runet_coord", "attention_unet", "attention_runet",
               "attention_runet_coord", "fcn_r50", "fcn_r101", "deeplabv3_r50", "deeplabv3_r101"]


@pytest.mark.parametrize("overrides", [[f"model={m}"] for m in ZOO_CONFIGS]
                         + [["experiment=unet_simple"]], ids=lambda o: o[0])
def test_zoo_configs_instantiate_through_the_experiment(overrides):
    """Each zoo model config, and ``experiment=unet_simple``, builds the
    port's model through ``experiments/train.py`` with the config's
    hyperparameters (the U-Nets at features_start 4 and depth 2, the
    segmentation models on the small backbone). The experiment's node keeps
    the default model's ``out_channels`` and ``hidden_dim``, which are
    dropped for a stacked model; any other key it does not take raises the
    TypeError the JAX package raises."""
    from satflow_tpu_torch.core.config import compose, default_config_dir

    # the package exports the function train under the module's name
    train_mod = importlib.import_module("satflow_tpu_torch.experiments.train")
    unet = "unet" in overrides[0]
    small = ["model.features_start=4", "model.depth=2"] if unet else []
    node = compose(default_config_dir(), "config.yaml", overrides + small)["model"]
    model = train_mod.instantiate(train_mod._model_node(node))
    assert type(model) is train_mod._counterpart(node["_target_"])
    hp = model.hparams()
    assert {k: hp[k] for k in node if k in hp} == {k: v for k, v in node.items() if k in hp}
    assert ("hidden_dim" in node) == (overrides[0] == "experiment=unet_simple")
    if unet:
        with pytest.raises(TypeError, match="features_strat"):
            train_mod.instantiate(train_mod._model_node(dict(node, features_strat=4)))


def test_pixelcnn_causality():
    """Masked convs: an output pixel does not depend on the input at or after
    it (the JAX package's test, through the port's core)."""
    core = PixelCNNCore(out_channels=1, hidden_channels=8, num_blocks=1,
                        generator=torch.Generator().manual_seed(0))
    x = torch.rand(1, 8, 8, 1, generator=torch.Generator().manual_seed(1))
    y1 = core(x)
    x2 = x.clone()
    x2[0, 7, 7, 0] = 123.0  # the last pixel
    y2 = core(x2)
    torch.testing.assert_close(y1[0, :7], y2[0, :7], atol=1e-5, rtol=0)
    torch.testing.assert_close(y1[0, 7, :7], y2[0, 7, :7], atol=1e-5, rtol=0)
    x3 = x.clone()
    x3[0, 3, 3, 0] = 123.0  # a pixel the last one does depend on
    assert not torch.allclose(core(x3)[0, 7, 7], y1[0, 7, 7])
    # and the same core as the JAX one on the same weights
    jcore = JaxPixelCNNCore(out_channels=1, hidden_channels=8, num_blocks=1)
    xn = np.random.default_rng(2).random((1, 8, 8, 1)).astype(np.float32)
    variables = _randomise(jax.eval_shape(jcore.init, jax.random.PRNGKey(0), xn), 4)
    core.load_state_dict(zoo_state_dict_from_flax(variables))
    _close(core(_t(xn)), jcore.apply(variables, xn), 1e-5)


@pytest.mark.parametrize("output_stride", [8, 16, 32])
def test_resnet_backbone_matches_jax_at_every_output_stride(output_stride):
    """``ResNetBackbone`` with small stages (1, 1, 1, 1) and width 4, train
    and eval mode, C5 and C4, on a 34x22 input (odd halvings: every strided
    conv and the stem's pool pad 0 before and 1 after, the 7x7 stem 2 and 3
    at an even size), its last row and column held on their own: atol 1e-5
    x max|ref|."""
    jnet = JaxResNetBackbone((1, 1, 1, 1), width=4, output_stride=output_stride)
    x = np.random.default_rng(5).normal(size=(2, 34, 22, 3)).astype(np.float32)
    variables = _randomise(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x), 6)
    net = ResNetBackbone((1, 1, 1, 1), width=4, output_stride=output_stride)
    net.load_state_dict(zoo_state_dict_from_flax(variables))
    for train in (False, True):
        net.train(train)
        out = jax.jit(functools.partial(jnet.apply, train=train,
                                        mutable=["batch_stats"] if train else False))(variables, x)
        (c5, c4) = out[0] if train else out
        with torch.no_grad():
            g5, g4 = net(_t(x))
        stride = min(output_stride, 32)
        assert g5.shape[1:3] == (-(-34 // stride), -(-22 // stride))
        for got, want in ((g5, c5), (g4, c4)):
            _close(got, want, 1e-5)
            _close(got[:, -1], np.asarray(want)[:, -1], 1e-5, "last row")
            _close(got[:, :, -1], np.asarray(want)[:, :, -1], 1e-5, "last column")


@pytest.mark.parametrize("shape", [(2, 5, 3), (16, 16), (2, 16, 16)], ids=str)
def test_bilinear_resize_matches_jax_image_resize(shape):
    """``resize_bilinear`` against ``jax.image.resize(..., "bilinear")`` on
    non-square inputs upsampled by x16 (the segmentation models') and by
    odd factors; the edge rows and columns on their own: atol 1e-5."""
    b, h, w = (1,) + shape if len(shape) == 2 else shape
    x = np.random.default_rng(7).normal(size=(b, h, w, 3)).astype(np.float32)
    for oh, ow in ((16 * h, 16 * w), (3 * h + 1, 5 * w + 2)):
        want = np.asarray(jax.image.resize(x, (b, oh, ow, 3), method="bilinear"))
        got = resize_bilinear(_t(x), oh, ow).numpy()
        for sl in (np.s_[:], np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
            np.testing.assert_allclose(got[sl], want[sl], atol=1e-5, rtol=0)


@pytest.mark.parametrize("window,strides,padding", [(2, 2, "VALID"), (2, 1, "SAME"),
                                                     (3, 2, "SAME")])
def test_max_pool_pads_as_flax(window, strides, padding):
    """flax's ``nn.max_pool`` on a 7x6 input of all-negative values (a zero
    pad would show): bit-equal, the last row and column included."""
    import flax.linen as fnn

    x = -np.random.default_rng(8).uniform(1, 2, (2, 7, 6, 3)).astype(np.float32)
    want = fnn.max_pool(jnp.asarray(x), (window, window), (strides, strides), padding)
    np.testing.assert_array_equal(max_pool(_t(x), window, strides, padding).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("layer_norm", [True, False])
def test_spatiotemporal_cell_under_scan_matches_jax(layer_norm):
    """``SpatioTemporalLSTMCell`` (kernel 3) under ``scan_cell`` over 4 steps,
    with and without its LayerNorms (flax's eps 1e-6): the final (h, c, m)
    and the stacked (h, Δc, Δm) against the JAX ``nn.scan``: atol 1e-5 x
    max|ref|."""
    feats = 4
    rng = np.random.default_rng(9)
    xs = rng.normal(size=(2, 4, 8, 8, 3)).astype(np.float32)
    carry = tuple(rng.normal(size=(2, 8, 8, feats)).astype(np.float32) for _ in range(3))
    jscan = jax_scan_cell(JaxSTCell, features=feats, kernel_size=3, layer_norm=layer_norm)
    variables = _randomise(jax.eval_shape(jscan.init, jax.random.PRNGKey(0), carry, xs), 10)
    want_carry, want_ys = jscan.apply(variables, carry, xs)
    scan = scan_cell(SpatioTemporalLSTMCell, 3, feats, kernel_size=3, layer_norm=layer_norm)
    scan.cell.load_state_dict(zoo_state_dict_from_flax(variables))
    got_carry, got_ys = scan(tuple(_t(c) for c in carry), _t(xs))
    assert len(got_ys) == 3 and got_ys[0].shape == (2, 4, 8, 8, feats)
    for got, want in zip(got_carry + got_ys, tuple(want_carry) + tuple(want_ys)):
        _close(got, want, 1e-5)


def test_time_distributed_matches_jax():
    """``TimeDistributed`` and ``time_distributed`` fold T into the batch:
    a (B, T, H, W, C) input through one conv, against the JAX wrapper."""
    import flax.linen as fnn

    from satflow_tpu_torch.nn.conv import Conv

    x = np.random.default_rng(11).normal(size=(2, 3, 6, 5, 4)).astype(np.float32)
    jtd = JaxTimeDistributed(fnn.Conv(7, (3, 3)))
    variables = _randomise(jax.eval_shape(jtd.init, jax.random.PRNGKey(0), x), 12)
    want = jtd.apply(variables, x)
    conv = Conv(4, 7, 3)
    td = TimeDistributed(conv)
    td.load_state_dict(zoo_state_dict_from_flax(variables))
    _close(td(_t(x)), want, 1e-5)
    _close(time_distributed(conv, _t(x)), want, 1e-5)


@pytest.mark.parametrize("arm", ["unet", "pixelcnn"])
def test_accuracy_gate_stacked_arms_run(arm, monkeypatch, tmp_path):
    """The accuracy gate's channels-stacked arms (the JAX tool's recipe: 4
    frames x 2 channels stacked, 12 lead times x 2 channels out) train and
    score on the CPU, at 1 epoch on 16² batches of 2: the curves' length,
    finite values, the recipe's epochs recorded."""
    from satflow_tpu_torch.tools import accuracy_gate

    epochs, lr, kw = accuracy_gate.STACKED_ARMS[arm]
    monkeypatch.setitem(accuracy_gate.STACKED_ARMS, arm, (1, lr, kw))
    monkeypatch.setattr(accuracy_gate, "DS_KW", {**accuracy_gate.DS_KW, "batch_size": 2,
                                                 "width": 16, "height": 16})
    monkeypatch.chdir(tmp_path)
    row = accuracy_gate.main([arm], device="cpu")[arm]
    assert len(row["mse_t"]) == len(row["ms_ssim_t"]) == accuracy_gate.STEPS
    assert np.isfinite(row["mse"]) and np.isfinite(row["ms_ssim"]) and row["epochs"] == 1
