"""PyTorch port, the Perceiver family: its layers and its five configs
against the JAX package on the same weights.

Weights come from ``jax.eval_shape`` of the flax ``init`` (the tree's names
and shapes; nothing compiles), filled from numpy seeds, and reach the port
through ``perceiver_state_dict_from_flax`` (a rename, with the Dense and
conv kernels in torch's layouts). Inputs are numpy-seeded. Nothing here has a
kernel: the attention is matmul and softmax on both sides.

Tolerances (each test says which it uses):
- Fourier features, space-to-depth and its inverse, the pixel pre- and
  post-processors: f32 atol 1e-6 (the same f32 ops; the inverse and the
  subsample are exact);
- a layer or block in float32: atol 1e-5 x max|ref| (the same products,
  summed in another order);
- a whole model in float32: atol 1e-5 x max|ref| (measured 2e-6);
- a whole model in bfloat16 compute on the same f32 weights: atol 3e-2 x
  max|ref| (each matmul's output rounds to bf16, 2^-8 relative, through a
  few layers; the port takes its softmax in f32, JAX in bf16);
- every parameter's gradient in float32, remat on and off: atol 1e-4 x
  max|grad| of that tensor (gradients sum over the batch, the tokens and
  the lead steps in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satflow_tpu.core import registry as jax_registry
from satflow_tpu.data.fake import FakeDataset
from satflow_tpu.nn import misc as jax_misc
from satflow_tpu.nn import perceiver as jp
import satflow_tpu.models  # noqa: F401 - populate the JAX registry
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.core import registry
from satflow_tpu_torch.interop.jax_weights import perceiver_state_dict_from_flax
from satflow_tpu_torch.nn import misc
from satflow_tpu_torch.nn import perceiver as tp

SMALL = dict(forecast_steps=2, depth=1, num_latents=8, latent_dim=16, dim=8, queries_dim=8,
             latent_dim_heads=8, cross_dim_heads=4, num_freq_bands=4, history_steps=3)
# the five shipped configs shrunk as tests/test_models.py shrinks perceiver.yaml:
# (registry name, keywords, image size, satellite channels). perceiver_encoder
# runs its one shared conv preprocessor over the satellite and the topography,
# so both packages build it only where the two have one width (1 channel);
# test_encoder_config_with_12_channels_raises_in_both holds the shipped width.
CONFIGS = {
    "perceiver": ("perceiver", dict(SMALL, input_size=8), 8, 3),
    "perceiver_encoder": ("perceiver", dict(SMALL, input_size=4, preprocessor_type="conv",
                                            postprocessor_type="conv"), 16, 1),
    "perceiver_metnet": ("perceiver", dict(SMALL, input_size=8, preprocessor_type="metnet"),
                         8, 3),
    "perceiver_single": ("perceiver", dict(SMALL, input_size=8, predict_timesteps_together=True,
                                           temporally_consistent_fourier_features=True), 8, 3),
    "hf_perceiver": ("huggingfaceperceiver", dict(SMALL, train_size=8), 8, 3),
}


def _randomise(tree, seed):
    """Random flax leaves of the tree's shapes: kernels normal / sqrt(fan_in),
    LayerNorm scales near 1, the rest (biases, latents, embeddings, the query
    grid) normal x 0.3."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        shape = tuple(a.shape)
        if name.endswith("['kernel']"):
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith("['scale']"):
            v = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            v = 0.3 * rng.normal(size=shape)
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


def _init(module, *args, seed=0):
    """numpy-seeded variables of a flax module's tree, and the port's state
    dict of them."""
    variables = _randomise(jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args)),
                           seed)
    return variables, perceiver_state_dict_from_flax(variables)


def _load(module, state_dict, *args):
    """The port's ``module`` with ``state_dict`` loaded (every flax leaf
    used), then run on ``args``."""
    result = module.load_state_dict(state_dict)
    assert not result.missing_keys and not result.unexpected_keys, result
    with torch.no_grad():
        return module(*args)


# -- the helpers --------------------------------------------------------------


@pytest.mark.parametrize("dims, bands, sine_only", [((5,), 3, False), ((4, 6), 4, True),
                                                    ((3, 4, 5), 2, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fourier_features_and_encode_position_match_jax(dims, bands, sine_only, dtype):
    """``fourier_features`` ([sin, cos] per axis, then the coordinate) in f32
    and in bf16, and ``encode_position`` (f32, batched): f32 atol 1e-6; bf16
    atol 2^-4, one bf16 step of the largest angle (3π: XLA fuses the angle's
    two products and rounds where the port's op-by-op bf16 does not, so an
    angle may sit one step apart, and its sine with it; the coordinates
    within 1e-6, and in bf16 within one step, 2^-7)."""
    want = jp.fourier_features(dims, bands, 6.0, sine_only, dtype=getattr(jnp, dtype))
    got = tp.fourier_features(dims, bands, 6.0, sine_only, dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(got, np.asarray(want, np.float32), 1e-6 if dtype == "float32" else 2.0 ** -4)
    _close(got[:, -len(dims):], np.asarray(want, np.float32)[:, -len(dims):],
           1e-6 if dtype == "float32" else 2.0 ** -7)
    _close(tp.encode_position(2, dims, bands, 6.0, sine_only),
           jp.encode_position(2, dims, bands, 6.0, sine_only), 1e-6)
    mod = tp.InputModality("m", 1, len(dims), bands, 6.0, sine_only)
    assert mod.fourier_dim == jp.InputModality("m", 1, len(dims), bands, 6.0,
                                               sine_only).fourier_dim == got.shape[-1]


@pytest.mark.parametrize("shape", [(2, 3, 4, 8), (2, 3, 2, 4, 8)])
def test_reverse_space_to_depth_matches_jax(shape):
    """``b [t] h w (dh dw c) -> b [t] (h dh) (w dw) c``, 4-D and 5-D, exact,
    and the inverse of ``space_to_depth``."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = misc.reverse_space_to_depth(_t(x), 2)
    _close(got, jax_misc.reverse_space_to_depth(jnp.asarray(x), 2), 0)
    torch.testing.assert_close(misc.space_to_depth(got, 2), _t(x), rtol=0, atol=0)
    with pytest.raises(ValueError):
        misc.reverse_space_to_depth(torch.zeros(2, 3, 4), 2)


# -- the layers -----------------------------------------------------------------


@pytest.mark.parametrize("prep", tp.ImageEncoder.PREP_TYPES)
@pytest.mark.parametrize("video", [False, True], ids=["image", "video"])
def test_image_encoder_matches_jax(prep, video):
    """Every prep type on 4-D and 5-D input (4 frames: ``metnet`` pairs
    them) at 18 x 14 pixels, a multiple of no stride (``conv``'s SAME pads):
    atol 1e-5 x max|ref|."""
    shape = (2, 4, 18, 14, 3) if video else (2, 18, 14, 3)
    if prep in ("patches", "metnet"):
        shape = shape[:-3] + (16, 16, 3)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jmod = jp.ImageEncoder(prep_type=prep, output_channels=5)
    variables, sd = _init(jmod, x)
    got = _load(tp.ImageEncoder(prep_type=prep, output_channels=5), sd, _t(x))
    _close(got, jmod.apply(variables, x), 1e-5, prep)


@pytest.mark.parametrize("post", tp.ImageDecoder.POSTPROCESS_TYPES)
@pytest.mark.parametrize("video", [False, True], ids=["image", "video"])
def test_image_decoder_matches_jax(post, video):
    """Every postprocess type on 4-D and 5-D input at 5 x 7 pixels (a
    multiple of no tile): ``conv`` is flax's unflipped SAME ConvTranspose
    against the flipped ``conv_transpose2d``; atol 1e-5 x max|ref|."""
    c = 16 if post == "patches" else 3
    shape = (2, 2, 5, 7, c) if video else (2, 5, 7, c)
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jmod = jp.ImageDecoder(postprocess_type=post, output_channels=3)
    variables, sd = _init(jmod, x)
    got = _load(tp.ImageDecoder(postprocess_type=post, output_channels=3), sd, _t(x))
    _close(got, jmod.apply(variables, x), 1e-5, post)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_mhattention_matches_jax(qkv_bias):
    """Queries (2, 5, 12) over a context (2, 9, 7), 3 heads of 4, with and
    without q/k/v biases: the DenseGeneral leaves as they are; atol 1e-5 x
    max|ref|."""
    rng = np.random.default_rng(3)
    q, kv = (rng.standard_normal(s).astype(np.float32) for s in ((2, 5, 12), (2, 9, 7)))
    jmod = jp.MHAttention(heads=3, dim_head=4, qkv_bias=qkv_bias)
    variables, sd = _init(jmod, q, kv)
    assert variables["params"]["to_q"]["kernel"].shape == (12, 3, 4)
    assert variables["params"]["to_out"]["kernel"].shape == (3, 4, 12)
    assert ("bias" in variables["params"]["to_k"]) == qkv_bias
    got = _load(tp.MHAttention(12, 7, heads=3, dim_head=4, qkv_bias=qkv_bias), sd, _t(q), _t(kv))
    _close(got, jmod.apply(variables, q, kv), 1e-5)


@pytest.mark.parametrize("block", ["cross", "cross_no_residual", "cross_no_ff", "self"])
def test_attention_blocks_match_jax(block):
    """The cross-attention block (with its query residual, without it as
    HF's flow decoder, without its feed-forward) and the self-attention
    block: LayerNorm eps 1e-6, tanh gelu; atol 1e-5 x max|ref|."""
    rng = np.random.default_rng(4)
    z, ctx = (rng.standard_normal(s).astype(np.float32) for s in ((2, 6, 12), (2, 9, 7)))
    if block == "self":
        jmod, mod, args = (jp.SelfAttentionBlock(heads=2, dim_head=4, qkv_bias=True),
                           tp.SelfAttentionBlock(12, heads=2, dim_head=4, qkv_bias=True), (z,))
    else:
        kw = dict(heads=2, dim_head=4, ff=block != "cross_no_ff",
                  query_residual=block != "cross_no_residual")
        jmod, mod, args = jp.CrossAttentionBlock(**kw), tp.CrossAttentionBlock(12, 7, **kw), \
            (z, ctx)
    variables, sd = _init(jmod, *args)
    _close(_load(mod, sd, *map(_t, args)), jmod.apply(variables, *args), 1e-5, block)


def _core_kwargs(**kw):
    return dict(dim=8, queries_dim=6, logits_dim=5, depth=2, num_latents=7, latent_dim=12,
                cross_heads=2, latent_heads=3, cross_dim_head=4, latent_dim_head=4, **kw)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "weight_tied"])
def test_multi_perceiver_io_matches_jax(tied):
    """``MultiPerceiverIO`` over a video, an image and a series without its
    channel axis; the first modality absent from the inputs, so the others'
    embeddings are rows 1-3 of ``modality_emb`` (the full list's index); no
    ``proj_absent`` leaf on either side; weight-tied and not: atol 1e-5 x
    max|ref|."""
    mods = (("absent", 2, 1, 3), ("video", 3, 3, 2), ("image", 2, 2, 3), ("series", 1, 1, 4))
    jmods = tuple(jp.InputModality(n, c, a, nb, 4.0) for n, c, a, nb in mods)
    rng = np.random.default_rng(5)
    inputs = {"video": rng.standard_normal((2, 3, 4, 5, 3)),
              "image": rng.standard_normal((2, 4, 5, 2)),
              "series": rng.standard_normal((2, 6))}
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    queries = rng.standard_normal((2, 10, 9)).astype(np.float32)
    jmod = jp.MultiPerceiverIO(jmods, weight_tie_layers=tied, **_core_kwargs())
    variables, sd = _init(jmod, inputs, queries)
    assert "proj_absent" not in variables["params"]
    assert ("latent" in variables["params"]) == tied
    mod = tp.MultiPerceiverIO(tuple(tp.InputModality(n, c, a, nb, 4.0) for n, c, a, nb in mods),
                              weight_tie_layers=tied, **_core_kwargs())
    got = _load(mod, sd, {k: _t(v) for k, v in inputs.items()}, _t(queries))
    _close(got, jmod.apply(variables, inputs, queries), 1e-5)
    assert "proj_absent.weight" not in mod.state_dict()
    # the embedding rows follow the full list: a changed row 0 moves nothing
    sd = dict(sd, modality_emb=sd["modality_emb"].clone())
    sd["modality_emb"][0] += 10.0
    torch.testing.assert_close(_load(mod, sd, {k: _t(v) for k, v in inputs.items()},
                                     _t(queries)), got)


@pytest.mark.parametrize("case", ["2d", "3d", "external", "no_fourier"])
def test_learnable_query_matches_jax(case):
    """The query grid in 2-D (3x3 mix) and 3-D (3x3x3 mix), with Fourier
    features supplied from outside (the temporally consistent ones) and
    with none: atol 1e-5 x max|ref|."""
    shape = (3, 4, 5) if case in ("3d", "external") else (4, 5)
    kw = dict(channel_dim=6, query_shape=shape, num_frequency_bands=3,
              generate_fourier_features=case != "no_fourier")
    fourier = None
    if case == "external":
        fourier = np.asarray(jp.encode_position(2, (5, 4, 5), 5, 4.0)).reshape(2, 5, 4, 5, -1)
        fourier = fourier[:, 2:]
    jmod = jp.LearnableQuery(**kw)
    variables, sd = _init(jmod, 2, fourier)
    got = _load(tp.LearnableQuery(**kw), sd, 2, None if fourier is None else _t(fourier))
    _close(got, jmod.apply(variables, 2, fourier), 1e-5, case)


# -- the five configs -----------------------------------------------------------


def _batch(key, seed=0):
    """A fake-data batch (the production key schema) at the config's size:
    4 history frames, 2 lead times."""
    _, _, size, channels = CONFIGS[key]
    ds = FakeDataset(batch_size=2, width=size, height=size, number_sat_channels=channels,
                     history_minutes=15, forecast_minutes=10, length=1, seed=seed)
    return ds[0]


def _models(key, dtype=None):
    name, kw, _, channels = CONFIGS[key]
    kw = dict(kw, input_channels=channels, sat_channels=channels)
    jmodel = jax_registry.create_model(name, **kw, dtype=None if dtype is None
                                       else getattr(jnp, dtype))
    model = registry.create_model(name, **kw, dtype=None if dtype is None
                                  else getattr(torch, dtype),
                                  generator=torch.Generator().manual_seed(0))
    return jmodel, model


@functools.lru_cache(maxsize=None)
def _jax_side(key):
    """The JAX model, numpy-seeded variables of its tree and a batch."""
    batch = _batch(key)
    jmodel, _ = _models(key)
    variables = _randomise(jax.eval_shape(jmodel.init_variables, jax.random.PRNGKey(0), batch),
                           7)
    return jmodel, variables, batch


def _port(key, dtype=None, **overrides):
    """The port's model of ``key`` with the JAX side's weights."""
    _, variables, batch = _jax_side(key)
    name, kw, _, channels = CONFIGS[key]
    model = registry.create_model(name, **dict(kw, input_channels=channels,
                                               sat_channels=channels, **overrides),
                                  dtype=None if dtype is None else getattr(torch, dtype))
    result = model.module.load_state_dict(model.state_dict_from_flax(variables))
    assert not result.missing_keys and not result.unexpected_keys, result
    return model, batch


def _torch_batch(batch):
    x, y = batch
    return ({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in y.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("key", list(CONFIGS))
def test_config_forward_matches_jax(key, dtype):
    """Each config's forward on the same weights and batch: float32 atol
    1e-5 x max|ref|; bfloat16 compute on the f32 weights atol 3e-2 x
    max|ref|, the output in bf16 on both sides."""
    jmodel, variables, batch = _jax_side(key)
    jm, _ = _models(key, dtype if dtype == "bfloat16" else None)
    inputs, _ = jmodel.prepare_batch(batch)
    want = jax.jit(jm.module.apply)(variables, inputs)
    model, batch = _port(key, dtype if dtype == "bfloat16" else None)
    x, _ = model.prepare_batch(_torch_batch(batch))
    with torch.no_grad():
        got = model(x)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert str(want.dtype) == dtype
    _close(got, np.asarray(want, np.float32), 1e-5 if dtype == "float32" else 3e-2, key)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_config_grads_match_jax(key):
    """Every parameter's float32 gradient of the MSE against ``jax.grad``
    of the JAX model's (its per-lead scan under ``nn.remat``), through the
    port with ``remat_steps`` on (``torch.utils.checkpoint`` a lead step)
    and off: atol 1e-4 x max|grad| per tensor; the loss at rtol 1e-5."""
    jmodel, variables, batch = _jax_side(key)
    inputs, y = jmodel.prepare_batch(batch)

    def loss_fn(params):
        return jnp.mean(jnp.square(jmodel.module.apply({"params": params}, inputs) - y))

    jloss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    want = perceiver_state_dict_from_flax({"params": grads})
    for remat in (True, False):
        model, _ = _port(key, remat_steps=remat)
        model.train()
        loss, metrics = model.loss(_torch_batch(batch))
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        assert metrics["frame_loss"].shape == (2,)
        got = dict(model.module.named_parameters())
        assert set(want) == set(got)
        for k, g in want.items():
            assert got[k].grad is not None, (remat, k)
            np.testing.assert_allclose(got[k].grad.numpy(), g.numpy(), rtol=0,
                                       atol=1e-4 * g.abs().max().item(),
                                       err_msg=f"remat={remat} {k}")


def test_encoder_config_with_12_channels_raises_in_both():
    """perceiver_encoder.yaml at its shipped 12 channels: the one conv
    preprocessor is made for the satellite's 12 channels and then meets the
    1-channel topography; flax raises ScopeParamShapeError, the port
    ValueError naming the widths."""
    name, kw, size, _ = CONFIGS["perceiver_encoder"]
    batch = FakeDataset(batch_size=1, width=size, height=size, number_sat_channels=12,
                        history_minutes=15, forecast_minutes=10, length=1)[0]
    jmodel = jax_registry.create_model(name, **kw)
    with pytest.raises(Exception, match="ScopeParamShapeError|expected to generate shape"):
        jmodel.init_variables(jax.random.PRNGKey(0), batch)
    model = registry.create_model(name, **kw)
    with pytest.raises(ValueError, match="made for 12 input channels"):
        model.materialize(_torch_batch(batch))


def test_prepare_batch_with_nwp_and_datetime_matches_jax():
    """``prepare_batch`` with the NWP and datetime modalities: NWP (B, C, T,
    h, w) moved to channels-last, the 3-D topography given its channel axis,
    the missing topographic coordinates zeros, every key and array equal to
    the JAX model's (exact); then the forward with those eight modalities
    more at atol 1e-5 x max|ref|, and a batch without topography (zeros of
    ``base_channels``)."""
    kw = dict(SMALL, input_size=8, input_channels=3, sat_channels=3, nwp_modality=True,
              datetime_modality=True)
    batch = FakeDataset(batch_size=2, width=8, height=8, number_sat_channels=3,
                        history_minutes=15, forecast_minutes=10, length=1)[0]
    jmodel = jax_registry.create_model("perceiver", **kw)
    model = registry.create_model("perceiver", **kw)
    jin, jy = jmodel.prepare_batch(batch)
    tin, ty = model.prepare_batch(_torch_batch(batch))
    assert list(tin) == list(jin)
    for k in jin:
        _close(tin[k], jin[k], 0, k)
    _close(ty, jy, 0)
    assert tin["nwp"].shape == (2, 4, 2, 2, 10) and tin["topo_data"].shape == (2, 8, 8, 1)
    assert not tin["topo_x_coords"].any()
    variables = _randomise(jax.eval_shape(jmodel.module.init, jax.random.PRNGKey(0), jin), 9)
    assert {"proj_nwp", "proj_sat_datetime_index", "proj_hour_of_day_sin"} <= set(
        variables["params"]["steps"]["core"])
    model.module.load_state_dict(model.state_dict_from_flax(variables))
    with torch.no_grad():
        got = model(tin)
    _close(got, jmodel.module.apply(variables, jin), 1e-5)
    x, y = batch
    x = {k: v for k, v in x.items() if k != "topo_data"}
    tin, _ = model.prepare_batch(_torch_batch((x, y)))
    jin, _ = jmodel.prepare_batch((x, y))
    _close(tin["topo_data"], jin["topo_data"], 0)


def test_hparams_and_registry_match_jax():
    """The registered names, all fourteen of the JAX registry, and each
    Perceiver config's hparams equal to the JAX model's (what
    ``hparams.json`` holds)."""
    assert registry.list_models() == sorted(jax_registry.list_models())
    assert len(registry.list_models()) == 14
    assert {"perceiver", "huggingfaceperceiver"} <= set(registry.list_models())
    for key in CONFIGS:
        jmodel, model = _models(key)
        assert model.hparams() == jmodel.hparams(), key
