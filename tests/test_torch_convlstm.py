"""PyTorch port, ConvLSTM slice: the cell, the whole ``EncoderDecoderConvLSTM``
forward and the weight bridge against the JAX package on the same weights.

Weights and inputs come from numpy seeds and go to both packages. On the CPU
the JAX model runs its fused cells through their XLA reference step (the
Pallas kernel is TPU-only outside interpret mode), and the port its plain step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satflow_tpu.core import registry as jax_registry
from satflow_tpu.nn.recurrent import FusedConvLSTMCell as JaxCell
import satflow_tpu.models  # noqa: F401 - populate the JAX registry
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.core import registry
from satflow_tpu_torch.interop.jax_weights import (
    flatten_tree,
    load_npz,
    params_from_flax,
    save_npz,
)
from satflow_tpu_torch.models.conv_lstm import ConvLSTMCore
from satflow_tpu_torch.nn.recurrent import FusedConvLSTMCell

B, T, H, W, CIN, HID, COUT, STEPS = 2, 3, 16, 16, 4, 8, 3, 3
KW = dict(input_channels=CIN, out_channels=COUT, forecast_steps=STEPS, hidden_dim=HID)
# float32: both sides run the same f32 convs and gate math in another order
# over 6 recurrent steps; measured max |diff| ~2.4e-7.
ATOL_F32 = 1e-5
# bfloat16: both round convs, states and the head to bf16 (step 2^-8
# relative) at different points; sigmoid outputs lie in [0, 1]; measured ~6e-3.
ATOL_BF16 = 2e-2


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.3).astype(np.float32), tree)


@pytest.fixture(scope="module")
def jax_model_and_params():
    model = jax_registry.create_model("encoderdecoderconvlstm", **KW)
    variables = model.module.init(jax.random.PRNGKey(0), np.zeros((1, T, H, W, CIN), np.float32))
    return model, _random_like(variables, seed=0)


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(1).random((B, T, H, W, CIN)).astype(np.float32)


def _port(params, dtype=None):
    model = registry.create_model("encoderdecoderconvlstm", dtype=dtype, **KW)
    model.module.load_state_dict(params_from_flax(params))
    return model.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cell_matches_jax(dtype):
    cx, ch = 4, 8
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, H, W, cx)).astype(np.float32)
    h = rng.normal(size=(B, H, W, ch)).astype(np.float32)
    c = rng.normal(size=(B, H, W, ch)).astype(np.float32)
    jcell = JaxCell(ch, dtype=getattr(jnp, dtype))
    params = _random_like(jcell.init(jax.random.PRNGKey(0), (h, c), x), seed=3)
    (h_j, c_j), _ = jcell.apply(params, (h, c), x)
    cell = FusedConvLSTMCell(cx, ch, dtype=getattr(torch, dtype))
    cell.load_state_dict({k: torch.from_numpy(v) for k, v in params["params"].items()})
    with torch.inference_mode():
        (h_t, c_t), out = cell((torch.from_numpy(h), torch.from_numpy(c)), torch.from_numpy(x))
    assert out is h_t and h_t.dtype == getattr(torch, dtype)
    atol = ATOL_F32 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(h_t.float().numpy(), np.asarray(h_j, np.float32), atol=atol)
    np.testing.assert_allclose(c_t.float().numpy(), np.asarray(c_j, np.float32), atol=atol)


@pytest.mark.parametrize("dtype, atol", [("float32", ATOL_F32), ("bfloat16", ATOL_BF16)])
def test_forward_matches_jax(jax_model_and_params, x, dtype, atol):
    jmodel, params = jax_model_and_params
    if dtype == "bfloat16":
        jmodel = jax_registry.create_model("encoderdecoderconvlstm", dtype=jnp.bfloat16, **KW)
    y_j = np.asarray(jmodel.forward(params, x).astype(jnp.float32))
    with torch.inference_mode():
        y_t = _port(params, getattr(torch, dtype))(torch.from_numpy(x))
    assert y_t.shape == (B, STEPS, H, W, COUT) and y_t.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(y_t.float().numpy(), y_j, atol=atol)


def test_forecast_steps_override(jax_model_and_params, x):
    jmodel, params = jax_model_and_params
    y_j = np.asarray(jmodel.module.apply(params, x, forecast_steps=5))
    with torch.inference_mode():
        y_t = _port(params).module(torch.from_numpy(x), forecast_steps=5).numpy()
    assert y_t.shape == (B, 5, H, W, COUT)
    np.testing.assert_allclose(y_t, y_j, atol=ATOL_F32)


def test_npz_round_trip(jax_model_and_params, tmp_path):
    _, params = jax_model_and_params
    path = tmp_path / "params.npz"
    save_npz(path, params)
    assert set(np.load(path).files) == set(flatten_tree(params["params"]))
    want, got = params_from_flax(params), load_npz(path)
    assert list(got) == list(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


@pytest.mark.parametrize("layout", [dict(remat_chunk=3), dict(head_in_scan=False)],
                         ids=["chunked_steps", "top_level_head"])
def test_bridge_normalises_jax_nesting(layout):
    """``encoder/steps/…``, ``decoder/steps/…`` and a top-level head map to
    the same state_dict as the flat tree the JAX ``adapt_restored_params``
    of the default model makes of them."""
    model = jax_registry.create_model("encoderdecoderconvlstm", **KW, **layout)
    tree = model.module.init(jax.random.PRNGKey(0), np.zeros((1, T, H, W, CIN), np.float32))
    tree = _random_like(tree, seed=4)
    default = jax_registry.create_model("encoderdecoderconvlstm", **KW)
    flat = default.adapt_restored_params(dict(tree["params"]))
    assert "steps" not in flat["decoder"] and "head" in flat["decoder"]
    got, want = params_from_flax(tree), params_from_flax({"params": flat})
    assert list(got) == list(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    kernel = np.asarray(flat["decoder"]["head"]["kernel"])  # HWIO -> OIHW
    torch.testing.assert_close(got["decoder.head.weight"],
                               torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))


def test_bridge_rejects_unknown_params(jax_model_and_params):
    _, params = jax_model_and_params
    bad = {"params": {**params["params"], "extra": {"kernel": np.zeros(3)}}}
    with pytest.raises(KeyError, match="extra"):
        params_from_flax(bad)


def test_hparams_match_jax():
    jmodel = jax_registry.create_model("encoderdecoderconvlstm", **KW)
    assert registry.create_model("encoderdecoderconvlstm", **KW).hparams() == jmodel.hparams()


def test_registries_are_separate():
    assert registry.list_models() == ["encoderdecoderconvlstm", "litmetnet"]
    for name in registry.list_models():
        assert registry.get_model(name) is not jax_registry.get_model(name)
    for source in ("local:/ckpt", "torch:/m.ckpt", "hf_hub:org/repo"):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
            registry.create_model(source)


@pytest.mark.parametrize("kwargs", [dict(cell_impl="split"), dict(cell_impl="cmajor"),
                                    dict(conv_type="coord")])
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError):
        ConvLSTMCore(**kwargs)


def test_prepare_batch_slices_target_channels():
    model = registry.create_model("encoderdecoderconvlstm", **KW)
    x, y = model.prepare_batch(({"sat_data": torch.zeros(1, T, H, W, CIN)},
                                {"sat_data": torch.zeros(1, STEPS, H, W, 12)}))
    assert x.shape[-1] == CIN and y.shape[-1] == COUT


def test_init_from_an_explicit_generator():
    """Initialization draws only from the generator it is given."""
    def make(seed):
        return registry.create_model("encoderdecoderconvlstm", generator=torch.Generator().manual_seed(seed), **KW)

    a, b, c = make(7).state_dict(), make(7).state_dict(), make(8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["module.encoder.encoder_1.x_gates_kernel"],
                           c["module.encoder.encoder_1.x_gates_kernel"])
    std = a["module.decoder.decoder_1.h_gates_kernel"].std().item()
    assert abs(std - (9 * HID) ** -0.5) < 0.2 * (9 * HID) ** -0.5  # lecun-normal scale


def test_spatial_sharding_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 13"):
        registry.create_model("encoderdecoderconvlstm", **KW).enable_spatial(mesh=None)
