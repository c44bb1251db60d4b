"""PyTorch port, MetNet slice: the gate tail (K3's op), the axial attention
(K4's op), the cell, the attention block, the downsampler, the whole
``MetNetCore`` and ``LitMetNet``'s batch preparation, gradients and Adam step
under ``warmup_cosine``, against the JAX package on the same weights.

Weights and inputs come from numpy seeds and go to both packages; flax
variables reach the port through ``metnet_state_dict_from_flax``. On the CPU
the JAX functions run their XLA references (``use_pallas=False``, as the
JAX package's own CPU tests run them) and the port its plain versions.
Temporal dropout is 0 in every parity test (the two packages draw different
random numbers); its mask is tested on its own.

Tolerances (each test says which it uses):
- float32 ops (gate tail, attention and their gradients, cell, block):
  atol 1e-5; the same f32 arithmetic in another order.
- float32 model (downsampler, ``MetNetCore``): atol 1e-4, as asked of the
  port; f32 convs over up to 9 x 256 products per output, four deep.
- bfloat16 ``MetNetCore``: atol 5e-2 x max|y|. Both sides round every conv,
  norm and Dense output to bf16 (step 2^-8 relative) at different points:
  the port's gate tail and attention keep f32 inside, the JAX references
  compute the gate tail in bf16.
- gradients of one train step, float32: atol 1e-4 x max|grad| per tensor
  (sums over the batch in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from satflow_tpu.core import registry as jax_registry
from satflow_tpu.models.metnet import _Downsampler as JaxDownsampler
from satflow_tpu.nn.attention import AxialAttentionBlock as JaxBlock
from satflow_tpu.nn.recurrent import ConvLSTMCell as JaxCell
from satflow_tpu.ops.pallas.axial_attention import axial_attention as jax_attention
from satflow_tpu.ops.pallas.fused_lstm import fused_lstm_gates as jax_gates
from satflow_tpu.train.schedules import warmup_cosine as jax_warmup_cosine
import satflow_tpu.models  # noqa: F401 - populate the JAX registry
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.core import registry
from satflow_tpu_torch.interop.jax_weights import metnet_state_dict_from_flax
from satflow_tpu_torch.models.metnet import LitMetNet, _Downsampler
from satflow_tpu_torch.nn.attention import AxialAttentionBlock
from satflow_tpu_torch.nn.misc import crop_center, space_to_depth
from satflow_tpu_torch.nn.recurrent import ConvLSTMCell
from satflow_tpu_torch.ops import axial_attention as A
from satflow_tpu_torch.ops import fused_lstm as G
from satflow_tpu_torch.train import TrainState
from satflow_tpu_torch.train.schedules import scheduled, warmup_cosine
from satflow_tpu_torch.train.steps import make_train_step

B, T, H, W, C, F, HID, COUT = 2, 3, 64, 64, 3, 2, 16, 2
KW = dict(forecast_steps=F, hidden_dim=HID, output_channels=COUT, temporal_dropout=0.0)


def _randomise(tree, seed):
    """Random flax leaves of the tree's shapes: kernels normal / sqrt(fan_in),
    scales near 1, running variances in [0.5, 1.5], the rest small."""
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


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a, dtype=np.float32))
    return t if dtype is None else t.to(dtype)


def _load(module, variables):
    module.load_state_dict(metnet_state_dict_from_flax(variables))
    return module


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(1).random((B, T, H, W, C)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_variables(x):
    model = jax_registry.create_model("litmetnet", **KW)
    return _randomise(model.module.init(jax.random.PRNGKey(0), x), seed=0)


def _port(variables, **kw):
    model = registry.create_model("litmetnet", **{**KW, **kw})
    _load(model.module, variables)
    return model.eval()


# -- the gate tail (K3's op) ------------------------------------------------


@pytest.mark.parametrize("shape, ch", [((7, 5), 3), ((2, 4, 4), 64), ((1,), 1)])
def test_gate_tail_matches_jax(shape, ch):
    """f32 forward and VJP of the port's gate tail against ``fused_lstm_gates
    (use_pallas=False)``, odd widths included; atol 1e-5."""
    rng = np.random.default_rng(ch)
    gates = rng.normal(size=shape + (4 * ch,)).astype(np.float32) * 2
    c = rng.normal(size=shape + (ch,)).astype(np.float32)
    dh, dc = (rng.normal(size=shape + (ch,)).astype(np.float32) for _ in range(2))
    (h_j, c_j), vjp = jax.vjp(lambda g, c: jax_gates(g, c, False), gates, c)
    dg_j, dcp_j = vjp((dh, dc))

    g_t, c_t = _t(gates).requires_grad_(), _t(c).requires_grad_()
    h_t, cn_t = G.fused_lstm_gates(g_t, c_t)
    assert h_t.grad_fn is not None and type(h_t.grad_fn).__name__ == "FusedLSTMGatesBackward"
    ((h_t * _t(dh)).sum() + (cn_t * _t(dc)).sum()).backward()
    for got, want in ((h_t, h_j), (cn_t, c_j), (g_t.grad, dg_j), (c_t.grad, dcp_j)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


def test_gate_tail_bf16_stores_in_c_dtype():
    """bf16 in, bf16 out; f32 math inside: within one bf16 step (2^-8
    relative) of the f32 result, and the backward's grads in bf16."""
    rng = np.random.default_rng(3)
    gates, c = _t(rng.normal(size=(9, 20))), _t(rng.normal(size=(9, 5)))
    h32, c32 = G.fused_lstm_gates_ref(gates, c)
    h16, c16 = G.fused_lstm_gates(gates.bfloat16(), c.bfloat16())
    assert h16.dtype == c16.dtype == torch.bfloat16
    torch.testing.assert_close(h16.float(), h32, atol=2e-2, rtol=2 ** -7)
    torch.testing.assert_close(c16.float(), c32, atol=2e-2, rtol=2 ** -7)
    g = gates.bfloat16().requires_grad_()
    h, _ = G.fused_lstm_gates(g, c.bfloat16())
    h.float().sum().backward()
    assert g.grad.dtype == torch.bfloat16


def test_gate_tail_checks_what_the_kernel_takes():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="4x its last dim"):
        G._check(torch.empty(3, 10, **meta), torch.empty(3, 3, **meta))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        G._check(torch.empty(3, 8, dtype=torch.float16, **meta),
                 torch.empty(3, 2, dtype=torch.float16, **meta))
    with pytest.raises(ValueError, match="cpu or cuda"):
        G._check(torch.empty(3, 8, **meta), torch.empty(3, 2, **meta))


# -- the axial attention (K4's op) --------------------------------------------


@pytest.mark.parametrize("n, length, d", [(6, 5, 3), (4, 16, 8), (2, 33, 64)])
def test_attention_matches_jax(n, length, d):
    """f32 forward and the three gradients against ``axial_attention
    (use_pallas=False)``; atol 1e-5."""
    rng = np.random.default_rng(length)
    q, k, v, g = (rng.normal(size=(n, length, d)).astype(np.float32) for _ in range(4))
    out_j, vjp = jax.vjp(lambda q, k, v: jax_attention(q, k, v, False), q, k, v)
    grads_j = vjp(g)
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    out = A.axial_attention(*ts)
    assert type(out.grad_fn).__name__ == "AxialAttentionBackward"
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5)
    for t, want in zip(ts, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=1e-5)


def test_attention_bf16_scales_q_in_its_dtype():
    """bf16: q * d^-0.5 is rounded to bf16 before the f32 product, as in the
    JAX reference; the two agree to one bf16 step of the output."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(3, 7, 8)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), False),
                      np.float32)
    got = A.axial_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2 ** -7)


@pytest.mark.parametrize("shape, kv_len, takes", [
    ((24576, 16, 8), 16, True),     # MetNet's
    ((2048, 128, 64), 128, True),
    ((256, 512, 256), 512, True),   # the caps
    ((1, 1, 1), 1, True),
    ((4, 513, 8), 513, False),      # L > 512
    ((4, 16, 257), 16, False),      # d > 256
    ((4, 16, 8), 12, False),        # k, v of another length
])
def test_kernel_dispatch_rule(shape, kv_len, takes):
    """K4 takes every shape of the JAX dispatcher's domain (the v5e rule L >=
    128 and d >= 64 is not carried over) and nothing outside it."""
    n, length, d = shape
    q = torch.empty(n, length, d, device="meta")
    k = v = torch.empty(n, kv_len, d, device="meta")
    assert A.kernel_takes(q, k, v) is takes
    if not takes:
        with pytest.raises(ValueError, match="outside the kernel's domain"):
            A.attention_kernel(q, k, v)


def test_attention_outside_the_domain_takes_the_plain_version():
    rng = np.random.default_rng(6)
    q = _t(rng.normal(size=(2, 3, 4)))
    k, v = _t(rng.normal(size=(2, 5, 4))), _t(rng.normal(size=(2, 5, 4)))
    torch.testing.assert_close(A.axial_attention(q, k, v), A.axial_attention_ref(q, k, v))


# -- layers -----------------------------------------------------------------


def test_conv_lstm_cell_matches_jax():
    """One step of the fused-gate cell, f32; atol 1e-5."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 6, 4)).astype(np.float32)
    h, c = (rng.normal(size=(2, 5, 6, 8)).astype(np.float32) for _ in range(2))
    cell = JaxCell(8)
    v = _randomise(cell.init(jax.random.PRNGKey(0), (h, c), x), seed=7)
    (h_j, c_j), _ = cell.apply(v, (h, c), x)
    port = _load(ConvLSTMCell(4, 8), v)
    (h_t, c_t), out = port((_t(h), _t(c)), _t(x))
    assert out is h_t
    np.testing.assert_allclose(h_t.detach().numpy(), np.asarray(h_j), atol=1e-5)
    np.testing.assert_allclose(c_t.detach().numpy(), np.asarray(c_j), atol=1e-5)
    zero = ConvLSTMCell.init_carry(2, 5, 6, 8)
    assert len(zero) == 2 and all(t.shape == (2, 5, 6, 8) and not t.any() for t in zero)


def test_axial_attention_block_matches_jax():
    """Pre-LN block over (H, W) of an NHWC tensor, 4 heads, f32; atol 1e-5
    (LayerNorm eps 1e-6 and the tanh gelu, flax's defaults, included)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 5, 7, 16)).astype(np.float32)
    block = JaxBlock(heads=4, axes=(-3, -2))
    v = _randomise(block.init(jax.random.PRNGKey(0), x), seed=8)
    want = np.asarray(block.apply(v, x))
    port = _load(AxialAttentionBlock(16, heads=4, axes=(-3, -2)), v)
    assert port.attn0.pos_emb.shape == (5, 16) and port.attn1.pos_emb.shape == (7, 16)
    np.testing.assert_allclose(port(_t(x)).detach().numpy(), want, atol=1e-5)
    # the same block, its pos_emb lengths taken from a first input instead
    lazy = AxialAttentionBlock(16, heads=4, axes=(-3, -2))
    lazy(_t(x))
    assert lazy.attn0.pos_emb.shape == (5, 16) and lazy.attn1.pos_emb.shape == (7, 16)


def _downsampler_case():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 8, 8, 5)).astype(np.float32)
    ds = JaxDownsampler(HID)
    return ds, x, _randomise(ds.init(jax.random.PRNGKey(0), x), seed=9)


def test_downsampler_eval_matches_jax():
    """BatchNorm with the running statistics (``use_running_average``), f32;
    atol 1e-4."""
    ds, x, v = _downsampler_case()
    want = np.asarray(ds.apply(v, x, False))
    port = _load(_Downsampler(), v).eval()
    np.testing.assert_allclose(port(_t(x)).detach().numpy(), want, atol=1e-4)


def test_downsampler_train_and_batch_stats_match_jax():
    """Train mode: normalised by the batch statistics, and the running ones
    moved by flax's rule (momentum 0.99, the biased batch variance). A batch
    of 3 x 4 x 4 pixels per BN0 channel, where biased and unbiased variances
    differ by 1/47; f32, atol 1e-4 on the output, 1e-6 on the statistics."""
    ds, x, v = _downsampler_case()
    want, new_vars = ds.apply(v, x, True, mutable=["batch_stats"])
    port = _load(_Downsampler(), v).train()
    got = port(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    stats = new_vars["batch_stats"]
    for bn in ("bn0", "bn1"):
        for name in ("mean", "var"):
            np.testing.assert_allclose(getattr(getattr(port, bn), name).numpy(),
                                       np.asarray(stats[bn][name]), atol=1e-6,
                                       err_msg=f"{bn}.{name}")


# -- the model --------------------------------------------------------------


def test_core_matches_jax_f32(jax_variables, x):
    """``MetNetCore`` forward, f32, eval: atol 1e-4."""
    model = jax_registry.create_model("litmetnet", **KW)
    want = np.asarray(model.module.apply(jax_variables, x, train=False))
    got = _port(jax_variables)(torch.from_numpy(x))
    assert got.shape == want.shape == (B, F, H // 16, W // 16, COUT)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4)


def test_core_matches_jax_bf16(jax_variables, x):
    """bf16 compute on f32 weights (the JAX model's ``dtype``): atol 5e-2 x
    max|y|. The head has no dtype in the JAX model, so both return f32."""
    model = jax_registry.create_model("litmetnet", dtype=jnp.bfloat16, **KW)
    want = np.asarray(model.module.apply(jax_variables, x, train=False))
    got = _port(jax_variables, dtype=torch.bfloat16)(torch.from_numpy(x))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=5e-2 * np.abs(want).max())


def _fake_batch(seed=2, nwp_hw=(3, 5)):
    """A batch of the fake datamodule's schema, its NWP grid 3x5 so that the
    resize to 64x64 has no integer factor."""
    rng = np.random.default_rng(seed)
    x = {"sat_data": rng.random((B, T, H, W, C), dtype=np.float32),
         "topo_data": rng.random((B, H, W), dtype=np.float32),
         "nwp": rng.random((B, 4, T, *nwp_hw), dtype=np.float32)}
    y = {"sat_data": rng.random((B, F, H, W, C), dtype=np.float32)}
    return x, y


def test_prepare_batch_matches_jax():
    """Satellite + topography over T + NWP by nearest (half-pixel centres)
    to the satellite grid; the target cropped to the center 1/4 and pooled
    4x; exact."""
    batch = _fake_batch()
    xj, yj = jax_registry.create_model("litmetnet", **KW).prepare_batch(batch)
    xt, yt = registry.create_model("litmetnet", **KW).prepare_batch(batch)
    assert xt.shape == (B, T, H, W, C + 1 + 4) and yt.shape == (B, F, H // 16, W // 16, COUT)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-6)


def test_hparams_match_jax():
    """The same serializable hyperparameters as the JAX model, the config's
    ignored ones (``image_encoder``, ``num_layers``, ``head``) left out alike."""
    kw = dict(KW, image_encoder="downsampler", num_layers=1, head="identity", input_size=64)
    want = jax_registry.create_model("litmetnet", **kw).hparams()
    assert registry.create_model("litmetnet", **kw).hparams() == want
    assert "image_encoder" not in want and want["input_size"] == 64


def test_misc_matches_jax():
    from satflow_tpu.nn.misc import crop_center as jcrop, space_to_depth as js2d

    a = np.arange(2 * 3 * 8 * 12 * 5, dtype=np.float32).reshape(2, 3, 8, 12, 5)
    np.testing.assert_array_equal(space_to_depth(_t(a)).numpy(), np.asarray(js2d(a)))
    np.testing.assert_array_equal(space_to_depth(_t(a[0]), 4).numpy(), np.asarray(js2d(a[0], 4)))
    np.testing.assert_array_equal(crop_center(_t(a), 3, 5).numpy(), np.asarray(jcrop(a, 3, 5)))


# Parameters whose gradient is zero in exact arithmetic: c0's bias is a
# per-channel shift that the max-pool passes on and the train-mode BatchNorm
# after it removes; a key bias adds the same q.b to every score of a row,
# which the softmax removes.
ZERO_GRAD = ("image_encoder.c0.bias", "axial0.attn0.k.bias", "axial0.attn1.k.bias")


def test_train_step_grads_and_batch_stats_match_jax(jax_variables):
    """One train-mode loss on a prepared fake batch: every parameter's
    gradient against ``jax.grad`` (atol 1e-4 x max|grad|) and the updated
    running statistics against flax's (atol 1e-6)."""
    batch = _fake_batch(seed=3)
    jmodel = jax_registry.create_model("litmetnet", **KW)
    x, _ = jmodel.prepare_batch(batch)
    variables = _randomise(jmodel.module.init(jax.random.PRNGKey(0), x), seed=4)
    params, state = jmodel.split_variables(variables)
    (_, (_, new_state)), grads = jax.value_and_grad(
        lambda p: jmodel.loss(p, state, batch, jax.random.PRNGKey(0)), has_aux=True)(params)
    want = metnet_state_dict_from_flax({"params": grads})

    model = _port(variables).train()
    loss, _ = model.loss(batch)
    loss.backward()
    got = {n: p.grad for n, p in model.module.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        if name in ZERO_GRAD:  # rounding noise on both sides, against the layer's weight grad
            scale = np.abs(want[name.replace(".bias", ".weight")].numpy()).max()
            assert np.abs(w).max() <= 1e-4 * scale and g.abs().max() <= 1e-4 * scale, name
            continue
        assert g.abs().sum() > 0, name
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), err_msg=name)
    stats = metnet_state_dict_from_flax({"params": {}, **new_state})
    for name, s in stats.items():
        np.testing.assert_allclose(model.module.get_buffer(name).numpy(), s.numpy(), atol=1e-6,
                                   err_msg=name)


def test_warmup_cosine_matches_optax():
    """The schedule at counts across warmup, decay and past its end; rtol
    1e-6 and atol two f32 steps at the peak rate (optax evaluates in f32, so
    its 1e-8 start carries the rounding of 1e-3)."""
    mine, ref = warmup_cosine(1e-3, 10, 100), jax_warmup_cosine(1e-3, 10, 100)
    for count in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(mine(count), float(ref(count)), rtol=1e-6,
                                   atol=2 * 1e-3 * 2 ** -24, err_msg=count)


def test_scheduled_sets_lr_before_each_update():
    p = torch.nn.Parameter(torch.zeros(2))
    opt = scheduled(torch.optim.SGD([p], lr=0.0), lambda n: 0.1 * (n + 1))
    for n in range(3):
        p.grad = torch.ones(2)
        opt.step()
        assert opt.param_groups[0]["lr"] == pytest.approx(0.1 * (n + 1))
    torch.testing.assert_close(p.detach(), torch.full((2,), -0.6))


def test_adam_step_under_warmup_cosine_matches_optax():
    """Three Adam updates under ``LitMetNet.make_optimizer``'s schedule
    (warmup 2, total 10) against ``optax.adam(warmup_cosine(...))`` on the
    same gradients; atol 1e-7 (f32 parameters of size ~1)."""
    rng = np.random.default_rng(10)
    init = rng.normal(size=(4, 3)).astype(np.float32)
    model = LitMetNet(lr=1e-2, warmup_steps=2, total_steps=10, **KW)
    tx = optax.adam(jax_warmup_cosine(1e-2, 2, 10))
    jp, opt_state = init, tx.init(init)
    p = torch.nn.Parameter(torch.from_numpy(init.copy()))
    model.parameters = lambda: iter([p])  # the schedule wraps whatever Adam holds
    state = TrainState(torch.nn.ParameterDict({"p": p}), model.make_optimizer())
    for i in range(3):
        g = rng.normal(size=init.shape).astype(np.float32)
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        p.grad = torch.from_numpy(g)
        state.apply_gradients()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), atol=1e-7,
                                   err_msg=f"update {i}")


def test_train_step_moves_the_weights_under_the_schedule():
    """A fresh LitMetNet takes its input width (4 x 8 channels + F one-hot)
    and attention lengths from a first batch (``materialize``, which moves
    no running statistic); then the port's train step gives finite metrics
    at the schedule's rate for count 0 and moves the weights."""
    model = registry.create_model("litmetnet", warmup_steps=5, total_steps=50,
                                  generator=torch.Generator().manual_seed(0), **KW)
    batch = _fake_batch(seed=5)
    model.materialize(batch)
    core = model.module
    assert core.image_encoder.c0.weight.shape == (160, 4 * (C + 1 + 4) + F, 3, 3)
    assert core.axial0.attn0.pos_emb.shape == (H // 16, HID)
    assert not core.image_encoder.bn0.mean.any() and model.training
    state = TrainState(model, model.make_optimizer())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = make_train_step(model)(state, batch)
    assert bool(metrics["finite"]) and metrics["frame_loss"].shape == (F,)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(model.lr_schedule(0))
    assert any(not torch.equal(p, before[n]) for n, p in model.named_parameters())


def test_temporal_dropout_mask_statistics():
    """Training draws keep ~ bernoulli(1 - p) per (B, T) frame from the
    model's generator and scales kept frames by 1 / (1 - p); eval draws
    nothing. Over 4000 frames the keep rate is within 3 sigma of 0.8, and the
    same seed gives the same mask."""
    from satflow_tpu_torch.models.metnet import MetNetCore

    core = MetNetCore(forecast_steps=1, out_channels=1, hidden_dim=8, temporal_dropout=0.2,
                      generator=torch.Generator().manual_seed(0)).train()
    x = torch.ones(400, 10, 2, 2, 3)
    core.generator.manual_seed(1)
    out = core._temporal_dropout(x)
    per_frame = out.amax(dim=(2, 3, 4))
    torch.testing.assert_close(out, per_frame[..., None, None, None].expand_as(out))
    assert set(per_frame.unique().tolist()) <= {0.0, 1.0 / 0.8}
    keep = (per_frame > 0).float().mean().item()
    assert abs(keep - 0.8) < 3 * (0.8 * 0.2 / 4000) ** 0.5
    core.generator.manual_seed(1)
    torch.testing.assert_close(core._temporal_dropout(x), out)
    assert core.eval()._temporal_dropout(x) is x
