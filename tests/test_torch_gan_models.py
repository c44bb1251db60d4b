"""PyTorch port, the GAN models: NowcastingGAN (DGMR), CloudGAN (R2U-Net and
ConvLSTM generators, with and without ``condition_time``) and Pix2Pix
against the JAX package on the same weights and noise.

Weights come from numpy seeds in the shapes of the JAX models' variables
(``jax.eval_shape`` of ``init_gan_variables``, so no JAX initialisation is
compiled), with nonzero attention gates, and reach the port through
``gan_state_dict_from_flax``. The port cannot draw JAX's random stream, so
both packages get the same noise: the JAX step runs under
``flax.linen.intercept_methods``, which records the key ``DGMRGenerator``
hands to its latent stack and the generator's output, and the port gets
``z = jax.random.normal(key, shape)``, the stack's own draw; the gradient
penalty's interpolation weights are ``jax.random.uniform`` of the step's key,
as ``gradient_penalty`` draws them, passed to the port as ``alpha``.

Each half of a round is held to JAX in float64 on both sides
(``jax.enable_x64``): a float32 rounding difference can flip a ReLU mask,
and flax's LayerNorm and BatchNorm take the variance as E[x²] - E[x]²,
which loses the digits of a 4-channel sampler LayerNorm in float32. The
loss and metrics at rtol 1e-7 (the BatchNorm variance is taken two
ways), every gradient at atol 1e-8 x max|grad| of
its tensor (1e-5 with the ConvLSTM generator, whose plain step takes its gate
math in float32, for the gradients and the statistics its samples reach) (a bias at its layer's weight gradient's scale where that is
larger: before a train-mode BatchNorm its exact gradient is zero), and the state each half leaves (spectral-norm ``u``, BatchNorm
statistics) at atol 1e-10, trap (a) included: the generator step leaves the
discriminator's state exactly as it was, the discriminator step the
generator's. The DGMR generator's float32 forward on the intercepted noise
at 1e-5 x max|ref|. ``fused`` and ``split`` rounds of the port are equal
bit for bit.
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import satflow_tpu.models  # noqa: F401 - populate the JAX registry
from satflow_tpu.core import registry as jax_registry
from satflow_tpu.models.dgmr import DGMRGenerator as JaxDGMRGenerator
from satflow_tpu.nn.dgmr_blocks import LatentConditioningStack as JaxLatentStack
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.core import registry
from satflow_tpu_torch.interop.jax_weights import (
    flax_tree_state_dict,
    gan_state_dict_from_flax,
)
from satflow_tpu_torch.train.state import GANTrainState
from satflow_tpu_torch.train.steps import make_gan_train_step

DGMR_KW = dict(forecast_steps=2, input_channels=1, output_shape=32, context_channels=64,
               latent_channels=32, disc_channels=4, disc_spatial_layers=2,
               disc_temporal_layers=1, num_samples=2)
GAN_KW = dict(forecast_steps=2, input_channels=2, channels_per_timestep=2, num_filters=4)
# (registry name, constructor keywords, history frames, image size)
CASES = {
    "cloudgan_runet": ("cloudgan", dict(GAN_KW, features_start=4, unet_depth=2,
                                        condition_time=False), 3, 16),
    "cloudgan_convlstm": ("cloudgan", dict(GAN_KW, generator_model="convlstm",
                                           condition_time=True), 3, 16),
    "pix2pix_wgangp": ("pix2pix", dict(GAN_KW, generator_model="resnet_6blocks",
                                       discriminator_model="n_layers",
                                       discriminator_layers=2, loss="wgangp"), 3, 16),
}
GRAD_ATOL = 1e-8
STATE_ATOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are tiny, and a GAN round is
    thousands of small ops, which threads only slow down when the suite runs
    in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
# the ConvLSTM's plain step takes its gate math in float32, as the kernel
# does, whatever the input's dtype: its samples, and what is computed from
# them, carry float32 rounding
F32_GATES_ATOL = 1e-5


def _weights(tree, rs):
    """numpy float64 leaves in the shapes of ``tree`` (ShapeDtypeStructs),
    each a float32 value (the converter's weights are float32): kernels at
    1/sqrt(fan-in), biases and gates small, scales near 1, variances
    positive, spectral vectors N(0, 1)."""
    def leaf(path, s):
        return _leaf(path, s).astype(np.float32).astype(np.float64)

    def _leaf(path, s):
        name = path[-1].key
        shape = tuple(s.shape)
        if name in ("kernel", "embedding", "x_gates_kernel", "h_gates_kernel"):
            return rs.randn(*shape) / math.sqrt(max(1, int(np.prod(shape[:-1]))))
        if name == "var":
            return 1.0 + 0.1 * rs.rand(*shape)
        if name == "scale":
            return 1.0 + 0.1 * rs.randn(*shape)
        if name == "u":
            return rs.randn(*shape)
        if name == "gamma":
            return np.asarray(0.5)
        return 0.1 * rs.randn(*shape)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _batch(rs, b, t, f, size, c):
    return (rs.rand(b, t, size, size, c).astype(np.float32).astype(np.float64),
            rs.rand(b, f, size, size, c).astype(np.float32).astype(np.float64))


def _pair(name, kw, t, size, seed=0):
    """(JAX model, its (g, d) float64 variables, port model in float64 with
    the same weights, float64 batch)."""
    rs = np.random.RandomState(seed)
    jmodel = jax_registry.create_model(name, **kw)
    batch = _batch(rs, 2, t, jmodel.forecast_steps, size, kw["input_channels"])
    g, d = _weights(jax.eval_shape(jmodel.init_gan_variables, jax.random.PRNGKey(0), batch), rs)
    model = registry.create_model(name, **kw)
    model.load_state_dict(gan_state_dict_from_flax(g, d))
    return jmodel, (g, d), model.double(), batch


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_tree(got: dict, want: dict, atol_scale, what, state_atol=STATE_ATOL):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        assert g is not None, (what, k)
        scale = w.abs().max().item() if atol_scale else 1.0
        weight = k[: -len("bias")] + "weight"
        if atol_scale and k.endswith(".bias") and weight in want:
            # a conv bias before a train-mode BatchNorm has a zero gradient in
            # exact arithmetic: rounding noise, held at its weight's scale
            scale = max(scale, want[weight].abs().max().item())
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=0,
                                   atol=(atol_scale or state_atol) * max(scale, 1e-30),
                                   err_msg=f"{what}: {k}")


def _buffers(net):
    return {k: v.clone() for k, v in net.state_dict().items()
            if k not in dict(net.named_parameters())}


def _intercepting(fn):
    """``fn(*args) -> (loss, aux)`` run under an interceptor that records
    the DGMR latent stack's noise and the generator's output into ``aux``'s
    second element."""
    def wrapped(*args):
        rec = {}

        def icpt(next_fun, a, k, ctx):
            out = next_fun(*a, **k)
            if isinstance(ctx.module, JaxLatentStack) and ctx.method_name == "__call__":
                rec["z"] = jax.random.normal(a[0], (a[1], a[2], a[3], ctx.module.shape_channels))
            if isinstance(ctx.module, JaxDGMRGenerator) and ctx.method_name == "__call__":
                rec["y"] = out
            return out

        with fnn.intercept_methods(icpt):
            loss, aux = fn(*args)
        return loss, (aux, rec)

    return wrapped


def _jax_halves(jmodel, g, d, batch, seed=3):
    """The JAX generator and discriminator halves in float64 from the same
    state: ((loss, metrics, new state, grads, record) for G, same for D)."""
    gp, gs = jmodel.split_variables(g)
    dp, ds = jmodel.split_variables(d)
    state = {"g": gs, "d": ds}
    rng_g, rng_d, rng_gp = jax.random.split(jax.random.PRNGKey(seed), 3)
    with jax.enable_x64(True):
        g_fn = _intercepting(lambda p: jmodel.generator_loss(p, dp, state, batch, rng_g))
        (gl, ((gm, gst), grec)), gg = jax.jit(jax.value_and_grad(g_fn, has_aux=True))(gp)
        d_fn = _intercepting(lambda p: jmodel.discriminator_loss(gp, p, state, batch, rng_d,
                                                                 rng_gp))
        (dl, ((dm, dst), drec)), dg = jax.jit(jax.value_and_grad(d_fn, has_aux=True))(dp)
        alpha = jax.random.uniform(rng_gp, (batch[1].shape[0],) + (1,) * 3, dtype=jnp.float64)
    g_half = (gl, gm, gst, gg, grec)
    d_half = (dl, dm, dst, dg, drec)
    return jax.tree_util.tree_map(np.asarray, (g_half, d_half, alpha))


def _check_metrics(got, want, keys):
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k].detach()), np.asarray(want[k]), rtol=1e-7,
                                   atol=1e-12, err_msg=k)


def _check_halves(jmodel, jvars, model, batch, alpha_in_d=False, f32_gates=False):
    """Both halves of one round from the same state, against JAX: losses,
    metrics, gradients, the state each half leaves, trap (a). ``f32_gates``:
    a ConvLSTM generator (gradients and the states its samples reach at
    F32_GATES_ATOL)."""
    grad_atol = F32_GATES_ATOL if f32_gates else GRAD_ATOL
    state_atol = F32_GATES_ATOL if f32_gates else STATE_ATOL
    (gl, gm, gst, gg, grec), (dl, dm, dst, dg, drec), alpha = _jax_halves(jmodel, *jvars, batch)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    tb = (_t(batch[0]), _t(batch[1]))
    noise = {}
    d_before = _buffers(model.disc_module)

    # generator step: the generator in training mode, the discriminator's state frozen
    if "z" in grec:
        noise = dict(z=_t(grec["z"]))
    loss, metrics = model.generator_loss(tb, **noise)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(gl), rtol=1e-7)
    _check_metrics(metrics, gm, [k for k in gm if k in metrics])
    got = {k: p.grad for k, p in model.module.named_parameters()}
    _close_tree(got, flax_tree_state_dict({"params": gg}, np.float64), grad_atol,
                "G grads")
    _close_tree(_buffers(model.module), flax_tree_state_dict(
        gst["g"], np.float64), None, "G state after the G step")
    _close_tree(_buffers(model.disc_module), d_before, None, "D state after the G step")

    # discriminator step from the same start
    model.load_state_dict(start)
    model.zero_grad(set_to_none=True)
    g_before = _buffers(model.module)
    kw = dict(z=_t(drec["z"])) if "z" in drec else {}
    if alpha_in_d:
        kw["alpha"] = _t(alpha)
    loss, metrics = model.discriminator_loss(tb, **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(dl), rtol=1e-7)
    _check_metrics(metrics, dm, dm.keys())
    got = {k: p.grad for k, p in model.disc_module.named_parameters()}
    _close_tree(got, flax_tree_state_dict({"params": dg}, np.float64), grad_atol,
                "D grads")
    assert all(p.grad is None for p in model.module.parameters())
    _close_tree(_buffers(model.disc_module), flax_tree_state_dict(
        dst["d"], np.float64), None, "D state after the D step", state_atol)
    _close_tree(_buffers(model.module), g_before, None, "G state after the D step")
    return grec


@pytest.fixture(scope="module")
def dgmr():
    return _pair("nowcastinggan", DGMR_KW, 4, 32)


def test_dgmr_halves_match_jax(dgmr):
    """DGMR's generator step (two samples a context in training mode, the
    dual discriminator in eval mode; adversarial loss, grid-cell
    regularizer, frame metrics) and discriminator step (one eval-mode
    sample; the four hinge terms) in float64 against JAX: losses, every
    gradient, the samples on the intercepted noise, and the state: the
    generator's ``u`` advances in its own step only, the discriminator's
    twice (real pass, then fake pass) in its step only."""
    jmodel, jvars, model, batch = dgmr
    captured = {}
    def keep_first(module, args, out):
        captured.setdefault("y", out)  # returns None: the output stays as it is

    hook = model.module.register_forward_hook(keep_first)
    try:
        grec = _check_halves(jmodel, jvars, model, batch)
    finally:
        hook.remove()
    # the samples: repeat_interleave order, (B·n, F, H, W, C)
    np.testing.assert_allclose(captured["y"].detach().numpy(), grec["y"], rtol=0,
                               atol=1e-10 * np.abs(grec["y"]).max())
    # the D step moved the discriminator's u away from the start (two passes)
    assert any(k.endswith("sn.u") for k in _buffers(model.disc_module))


def test_dgmr_generator_float32_on_intercepted_noise(dgmr):
    """The generator's float32 sample (eval mode, one draw a context) on the
    key JAX hands to its latent stack: atol 1e-5 x max|ref|."""
    jmodel, (g, _), _, batch = dgmr
    model = registry.create_model("nowcastinggan", **DGMR_KW)
    model.load_state_dict(gan_state_dict_from_flax(g), strict=False)
    x = batch[0].astype(np.float32)
    g32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), g)
    fn = _intercepting(lambda v: (0.0, jmodel._sample(v, x, jax.random.PRNGKey(7), False, 1)))
    _, ((want, _), rec) = jax.jit(fn)(g32)
    got, _ = model._sample(_t(x), None, False, 1, z=_t(rec["z"]))
    assert tuple(got.shape) == (2, 1, 2, 32, 32, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("key", list(CASES))
def test_gan_halves_match_jax(key):
    """CloudGAN (R2U-Net generator and all-timestep discriminator; the
    ConvLSTM generator through the plain step on the CPU and the
    per-timestep discriminator) and Pix2Pix (ResNet generator, PatchGAN,
    WGAN-GP with the interpolation weights JAX draws): each half of a round
    in float64 against JAX, BatchNorm statistics included. With the ConvLSTM
    generator, whose plain step's gate math is float32, the gradients and
    the discriminator's statistics at atol 1e-5 (x max|grad|)."""
    name, kw, t, size = CASES[key]
    jmodel, jvars, model, batch = _pair(name, kw, t, size, seed=1)
    _check_halves(jmodel, jvars, model, batch, alpha_in_d=kw.get("loss") == "wgangp",
                  f32_gates=key == "cloudgan_convlstm")


def _round_state(model, mode, batch, rounds=2):
    state = GANTrainState.create(model, *model.make_optimizers(),
                                 torch.Generator().manual_seed(5))
    step = make_gan_train_step(model, mode=mode)
    for _ in range(rounds):
        metrics = step(state, batch)
    return state, metrics


def test_fused_and_split_rounds_are_equal():
    """Two ``disc_steps=2`` rounds of DGMR in ``fused`` and in ``split``
    mode from the same weights and noise seed: every parameter, buffer and
    Adam moment equal bit for bit, ``step`` counting the four discriminator
    updates; another mode or ``disc_steps`` < 1 raise ValueError."""
    rs = np.random.RandomState(4)
    batch = tuple(_t(a.astype(np.float32)) for a in _batch(rs, 1, 4, 2, 32, 1))
    runs = []
    for mode in ("fused", "split"):
        torch.manual_seed(0)
        model = registry.create_model("nowcastinggan", **dict(DGMR_KW, disc_steps=2))
        model.materialize(batch)
        state, metrics = _round_state(model, mode, batch)
        runs.append((state, metrics))
    (a, ma), (b, mb) = runs
    assert a.step == b.step == 4
    for k, v in a.state_dict()["model"].items():
        assert torch.equal(v, b.state_dict()["model"][k]), k
    for half in ("g", "d"):
        sa = getattr(a, half).optimizer.state_dict()["state"]
        sb = getattr(b, half).optimizer.state_dict()["state"]
        for i in sa:
            assert torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"]), (half, i)
    for k in ("g_loss", "d_loss", "g_grid_reg", "finite"):
        assert torch.equal(ma[k], mb[k]), k
    assert bool(ma["finite"])
    with pytest.raises(ValueError):
        make_gan_train_step(a.model, mode="both")
    a.model.disc_steps = 0
    with pytest.raises(ValueError):
        make_gan_train_step(a.model)


@pytest.mark.parametrize("key", ["cloudgan_runet", "pix2pix_wgangp"])
def test_gan_hparams_match_jax(key):
    """``hparams()`` (what ``hparams.json`` holds) equal to the JAX model's."""
    name, kw, _, _ = CASES[key]
    assert registry.create_model(name, **kw).hparams() == \
        jax_registry.create_model(name, **kw).hparams()
    assert registry.create_model("nowcastinggan", **DGMR_KW).hparams() == \
        jax_registry.create_model("nowcastinggan", **DGMR_KW).hparams()


def test_float32_round_of_each_model_is_finite():
    """One f32 round of every case through the Trainer's step on the CPU:
    losses finite and every generator and discriminator parameter moved,
    but the WGAN critic's output bias, whose gradient is zero (the real and
    fake means cancel it; the penalty does not see it)."""
    for key, (name, kw, t, size) in CASES.items():
        rs = np.random.RandomState(2)
        batch = tuple(_t(a.astype(np.float32)) for a in _batch(rs, 2, t, 2, size, 2))
        torch.manual_seed(0)
        model = registry.create_model(name, **kw)
        model.materialize(batch)
        before = {k: v.clone() for k, v in model.named_parameters()}
        _, metrics = _round_state(model, "fused", batch, rounds=1)
        assert bool(metrics["finite"]), key
        moved = [k for k, v in model.named_parameters() if not torch.equal(v, before[k])]
        still = {"disc_module.out.bias"} if kw.get("loss") == "wgangp" else set()
        assert set(moved) == set(before) - still, (key, set(before) - set(moved))

