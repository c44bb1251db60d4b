"""PyTorch port, the GAN layers against the JAX package on the same weights:
spectral norm (stateful and stateless) and the layers it wraps, the
conditional batch norm, the ConvGRU cell, the SAGAN attentions,
``condition_time``, every DGMR block and conditioning stack, every
generator and discriminator name of ``define_generator`` /
``define_discriminator``, ``GANLoss`` in its three modes and
``gradient_penalty`` with fixed interpolation weights.

Weights come from numpy seeds in the shapes of the flax variables
(``jax.eval_shape`` of ``init``: no JAX initialisation is compiled), with
nonzero attention gates, and reach the port through
``flax_tree_state_dict``. Tolerances (each test names its own):

- float32 forwards, and the state they leave (spectral-norm ``u``,
  BatchNorm statistics): atol 1e-5 x max|ref|. flax's BatchNorm takes the
  variance as E[x²] - E[x]², the port as E[(x - E[x])²]: the same value up
  to float32 rounding on these O(1) activations;
- gradients of the spectral norm and the losses in float32: atol 1e-5 x
  max|grad|;
- the generators and discriminators, deep stacks of train-mode BatchNorms,
  LeakyReLUs and reflect pads, in float64 on both sides
  (``jax.enable_x64``), where no ReLU mask can flip: atol 1e-9 x max|ref|.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satflow_tpu.nn import attention as jax_attention
from satflow_tpu.nn import dgmr_blocks as jax_blocks
from satflow_tpu.nn import gan as jax_gan
from satflow_tpu.nn import losses as jax_losses
from satflow_tpu.nn import misc as jax_misc
from satflow_tpu.nn import norm as jax_norm
from satflow_tpu.nn.recurrent import ConvGRUCell as JaxConvGRUCell
from satflow_tpu_torch.interop.jax_weights import flax_tree_state_dict
from satflow_tpu_torch.nn import attention, dgmr_blocks, gan, losses, misc, norm
from satflow_tpu_torch.nn.recurrent import ConvGRUCell

TOL = 1e-5
TOL64 = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are tiny, and a GAN round is
    thousands of small ops, which threads only slow down when the suite runs
    in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(tree, rs, dtype=np.float32):
    """numpy leaves of ``dtype`` in the shapes of ``tree``: kernels at
    1/sqrt(fan-in), scales near 1, variances positive, gates 0.5, spectral
    vectors N(0, 1), the rest small."""
    def leaf(path, s):
        name, shape = path[-1].key, tuple(s.shape)
        if name in ("kernel", "embedding"):
            a = rs.randn(*shape) / math.sqrt(max(1, int(np.prod(shape[:-1]))))
        elif name == "var":
            a = 1.0 + 0.1 * rs.rand(*shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rs.randn(*shape)
        elif name == "u":
            a = rs.randn(*shape)
        elif name == "gamma":
            a = np.asarray(0.5)
        else:
            a = 0.1 * rs.randn(*shape)
        return np.asarray(a, dtype)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _run(jmod, port, args, port_args=None, mutable=False, port_train=False, seed=0,
         dtype=np.float32, jkw=None):
    """The JAX module and its port on the same weights: ((JAX output, JAX
    state), port output). ``args`` go to both (numpy arrays become tensors
    for the port, tuples stay tuples) unless ``port_args`` is given; ``jkw``
    to the JAX module only; the port runs in training mode with
    ``port_train``."""
    jkw = jkw or {}
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args, **jkw))
    v = _weights(shapes, rs, dtype)
    if dtype == np.float64:
        port.double()  # first: loading into float32 parameters would round
    port.load_state_dict(flax_tree_state_dict(v, dtype))
    port.train(port_train)
    out = jax.jit(lambda v: jmod.apply(v, *args, mutable=mutable, **jkw))(v)
    out, state = out if mutable else (out, None)
    got = port(*(port_args if port_args is not None else _to_torch(args)))
    return jax.tree_util.tree_map(np.asarray, (out, state)), got


def _to_torch(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_torch(t) for t in tree)
    return torch.from_numpy(np.array(tree)) if isinstance(tree, np.ndarray) else tree


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _close_state(port, state, tol=TOL, dtype=np.float32):
    """The port's buffers against the JAX state collections."""
    want = flax_tree_state_dict(state, dtype)
    params = dict(port.named_parameters())
    got = {k: v for k, v in port.state_dict().items() if k not in params}
    assert set(got) == set(want), set(got) ^ set(want)
    for k, v in want.items():
        _close(got[k], v.numpy(), tol, k)


def _rand(rs, *shape, dtype=np.float32):
    return rs.rand(*shape).astype(dtype)


# -- spectral norm ------------------------------------------------------------


@pytest.mark.parametrize("stateless", [False, True], ids=["stateful", "stateless"])
def test_spectral_norm_sigma_u_and_gradient(stateless):
    """``SpectralNorm`` on an HWIO conv kernel (the port on its OIHW
    weight): the normalised kernel, the ``u`` written back (training mode,
    flax's ``spectral`` mutable; stateless keeps none) and the gradient of a
    weighted sum of the normalised kernel, float32 at 1e-5 x max|ref|; in
    eval mode ``u`` stays."""
    rs = np.random.RandomState(1)
    kernel = rs.randn(3, 3, 5, 7).astype(np.float32)
    weights = rs.randn(3, 3, 5, 7).astype(np.float32)
    u0 = rs.randn(7).astype(np.float32)
    jmod = jax_norm.SpectralNorm(n_steps=2, stateless=stateless)
    variables = {} if stateless else {"spectral": {"u": u0}}

    def fn(k):
        out, state = jmod.apply(variables, k, mutable=["spectral"])
        return jnp.sum(out * weights), (out, state)

    (_, (want, state)), grad = jax.jit(jax.value_and_grad(fn, has_aux=True))(kernel)
    sn = norm.SpectralNorm(7, n_steps=2, stateless=stateless)
    if not stateless:
        sn.u.copy_(torch.from_numpy(u0))
    w = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    sn.train()
    out = sn(w)
    (out * torch.from_numpy(weights.transpose(3, 2, 0, 1).copy())).sum().backward()
    _close(out.permute(2, 3, 1, 0), want)
    _close(w.grad.permute(2, 3, 1, 0), grad)
    if stateless:
        assert not list(sn.buffers()) and not state
    else:
        _close(sn.u, state["spectral"]["u"])
        sn.eval()
        before = sn.u.clone()
        sn(w)
        assert torch.equal(sn.u, before)
        with norm.frozen_state(sn):
            sn.train()
            sn(w)
        assert torch.equal(sn.u, before)


@pytest.mark.parametrize("case", ["conv2d", "conv3d", "conv2d_stateless", "dense", "embed"])
def test_sn_layers_match_jax(case):
    """``SNConv`` 2-D (stateful, stateless) and 3-D, ``SNDense`` and
    ``SNEmbed`` in training mode: the output and the written-back ``u``,
    float32 at 1e-5 x max|ref|."""
    rs = np.random.RandomState(2)
    if case.startswith("conv2d"):
        stateless = case.endswith("stateless")
        jmod, port = (jax_norm.SNConv(6, 3, stateless=stateless),
                      norm.SNConv(4, 6, 3, stateless=stateless))
        args = (_rand(rs, 2, 8, 8, 4),)
    elif case == "conv3d":
        jmod, port = jax_norm.SNConv(6, (2, 3, 3)), norm.SNConv(None, 6, (2, 3, 3))
        args = (_rand(rs, 2, 4, 8, 8, 4),)
    elif case == "dense":
        jmod, port = jax_norm.SNDense(5), norm.SNDense(7, 5)
        args = (_rand(rs, 3, 7),)
    else:
        jmod, port = jax_norm.SNEmbed(9, 6), norm.SNEmbed(9, 6)
        args = (np.array([0, 3, 8, 3]),)
    (want, state), got = _run(jmod, port, args, mutable=["spectral"], port_train=True)
    _close(got, want)
    if state:
        _close_state(port, state)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_conditional_norm_matches_jax(train):
    """``ConditionalNorm``: batch statistics (moved, training) or running
    ones (eval), affine from the condition, float32 at 1e-5 x max|ref|."""
    rs = np.random.RandomState(3)
    args = (_rand(rs, 4, 6, 6, 5), _rand(rs, 4, 3))
    jmod = jax_norm.ConditionalNorm(5, use_running_average=not train)
    port = norm.ConditionalNorm(5, 3)
    (want, state), got = _run(jmod, port, args, mutable=["batch_stats"], port_train=train)
    _close(got, want)
    _close_state(port, state)


@pytest.mark.parametrize("sn", ["plain", "sn", "sn_stateless"])
def test_conv_gru_cell_matches_jax(sn):
    """``ConvGRUCell`` ((h,), x) -> ((h',), h'), with plain, spectrally
    normalised and stateless-SN convs: float32 at 1e-5 x max|ref|."""
    rs = np.random.RandomState(4)
    h, x = _rand(rs, 2, 6, 6, 8), _rand(rs, 2, 6, 6, 3)
    kw = dict(sn=sn != "plain", sn_stateless=sn == "sn_stateless")
    ((want_carry, want), _), (carry, got) = _run(JaxConvGRUCell(8, **kw), ConvGRUCell(3, 8, **kw),
                                                ((h,), x))
    _close(got, want)
    _close(carry[0], want_carry[0])


@pytest.mark.parametrize("case", ["sagan2d", "sagan2d_nopool", "self3d", "separable"])
def test_sagan_attentions_match_jax(case):
    """``SAGANAttention2d`` (k/v pooled and not), ``SelfAttention3d`` and
    ``SeparableAttention`` with gamma 0.5: float32 at 1e-5 x max|ref|."""
    rs = np.random.RandomState(5)
    if case.startswith("sagan2d"):
        pool = case == "sagan2d"
        jmod, port = (jax_attention.SAGANAttention2d(pool_kv=pool),
                      attention.SAGANAttention2d(16, pool_kv=pool))
        args = (_rand(rs, 2, 6, 6, 16),)
    elif case == "self3d":
        jmod, port = jax_attention.SelfAttention3d(), attention.SelfAttention3d(8)
        args = (_rand(rs, 2, 4, 3, 5, 8),)
    else:
        jmod, port = jax_attention.SeparableAttention(), attention.SeparableAttention(8)
        args = (_rand(rs, 2, 4, 6, 3, 8),)
    (want, _), got = _run(jmod, port, args)
    _close(got, want)


def test_condition_time_matches_jax():
    """``condition_time`` / ``ConditionTime`` on 4-D and 5-D input, an index
    in range and one past the horizon (all-zero one-hot): exact."""
    rs = np.random.RandomState(6)
    for shape in ((2, 3, 4, 2), (2, 2, 3, 4, 2)):
        x = _rand(rs, *shape)
        for fstep in (0, 2, 5):
            want = np.asarray(jax_misc.condition_time(jnp.asarray(x), fstep, 4))
            np.testing.assert_array_equal(misc.condition_time(torch.from_numpy(x), fstep, 4)
                                          .numpy(), want)
            np.testing.assert_array_equal(misc.ConditionTime(4)(torch.from_numpy(x), fstep)
                                          .numpy(), want)


# -- DGMR blocks -----------------------------------------------------------------


DGMR_BLOCKS = {
    # name: (JAX module, port module, input shape, mutable, train)
    "gblock_batch_up": (lambda: jax_blocks.GBlock(12, upsample=True),
                        lambda: dgmr_blocks.GBlock(6, 12, upsample=True), (2, 4, 4, 6), True),
    "gblock_layer_stateless": (
        lambda: jax_blocks.GBlock(6, norm="layer", sn_stateless=True),
        lambda: dgmr_blocks.GBlock(6, 6, norm="layer", sn_stateless=True), (2, 4, 4, 6), True),
    "dblock_first": (lambda: jax_blocks.DBlock(8, first=True),
                     lambda: dgmr_blocks.DBlock(4, 8, first=True), (2, 8, 8, 4), True),
    "dblock_3d": (lambda: jax_blocks.DBlock(8, conv_3d=True),
                  lambda: dgmr_blocks.DBlock(4, 8, conv_3d=True), (2, 3, 8, 8, 4), True),
    "dblock_keep": (lambda: jax_blocks.DBlock(4, downsample=False),
                    lambda: dgmr_blocks.DBlock(4, 4, downsample=False), (2, 8, 8, 4), True),
    "lblock_widen": (lambda: jax_blocks.LBlock(12), lambda: dgmr_blocks.LBlock(4, 12),
                     (2, 4, 4, 4), True),
    "lblock_narrow": (lambda: jax_blocks.LBlock(4), lambda: dgmr_blocks.LBlock(12, 4),
                      (2, 4, 4, 12), True),
    "context_stack": (lambda: jax_blocks.ContextConditioningStack((8, 16, 32, 64)),
                      lambda: dgmr_blocks.ContextConditioningStack(1, (8, 16, 32, 64)),
                      (2, 3, 32, 32, 1), True),
}


@pytest.mark.parametrize("key", list(DGMR_BLOCKS))
def test_dgmr_blocks_match_jax(key):
    """Each DGMR block in training mode (the G-block's batch norm on batch
    statistics, the stateful spectral norms writing ``u`` back): output and
    state, float32 at 1e-5 x max|ref|."""
    jfn, pfn, shape, train = DGMR_BLOCKS[key]
    x = _rand(np.random.RandomState(7), *shape)
    port = pfn()
    jkw = dict(train=True) if key.startswith("gblock") else None
    (want, state), got = _run(jfn(), port, (x,), mutable=["spectral", "batch_stats"],
                              port_train=train, jkw=jkw)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        _close(g, w)
    _close_state(port, state)


def test_conditional_gblock_matches_jax():
    """``ConditionalGBlock`` in training mode: float32 at 1e-5 x max|ref|."""
    rs = np.random.RandomState(8)
    x, cond = _rand(rs, 3, 4, 4, 6), _rand(rs, 3, 5)
    port = dgmr_blocks.ConditionalGBlock(6, 8, 5, upsample=True)
    (want, state), got = _run(jax_blocks.ConditionalGBlock(8, upsample=True), port, (x, cond),
                              mutable=["spectral", "batch_stats"], port_train=True,
                              jkw=dict(train=True))
    _close(got, want)
    _close_state(port, state)


def test_latent_stack_and_sampler_step_match_jax():
    """The latent stack on the noise its key draws (``z = normal(key,
    shape)``, the stack's own draw, passed to the port) and one sampler step
    (coarsest first), float32 at 1e-5 x max|ref|."""
    key = jax.random.PRNGKey(9)
    z = np.array(jax.random.normal(key, (2, 2, 2, 8)))
    (want, state), got = _run(jax_blocks.LatentConditioningStack(32),
                              dgmr_blocks.LatentConditioningStack(32), (key, 2, 2, 2),
                              port_args=(2, 2, 2, None, torch.from_numpy(z)),
                              mutable=["spectral"], port_train=True)
    _close(got, want)
    rs = np.random.RandomState(10)
    states = tuple(_rand(rs, 2, s, s, c) for s, c in ((1, 64), (2, 32), (4, 16), (8, 8)))
    latent = _rand(rs, 2, 1, 1, 32)
    ((want_states, want_frame), _), (got_states, got_frame) = _run(
        jax_blocks.SamplerStep((64, 32, 16, 8), 1),
        dgmr_blocks.SamplerStep(32, (64, 32, 16, 8), 1), (states, latent))
    _close(got_frame, want_frame)
    for g, w in zip(got_states, want_states):
        _close(g, w)


# -- generators, discriminators ------------------------------------------------------


NETS = {
    # name: (factory keywords, input shape)
    "resnet_6blocks": ("G", dict(generator="resnet_6blocks"), (2, 16, 16, 3)),
    "resnet_9blocks_instance": ("G", dict(generator="resnet_9blocks", norm="instance"),
                                (2, 8, 8, 3)),
    "resnet_6blocks_antialiased": ("G", dict(generator="resnet_6blocks", antialiased=True),
                                   (2, 16, 16, 3)),
    "unet_128": ("G", dict(generator="unet_128"), (1, 128, 128, 3)),
    "unet_256_none": ("G", dict(generator="unet_256", norm="none"), (1, 256, 256, 2)),
    "basic": ("D", dict(discriminator="basic"), (2, 32, 32, 3)),
    "n_layers": ("D", dict(discriminator="n_layers", n_layers=2), (2, 16, 16, 3)),
    "pixel": ("D", dict(discriminator="pixel"), (2, 6, 6, 3)),
    "enhanced": ("D", dict(discriminator="enhanced"), (2, 16, 16, 3)),
}


@pytest.mark.parametrize("key", list(NETS))
def test_generators_and_discriminators_match_jax(key):
    """Every name of ``define_generator`` and ``define_discriminator``
    (ngf / ndf 2, ``batch``, ``instance`` and ``none`` norms) in training
    mode: output and BatchNorm statistics in float64 at 1e-9 x max|ref|;
    the antialiased ResNet generator too."""
    kind, kw, shape = NETS[key]
    x = np.random.RandomState(11).rand(*shape)
    if kind == "G":
        jmod = jax_gan.define_generator(output_channels=4, ngf=2, **kw)
        port = gan.define_generator(output_channels=4, ngf=2, **kw)
    else:
        jmod = jax_gan.define_discriminator(ndf=2, **kw)
        port = gan.define_discriminator(ndf=2, **kw)
    with jax.enable_x64(True):
        (want, state), got = _run(jmod, port, (x,), mutable=["batch_stats"], port_train=True,
                                  dtype=np.float64, jkw=dict(train=True))
    _close(got, want, TOL64)
    _close_state(port, state, TOL64, np.float64)


def test_factories_reject_unknown_names():
    """Unknown generator, discriminator, norm and init names raise
    ValueError, as in JAX; a module passes through ``define_generator``."""
    for fn in (lambda: gan.define_generator("nope"),
               lambda: gan.define_discriminator(discriminator="nope"),
               lambda: gan.get_norm_layer("nope"), lambda: gan.get_initializer("nope")):
        with pytest.raises(ValueError):
            fn()
    net = gan.PixelDiscriminator(2)
    assert gan.define_generator(net) is net
    with pytest.raises(ValueError, match="collapsed"):
        gan.NLayerDiscriminator(2, 3)(torch.zeros(1, 8, 8, 3))


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming", "orthogonal"])
def test_initializers_follow_flax_statistics(init_type):
    """``get_initializer`` fills a (64, 32, 3, 3) conv weight with flax's
    distribution of that name: the sample std within 5 % of flax's
    (normal: gain; glorot: sqrt(2 / (fan_in + fan_out)); he: sqrt(2 /
    fan_in), both truncated at 2σ and rescaled); orthogonal rows."""
    w = torch.empty(64, 32, 3, 3)
    gan.get_initializer(init_type, gain=0.02)(w, torch.Generator().manual_seed(0))
    fan_in, fan_out = 32 * 9, 64 * 9
    want = {"normal": 0.02, "xavier": math.sqrt(2.0 / (fan_in + fan_out)),
            "kaiming": math.sqrt(2.0 / fan_in)}
    if init_type == "orthogonal":
        m = w.reshape(64, -1)
        torch.testing.assert_close(m @ m.T, 0.02**2 * torch.eye(64), atol=1e-6, rtol=0)
    else:
        assert abs(w.std().item() / want[init_type] - 1) < 0.05


@pytest.mark.parametrize("mode", ["vanilla", "lsgan", "wgangp"])
def test_gan_loss_matches_jax(mode):
    """``GANLoss`` for real and fake targets: value and gradient in float32
    at 1e-5 x max|ref|."""
    pred = np.random.RandomState(13).randn(3, 4, 4, 1).astype(np.float32)
    jloss, loss = jax_losses.GANLoss(mode), losses.GANLoss(mode)
    for real in (True, False):
        want, grad = jax.value_and_grad(lambda p: jloss(p, real))(pred)
        p = torch.from_numpy(pred).requires_grad_(True)
        got = loss(p, real)
        got.backward()
        _close(got, want)
        _close(p.grad, grad)
    with pytest.raises(ValueError):
        losses.GANLoss("hinge")


@pytest.mark.parametrize("mode", ["mixed", "real", "fake"])
def test_gradient_penalty_matches_jax(mode):
    """``gradient_penalty`` through a small conv critic, with the
    interpolation weights JAX draws passed to the port: the penalty and its
    gradient with respect to the critic's kernel (a double backward), float32
    at 1e-5 x max|ref|; ``lambda_gp`` 0 is zero."""
    rs = np.random.RandomState(14)
    real, fake = _rand(rs, 2, 6, 6, 3), _rand(rs, 2, 6, 6, 3)
    kernel = (rs.randn(3, 3, 3, 1) / 5).astype(np.float32)
    key = jax.random.PRNGKey(15)
    alpha = np.array(jax.random.uniform(key, (2, 1, 1, 1), dtype=jnp.float32))

    def jcritic(k):
        return lambda x: jnp.tanh(jax.lax.conv_general_dilated(
            x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))

    want, grad = jax.value_and_grad(
        lambda k: jax_losses.gradient_penalty(jcritic(k), real, fake, key, mode))(kernel)
    w = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()).requires_grad_(True)

    def critic(x):
        return torch.tanh(torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1))

    got = losses.gradient_penalty(critic, torch.from_numpy(real), torch.from_numpy(fake),
                                  mode=mode, alpha=torch.from_numpy(alpha))
    got.backward()
    _close(got, want)
    _close(w.grad.permute(2, 3, 1, 0), grad)
    assert losses.gradient_penalty(critic, torch.from_numpy(real), torch.from_numpy(fake),
                                   lambda_gp=0.0).item() == 0.0
