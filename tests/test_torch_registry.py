"""PyTorch port, the registries against the JAX package's
(``satflow_tpu/core/registry.py``): ``Registry`` (register / get / create /
names, a name registered twice, an unknown name), ``is_model``, and the
losses' ``LOSSES`` registry with its ``mae`` and ``l2`` aliases."""

import pytest

import satflow_tpu.models  # noqa: F401 - populate the JAX registry
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu.core import registry as jax_registry
from satflow_tpu.nn import losses as jax_losses
from satflow_tpu_torch.core import registry
from satflow_tpu_torch.nn import losses


def _filled(module):
    reg = module.Registry("widget")
    reg.register("Small")(lambda size=1, **_: ("small", size))
    reg.register("large")(lambda **kw: ("large", kw))
    return reg


def _error(fn, *args):
    with pytest.raises(Exception) as info:
        fn(*args)
    return type(info.value), str(info.value)


def test_registry_matches_jax():
    """The same names (lowercased, sorted), factories, keywords passed on,
    and the same errors with the same messages."""
    jax_reg, reg = _filled(jax_registry), _filled(registry)
    assert reg.kind == jax_reg.kind == "widget"
    assert reg.names() == jax_reg.names() == ["large", "small"]
    assert reg.get("SMALL")() == jax_reg.get("SMALL")() == ("small", 1)
    assert reg.create("small", size=3) == jax_reg.create("small", size=3) == ("small", 3)
    assert reg.create("large", a=1) == jax_reg.create("large", a=1)
    for method, args in ((lambda r, n: r.get(n), ("nope",)),
                         (lambda r, n: r.create(n), ("Nope",)),
                         (lambda r, n: r.register(n)(len), ("SMALL",))):
        got = _error(method, reg, *args)
        assert got == _error(method, jax_reg, *args)
        assert got[0] is (ValueError if args == ("SMALL",) else KeyError)
    assert "Registered: ['large', 'small']" in _error(reg.get, "nope")[1]


def test_is_model_matches_jax():
    """Every registered name in either case; unknown and sourced names not."""
    assert set(registry.list_models()) <= set(jax_registry.list_models())
    for name in registry.list_models() + ["ConvLSTM", "EncoderDecoderConvLSTM", "MetNet",
                                          "no_such_model", "local:/tmp/x", ""]:
        assert registry.is_model(name) == jax_registry.is_model(name), name


def test_losses_registry_matches_jax():
    """``LOSSES`` is a ``Registry("loss")`` with JAX's names (aliases
    included), the aliases the same factories, the same unknown-name error;
    ``get_loss`` builds through it."""
    assert isinstance(losses.LOSSES, registry.Registry) and losses.LOSSES.kind == "loss"
    assert losses.LOSSES.names() == jax_losses.LOSSES.names()
    assert losses.LOSSES.get("mae") is losses.LOSSES.get("l1") is losses.make_l1
    assert losses.LOSSES.get("L2") is losses.LOSSES.get("mse") is losses.make_mse
    assert losses.LOSSES.get("msssim") is losses.LOSSES.get("ms_ssim")
    assert _error(losses.get_loss, "no_such_loss") == _error(jax_losses.get_loss, "no_such_loss")
    assert _error(losses.LOSSES.register("mse"), len) == _error(
        jax_losses.LOSSES.register("mse"), len)
    assert losses.LOSSES.names() == jax_losses.LOSSES.names()  # the refused names left no trace
