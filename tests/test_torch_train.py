"""PyTorch port, training: whole-model gradients, the optimizer step, the
Trainer and the CLI, against the JAX package on the same weights and data.

Weights come from numpy seeds in the flax layout and reach the port through
``params_from_flax``; batches are numpy and go to both packages. On the CPU
the JAX model runs its fused cells through the XLA reference step, the port
through the plain versions of K1 and K2.

Tolerances:
- model gradients, float32: atol 1e-5 x max|grad| per tensor. Both sides
  run the same f32 convs and gate chain in another order over 2T + 2F
  recurrent steps (measured 7.3e-7 x max).
- model gradients, bfloat16: atol 3e-2 x max|grad|. Both round every
  state, dgates and conv grad to bf16 (step 2^-8) at different points
  over the whole rollout (measured 5.4e-3 x max).
- remat against no remat (the port alone): atol 1e-6 x max|grad|; the
  recompute repeats the same f32 operations, only the order in which the
  steps' weight gradients are summed changes.
- Adam: loss, frame losses and grad_norm to 1e-5 relative (f32 means over
  ~10^4 elements, summed in another order; measured 1.04e-6). Adam's first
  update is lr * g / (|g| + eps) elementwise, so elements whose |g| is
  near eps = 1e-8 amplify any rounding of g; such elements are compared
  only as bounded by lr, the rest to 1e-4 x lr (see ``_assert_updates``).
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from satflow_tpu.core import registry as jax_registry
from satflow_tpu.data.datamodule import SatFlowDataModule as JaxDataModule
from satflow_tpu.train.engine import Trainer as JaxTrainer
from satflow_tpu.train.state import TrainState as JaxTrainState
from satflow_tpu.train.steps import make_train_step as jax_make_train_step
import satflow_tpu.models  # noqa: F401 - populate the JAX registry
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.core import registry
from satflow_tpu_torch.core.utils import extras
from satflow_tpu_torch.data.datamodule import SatFlowDataModule, to_device
from satflow_tpu_torch.interop.jax_weights import params_from_flax
from satflow_tpu_torch.nn.losses import get_loss
from satflow_tpu_torch.train import Trainer, TrainState
from satflow_tpu_torch.train.steps import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, H, W, CIN, HID, COUT, STEPS = 2, 3, 16, 16, 4, 8, 3, 4
KW = dict(input_channels=CIN, out_channels=COUT, forecast_steps=STEPS, hidden_dim=HID)
DM_KW = dict(fake_data=True, num_workers=0, n_train_data=4, n_val_data=2,
             history_minutes=10, forecast_minutes=20,
             fake_kwargs=dict(batch_size=B, width=W, height=H, number_sat_channels=CIN))


def _flax_params(seed=0, **kw):
    model = jax_registry.create_model("encoderdecoderconvlstm", **{**KW, **kw})
    tree = model.module.init(jax.random.PRNGKey(0), np.zeros((1, T, H, W, CIN), np.float32))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: (rng.normal(size=a.shape) * 0.3).astype(np.float32),
                                  tree)


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.random((B, T, H, W, CIN), dtype=np.float32),
            rng.random((B, STEPS, H, W, CIN), dtype=np.float32))


def _port(params, **kw):
    model = registry.create_model("encoderdecoderconvlstm", **{**KW, **kw})
    model.module.load_state_dict(params_from_flax(params))
    return model


def _port_grads(model, batch):
    loss, _ = model.loss(tuple(torch.from_numpy(a) for a in batch))
    loss.backward()
    return {name: p.grad.clone() for name, p in model.module.named_parameters()}


@pytest.fixture(scope="module")
def flax_params():
    return _flax_params()


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("remat, remat_chunk", [(False, 0), (False, 2), (True, 0), (True, 2)])
def test_model_grads_match_jax(dtype, tol, remat, remat_chunk):
    """loss.backward() on the port against jax.grad(model.loss) of the JAX
    model with the same remat schedule, weights and batch: every parameter
    of the four cells and the head."""
    kw = dict(remat=remat, remat_chunk=remat_chunk)
    params = _flax_params(**kw)  # the chunked layout nests params under steps/
    jmodel = jax_registry.create_model("encoderdecoderconvlstm", dtype=getattr(jnp, dtype),
                                       **KW, **kw)
    batch = _batch()
    want = params_from_flax({"params": jax.grad(
        lambda p: jmodel.loss(p, {}, batch, jax.random.PRNGKey(0))[0])(params["params"])})
    got = _port_grads(_port(params, dtype=getattr(torch, dtype), **kw), batch)
    assert list(got) == list(want)
    for name, g in got.items():
        w = want[name].numpy()
        assert g.abs().sum() > 0, name
        np.testing.assert_allclose(g.numpy(), w, atol=tol * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("remat, remat_chunk", [(True, 0), (True, 2), (True, 3)])
def test_remat_changes_no_gradient(flax_params, remat, remat_chunk):
    """Per-step and sqrt remat (chunk 2 divides F=4; chunk 3 falls back to
    the largest divisor, 2) give the gradients of no remat."""
    batch = _batch(seed=2)
    want = _port_grads(_port(flax_params), batch)
    got = _port_grads(_port(flax_params, remat=remat, remat_chunk=remat_chunk), batch)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=1e-6 * want[name].abs().max().item(), err_msg=name)


def test_remat_is_off_without_grad(flax_params, monkeypatch):
    """Under no_grad the forward takes no checkpoint at all."""
    import satflow_tpu_torch.models.conv_lstm as M

    calls = []
    monkeypatch.setattr(M, "_remat", lambda fn, *a: calls.append(fn) or fn(*a))
    model = _port(flax_params, remat=True, remat_chunk=2)
    x = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        model(x)
    assert calls == []
    model(x)
    assert len(calls) == 1 + STEPS // 2  # the whole encoder, then F/chunk decoder chunks


def _assert_updates(new, old, want_new, lr, g_ref):
    """Compare one parameter's update against the JAX one (see the module
    docstring): to 1e-4 x lr where |g| > 1e-6, bounded by lr elsewhere. An
    update read back from f32 parameters of size ~1 carries their rounding
    (~6e-8, i.e. 6e-5 x lr at lr 1e-3), hence the 1e-4 x lr slack."""
    d_got = (new - old) / lr
    d_want = (want_new - old) / lr
    big = np.abs(g_ref) > 1e-6
    np.testing.assert_allclose(d_got[big], d_want[big], atol=1e-4)
    assert np.all(np.abs(d_got) <= 1 + 1e-4)


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_flax({"params": tree}).items()}


def test_train_step_matches_jax(flax_params):
    """One Adam step: the port's make_train_step against the JAX
    make_train_step on a TrainState with the model's optax Adam."""
    batch = _batch(seed=3)
    jmodel = jax_registry.create_model("encoderdecoderconvlstm", **KW)
    jstate = JaxTrainState.create(flax_params["params"], {}, jmodel.make_optimizer())
    grads_ref = _flat(jax.grad(lambda p: jmodel.loss(p, {}, batch, jax.random.PRNGKey(0))[0])(
        flax_params["params"]))
    old = _flat(flax_params["params"])
    jstate, jm = jax_make_train_step(jmodel)(jstate, batch, jax.random.PRNGKey(0))

    model = _port(flax_params)
    state = TrainState(model, model.make_optimizer())
    metrics = make_train_step(model)(state, tuple(torch.from_numpy(a) for a in batch))
    assert state.step == 1 and bool(metrics["finite"])
    for key in ("loss", "grad_norm", "frame_loss"):
        np.testing.assert_allclose(metrics[key].numpy(), np.asarray(jm[key]), rtol=1e-5,
                                   err_msg=key)
    assert metrics["frame_loss"].shape == (STEPS,)
    want = _flat(jstate.params)
    for name, p in model.module.named_parameters():
        assert p.grad is None  # consumed by apply_gradients
        _assert_updates(p.detach().numpy(), old[name], want[name], model.lr, grads_ref[name])


@pytest.mark.parametrize("accumulate, clip", [(2, 0.0), (1, 0.05), (3, 0.05)])
def test_train_state_chain_matches_optax(accumulate, clip):
    """TrainState.apply_gradients against the JAX engine's own chain
    (``MultiSteps(chain(clip_by_global_norm, adam))``) over six mini-steps of
    given gradients, large enough that the clip bites."""
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 5), "b": (7,)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = JaxTrainer(gradient_clip_val=clip,
                    accumulate_grad_batches=accumulate)._wrap_tx(optax.adam(1e-2))
    jparams, opt_state = init, tx.init(init)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    state = TrainState(torch.nn.ParameterDict(params),
                       torch.optim.Adam(params.values(), lr=1e-2, betas=(0.9, 0.999), eps=1e-8),
                       gradient_clip_val=clip, accumulate_grad_batches=accumulate)
    for i in range(6):
        grads = {k: (rng.normal(size=s) * (i + 1) * 0.1).astype(np.float32)
                 for k, s in shapes.items()}
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k])
        state.apply_gradients()
        assert state.step == i + 1
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=0,
                                       atol=1e-6, err_msg=f"mini-step {i} {k}")


def _fit(tmp_path, jax_side=False, **trainer_kw):
    """A Trainer of either package on the same tiny fake-data run."""
    kw = {"max_epochs": 1, "log_every_n_steps": 1, **trainer_kw}
    if jax_side:
        model = jax_registry.create_model("encoderdecoderconvlstm", **KW)
        trainer = JaxTrainer(**kw)
        trainer.fit(model, JaxDataModule(**DM_KW))
    else:
        model = _port(_flax_params())
        trainer = Trainer(**kw)
        trainer.fit(model, SatFlowDataModule(**DM_KW))
    return trainer, model


def test_trainer_fits_and_validates(tmp_path):
    trainer, model = _fit(tmp_path, max_steps=3, limit_val_batches=1)
    assert trainer.global_step == 3 and trainer.state.step == 3
    train_losses = [e["train/loss"] for e in trainer.history.history if "train/loss" in e]
    assert len(train_losses) == 3 and np.all(np.isfinite(train_losses))
    assert np.isfinite(trainer.callback_metrics["val/loss"])
    assert trainer.device == torch.device("cpu")
    assert all(p.grad is None for p in model.parameters())


def test_trainer_logs_the_jax_keys(tmp_path):
    """The same keys as the JAX Trainer on the same tiny run (train/loss,
    train/frame_{f}_loss, train/grad_norm, train/finite,
    train/steps_per_sec, val/...)."""
    def keys(trainer):
        return set().union(*(e.keys() for e in trainer.history.history))

    port, _ = _fit(tmp_path, max_steps=2)
    jax_trainer, _ = _fit(tmp_path, jax_side=True, max_steps=2)
    assert keys(port) == keys(jax_trainer)
    assert {"train/loss", "train/grad_norm", "train/steps_per_sec",
            f"train/frame_{STEPS - 1}_loss", "val/loss"} <= keys(port)


@pytest.mark.parametrize("knobs, steps", [
    (dict(max_steps=2), 2),
    (dict(fast_dev_run=True), 1),
    (dict(limit_train_batches=3), 3),
    (dict(limit_train_batches=0.5), 2),
    (dict(max_epochs=2, limit_train_batches=1), 2),
    (dict(overfit_batches=1, max_epochs=2), 2),
    (dict(accumulate_grad_batches=2, max_steps=3), 3),
])
def test_trainer_loop_limits(tmp_path, knobs, steps):
    trainer, _ = _fit(tmp_path, **knobs)
    assert trainer.global_step == steps


def test_trainer_bf16_keeps_loaded_weights(tmp_path):
    """precision="bf16" computes in bf16 on f32 parameters, from the weights
    the model already held (nothing is re-initialised)."""
    model = _port(_flax_params())
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    trainer = Trainer(max_steps=1, precision="bf16", limit_val_batches=1)
    state = trainer._build_state(model, SatFlowDataModule(**DM_KW)) or trainer.state
    assert model.dtype == torch.bfloat16
    assert all(c.dtype == torch.bfloat16 for c in (model.module.encoder["encoder_1"],
                                                   model.module.decoder["decoder_2"]))
    for k, v in model.module.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, before[k]), k
    batch = tuple(torch.from_numpy(a) for a in _batch())
    metrics = make_train_step(model)(state, batch)
    assert bool(metrics["finite"]) and model(batch[0]).dtype == torch.bfloat16


def test_trainer_validate_and_test(tmp_path):
    trainer, model = _fit(tmp_path, max_steps=1)
    dm = SatFlowDataModule(**DM_KW)
    assert set(trainer.validate(model, dm)) == {"val/loss"} | {
        f"val/frame_{f}_loss" for f in range(STEPS)}
    assert np.isfinite(trainer.test(model, dm)["test/loss"])


def test_terminate_on_nan_stops_one_step_late(tmp_path):
    """A non-finite step is caught at the next step's check (the JAX
    one-step lag), or at the end of the epoch."""
    model = _port(_flax_params())
    with torch.no_grad():
        model.module.decoder["head"].bias.fill_(float("nan"))
    trainer = Trainer(max_epochs=1, terminate_on_nan=True, log_every_n_steps=100)
    trainer.fit(model, SatFlowDataModule(**DM_KW))
    assert trainer.should_stop and trainer.global_step == 2


@pytest.mark.parametrize("knob, item", [
    (dict(zero_sharding=True), "item 13"),
    (dict(spatial="2x4"), "item 13"),
])
def test_unported_trainer_knobs_raise(knob, item):
    with pytest.raises(NotImplementedError, match=item):
        Trainer(**knob)


@pytest.mark.parametrize("knob", ["profiler", "resume_from_checkpoint"])
def test_item6_trainer_knobs_work(tmp_path, knob):
    """The two knobs item 6 ported: ``profiler`` writes a trace of the fit
    to ``profile_dir``; ``resume_from_checkpoint`` goes on from a saved
    state's step and weights."""
    from satflow_tpu_torch.train.callbacks import ModelCheckpoint

    if knob == "profiler":
        trainer, _ = _fit(tmp_path, max_steps=1, profiler="simple",
                          profile_dir=str(tmp_path / "prof"))
        assert os.path.exists(tmp_path / "prof" / "trace.json")
        assert trainer.profile_path == str(tmp_path / "prof" / "trace.json")
        return
    first, model = _fit(tmp_path, max_steps=2,
                        callbacks=[ModelCheckpoint(dirpath=str(tmp_path / "ck"))])
    trainer = Trainer(max_epochs=0, resume_from_checkpoint=str(tmp_path / "ck" / "last"))
    trainer.fit(_port(_flax_params(seed=1)), SatFlowDataModule(**DM_KW))
    assert trainer.global_step == trainer.state.step == first.global_step == 2
    for k, v in model.state_dict().items():
        assert torch.equal(trainer.model.state_dict()[k], v), k


def test_unported_losses_and_gan_models_raise():
    """The losses by name (ssim and ms_ssim ported with item 7; the GAN
    objectives are no registry names, in JAX either: a KeyError), and a GAN
    model, ported with item 11, trained by the Trainer through its two
    optimizers instead of raising."""
    for name in ("ssim", "ms_ssim"):
        assert callable(get_loss(name))
    for name in ("lsgan", "wgangp", "gradient_penalty", "no_such_loss"):
        with pytest.raises(KeyError):
            get_loss(name)
    x, y = torch.rand(2, 3, 4), torch.rand(2, 3, 4)
    torch.testing.assert_close(get_loss("l2")(x, y), torch.mean((x - y) ** 2))
    torch.testing.assert_close(get_loss("mae")(x, y), torch.mean((x - y).abs()))
    gan = registry.create_model("cloudgan", forecast_steps=STEPS, input_channels=CIN,
                                channels_per_timestep=CIN, num_filters=2,
                                features_start=2, unet_depth=2)
    trainer = Trainer(max_steps=1, device="cpu")
    metrics = trainer.fit(gan, SatFlowDataModule(**DM_KW))
    assert trainer.state.step == 1 and np.isfinite(metrics["val/g_loss"])


def test_unported_config_targets_raise():
    """A GAN model's target (item 11) builds the port's model; the
    checkpoint callbacks of the default ``callbacks`` group (item 6) build
    the port's callbacks with the config's arguments."""
    from satflow_tpu_torch.experiments.train import instantiate
    from satflow_tpu_torch.train import callbacks

    from satflow_tpu_torch.models.dgmr import NowcastingGAN

    gan = instantiate({"_target_": "satflow_tpu.models.dgmr.NowcastingGAN",
                       "context_channels": 32, "latent_channels": 32})
    assert type(gan) is NowcastingGAN and gan.is_gan
    cb = instantiate({"_target_": "satflow_tpu.train.callbacks.ModelCheckpoint",
                      "monitor": "val/loss", "dirpath": "ck/", "save_top_k": 1, "mode": "max"})
    assert type(cb) is callbacks.ModelCheckpoint and (cb.dirpath, cb.mode) == ("ck/", "max")
    assert cb.best_score == -float("inf")
    cb = instantiate({"_target_": "satflow_tpu.train.callbacks.ModelArtifactLogger",
                      "dirpath": "art/"})
    assert type(cb) is callbacks.ModelArtifactLogger and cb.dirpath == "art/"
    cb = instantiate({"_target_": "satflow_tpu.train.callbacks.EarlyStopping", "patience": 3})
    assert type(cb).__name__ == "EarlyStopping" and cb.patience == 3


def test_datamodule_puts_tensors_on_the_device():
    dm = SatFlowDataModule(**DM_KW)
    assert dm._device_put() is None  # no device yet: numpy as the JAX loader gives it
    dm.device = torch.device("cpu")
    x, y = next(iter(dm.train_dataloader()))
    assert isinstance(x["sat_data"], torch.Tensor) and x["sat_data"].shape == (B, T, W, H, CIN)
    assert y["sat_data"].shape == (B, STEPS, W, H, CIN)
    nested = to_device({"a": [np.zeros(2)], "b": (np.ones(1), 3)}, torch.device("cpu"))
    assert isinstance(nested["a"][0], torch.Tensor) and nested["b"][1] == 3


def test_extras_makes_the_datamodule_follow_the_model():
    cfg = extras({"model": {"forecast_steps": 2}, "datamodule": {"forecast_minutes": 120},
                  "debug": True, "trainer": {}})
    assert cfg["datamodule"]["forecast_minutes"] == 10
    assert cfg["trainer"]["fast_dev_run"] and cfg["datamodule"]["num_workers"] == 0


def test_cli_example_runs(tmp_path, monkeypatch):
    """The README's CPU example, through ``satflow_tpu_torch.run.main``."""
    from satflow_tpu_torch.run import main

    monkeypatch.chdir(tmp_path)  # main chdirs into the run dir; undone at teardown
    result = main(["model=convlstm", "datamodule=fake", "trainer=minimal", "callbacks=none",
                   "model.hidden_dim=8", "model.forecast_steps=2", "trainer.max_steps=2",
                   "trainer.device=cpu", f"work_dir={tmp_path / 'runs'}", "print_config=false"])
    assert result is not None and np.isfinite(result)  # optimized_metric val/loss
    csvs = list((tmp_path / "runs").rglob("metrics.csv"))
    assert len(csvs) == 1
    header = csvs[0].read_text().splitlines()[0].split(",")
    assert {"val/loss", "test/loss"} <= set(header)


def test_training_imports_no_jax(tmp_path):
    """A process that runs the CLI example (compose the config tree, train on
    the fake datamodule, test, write metrics.csv) through the port imports
    neither jax, flax or optax nor any module of the JAX package."""
    code = textwrap.dedent(f"""
        import sys
        from satflow_tpu_torch.run import main
        result = main(["model=convlstm", "datamodule=fake", "trainer=minimal",
                       "callbacks=none", "model.hidden_dim=8", "model.forecast_steps=2",
                       "trainer.max_steps=2", "trainer.device=cpu", "work_dir={tmp_path / 'runs'}",
                       "print_config=false"])
        assert result is not None
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "flax", "optax", "satflow_tpu")))
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert len(list((tmp_path / "runs").rglob("metrics.csv"))) == 1
