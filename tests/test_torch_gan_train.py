"""PyTorch port, GAN training and serving: ``GANTrainState`` and the GAN
optimizers against optax (DGMR's ``b1=0``, the injected rate rewritten by
``PlateauScheduler`` / ``rewrite_learning_rate``, the cosine schedule),
``Trainer.fit`` / ``validate`` / ``scale_batch_size`` on the fake
datamodule, the GAN checkpoint and a resume bit-equal to the uninterrupted
run, ``local:`` serving the generator, the session's sampling and its
refusals, ``eval --ensemble`` and export on a GAN checkpoint,
``experiment=nowcasting_gan_simple`` through the CLI, ``crps_finetune``
(its fair-CRPS loss and gradient against JAX's), and a process that imports
every new module and trains a round without loading jax.

Optimizer updates against optax on the same gradients: atol 1e-4 x lr +
1e-6 x max|param| (optax's float32 bias correction); the plateau scales
exactly; the fair CRPS and its gradient at 1e-5 x max|ref| in float32.
"""

import json
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

import satflow_tpu.models  # noqa: F401 - populate the JAX registry
from satflow_tpu.core import registry as jax_registry
from satflow_tpu.eval.probabilistic import crps_ensemble as jax_crps_ensemble
from satflow_tpu.train import schedules as jax_schedules
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.core import registry
from satflow_tpu_torch.data.datamodule import SatFlowDataModule
from satflow_tpu_torch.serve.session import InferenceSession
from satflow_tpu_torch.train import Trainer, schedules
from satflow_tpu_torch.train.callbacks import ModelCheckpoint
from satflow_tpu_torch.train.probabilistic import crps_finetune, fair_crps_loss
from satflow_tpu_torch.train.state import GANTrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DGMR_KW = dict(forecast_steps=2, input_channels=1, output_shape=32, context_channels=32,
               latent_channels=32, disc_channels=4, disc_spatial_layers=2,
               disc_temporal_layers=1, num_samples=2)
CLOUDGAN_KW = dict(forecast_steps=2, input_channels=1, channels_per_timestep=1,
                   num_filters=4, features_start=4, unet_depth=2)
DM_KW = dict(fake_data=True, num_workers=0, n_train_data=2, n_val_data=1, history_minutes=15,
             forecast_minutes=10,
             fake_kwargs=dict(batch_size=2, width=32, height=32, number_sat_channels=1))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are tiny, and a GAN round is
    thousands of small ops, which threads only slow down when the suite runs
    in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dgmr(seed=0, **kw):
    return registry.create_model("nowcastinggan", **{**DGMR_KW, **kw},
                                 generator=torch.Generator().manual_seed(seed))


def _batch(seed=0, b=2):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.rand(b, 4, 32, 32, 1).astype(np.float32)),
            torch.from_numpy(rs.rand(b, 2, 32, 32, 1).astype(np.float32)))


# -- optimizers and the train state ---------------------------------------------------


@pytest.mark.parametrize("case", ["dgmr_b1_0", "cloudgan_plateau", "cloudgan_cosine"])
def test_gan_optimizers_match_optax(case):
    """Three discriminator and three generator updates of ``GANTrainState``
    on the same random gradients as the JAX model's ``make_optimizers``
    (DGMR: Adam with ``b1=0``; CloudGAN: ``inject_hyperparams(adam)`` at a
    constant rate, which ``rewrite_learning_rate`` halves before the third
    update, or under the cosine schedule over 4 steps): every parameter at
    atol 1e-4 x lr + 1e-6 x max|param| (optax takes Adam's bias correction
    1 - b2^t in float32, which cancels to ~1e-5 of a step by t = 3); ``step`` counts discriminator updates only."""
    if case == "dgmr_b1_0":
        name, kw = "nowcastinggan", DGMR_KW
    else:
        name, kw = "cloudgan", dict(CLOUDGAN_KW, scheduler=case.split("_")[1])
    jmodel = jax_registry.create_model(name, **kw)
    if case == "cloudgan_cosine":
        jmodel.total_steps = 4
    model = registry.create_model(name, **kw)
    if case == "cloudgan_cosine":
        model.total_steps = 4
    model.materialize(_batch())
    state = GANTrainState.create(model, *model.make_optimizers(), torch.Generator())
    rs = np.random.RandomState(1)
    for half, tx, net in (("d", jmodel.make_optimizers()[1], model.disc_module),
                          ("g", jmodel.make_optimizers()[0], model.module)):
        params = [p.detach().numpy().copy() for p in net.parameters()]
        opt_state = tx.init(params)
        update = jax.jit(tx.update)
        for i in range(3):
            if case == "cloudgan_plateau" and i == 2:
                lr = 0.5 * (model.disc_lr if half == "d" else model.gen_lr)
                opt_state = jax_schedules.rewrite_learning_rate(opt_state, lr)
                schedules.rewrite_learning_rate(getattr(state, half).optimizer, lr)
            grads = [np.asarray(rs.randn(*p.shape), np.float32) for p in params]
            updates, opt_state = update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            for p, g in zip(net.parameters(), grads):
                p.grad = torch.from_numpy(g.copy())
            state.apply_d() if half == "d" else state.apply_g()
        for p, want in zip(net.parameters(), params):
            want = np.asarray(want)
            lr = max(model.gen_lr, model.disc_lr)
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                       atol=1e-4 * lr + 1e-6 * np.abs(want).max())
    assert state.step == 3 and state.g.step == 3


def test_plateau_scheduler_matches_jax_and_scales_each_base_rate():
    """``PlateauScheduler`` fed the same metrics as the JAX one gives the
    same scales (patience, factor, the ``min_lr`` floor); the engine's
    ``_plateau_step`` on ``val/g_loss`` rewrites the generator's and the
    discriminator's rates from their own base rates."""
    kw = dict(base_lr=1e-3, factor=0.5, patience=1, min_lr=2e-4)
    mine, ref = schedules.PlateauScheduler(**kw), jax_schedules.PlateauScheduler(**kw)
    for metric in (1.0, 0.9, 0.95, 0.97, 0.91, 0.99, 0.98, 0.97, 0.96, 0.95, 0.8):
        assert mine.update(metric) == ref.update(metric)
        assert mine.lr == ref.lr
    assert mine.scale == 0.2  # clamped at min_lr / base_lr

    model = registry.create_model("cloudgan", **dict(CLOUDGAN_KW, lr_epochs=2))
    model.disc_lr = 4e-4  # another base rate than the generator's 2e-4
    trainer = Trainer(max_steps=1, device="cpu", check_val_every_n_epoch=10)
    trainer.fit(model, SatFlowDataModule(**DM_KW))
    for metric in (1.0, 1.1, 1.2):
        trainer._plateau_step({"val/g_loss": metric, "val/loss": 0.0})
    assert trainer.state.g.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)
    assert trainer.state.d.optimizer.param_groups[0]["lr"] == pytest.approx(2e-4)


# -- the engine -------------------------------------------------------------------------


def test_fit_validate_and_scale_batch_size_on_the_fake_datamodule():
    """``Trainer.fit`` of DGMR (``disc_steps`` 2) for two rounds: the JAX
    metric keys (``train/d_*``, ``train/g_*``, ``val/g_loss``, per-lead
    ``val/g_frame_{f}_loss``), finite losses, ``step`` 4; ``validate``
    moves no weight, statistic or spectral vector; ``scale_batch_size``
    probes whole rounds on a copy (the model's weights stay)."""
    model = _dgmr()
    dm = SatFlowDataModule(**DM_KW)
    trainer = Trainer(max_steps=2, device="cpu", log_every_n_steps=1)
    out = trainer.fit(model, dm)
    assert trainer.state.step == 4 and trainer.global_step == 2
    assert {"val/d_loss", "val/g_loss", "val/g_grid_reg", "val/g_frame_1_loss"} <= set(out)
    assert all(np.isfinite(v) for v in out.values())
    logged = set().union(*(set(r) for r in trainer.history.history))
    assert {"train/d_loss", "train/d_real_loss", "train/g_loss", "train/g_adv_loss"} <= logged
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer.validate(model, dm)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert Trainer(device="cpu").scale_batch_size(model, dm, init_val=1, max_trials=2) == 2
    assert dm.batch_size == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_fit_in_bf16_and_split_mode():
    """CloudGAN's ConvLSTM generator (the plain step on the CPU) trained a
    round in ``precision="bf16"`` with ``gan_step_mode="split"``: both
    networks compute in bfloat16, the f32 weights move, the losses are
    finite."""
    model = registry.create_model("cloudgan", **dict(CLOUDGAN_KW, generator_model="convlstm",
                                                     condition_time=True))
    trainer = Trainer(max_steps=1, device="cpu", precision="bf16", gan_step_mode="split")
    out = trainer.fit(model, SatFlowDataModule(**DM_KW))
    assert model.module.dtype == torch.bfloat16 and model.disc_module.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert np.isfinite(out["val/g_loss"]) and np.isfinite(out["val/d_loss"])


@pytest.fixture(scope="module")
def checkpointed(tmp_path_factory):
    """DGMR trained 2 rounds through ``ModelCheckpoint`` (monitoring
    ``val/g_loss``), then resumed for 2 more, and the uninterrupted 4-round
    run."""
    root = tmp_path_factory.mktemp("gan_ck")
    ck = str(root / "ck")
    first = _dgmr(seed=3)
    Trainer(max_steps=2, device="cpu", seed=7,
            callbacks=[ModelCheckpoint(dirpath=ck, monitor="val/g_loss")]).fit(
        first, SatFlowDataModule(**DM_KW))
    resumed_model = _dgmr(seed=99)
    resumed = Trainer(max_steps=4, max_epochs=2, device="cpu", seed=7,
                      resume_from_checkpoint=os.path.join(ck, "last"))
    resumed.fit(resumed_model, SatFlowDataModule(**DM_KW))
    straight_model = _dgmr(seed=3)
    straight = Trainer(max_steps=4, max_epochs=2, device="cpu", seed=7)
    straight.fit(straight_model, SatFlowDataModule(**DM_KW))
    return root, ck, resumed, straight


def test_checkpoint_holds_both_networks_and_resume_is_bit_equal(checkpointed):
    """The GAN checkpoint: ``hparams.json`` as the JAX package writes it
    (the model's hparams, the monitored metrics) and ``state.pt`` with both
    networks (``module.*``, ``disc_module.*``, the spectral vectors), both
    optimizers and the noise generator; the resumed run equals the
    uninterrupted one bit for bit (weights, ``u``, both Adams, step)."""
    root, ck, resumed, straight = checkpointed
    meta = json.load(open(os.path.join(ck, "best", "hparams.json")))
    assert meta["hparams"] == _dgmr().hparams() and "val/g_loss" in meta["metrics"]
    saved = torch.load(os.path.join(ck, "last", "state.pt"), weights_only=True)
    assert {"model", "g", "d", "noise", "step"} <= set(saved)
    keys = set(saved["model"])
    assert any(k.startswith("module.") for k in keys)
    assert any(k.startswith("disc_module.") and k.endswith("sn.u") for k in keys)
    assert resumed.state.step == straight.state.step == 8
    a, b = resumed.state.state_dict(), straight.state.state_dict()
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for half in ("g", "d"):
        for i, s in a[half]["optimizer"]["state"].items():
            for name in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(s[name], b[half]["optimizer"]["state"][i][name]), (half, i)
    assert torch.equal(a["noise"], b["noise"])


def test_local_serving_samples_the_generator(checkpointed):
    """``local:`` rebuilds the GAN and a session serves its generator: the
    n-th call of any session draws from a generator seeded n (two sessions
    agree, and equal ``model.sample`` with that seed), a second call draws
    fresh samples; int8 and ``donate`` are refused, as in JAX."""
    _, ck, _, _ = checkpointed
    source = "local:" + os.path.join(ck, "last")
    x = np.random.RandomState(5).rand(3, 4, 32, 32, 1).astype(np.float32)
    s1 = InferenceSession(source, max_batch=4, device="cpu")
    s2 = InferenceSession(source, max_batch=4, device="cpu")
    first = s1.predict(x)
    assert first.shape == (3, 2, 32, 32, 1) and np.isfinite(first).all()
    np.testing.assert_array_equal(first, s2.predict(x))
    assert np.abs(s1.predict(x) - first).max() > 1e-3
    model = registry.create_model(source)
    pad = np.concatenate([x, np.zeros_like(x[:1])])
    with torch.no_grad():
        want = model.sample(torch.from_numpy(pad), torch.Generator().manual_seed(0))[:3]
    np.testing.assert_array_equal(first, want.numpy())
    with pytest.raises(ValueError, match="int8"):
        InferenceSession(source, device="cpu", quantize="int8")
    with pytest.raises(ValueError, match="donate"):
        InferenceSession(source, device="cpu", donate=True)


def test_session_takes_the_generator_subtree_of_gan_variables():
    """``variables=`` in a GAN checkpoint's layout (``{'params':
    {'generator', 'discriminator'}, 'g', 'd'}``) loads the generator's
    params and spectral vectors into the served module."""
    from satflow_tpu_torch.interop.jax_weights import flax_tree_state_dict

    jmodel = jax_registry.create_model("nowcastinggan", **DGMR_KW)
    g, d = jax.eval_shape(jmodel.init_gan_variables, jax.random.PRNGKey(0),
                          tuple(t.numpy() for t in _batch()))
    rs = np.random.RandomState(6)
    g, d = jax.tree_util.tree_map(lambda s: np.asarray(rs.randn(*s.shape), np.float32), (g, d))
    variables = {"params": {"generator": g["params"], "discriminator": d["params"]},
                 "g": {"spectral": g["spectral"]}, "d": {"spectral": d["spectral"]}}
    session = InferenceSession(_dgmr(), variables=variables, device="cpu", max_batch=1)
    want = flax_tree_state_dict(g)
    for k, v in session.model.module.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_eval_ensemble_and_export_on_a_gan_checkpoint(checkpointed, capsys):
    """``python -m satflow_tpu_torch.eval.evaluate --ensemble 2`` on the GAN
    checkpoint: CRPS and MSE curves per lead time; the export CLI refuses a
    GAN, as the JAX one does."""
    from satflow_tpu_torch.eval import evaluate
    from satflow_tpu_torch.serve import export

    root, ck, _, _ = checkpointed
    out = str(root / "eval")
    evaluate.main(["--checkpoint", os.path.join(ck, "best"), "--ensemble", "2", "--dataset",
                   "fake", "--size", "32", "--channels", "1", "--history-minutes", "15",
                   "--batches", "1", "--output", out, "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(summary["crps_mean"]) and summary["sample_std"] > 0
    assert np.load(os.path.join(out, "crps.npy")).shape == (2,)
    with pytest.raises(SystemExit, match="GAN"):
        export.main(["local:" + os.path.join(ck, "best"), str(root / "gan.pt2"),
                     "--device", "cpu"])


def test_experiment_nowcasting_gan_simple_through_the_cli(tmp_path):
    """``python -m satflow_tpu_torch.run experiment=nowcasting_gan_simple``
    on the CPU at a tiny size: the default model config's ``out_channels``,
    ``hidden_dim``, ``lr`` and ``loss`` dropped from DGMR's node (the JAX
    package raises TypeError on them), the checkpoint monitored on
    ``val/g_loss``, the GAN metrics logged."""
    out = subprocess.run(
        [sys.executable, "-m", "satflow_tpu_torch.run", "experiment=nowcasting_gan_simple",
         "trainer.device=cpu", "trainer.max_steps=1", "trainer.max_epochs=1",
         "model.forecast_steps=2", "model.context_channels=32", "model.latent_channels=32",
         "model.num_samples=2", "datamodule.forecast_minutes=10",
         "datamodule.history_minutes=15", "datamodule.n_train_data=1",
         "datamodule.n_val_data=1", "work_dir=runs", "print_config=false"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "takes no out_channels, hidden_dim, lr, loss" in out.stderr + out.stdout
    csvs = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path) for f in fs
            if f == "metrics.csv"]
    header = open(csvs[0]).read().splitlines()[0].split(",")
    assert {"train/d_loss", "train/g_loss", "val/g_loss", "test/g_loss"} <= set(header)
    run = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(csvs[0]))))
    meta = json.load(open(os.path.join(run, "checkpoints", "best", "hparams.json")))
    assert meta["hparams"]["class"] == "NowcastingGAN" and "val/g_loss" in meta["metrics"]


# -- CRPS fine-tune ------------------------------------------------------------------


def test_fair_crps_loss_matches_jax():
    """The fine-tune's loss, the mean fair CRPS of (B, M, T, H, W, C)
    samples, and its gradient with respect to the samples against JAX's
    ``crps_ensemble(fair=True)``: float32 at 1e-5 x max|ref|."""
    rs = np.random.RandomState(7)
    samples = rs.rand(2, 3, 2, 8, 8, 1).astype(np.float32)
    y = rs.rand(2, 2, 8, 8, 1).astype(np.float32)
    want, grad = jax.value_and_grad(
        lambda s: jnp.mean(jax_crps_ensemble(s, y, fair=True)))(samples)
    s = torch.from_numpy(samples).requires_grad_(True)
    got = fair_crps_loss(s, torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(grad), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(grad)).max())


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_crps_finetune_moves_params_only(schedule):
    """Three fine-tune steps of DGMR's generator: finite losses recorded,
    every generator parameter with a gradient moved, the discriminator and every spectral
    vector untouched, ``eval_fn`` called at the end; fewer than two samples
    raise ValueError."""
    model = _dgmr(seed=1)
    model.materialize(_batch())
    with torch.no_grad():  # an open attention gate: its projections get gradients
        model.module.latent_stack.attn.gamma.fill_(0.5)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model, history = crps_finetune(model, [_batch(1), _batch(2)], steps=3, num_samples=2,
                                   lr=1e-3, lr_schedule=schedule, log_every=1,
                                   eval_fn=lambda m: 1.0, eval_every=2)
    assert len(history) == 4 and all(np.isfinite(history))
    assert [s for s, _ in history.frontier] == [2, 3]
    # on the 1x1 latent grid of 32² inputs the latent attention's softmax has
    # one position: its query and key get no gradient
    params = {f"module.{k}" for k, _ in model.module.named_parameters()
              if not k.startswith(("latent_stack.attn.query", "latent_stack.attn.key"))}
    frozen_qk = {f"module.latent_stack.attn.{n}.{p}" for n in ("query", "key")
                 for p in ("weight", "bias")}
    for k, v in model.state_dict().items():
        if k in frozen_qk:
            continue
        assert torch.equal(v, before[k]) != (k in params), k
    with pytest.raises(ValueError):
        crps_finetune(model, [_batch()], steps=1, num_samples=1)


# -- no jax ------------------------------------------------------------------------------


def test_gan_modules_import_no_jax(tmp_path):
    """A process that imports every module of the GAN slice, builds the
    three GAN models, trains a DGMR round through the Trainer and samples
    it through a session imports neither jax, flax, optax nor any module of
    the JAX package."""
    code = textwrap.dedent(f"""
        import sys
        import torch
        import satflow_tpu_torch.models
        import satflow_tpu_torch.nn
        from satflow_tpu_torch.core.registry import create_model
        from satflow_tpu_torch.data.datamodule import SatFlowDataModule
        from satflow_tpu_torch.interop.jax_weights import gan_state_dict_from_flax
        from satflow_tpu_torch.models import dgmr, cloudgan, pix2pix, gan_base
        from satflow_tpu_torch.nn import dgmr_blocks, gan, norm
        from satflow_tpu_torch.serve.session import InferenceSession
        from satflow_tpu_torch.train import Trainer
        from satflow_tpu_torch.train.probabilistic import crps_finetune

        model = create_model("nowcastinggan", **{DGMR_KW!r})
        Trainer(max_steps=1, device="cpu").fit(model, SatFlowDataModule(**{DM_KW!r}))
        model.restored_from = "in memory"
        InferenceSession(model, device="cpu", max_batch=1).predict(
            torch.rand(1, 4, 32, 32, 1).numpy())
        create_model("cloudgan", **{CLOUDGAN_KW!r})
        create_model("pix2pix", forecast_steps=2, input_channels=1, channels_per_timestep=1)
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "satflow_tpu")))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
