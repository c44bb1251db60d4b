"""PyTorch port, the JAX package's slow accuracy gates on the port's Trainer
(``tests/test_accuracy.py``'s recipes and bars, trained on the CPU): a
trained model must beat optical flow, which must beat persistence, on the
gate's held-out decaying advection (16 px, 1 channel, 6 lead times, decay
0.8).

- the channels-stacked family, ``test_accuracy.py:112-149``: U-Net,
  R2U-Net, Attention U-Net, FCN, DeepLabV3, PixelCNN;
- CloudGAN, ``:152-187``: its ConvLSTM generator, lsgan + 100 x L1, and the
  discriminator neither won nor diverged (``0.02 < d_loss < 2``);
- Pix2Pix, ``:190-224``: ``resnet_6blocks`` against a 2-layer PatchGAN, the
  same bars;
- the FCN case once more from the JAX Trainer's initial weights, and at four
  initial draws of each package (JAX misses flow at some of its keys, the
  port passes at some of its draws);
- the accuracy gate's 32-px study arms that the port's card run with cuDNN's
  TF32 trained above flow (R2U-Net, R2AttU-Net, FCN), from the JAX Trainer's
  initial weights at the study's budgets (and FCN from the port's own
  draw), and ``gan_gate``'s DGMR arm in both packages from the JAX initial
  weights at a cut budget.

Marked ``slow``, as their JAX counterparts: ``python -m pytest
tests/test_torch_accuracy_gates.py -m slow -n 8 -p xdist``.
"""

import numpy as np
import pytest
import torch

import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.baseline.optical_flow import run_baseline
from satflow_tpu_torch.core.registry import create_model
from satflow_tpu_torch.data.fake import DecayingAdvectionDataset
from satflow_tpu_torch.eval.evaluate import evaluate_model
from satflow_tpu_torch.tools.studies import study_dm
from satflow_tpu_torch.train import Trainer

# tests/test_accuracy.py's DS_KW: decay 0.8 makes the learnable intensity
# decay dominate the error budget
DS_KW = dict(batch_size=8, width=16, height=16, number_sat_channels=1,
             history_minutes=15, forecast_minutes=30, velocity=(1, 1),
             decay=0.8, n_blobs=3)
STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread a process: these tensors are small, and the
    gates run side by side under xdist, where threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _eval_ds():
    return DecayingAdvectionDataset(length=2, seed=300, **DS_KW)


def _baselines(eval_ds):
    base = run_baseline(eval_ds, forecast_steps=STEPS, flow_method="farneback",
                        max_batches=2, device="cpu")
    persist = float(np.mean(base["baseline_loss"]))
    flow = float(np.mean(base["flow_loss"]))
    assert flow < persist  # the flow arm must be functioning
    return persist, flow


def _fit_and_score(model, epochs, eval_ds):
    trainer = Trainer(max_epochs=epochs, log_every_n_steps=1000, device="cpu")
    trainer.fit(model, study_dm(DecayingAdvectionDataset, DS_KW, 8))
    curves = evaluate_model(model, eval_ds, max_batches=2, compute_ms_ssim=False)
    return float(np.mean(curves["mse"])), trainer


@pytest.mark.parametrize("name,epochs,extra", [
    ("unet", 40, dict(features_start=32, depth=3)),
    ("runet", 60, dict(features_start=32, depth=3)),
    ("attentionunet", 40, dict(features_start=32, depth=3)),
    ("fcn", 40, {}),
    ("deeplabv3", 40, {}),
    ("pixelcnn", 20, {}),
])
@pytest.mark.slow
def test_port_trained_unet_family_beats_persistence_and_flow(name, epochs, extra):
    eval_ds = _eval_ds()
    persist_mse, flow_mse = _baselines(eval_ds)
    model = create_model(name, input_channels=4, forecast_steps=STEPS, channels_per_timestep=1,
                         lr=3e-3, generator=torch.Generator().manual_seed(0), **extra)
    model_mse, _ = _fit_and_score(model, epochs, eval_ds)
    assert model_mse < flow_mse < persist_mse, (
        f"expected {name} ({model_mse:.4f}) < flow ({flow_mse:.4f}) "
        f"< persistence ({persist_mse:.4f})")


def _gan_gate(recipe):
    eval_ds = _eval_ds()
    persist_mse, flow_mse = _baselines(eval_ds)
    model = create_model(generator=torch.Generator().manual_seed(0), **recipe)
    gen_mse, trainer = _fit_and_score(model, 12, eval_ds)
    assert gen_mse < flow_mse < persist_mse, (
        f"expected generator ({gen_mse:.4f}) < flow ({flow_mse:.4f}) "
        f"< persistence ({persist_mse:.4f})")
    # adversarial health: D neither dead / won (-> 0) nor diverged
    d_loss = trainer.callback_metrics["train/d_loss"]
    assert 0.02 < d_loss < 2.0, f"discriminator collapsed/diverged: {d_loss}"
    assert np.isfinite(trainer.callback_metrics["train/g_adv_loss"])


@pytest.mark.slow
def test_port_trained_cloudgan_beats_baselines_without_collapse():
    _gan_gate(dict(name="cloudgan", forecast_steps=STEPS, input_channels=1,
                   channels_per_timestep=1, generator_model="convlstm", num_filters=16,
                   lr=2e-3, lambda_l1=100.0, loss="lsgan"))


@pytest.mark.slow
def test_port_trained_pix2pix_beats_baselines_without_collapse():
    _gan_gate(dict(name="pix2pix", forecast_steps=STEPS, input_channels=4,
                   channels_per_timestep=1, generator_model="resnet_6blocks",
                   discriminator_model="n_layers", discriminator_layers=2, num_filters=16,
                   lr=2e-3, lambda_l1=100.0, loss="lsgan"))


@pytest.mark.slow
def test_port_trained_fcn_from_the_jax_init_beats_persistence_and_flow():
    """The FCN gate's recipe started from the JAX Trainer's own initial
    weights (``init_variables(PRNGKey(0), first batch)`` of the JAX model,
    loaded through ``state_dict_from_flax``): the port's Trainer takes them
    below flow, as the JAX gate's run does, so the FCN case above is a
    matter of the initial draw, not of the training path."""
    import jax

    import satflow_tpu.models  # noqa: F401 - populate the JAX registry
    from satflow_tpu.core import registry as jax_registry
    from satflow_tpu.data.fake import DecayingAdvectionDataset as JaxDataset

    eval_ds = _eval_ds()
    persist_mse, flow_mse = _baselines(eval_ds)
    kw = dict(input_channels=4, forecast_steps=STEPS, channels_per_timestep=1, lr=3e-3)
    first = JaxDataset(length=8, seed=0, **DS_KW)[0]  # the JAX Trainer's first batch
    variables = jax.tree_util.tree_map(np.asarray, jax_registry.create_model(
        "fcn", **kw).init_variables(jax.random.PRNGKey(0), first))
    model = create_model("fcn", **kw)
    model.module.load_state_dict(model.state_dict_from_flax(variables))
    model_mse, _ = _fit_and_score(model, 40, eval_ds)
    assert model_mse < flow_mse < persist_mse, (
        f"expected fcn ({model_mse:.4f}) < flow ({flow_mse:.4f}) < persistence "
        f"({persist_mse:.4f})")


def _jax_fcn_gate_mse(seed):
    """The JAX gate's FCN case (``tests/test_accuracy.py:112-149``) trained
    by the JAX Trainer at ``seed``: its held-out MSE."""
    import satflow_tpu.models  # noqa: F401 - populate the JAX registry
    from satflow_tpu.core.registry import create_model as jax_create_model
    from satflow_tpu.data.datamodule import SatFlowDataModule
    from satflow_tpu.data.fake import DecayingAdvectionDataset as JaxDataset
    from satflow_tpu.eval.evaluate import evaluate_model as jax_evaluate_model
    from satflow_tpu.train.engine import Trainer as JaxTrainer

    class DecayDM(SatFlowDataModule):
        def __init__(self):
            super().__init__(fake_data=True, num_workers=0, shard=False)

        def _dataset(self, split, n):
            return JaxDataset(length=8, seed={"train": 0, "validation": 100, "test": 200}[split],
                              **DS_KW)

    model = jax_create_model("fcn", input_channels=4, forecast_steps=STEPS,
                             channels_per_timestep=1, lr=3e-3)
    trainer = JaxTrainer(max_epochs=40, log_every_n_steps=1000, seed=seed)
    trainer.fit(model, DecayDM())
    variables = {"params": trainer.state.params, **trainer.state.model_state}
    jax_eval = JaxDataset(length=2, seed=300, **DS_KW)
    return float(np.mean(jax_evaluate_model(model, variables, jax_eval, max_batches=2,
                                            compute_ms_ssim=False)["mse"]))


def _port_fcn_gate_mse(seed):
    model = create_model("fcn", input_channels=4, forecast_steps=STEPS, channels_per_timestep=1,
                         lr=3e-3, generator=torch.Generator().manual_seed(seed))
    return _fit_and_score(model, 40, _eval_ds())[0]


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.slow
def test_fcn_gate_recipe_at_four_draws(package):
    """The FCN gate's recipe at four initial draws of each package, the JAX
    Trainer at ``seed`` 0-3 and the port's at ``torch.Generator`` seeds 0-3
    (~300-550 s a draw on one core). The JAX package misses flow at some of
    its own keys, so its gate's single-draw bar is its design; the port
    reaches the bar at some draw. Measured: JAX 0.00537, 0.02860, 0.01233,
    0.00533; the port 0.00787, 0.00560, 0.01424, 0.01077; flow 0.00713,
    persistence 0.01826. The draws print."""
    _, flow_mse = _baselines(_eval_ds())
    draw = _jax_fcn_gate_mse if package == "jax" else _port_fcn_gate_mse
    mses = [draw(seed) for seed in range(4)]
    print(f"{package} FCN gate draws, seeds 0-3: {mses}; flow {flow_mse}")
    if package == "jax":
        assert max(mses) > flow_mse, (mses, flow_mse)
    else:
        assert min(mses) < flow_mse, (mses, flow_mse)


def _jax_init(name, first, **kw):
    """The JAX Trainer's initial variables of ``name`` (``init_variables``
    at ``PRNGKey(0)`` on the first training batch), as numpy."""
    import jax

    import satflow_tpu.models  # noqa: F401 - populate the JAX registry
    from satflow_tpu.core import registry as jax_registry

    return jax.tree_util.tree_map(np.asarray, jax_registry.create_model(name, **kw)
                                  .init_variables(jax.random.PRNGKey(0), first))


@pytest.mark.parametrize("arm,init", [("runet", "jax"), ("attentionrunet", "jax"),
                                       ("fcn", "jax"), ("fcn", "port")])
@pytest.mark.slow
def test_port_trained_study_arm_beats_flow_on_the_cpu(arm, init):
    """The accuracy gate's 32-px study arms whose card run with cuDNN's TF32
    missed flow, trained by the port's Trainer on the CPU at the study's
    recipe and budget (10-35 min an arm on one core): from the JAX Trainer's
    initial weights (``init="jax"``), below flow as the JAX study's run is
    (runet 0.00654, attentionrunet 0.00820, fcn 0.00711 in
    ``docs/accuracy_results.json``); and FCN from the port's own draw
    (``init="port"``, the card run's weights), below flow on the CPU where
    the card's TF32 run ended at 0.01035. The final MSE prints."""
    from satflow_tpu.data.fake import DecayingAdvectionDataset as JaxDataset
    from satflow_tpu_torch.tools import accuracy_gate

    epochs, lr, extra = accuracy_gate.STACKED_ARMS[arm]
    kw = dict(input_channels=8, forecast_steps=accuracy_gate.STEPS, channels_per_timestep=2,
              lr=lr, **extra)
    if init == "jax":
        variables = _jax_init(arm, JaxDataset(length=12, seed=0, **accuracy_gate.DS_KW)[0], **kw)
        model = create_model(arm, **kw)
        model.module.load_state_dict(model.state_dict_from_flax(variables))
    else:
        model = create_model(arm, generator=torch.Generator().manual_seed(0), **kw)
    eval_ds = DecayingAdvectionDataset(length=3, seed=300, **accuracy_gate.DS_KW)
    base = run_baseline(eval_ds, forecast_steps=accuracy_gate.STEPS, flow_method="farneback",
                        max_batches=3, device="cpu")
    flow = float(np.mean(base["flow_loss"]))
    trainer = Trainer(max_epochs=epochs, log_every_n_steps=1000, device="cpu")
    trainer.fit(model, study_dm(DecayingAdvectionDataset, accuracy_gate.DS_KW, 12))
    mse = float(np.mean(evaluate_model(model, eval_ds, max_batches=3,
                                       compute_ms_ssim=False)["mse"]))
    print(f"{arm} from the {init} init, {epochs} epochs on the CPU: MSE {mse:.6f}, flow {flow:.6f}")
    assert mse < flow, f"{arm} from the {init} init: {mse:.5f}, flow {flow:.5f}"


@pytest.mark.slow
def test_port_dgmr_arm_from_the_jax_init_lands_beside_jax(tmp_path, monkeypatch):
    """``gan_gate``'s DGMR arm in both packages from the JAX Trainer's
    initial weights (captured from the JAX run, loaded through
    ``gan_state_dict_from_flax``) at a cut budget: 20 epochs of 12 rounds,
    CRPS selection, a 400-step M=8 fair-CRPS fine-tune (~7 min a package on
    the CPU). The noise streams differ, so the two runs agree in law, not
    bit for bit: the fine-tuned fair CRPS within 10 % of JAX's, the MSE
    within 10 %, the spread within a factor of two. Measured (one thread a
    process): JAX 0.023660, 0.007197, 0.010135; the port 0.023497, 0.007309,
    0.013270. The numbers print."""
    import importlib.util
    import json
    import os

    import jax
    import satflow_tpu.models.dgmr as jax_dgmr
    from flax.core import unfreeze

    import satflow_tpu_torch.core.registry as port_registry
    from satflow_tpu_torch.interop.jax_weights import gan_state_dict_from_flax
    from satflow_tpu_torch.tools import gan_gate

    for k, v in (("SATFLOW_DGMR_EPOCHS", "20"), ("SATFLOW_DGMR_FT_STEPS", "400"),
                 ("SATFLOW_DGMR_FT_SAMPLES", "8")):
        monkeypatch.setenv(k, v)
    init, captured = jax_dgmr.NowcastingGAN.init_gan_variables, []

    def capture(self, rng, batch):
        g, d = init(self, rng, batch)
        # copied out at once: the JAX step donates the buffers it is given
        captured.append(jax.tree_util.tree_map(np.array, (unfreeze(g), unfreeze(d))))
        return g, d

    monkeypatch.setattr(jax_dgmr.NowcastingGAN, "init_gan_variables", capture)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_gan_gate", os.path.join(repo, "tools", "gan_gate.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    monkeypatch.chdir(tmp_path)  # the JAX tool writes docs/ under the working directory
    jax_tool.main(["dgmr"])
    with open(tmp_path / "docs" / "gan_results.json") as f:
        want = json.load(f)["dgmr_crps_finetuned"]

    g, d = captured[0]
    create = port_registry.create_model

    def from_jax_init(name, **kw):
        model = create(name, **kw)
        model.load_state_dict(gan_state_dict_from_flax(g, d))
        return model

    monkeypatch.setattr(port_registry, "create_model", from_jax_init)
    got = gan_gate.main(["dgmr"], out=str(tmp_path / "port"), device="cpu")
    got = got["dgmr_crps_finetuned"]
    assert got["finetune_steps"] == 400
    print("fine-tuned (fair CRPS, MSE, spread): JAX", [want[k] for k in (
        "crps_fair_m8", "mse", "sample_std")], "port", [got[k] for k in (
        "crps_fair_m8", "mse", "sample_std")])
    assert abs(got["crps_fair_m8"] / want["crps_fair_m8"] - 1) < 0.1, (got, want)
    assert abs(got["mse"] / want["mse"] - 1) < 0.1, (got, want)
    assert 0.5 < got["sample_std"] / want["sample_std"] < 2, (got, want)
