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
- the FCN case once more from the JAX Trainer's initial weights.

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
