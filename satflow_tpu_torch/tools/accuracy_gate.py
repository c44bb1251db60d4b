"""Accuracy gate of the port: train a model on decaying advection and score
it against persistence and optical flow, per lead time.

The port's copy of the JAX package's ``tools/accuracy_gate.py``, with its
data (``DS_KW``, ``STEPS``, the ``DecayDM`` seeds, the eval set of 3 batches
at seed 300) and its recipe. Ported arms: ``baselines`` (persistence, the
Farneback flow as :func:`~satflow_tpu_torch.ops.flow.farneback_backend`
resolves it, and Horn–Schunck), ``convlstm`` (hidden 32, lr 3e-3, 30
epochs), ``perceiver`` (``PERCEIVER``: LAMB under ``warmup_cosine``, every
lead time decoded at once, 60 epochs) and the channels-stacked zoo
(``STACKED_ARMS``: the U-Net family, FCN, DeepLabV3, PixelCNN), each at the
JAX tool's recipe. The other arms raise ``NotImplementedError`` naming the
ROADMAP item that ports them.

    python -m satflow_tpu_torch.tools.accuracy_gate [--arms baselines,convlstm]
        [--out DIR] [--device cuda]

It prints the results as one JSON object and writes them only under
``--out`` (``accuracy_results.json``); it never touches the JAX study's
``docs/accuracy_results.json`` or ``docs/ACCURACY.md``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

DS_KW = dict(batch_size=8, width=32, height=32, number_sat_channels=2,
             history_minutes=15, forecast_minutes=60, velocity=(1, 2),
             decay=0.93, n_blobs=4)
STEPS = 12
SPLIT_SEEDS = {"train": 0, "validation": 100, "test": 200}
CONVLSTM_EPOCHS = 30

ALL_ARMS = ("baselines", "convlstm", "perceiver", "metnet", "metnet_stoch",
            "unet", "runet", "attentionunet", "attentionrunet", "fcn",
            "deeplabv3", "pixelcnn")
EXTRA_ARMS = ("metnet_baselines",)
PORTED_ARMS = ("baselines", "convlstm", "perceiver", "unet", "runet", "attentionunet", "attentionrunet",
               "fcn", "deeplabv3", "pixelcnn")
# the other arms, by the ROADMAP queue 1 item that ports them
UNPORTED_ARMS = {"metnet": 7, "metnet_stoch": 7, "metnet_baselines": 7}
# the Perceiver arm, the JAX tool's recipe: (epochs, model keywords); at
# full resolution like the ConvLSTM, 12 batches an epoch
PERCEIVER_EPOCHS = 60
PERCEIVER = dict(input_channels=2, sat_channels=2, base_channels=1, input_size=32,
                 forecast_steps=STEPS, history_steps=4, depth=3, num_latents=64,
                 latent_dim=128, dim=48, queries_dim=48, num_freq_bands=16,
                 predict_timesteps_together=True, lr=2e-3, warmup_steps=100)
# the channels-stacked arms, the JAX tool's recipes: (epochs, lr, model
# keywords); all lead times as output channels, 4 x 2 input channels stacked
STACKED_ARMS = {
    "unet": (60, 3e-3, dict(features_start=32, depth=3)),
    "runet": (100, 3e-3, dict(features_start=32, depth=3)),
    "attentionunet": (60, 3e-3, dict(features_start=32, depth=3)),
    "attentionrunet": (200, 3e-3, dict(features_start=64, depth=3)),
    "fcn": (60, 3e-3, {}),
    "deeplabv3": (150, 1e-3, {}),
    "pixelcnn": (40, 1e-3, {}),
}


def make_dm():
    """The training data module: ``DecayingAdvectionDataset`` of 12 batches
    per split at the split's seed."""
    from satflow_tpu_torch.data.datamodule import SatFlowDataModule
    from satflow_tpu_torch.data.fake import DecayingAdvectionDataset

    class DecayDM(SatFlowDataModule):
        def __init__(self):
            super().__init__(fake_data=True, num_workers=0, shard=False)

        def _dataset(self, split, n):
            return DecayingAdvectionDataset(length=12, seed=SPLIT_SEEDS[split], **DS_KW)

    return DecayDM()


def _baseline_rows(base) -> Dict[str, Dict]:
    return {name: {"mse_t": np.mean(base[key], axis=0).tolist(),
                   "mse": float(np.mean(base[key]))}
            for name, key in (("persistence", "baseline_loss"), ("optical_flow", "flow_loss"))}


def main(arms: Optional[Iterable[str]] = None, out: Optional[str] = None,
         device="cuda") -> Dict[str, Dict]:
    """Run ``arms`` (default: the ported ones) on ``device``; returns the
    results and writes them under ``out`` if given."""
    from satflow_tpu_torch import resolve_device
    from satflow_tpu_torch.baseline.optical_flow import run_baseline
    from satflow_tpu_torch.core.registry import create_model
    from satflow_tpu_torch.data.fake import DecayingAdvectionDataset
    from satflow_tpu_torch.eval.evaluate import evaluate_model
    from satflow_tpu_torch.ops.flow import farneback_backend
    from satflow_tpu_torch.train import Trainer
    import satflow_tpu_torch.models  # noqa: F401 - populate the registry

    arms = set(arms or PORTED_ARMS)
    unknown = arms - set(ALL_ARMS) - set(EXTRA_ARMS)
    if unknown:
        raise SystemExit(f"unknown --arms {sorted(unknown)}; valid: {list(ALL_ARMS)}")
    unported = sorted(arms & set(UNPORTED_ARMS))
    if unported:
        raise NotImplementedError(
            "accuracy-gate arms " + ", ".join(
                f"{a!r} (ROADMAP queue 1 item {UNPORTED_ARMS[a]})" for a in unported)
            + " are not ported yet")
    device = resolve_device(device)
    eval_ds = DecayingAdvectionDataset(length=3, seed=300, **DS_KW)
    results: Dict[str, Dict] = {}

    if "baselines" in arms:
        base = run_baseline(eval_ds, forecast_steps=STEPS, flow_method="farneback",
                            max_batches=3, device=device)
        results.update(_baseline_rows(base))
        results["optical_flow"]["solve"] = farneback_backend()
        base_hs = run_baseline(eval_ds, forecast_steps=STEPS, flow_method="horn_schunck",
                               max_batches=3, device=device)
        results["optical_flow_hs"] = _baseline_rows(base_hs)["optical_flow"]

    # ConvLSTM: full resolution, directly against the baselines
    if "convlstm" in arms:
        model = create_model("encoderdecoderconvlstm", input_channels=2, out_channels=2,
                             forecast_steps=STEPS, hidden_dim=32, lr=3e-3,
                             generator=torch.Generator().manual_seed(0))
        trainer = Trainer(max_epochs=CONVLSTM_EPOCHS, log_every_n_steps=100, device=device)
        t0 = time.perf_counter()
        trainer.fit(model, make_dm())
        train_s = time.perf_counter() - t0
        curves = evaluate_model(model, eval_ds, max_batches=3, compute_ms_ssim=True)
        results["convlstm"] = {
            "mse_t": np.mean(curves["mse"], axis=0).tolist(),
            "mse": float(np.mean(curves["mse"])),
            "ms_ssim_t": np.asarray(curves["ms_ssim"]).tolist(),
            "ms_ssim": float(np.mean(curves["ms_ssim"])),
            "epochs": CONVLSTM_EPOCHS,
            "train_seconds": train_s,
        }

    arm_models = {}
    if "perceiver" in arms:
        arm_models["perceiver"] = (PERCEIVER_EPOCHS, 500, lambda: create_model(
            "perceiver", total_steps=PERCEIVER_EPOCHS * 12,
            generator=torch.Generator().manual_seed(0), **PERCEIVER))
    for name, (epochs, lr, extra) in STACKED_ARMS.items():
        if name in arms:
            arm_models[name] = (epochs, 2000, lambda name=name, lr=lr, extra=extra: create_model(
                name, input_channels=8, forecast_steps=STEPS, channels_per_timestep=2, lr=lr,
                generator=torch.Generator().manual_seed(0), **extra))
    for name, (epochs, log_every, make) in arm_models.items():
        model = make()
        trainer = Trainer(max_epochs=epochs, log_every_n_steps=log_every, device=device)
        t0 = time.perf_counter()
        trainer.fit(model, make_dm())
        train_s = time.perf_counter() - t0
        curves = evaluate_model(model, eval_ds, max_batches=3, compute_ms_ssim=True)
        results[name] = {
            "mse_t": np.mean(curves["mse"], axis=0).tolist(),
            "mse": float(np.mean(curves["mse"])),
            "ms_ssim_t": np.asarray(curves["ms_ssim"]).tolist(),
            "ms_ssim": float(np.mean(curves["ms_ssim"])),
            "epochs": epochs,
            "train_seconds": train_s,
        }

    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "accuracy_results.json"), "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arms", default=None,
                   help=f"comma list of arms; default: {','.join(PORTED_ARMS)}")
    p.add_argument("--out", default=None, help="directory for accuracy_results.json")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.arms.split(",") if a.arms else None, out=a.out, device=a.device)
