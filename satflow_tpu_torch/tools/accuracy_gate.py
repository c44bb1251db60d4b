"""Accuracy gate of the port: train a model on decaying advection and score
it against persistence and optical flow, per lead time.

The port's copy of the JAX package's ``tools/accuracy_gate.py``, with its
data (``DS_KW``, ``STEPS``, the split seeds, the eval set of 3 batches at
seed 300) and its recipes, every arm of it: ``baselines`` (persistence, the
Farneback flow as :func:`~satflow_tpu_torch.ops.flow.farneback_backend`
resolves it, and Horn–Schunck), ``convlstm`` (hidden 32, lr 3e-3, 30
epochs), ``perceiver`` (``PERCEIVER``: LAMB under ``warmup_cosine``, every
lead time decoded at once, 60 epochs), the channels-stacked zoo
(``STACKED_ARMS``: the U-Net family, FCN, DeepLabV3, PixelCNN) and MetNet
(``METNET``: ``litmetnet`` at 64 px, hidden 64, lr 2e-3 under
``warmup_cosine``, 150 epochs), which predicts the centre 16 px at a quarter
of the resolution and is therefore scored, with its baselines, on that
pooled 4x4 grid (``_to_metnet_grid``): ``metnet`` on decaying advection,
``metnet_stoch`` on ``StochasticAdvectionDataset`` (the future velocity
redrawn at the forecast boundary, where a trained model must beat both
baselines), ``metnet_baselines`` the grid baselines alone.

    python -m satflow_tpu_torch.tools.accuracy_gate [--arms baselines,convlstm]
        [--out DIR] [--device cuda]

It prints the results as one JSON object and writes them only under
``--out`` (``accuracy_results.json``, stamped with the card, and its
markdown section ``accuracy_results.md``), merging into the file it finds
there; it never touches the JAX study's ``docs/``.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Iterable, Optional

import torch

from satflow_tpu_torch.tools.studies import (  # SPLIT_SEEDS: the split seeds, re-exported
    SPLIT_SEEDS,  # noqa: F401
    baseline_rows,
    card_name,
    curve,
    full_f32,
    load_results,
    model_row,
    per_lead_table,
    save_results,
    study_dm,
)

DS_KW = dict(batch_size=8, width=32, height=32, number_sat_channels=2,
             history_minutes=15, forecast_minutes=60, velocity=(1, 2),
             decay=0.93, n_blobs=4)
STEPS = 12
CONVLSTM_EPOCHS = 30

ALL_ARMS = ("baselines", "convlstm", "perceiver", "metnet", "metnet_stoch",
            "unet", "runet", "attentionunet", "attentionrunet", "fcn",
            "deeplabv3", "pixelcnn")
EXTRA_ARMS = ("metnet_baselines",)
PORTED_ARMS = ALL_ARMS + EXTRA_ARMS
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
# the MetNet arms (metnet, metnet_stoch), the JAX tool's recipe: 64 px data
# (MetNet sees the centre crop at a quarter of the resolution), the warm-up
# short enough for the run (the default 1000 steps would last the study)
METNET_EPOCHS = 150
METNET = dict(input_channels=2, sat_channels=2, output_channels=2, input_size=64,
              forecast_steps=STEPS, hidden_dim=64, lr=2e-3, warmup_steps=100)
DS64 = dict(DS_KW, width=64, height=64)
RESULTS = "accuracy_results.json"


def _to_metnet_grid(frames):
    # (F, 64, 64) -> center-crop 16 -> avg-pool 4x -> (F, 4, 4); numpy
    # mirror of crop_center + _avg_pool_frames in the MetNet model
    f, h, w = frames.shape
    sh, sw = (h - 16) // 2, (w - 16) // 2
    crop = frames[:, sh:sh + 16, sw:sw + 16]
    return crop.reshape(f, 4, 4, 4, 4).mean(axis=(2, 4))


def main(arms: Optional[Iterable[str]] = None, out: Optional[str] = None,
         device="cuda", epochs: Optional[Dict[str, int]] = None,
         length: int = 12) -> Dict[str, Dict]:
    """Run ``arms`` (default: all of ``ALL_ARMS``) on ``device``; returns the
    results and writes them under ``out`` if given. ``epochs`` overrides an
    arm's budget (arm name -> epochs), ``length`` the batches of an epoch
    (the JAX tool's 12; a schedule's ``total_steps`` follows it)."""
    from satflow_tpu_torch import resolve_device
    from satflow_tpu_torch.baseline.optical_flow import run_baseline
    from satflow_tpu_torch.core.registry import create_model
    from satflow_tpu_torch.data.fake import DecayingAdvectionDataset, StochasticAdvectionDataset
    from satflow_tpu_torch.eval.evaluate import evaluate_model
    from satflow_tpu_torch.ops.flow import farneback_backend
    from satflow_tpu_torch.train import Trainer
    import satflow_tpu_torch.models  # noqa: F401 - populate the registry

    arms = set(arms or ALL_ARMS)
    unknown = arms - set(ALL_ARMS) - set(EXTRA_ARMS)
    if unknown:
        raise SystemExit(f"unknown --arms {sorted(unknown)}; valid: {list(ALL_ARMS)}")
    device = resolve_device(device)
    full_f32(device)
    card = card_name(device)
    budget = {"convlstm": CONVLSTM_EPOCHS, "perceiver": PERCEIVER_EPOCHS,
              "metnet": METNET_EPOCHS, "metnet_stoch": METNET_EPOCHS,
              **{name: v[0] for name, v in STACKED_ARMS.items()}, **(epochs or {})}
    eval_ds = DecayingAdvectionDataset(length=3, seed=300, **DS_KW)
    load_results(out, RESULTS, card)  # a file of another card raises before any training
    results = {}

    def seeded():
        return torch.Generator().manual_seed(0)

    def scheduled(recipe, arm):
        # a budget cut below the warm-up (a smoke run) warms up for half of it
        total = budget[arm] * length
        return {**recipe, "total_steps": total,
                "warmup_steps": min(recipe["warmup_steps"], total // 2)}

    def train_and_score(arm, model, log_every, dataset_cls=DecayingAdvectionDataset,
                        ds_kw=DS_KW, eval_set=eval_ds, row=None):
        """Fit ``model`` for the arm's budget, score it as ``row`` (the arm)."""
        trainer = Trainer(max_epochs=budget[arm], log_every_n_steps=log_every, device=device)
        t0 = time.perf_counter()
        trainer.fit(model, study_dm(dataset_cls, ds_kw, length))
        train_s = time.perf_counter() - t0
        curves = evaluate_model(model, eval_set, max_batches=3, compute_ms_ssim=True)
        results[row or arm] = {**model_row(curves, budget[arm]), "train_seconds": train_s}

    def grid_baselines(eval_set, suffix):
        results.update(baseline_rows(run_baseline(
            eval_set, forecast_steps=STEPS, flow_method="farneback", max_batches=3,
            target_view=_to_metnet_grid, device=device), suffix))

    if "baselines" in arms:
        base = run_baseline(eval_ds, forecast_steps=STEPS, flow_method="farneback",
                            max_batches=3, device=device)
        results.update(baseline_rows(base))
        results["optical_flow"]["solve"] = farneback_backend()
        base_hs = run_baseline(eval_ds, forecast_steps=STEPS, flow_method="horn_schunck",
                               max_batches=3, device=device)
        results["optical_flow_hs"] = curve(base_hs["flow_loss"])

    # ConvLSTM: full resolution, directly against the baselines
    if "convlstm" in arms:
        train_and_score("convlstm", create_model(
            "encoderdecoderconvlstm", input_channels=2, out_channels=2, forecast_steps=STEPS,
            hidden_dim=32, lr=3e-3, generator=seeded()), 100)

    if "perceiver" in arms:
        train_and_score("perceiver", create_model(
            "perceiver", generator=seeded(), **scheduled(PERCEIVER, "perceiver")), 500)
    for name, (_, lr, extra) in STACKED_ARMS.items():
        if name in arms:
            train_and_score(name, create_model(
                name, input_channels=8, forecast_steps=STEPS, channels_per_timestep=2, lr=lr,
                generator=seeded(), **extra), 2000)

    # MetNet predicts the centre quarter crop at 1/4 resolution, so its
    # baselines are scored on that pooled grid; the flow is still solved and
    # warped at input resolution (solving on the 4x4 grid would degenerate to
    # zero flow, i.e. persistence). On deterministic advection that flow is a
    # near-oracle at the grid; the stochastic arm is the three-way gate.
    if arms & {"metnet", "metnet_baselines"}:
        grid_baselines(DecayingAdvectionDataset(length=3, seed=300, **DS64), "@metnet_grid")
    for arm, dataset_cls, row in (("metnet", DecayingAdvectionDataset, "metnet"),
                                  ("metnet_stoch", StochasticAdvectionDataset, "metnet@stoch")):
        if arm not in arms:
            continue
        eval64 = dataset_cls(length=3, seed=300, **DS64)
        if arm == "metnet_stoch":
            grid_baselines(eval64, "@metnet_grid_stoch")
        train_and_score(arm, create_model(
            "litmetnet", generator=seeded(), **scheduled(METNET, arm)), 500,
            dataset_cls, DS64, eval64, row)

    results = save_results(out, RESULTS, results, card, _section)
    print(json.dumps(results), flush=True)
    return results


_FULL_RES = ("persistence", "optical_flow", "optical_flow_hs", "convlstm", "perceiver", "unet",
             "runet", "attentionunet", "attentionrunet", "fcn", "deeplabv3", "pixelcnn")
_METNET_GRID = ("persistence@metnet_grid", "optical_flow@metnet_grid", "metnet")
_METNET_STOCH = ("persistence@metnet_grid_stoch", "optical_flow@metnet_grid_stoch",
                 "metnet@stoch")


def _table(r, names):
    present = [n for n in names if n in r]
    if not present:
        return []
    lines = ["| Method | Mean MSE | Mean MS-SSIM | Training s |", "|---|---|---|---|"]
    for name in present:
        ms, sec = r[name].get("ms_ssim"), r[name].get("train_seconds")
        lines.append(f"| {name} | {r[name]['mse']:.5f} | {'-' if ms is None else f'{ms:.4f}'} "
                     f"| {'-' if sec is None else f'{sec:.1f}'} |")
    return lines + [""] + per_lead_table(r, present, len(r[present[0]]["mse_t"])) + [""]


def _section(r) -> str:
    """The study's section: the full-resolution arms, then MetNet at its
    pooled grid on the deterministic and the stochastic sets."""
    return "\n".join([
        "# Accuracy gate: trained models vs persistence and optical flow",
        "",
        "`python -m satflow_tpu_torch.tools.accuracy_gate`: the JAX study's data and recipes",
        "(`tools/accuracy_gate.py`) on the port. A trained model must beat both baselines.",
        "",
        "## Full resolution (32 px, 12 lead times)",
        "",
        *_table(r, _FULL_RES),
        "## MetNet at its output grid (64 px data, the centre 16 px pooled to 4x4)",
        "",
        "The flow is solved and warped at input resolution and only then pooled. On",
        "deterministic advection it is a near-oracle at the grid, so MetNet is held to",
        "persistence there, and to both baselines on the stochastic-future set below.",
        "",
        *_table(r, _METNET_GRID),
        *_table(r, _METNET_STOCH),
    ])


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arms", default=None,
                   help=f"comma list of arms of {','.join(PORTED_ARMS)}; default: "
                        f"{','.join(ALL_ARMS)}")
    p.add_argument("--out", default=None,
                   help="directory for accuracy_results.json (merged into) and its .md")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.arms.split(",") if a.arms else None, out=a.out, device=a.device)
