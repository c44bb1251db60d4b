"""48-step horizon study: the reference's full evaluation length (4 hours at
5-minute cadence) at 64 px, trained models against persistence and flow.

The port's copy of the JAX package's ``tools/horizon_gate.py``: its data
(``DS48``: decaying advection at velocity (1, 1), decay 0.985, 4 history
frames, 48 lead times, torus wrap), eval sets (3 batches at seed 300) and
every arm of ``ALL_ARMS`` at its recipe: the baselines at full resolution
and at MetNet's pooled 4x4 grid; the ConvLSTM's autoregressive 48-step
rollout (hidden 64; K1 / K2 on a card), the U-Net with the 48 lead times as
output channels, MetNet at its grid (K3 / K4 on a card), the Perceiver's
per-lead decode; their ``_stoch`` forms and ``stoch_baselines`` on
``StochasticAdvectionDataset`` (the future velocity redrawn at the
boundary); and ``dgmr_stoch``, DGMR's 3-sample ensemble mean trained with
the split D / G step and no per-epoch validation (:func:`dgmr_stoch`).
``SATFLOW_HORIZON_EPOCHS`` sets every arm's budget, as in the JAX tool.

    python -m satflow_tpu_torch.tools.horizon_gate [--arms baselines,convlstm]
        [--out DIR] [--device cuda]

Writes ``horizon_results.json`` and ``horizon_results.md`` under ``--out``
only, and prints the results. Its rows are merged into the file as it
stands when the run ends, so a rerun, or runs of other arms side by side
into the same ``--out``, keep every row. Each trained row records its
training seconds and ``kernel_launches``, the K1-K4 launches of its fit.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, Optional

import torch

from satflow_tpu_torch.tools.accuracy_gate import _to_metnet_grid
from satflow_tpu_torch.tools.studies import (
    baseline_rows,
    card_name,
    full_f32,
    kernel_launches,
    launches_since,
    load_results,
    model_row,
    per_lead_table,
    save_results,
    study_dm,
)

# velocity (1,1) over 48 steps traverses 48 of the 64px (torus wrap: the
# analog of clouds leaving/entering the frame); decay 0.985 keeps ~48% of
# the intensity at t=47 so the decay signal survives the full horizon
DS48 = dict(batch_size=8, width=64, height=64, number_sat_channels=1,
            history_minutes=15, forecast_minutes=240, velocity=(1, 1),
            decay=0.985, n_blobs=4)
STEPS = 48
EVAL_BATCHES = 3

ALL_ARMS = ("baselines", "convlstm", "unet", "metnet", "perceiver",
            "stoch_baselines", "convlstm_stoch", "unet_stoch",
            "metnet_stoch", "perceiver_stoch", "dgmr_stoch")
RESULTS = "horizon_results.json"

# the model arms: registry name, epochs, keywords (a warm-up schedule's
# ``warmup_steps`` is min(100, half the steps) and ``total_steps`` the run's)
RECIPES = {
    "convlstm": ("encoderdecoderconvlstm", 150, dict(
        input_channels=1, out_channels=1, forecast_steps=STEPS, hidden_dim=64, lr=2e-3)),
    "unet": ("unet", 150, dict(
        input_channels=4, forecast_steps=STEPS, channels_per_timestep=1, features_start=64,
        depth=4, lr=1e-3)),
    "metnet": ("litmetnet", 100, dict(
        input_channels=1, sat_channels=1, output_channels=1, input_size=64,
        forecast_steps=STEPS, hidden_dim=64, lr=2e-3)),
    "perceiver": ("perceiver", 60, dict(
        input_channels=1, sat_channels=1, base_channels=1, input_size=64, forecast_steps=STEPS,
        history_steps=4, depth=3, num_latents=128, latent_dim=128, dim=48, queries_dim=48,
        num_freq_bands=16, predict_timesteps_together=False, lr=2e-3)),
    "dgmr": ("nowcastinggan", 60, dict(
        forecast_steps=STEPS, input_channels=1, output_shape=DS48["width"], context_channels=24,
        latent_channels=48, disc_channels=6, num_samples=3, grid_lambda=20.0, disc_steps=1,
        gen_lr=2e-4, disc_lr=5e-5)),
}
SCHEDULED = ("metnet", "perceiver")


def _epochs(default: int) -> int:
    """Arm training budget; SATFLOW_HORIZON_EPOCHS overrides (smoke/CI)."""
    return int(os.environ.get("SATFLOW_HORIZON_EPOCHS", default))


def build(arm: str, epochs: Optional[int] = None, length: int = 12):
    """``arm``'s model at its recipe, drawn from a generator seeded 0, and
    its epochs (``epochs``, else ``SATFLOW_HORIZON_EPOCHS``, else the
    recipe's); a scheduled arm warms up over min(100, half the steps) of the
    ``epochs`` x ``length`` steps."""
    from satflow_tpu_torch.core.registry import create_model
    import satflow_tpu_torch.models  # noqa: F401 - populate the registry

    name, default, kw = RECIPES[arm]
    n = _epochs(default) if epochs is None else epochs
    if arm in SCHEDULED:
        total = n * length
        kw = {**kw, "warmup_steps": min(100, total // 2), "total_steps": total}
    return create_model(name, generator=torch.Generator().manual_seed(0), **kw), n


def fit(model, n: int, stochastic: bool, device, length: int = 12, **trainer_kw):
    """``model`` trained ``n`` epochs of ``length`` batches of ``DS48``
    (stochastic futures if ``stochastic``): the trainer, and the trained
    row's training seconds and K1-K4 launches."""
    from satflow_tpu_torch.data.fake import DecayingAdvectionDataset, StochasticAdvectionDataset
    from satflow_tpu_torch.train import Trainer

    trainer = Trainer(max_epochs=n, log_every_n_steps=500, device=device, **trainer_kw)
    before, t0 = kernel_launches(), time.perf_counter()
    trainer.fit(model, study_dm(StochasticAdvectionDataset if stochastic
                                else DecayingAdvectionDataset, DS48, length))
    return trainer, {"train_seconds": time.perf_counter() - t0,
                     "kernel_launches": launches_since(before)}


def dgmr_stoch(device, eval_set, epochs: Optional[int] = None, length: int = 12,
               validate: bool = False):
    """The ``dgmr_stoch`` arm: DGMR trained with the split D / G step on
    stochastic futures, then its row on ``eval_set`` (the 3-sample ensemble
    mean's MSE curve, its CRPS and spread, the final ``train/d_loss``).
    Returns (model, trainer, row).

    The fit runs no per-epoch validation unless ``validate``: nothing reads
    it. DGMR sets no ``scheduler`` (no plateau reads ``val/g_loss``), no
    callback is passed, the eval step draws its own noise from the trainer's
    seed, where the training noise lives in the train state, and the row
    keeps only the training's ``d_loss``. So the trained weights, buffers,
    optimizer and noise states and the row are those of a validated fit,
    bit for bit (``tests/test_torch_dgmr_studies.py``), and the epochs cost
    their training only."""
    from satflow_tpu_torch.tools.studies import ensemble_row

    model, n = build("dgmr", epochs, length)
    # a validation every n + 1 epochs: never, in an n-epoch fit
    trainer, trained = fit(model, n, True, device, length, gan_step_mode="split",
                           **({} if validate else {"check_val_every_n_epoch": n + 1}))
    ens = ensemble_row(model, eval_set, EVAL_BATCHES)
    row = {**{k: ens[k] for k in ("mse_t", "mse", "crps", "sample_std")},
           "d_loss": float(trainer.callback_metrics["train/d_loss"]), "epochs": n,
           "validation": "every epoch" if validate else "none", **trained}
    return model, trainer, row


def main(arms: Optional[Iterable[str]] = None, out: Optional[str] = None, device="cuda",
         epochs: Optional[int] = None, length: int = 12) -> Dict:
    """Run ``arms`` (default all) on ``device``; returns the results (merged
    into ``out``'s file if given). ``epochs`` sets every arm's budget (as
    ``SATFLOW_HORIZON_EPOCHS`` does), ``length`` the batches of an epoch
    (the JAX tool's 12)."""
    from satflow_tpu_torch import resolve_device
    from satflow_tpu_torch.baseline.optical_flow import run_baseline
    from satflow_tpu_torch.data.fake import DecayingAdvectionDataset, StochasticAdvectionDataset
    from satflow_tpu_torch.eval.evaluate import evaluate_model

    arms = set(arms or ALL_ARMS)
    unknown = arms - set(ALL_ARMS)
    if unknown:
        raise SystemExit(f"unknown --arms {sorted(unknown)}; valid: {list(ALL_ARMS)}")
    device = resolve_device(device)
    full_f32(device)
    card = card_name(device)
    eval_ds = DecayingAdvectionDataset(length=EVAL_BATCHES, seed=300, **DS48)
    eval_sto = StochasticAdvectionDataset(length=EVAL_BATCHES, seed=300, **DS48)
    load_results(out, RESULTS, card)  # a file of another card raises before any training
    results = {}

    def baselines(eval_set, full_suffix, grid_suffix):
        kw = dict(forecast_steps=STEPS, flow_method="farneback", max_batches=EVAL_BATCHES,
                  device=device)
        results.update(baseline_rows(run_baseline(eval_set, **kw), full_suffix))
        results.update(baseline_rows(run_baseline(eval_set, target_view=_to_metnet_grid, **kw),
                                     grid_suffix))

    if "baselines" in arms:
        baselines(eval_ds, "", "@metnet_grid")
    if "stoch_baselines" in arms:
        baselines(eval_sto, "@stoch", "@metnet_grid_stoch")

    for arm in ("convlstm", "unet", "metnet", "perceiver"):
        for stochastic in (False, True):
            if (arm + "_stoch" if stochastic else arm) not in arms:
                continue
            model, n = build(arm, epochs, length)
            _, trained = fit(model, n, stochastic, device, length)
            row = arm + "@stoch" if stochastic else arm
            curves = evaluate_model(model, eval_sto if stochastic else eval_ds,
                                    max_batches=EVAL_BATCHES, compute_ms_ssim=True)
            results[row] = {**model_row(curves, n, per_lead_ms_ssim=False), **trained}
            print(row, "mse", results[row]["mse"], "final", results[row]["mse_t"][-1], flush=True)

    # DGMR's 3-sample ensemble mean (the reference config's num_samples),
    # with its CRPS and spread beside it
    if "dgmr_stoch" in arms:
        row = results["dgmr_mean@stoch"] = dgmr_stoch(device, eval_sto, epochs, length)[2]
        print("dgmr_mean@stoch", {k: row[k] for k in ("mse", "crps", "sample_std")}, flush=True)

    results = save_results(out, RESULTS, results, card, _section)
    print(json.dumps(results), flush=True)
    return results


_FULL_RES = ("persistence", "optical_flow", "convlstm", "unet", "perceiver")
_GRID = ("persistence@metnet_grid", "optical_flow@metnet_grid", "metnet")
_STOCH = ("persistence@stoch", "optical_flow@stoch", "convlstm@stoch", "unet@stoch",
          "metnet@stoch", "perceiver@stoch", "dgmr_mean@stoch")
_GRID_STOCH = ("persistence@metnet_grid_stoch", "optical_flow@metnet_grid_stoch")


def _section(r) -> str:
    lines = [
        "## 48-step horizon — the reference's full protocol length",
        "",
        "`python -m satflow_tpu_torch.tools.horizon_gate`: the JAX study's data and recipes",
        "(`tools/horizon_gate.py`) on the port, 64 px, 48 lead times. On the deterministic set",
        "Farneback is near-oracle for the first lead times, so the trained models are held to",
        "both baselines at t=47; on the stochastic set (`@stoch`) at the full-horizon mean too.",
        "",
        "| Method | Mean MSE | Final-step MSE (t=47) | Training s |",
        "|---|---|---|---|",
    ]
    for name in _FULL_RES + _GRID + _STOCH + _GRID_STOCH:
        if name in r:
            sec = r[name].get("train_seconds")
            lines.append(f"| {name} | {r[name]['mse']:.5f} | {r[name]['mse_t'][-1]:.5f} | "
                         f"{'-' if sec is None else f'{sec:.1f}'} |")
    lines.append("")
    if r.get("dgmr_mean@stoch", {}).get("validation") == "none":
        lines += ["`dgmr_mean@stoch` trained with no per-epoch validation: nothing reads it",
                  "(DGMR has no plateau schedule, the row keeps the training's `d_loss`), and",
                  "the trained state and the row equal a validated fit's bit for bit.", ""]
    for title, names in (("Deterministic", _FULL_RES + _GRID), ("Stochastic-future", _STOCH)):
        present = [n for n in names if n in r]
        if present:
            lines += [f"{title} per-lead-time curves:", "",
                      *per_lead_table(r, present, len(r[present[0]]["mse_t"])), ""]
    return "\n".join(lines)


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arms", default=None,
                   help=f"comma list of arms; default: all of {','.join(ALL_ARMS)}")
    p.add_argument("--out", default=None,
                   help="directory for horizon_results.json (merged into) and its .md")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.arms.split(",") if a.arms else None, out=a.out, device=a.device)
