"""The flagship at the serving geometry: the main path's ConvLSTM trained at
256 px, batch 8, 24 lead times, scored against persistence and Farneback
flow at that geometry, with MS-SSIM.

The port's copy of the JAX package's ``tools/accuracy_256.py``: its data
(``DS256``: decaying advection at velocity (2, 4) with 24 blobs, 4 history
frames), its recipe (fused cells, hidden 64, sqrt remat with
``remat_chunk=6``, bf16 compute on f32 weights, Adam 2e-4, one validation
batch an epoch) and its budgets (8 epochs of 12 batches, 12 epochs with
``--stochastic``, as in the JAX study's ``docs/accuracy_256.json``). On
deterministic advection Farneback at 256 px is near-oracle (the motion is
exactly estimable), so the deterministic arm holds the model to persistence
and records MS-SSIM; ``--stochastic`` reruns
the protocol on ``StochasticAdvectionDataset`` (the future velocity
redrawn at the boundary), where the trained model must beat both baselines.
On a card every cell step is a launch of K1 (2 x (4 + 24) = 56 a forward)
and every train step 112 K1 + 56 K2 (the rollout once, its checkpoints once
more, the backward once).

    python -m satflow_tpu_torch.tools.accuracy_256 [--epochs 8] [--stochastic]
        [--out DIR] [--device cuda]

Writes ``accuracy_256.json`` (a rerun merges into it; the rows of the two
arms are suffixed ``@256px`` and ``@256px_stoch``) and ``accuracy_256.md``
under ``--out`` only, and prints the results.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

import torch

from satflow_tpu_torch.tools.studies import (
    baseline_rows,
    card_name,
    full_f32,
    load_results,
    model_row,
    save_results,
    study_dm,
)

# velocity (2,4)*24 steps = (48,96)px displacement — super-pixel motion with
# no torus wrap inside the horizon; decay 0.93^24 = 0.18 leaves a strong
# intensity signal the flow warp cannot capture; 24 blobs keep the blob
# coverage fraction comparable to the 32px study's 4 blobs.
DS256 = dict(batch_size=8, width=256, height=256, number_sat_channels=1,
             history_minutes=15, forecast_minutes=120, velocity=(2, 4),
             decay=0.93, n_blobs=24)
STEPS = 24
EVAL_BATCHES = 2
RESULTS = "accuracy_256.json"
# the recipe: the main path's cells, sqrt remat (chunk 6 ~ sqrt(24)), bf16
# compute, Adam 2e-4
MODEL = dict(input_channels=1, out_channels=1, forecast_steps=STEPS, hidden_dim=64, lr=2e-4,
             cell_impl="fused", remat=True, remat_chunk=6)
EPOCHS = {False: 8, True: 12}  # by ``stochastic``


def main(epochs: Optional[int] = None, stochastic: bool = False, out: Optional[str] = None,
         device="cuda", length: int = 12) -> Dict:
    """Train and score one arm on ``device`` (``epochs`` of ``length``
    batches, by default ``EPOCHS[stochastic]``); returns the results (merged
    into ``out``'s file if given)."""
    from satflow_tpu_torch import resolve_device
    from satflow_tpu_torch.baseline.optical_flow import run_baseline
    from satflow_tpu_torch.core.registry import create_model
    from satflow_tpu_torch.data.fake import DecayingAdvectionDataset, StochasticAdvectionDataset
    from satflow_tpu_torch.eval.evaluate import evaluate_model
    from satflow_tpu_torch.train import Trainer
    import satflow_tpu_torch.models  # noqa: F401 - populate the registry

    epochs = EPOCHS[stochastic] if epochs is None else epochs
    device = resolve_device(device)
    full_f32(device)
    card = card_name(device)
    ds_cls = StochasticAdvectionDataset if stochastic else DecayingAdvectionDataset
    sfx = "@256px_stoch" if stochastic else "@256px"
    eval_ds = ds_cls(length=EVAL_BATCHES, seed=300, **DS256)
    load_results(out, RESULTS, card)  # a file of another card raises before any training
    results = {}

    base = run_baseline(eval_ds, forecast_steps=STEPS, flow_method="farneback",
                        max_batches=EVAL_BATCHES, device=device)
    results.update(baseline_rows(base, sfx))
    print("persistence", results["persistence" + sfx]["mse"],
          "flow", results["optical_flow" + sfx]["mse"], flush=True)

    model = create_model("encoderdecoderconvlstm", dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0), **MODEL)
    trainer = Trainer(max_epochs=epochs, log_every_n_steps=12, limit_val_batches=1,
                      device=device)
    t0 = time.perf_counter()
    trainer.fit(model, study_dm(ds_cls, DS256, length))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0
    curves = evaluate_model(model, eval_ds, max_batches=EVAL_BATCHES, compute_ms_ssim=True)
    results["convlstm" + sfx] = {**model_row(curves, epochs), "optimizer_steps": epochs * length,
                                 "train_seconds": train_s,
                                 "final_train_loss": trainer.callback_metrics["train/loss"]}
    row = results["convlstm" + sfx]
    print("convlstm" + sfx, "mse", row["mse"], "ms_ssim", row["ms_ssim"], flush=True)

    results = save_results(out, RESULTS, results, card, _section)
    print(json.dumps(results), flush=True)
    return results


_ROWS = ("persistence@256px", "optical_flow@256px", "convlstm@256px",
         "persistence@256px_stoch", "optical_flow@256px_stoch", "convlstm@256px_stoch")


def _section(r) -> str:
    m = r.get("convlstm@256px") or r.get("convlstm@256px_stoch") or {}
    lines = [
        "## 256px production geometry",
        "",
        "`python -m satflow_tpu_torch.tools.accuracy_256 [--stochastic]`: the main path's",
        "ConvLSTM (fused cells, hidden 64, `remat_chunk=6`, bf16, Adam 2e-4) trained at 256 px,",
        f"batch 8, 24 lead times ({m.get('optimizer_steps', '-')} optimizer steps) and scored",
        "against persistence and Farneback flow at that geometry. On deterministic advection",
        "the flow is near-oracle, so the model is held to persistence and MS-SSIM there; the",
        "`@256px_stoch` rows (future velocity redrawn at the boundary) hold it to both.",
        "",
        "| Method | Mean MSE | Final-step MSE (t=23) | Mean MS-SSIM | Training s |",
        "|---|---|---|---|---|",
    ]
    for name in _ROWS:
        if name in r:
            row = r[name]
            ms = f"{row['ms_ssim']:.4f}" if "ms_ssim" in row else "-"
            sec = f"{row['train_seconds']:.1f}" if "train_seconds" in row else "-"
            lines.append(f"| {name} | {row['mse']:.5f} | {row['mse_t'][-1]:.5f} | {ms} | {sec} |")
    return "\n".join(lines + [""])


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=None, help="default 8, 12 with --stochastic")
    p.add_argument("--stochastic", action="store_true", default=False)
    p.add_argument("--out", default=None,
                   help="directory for accuracy_256.json (merged into) and its .md")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.epochs, stochastic=a.stochastic, out=a.out, device=a.device)
