"""What the port's quality studies share: their data modules, result rows,
the card they ran on and the results file under ``--out``.

The study tools (``accuracy_gate``, ``accuracy_256``, ``gan_gate``,
``gan_128``, ``horizon_gate``) are the port's copies of the JAX package's
``tools/*.py`` studies. Each trains on synthetic advection at its JAX
recipe, scores against persistence and optical flow, writes its results
file (and a markdown section beside it) under ``--out`` only, and merges a
rerun into the file it finds there. On a card each runs its convolutions
in full float32 (:func:`full_f32`).
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Dict, Optional

import numpy as np
import torch

# the data modules' split seeds, the JAX studies' (``{"train": 0, ...}``)
SPLIT_SEEDS = {"train": 0, "validation": 100, "test": 200}
# the key of a results file that names the device its rows were computed on
CARD_KEY = "card"


def study_dm(dataset_cls, ds_kw: dict, length: int = 12):
    """The studies' data module: ``dataset_cls(length, seed of the split,
    **ds_kw)`` for each split, no worker threads."""
    from satflow_tpu_torch.data.datamodule import SatFlowDataModule

    class StudyDM(SatFlowDataModule):
        def __init__(self):
            super().__init__(fake_data=True, num_workers=0, shard=False)

        def _dataset(self, split, n):
            return dataset_cls(length=length, seed=SPLIT_SEEDS[split], **ds_kw)

    return StudyDM()


def curve(losses) -> Dict:
    """A baseline's row: the per-lead-time MSE (averaged over channels) and
    its mean, from ``run_baseline``'s (C, T) losses."""
    return {"mse_t": np.mean(losses, axis=0).tolist(), "mse": float(np.mean(losses))}


def baseline_rows(base, suffix: str = "") -> Dict[str, Dict]:
    """``persistence{suffix}`` and ``optical_flow{suffix}`` from one
    ``run_baseline`` result."""
    return {"persistence" + suffix: curve(base["baseline_loss"]),
            "optical_flow" + suffix: curve(base["flow_loss"])}


def model_row(curves, epochs: int, per_lead_ms_ssim: bool = True) -> Dict:
    """A trained model's row from ``evaluate_model``'s curves (with MS-SSIM)."""
    row = {"mse_t": np.mean(curves["mse"], axis=0).tolist(),
           "mse": float(np.mean(curves["mse"]))}
    if per_lead_ms_ssim:
        row["ms_ssim_t"] = np.asarray(curves["ms_ssim"]).tolist()
    row["ms_ssim"] = float(np.mean(curves["ms_ssim"]))
    row["epochs"] = epochs
    return row


def ensemble_row(model, dataset, max_batches: int) -> Dict:
    """A sampling model's row on ``dataset``: the ensemble mean's MSE curve,
    CRPS at its ``num_samples`` (the classic estimator, the reference
    protocol's M=3), the spread, and the fair CRPS at M=8."""
    from satflow_tpu_torch.eval.probabilistic import evaluate_ensemble

    ens = evaluate_ensemble(model, dataset, max_batches=max_batches)
    ens8 = evaluate_ensemble(model, dataset, num_samples=8, max_batches=max_batches, fair=True)
    return {"mse_t": np.asarray(ens["mse"]).tolist(), "mse": ens["mse_mean"],
            "crps": ens["crps_mean"], "crps_t": np.asarray(ens["crps"]).tolist(),
            "sample_std": ens["sample_std"], "crps_fair_m8": ens8["crps_mean"]}


def card_name(device: torch.device) -> str:
    """The device the rows were computed on: for a card, its name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them; else the device type."""
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def full_f32(device: torch.device) -> None:
    """On a card, run cuDNN's convolutions and cuBLAS's matmuls in full
    float32 for the rest of the process. By default cuDNN rounds a
    convolution's inputs to TF32, and the accuracy gate's attentionrunet and
    fcn arms ended above flow with that rounding and below it without, as the
    CPU path does that the tests hold to the JAX package (ROADMAP §3)."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def load_results(out: Optional[str], filename: str, card: str) -> Dict:
    """The results file under ``out`` that a rerun merges into (empty when
    there is none). A file whose rows were computed on another device
    raises: its rows and this run's could not be compared."""
    path = os.path.join(out, filename) if out else None
    if not path or not os.path.exists(path):
        return {}
    with open(path) as f:
        results = json.load(f)
    on = results.pop(CARD_KEY, card)
    if on != card:
        raise ValueError(f"{path} holds rows computed on {on!r}, this run is on {card!r}: "
                         "write to another --out")
    return results


def save_results(out: Optional[str], filename: str, results: Dict, card: str,
                 markdown: Optional[str] = None) -> None:
    """Write ``results``, stamped with the card under ``CARD_KEY``, as
    ``out/filename`` and, with ``markdown``, the study's section beside it
    (``.md``); nothing without ``out``."""
    if not out:
        return
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, filename), "w") as f:
        json.dump({**results, CARD_KEY: card}, f, indent=2)
    if markdown is not None:
        with open(os.path.join(out, os.path.splitext(filename)[0] + ".md"), "w") as f:
            f.write(markdown)


def per_lead_table(r: Dict, names, steps: int):
    """Markdown rows of each present row's per-lead-time MSE."""
    present = [n for n in names if n in r]
    lines = ["| t | " + " | ".join(present) + " |", "|" + "---|" * (1 + len(present))]
    for t in range(steps):
        lines.append("| " + " | ".join([str(t)] + [f"{r[n]['mse_t'][t]:.5f}" for n in present])
                     + " |")
    return lines
