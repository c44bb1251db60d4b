"""What the port's quality studies share: their data modules, result rows,
the card they ran on and the results file under ``--out``.

The study tools (``accuracy_gate``, ``accuracy_256``, ``gan_gate``,
``gan_128``, ``horizon_gate``) are the port's copies of the JAX package's
``tools/*.py`` studies. Each trains on synthetic advection at its JAX
recipe, scores against persistence and optical flow, writes its results
file (and a markdown section beside it) under ``--out`` only, and merges
its rows into the file it finds there when it saves, so that a rerun, or
runs side by side into one ``--out``, keep every row (:func:`save_results`).
On a card each runs its convolutions in full float32 (:func:`full_f32`).
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import subprocess
import tempfile
from typing import Callable, Dict, Optional

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
    """The rows of the results file under ``out`` (empty when there is
    none). A file whose rows were computed on another device raises: its
    rows and this run's could not be compared. A tool reads it when it
    starts, so that such a file stops the run before its training."""
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


@contextlib.contextmanager
def _locked(directory: str):
    """An exclusive ``flock`` on ``directory`` itself (no lock file is left
    behind), held until the block ends."""
    fd = os.open(directory, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def _write_atomic(path: str, text: str) -> None:
    """``text`` as ``path``, through a temporary file beside it and
    ``os.replace``: a reader sees the old file or the new one, never part."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix="." + os.path.basename(path) + ".")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.chmod(tmp, 0o644)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def save_results(out: Optional[str], filename: str, rows: Dict, card: str,
                 section: Optional[Callable[[Dict], str]] = None) -> Dict:
    """Merge ``rows``, the rows this run computed, into ``out/filename``
    (stamped with the card under ``CARD_KEY``) and, with ``section``, write
    ``section(merged rows)`` beside it (``.md``); returns the merged rows.
    Without ``out`` nothing is written and ``rows`` come back.

    The file is read as it stands at save time and both files are replaced
    atomically, under an exclusive lock on ``out`` held across the read and
    the writes: runs that share one ``--out`` side by side keep every row of
    each other's, and a file of another card raises here too."""
    if not out:
        return dict(rows)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, filename)
    with _locked(out):
        merged = {**load_results(out, filename, card), **rows}
        _write_atomic(path, json.dumps({**merged, CARD_KEY: card}, indent=2))
        if section is not None:
            _write_atomic(os.path.splitext(path)[0] + ".md", section(merged))
    return merged


def kernel_launches() -> Dict[str, int]:
    """The launch counters of the repo's kernels on the studies' paths: K1
    (``fused_convlstm_step``), K2 (``gate_bwd``), K3 (``fused_lstm_gates``)
    and K4 (``axial_attention``). A wrapper counts only where it launches its
    kernel on a card: on the CPU they stay as they are."""
    from satflow_tpu_torch.ops.axial_attention import axial_attention
    from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step, gate_bwd
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates

    return {"K1": fused_convlstm_step.launches, "K2": gate_bwd.launches,
            "K3": fused_lstm_gates.launches, "K4": axial_attention.launches}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """Each of :func:`kernel_launches` since ``before`` (an earlier reading):
    a trained row's ``kernel_launches``."""
    return {k: n - before[k] for k, n in kernel_launches().items()}


def per_lead_table(r: Dict, names, steps: int):
    """Markdown rows of each present row's per-lead-time MSE."""
    present = [n for n in names if n in r]
    lines = ["| t | " + " | ".join(present) + " |", "|" + "---|" * (1 + len(present))]
    for t in range(steps):
        lines.append("| " + " | ".join([str(t)] + [f"{r[n]['mse_t'][t]:.5f}" for n in present])
                     + " |")
    return lines
