"""Checkpoint evaluation: MSE / SSIM / MS-SSIM per lead time (and per
channel), counterpart of ``satflow_tpu/eval/evaluate.py``.

Model quality is judged on per-lead-time curves against the optical-flow and
persistence baselines, and a speed claim counts only "at matching MS-SSIM"
(``BASELINE.json``). This harness gives those curves for a model of the
port's registry:

    python -m satflow_tpu_torch.eval.evaluate --checkpoint DIR \\
        --dataset advection --batches 4 --output eval_out

which writes ``mse.npy`` (C, T), ``ssim.npy`` (T,), ``ms_ssim.npy`` (T,)
and a JSON summary. The port holds its weights in the model, so
:func:`evaluate_model` takes no ``variables``; ``forward_kwargs`` go to the
model's forward (the chip smoke passes the plain step to score the same
model without the kernels).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from satflow_tpu_torch.data.datamodule import to_device
from satflow_tpu_torch.ops.ssim import ms_ssim_frames, ssim_frames


def batch_metrics(y_hat: torch.Tensor, y: torch.Tensor,
                  compute_ms_ssim: bool = True) -> Dict[str, torch.Tensor]:
    """One batch's curves from a (B, T, H, W, C) forecast and its truth:
    ``mse`` (C, T), the mean over batch and space per channel and lead
    time; ``ssim`` (T,) and ``ms_ssim`` (T,), the index of each lead time's
    frames, all lead times in one pass."""
    se = torch.square(y_hat - y)
    out = {"mse": torch.mean(se, dim=(0, 2, 3)).transpose(0, 1),  # (C, T)
           "ssim": ssim_frames(y_hat, y)}
    if compute_ms_ssim:
        out["ms_ssim"] = ms_ssim_frames(y_hat, y)
    return out


def evaluate_model(
    model,
    dataset: Iterable,
    max_batches: Optional[int] = None,
    compute_ms_ssim: bool = True,
    **forward_kwargs,
) -> Dict[str, np.ndarray]:
    """Per-lead-time metric curves of a model over a dataset, under
    ``torch.no_grad()`` in eval mode on the model's device.

    Returns dict with ``mse`` (C, T), ``ssim`` (T,), optionally ``ms_ssim``
    (T,), and their scalar means.
    """
    device = next(model.parameters()).device
    training = model.training
    model.eval()
    sums: Dict[str, np.ndarray] = {}
    count = 0
    try:
        with torch.no_grad():
            for bi, batch in enumerate(dataset):
                if max_batches is not None and bi >= max_batches:
                    break
                x, y = model.eval_batch(to_device(batch, device))
                metrics = batch_metrics(model(x, **forward_kwargs), y, compute_ms_ssim)
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.0) + v.double().cpu().numpy()
                count += 1
    finally:
        model.train(training)

    if not count:
        raise ValueError("evaluate_model got an empty dataset (or "
                         "max_batches=0) — nothing to score")
    results = {k: v / count for k, v in sums.items()}
    results["mse_mean"] = float(results["mse"].mean())
    results["ssim_mean"] = float(results["ssim"].mean())
    if compute_ms_ssim:
        results["ms_ssim_mean"] = float(results["ms_ssim"].mean())
    return results


def save_results(results: Dict[str, np.ndarray], output_dir: str) -> None:
    """Each array as ``{name}.npy`` and the scalars as ``summary.json``."""
    os.makedirs(output_dir, exist_ok=True)
    summary = {}
    for k, v in results.items():
        if isinstance(v, np.ndarray):
            np.save(os.path.join(output_dir, f"{k}.npy"), v)
        else:
            summary[k] = v
    with open(os.path.join(output_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)


def main(argv=None):  # pragma: no cover - CLI convenience
    import argparse

    from satflow_tpu_torch import resolve_device
    from satflow_tpu_torch.core.registry import create_model
    from satflow_tpu_torch.data.fake import AdvectionDataset, FakeDataset

    p = argparse.ArgumentParser(description="Evaluate a checkpoint")
    p.add_argument("--checkpoint", required=True, help="checkpoint dir")
    p.add_argument("--dataset", default="advection", choices=["advection", "fake"])
    p.add_argument("--batches", type=int, default=4)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--channels", type=int, default=12)
    p.add_argument("--history-minutes", type=int, default=30,
                   help="past-window length; must match the checkpoint's training history")
    p.add_argument("--output", default="eval_out")
    p.add_argument("--ensemble", type=int, default=0, metavar="M",
                   help="for sampling models: draw M samples per forecast and report "
                        "ensemble CRPS + spread instead of the deterministic curves")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    model = create_model(f"local:{args.checkpoint}").to(resolve_device(args.device))
    ds_cls = AdvectionDataset if args.dataset == "advection" else FakeDataset
    ds = ds_cls(
        batch_size=4, width=args.size, height=args.size,
        number_sat_channels=args.channels,
        history_minutes=args.history_minutes,
        forecast_minutes=model.forecast_steps * 5, length=args.batches,
    )
    if args.ensemble:
        from satflow_tpu_torch.eval.probabilistic import evaluate_ensemble

        results = evaluate_ensemble(model, ds, max_batches=args.batches,
                                    num_samples=args.ensemble)
        os.makedirs(args.output, exist_ok=True)
        for k in ("crps", "mse"):
            np.save(os.path.join(args.output, f"{k}.npy"), np.asarray(results[k]))
    else:
        results = evaluate_model(model, ds, args.batches)
        save_results(results, args.output)
    print(json.dumps({k: v for k, v in results.items() if not isinstance(v, np.ndarray)}))


if __name__ == "__main__":
    main()
