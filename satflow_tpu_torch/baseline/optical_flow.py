"""Optical-flow baseline: per-channel, per-lead-time MSE against persistence,
counterpart of ``satflow_tpu/baseline/optical_flow.py``.

For every sample: dense flow between the two most recent past frames (per
channel, or once on ``flow_channel``), the current frame warped forward
``forecast_steps`` times, and the MSE per channel and lead time against the
true future frames, beside the persistence baseline (the current frame
repeated). The flow solve (Horn–Schunck; Farneback runs on the host through
OpenCV where ``cv2`` imports), the warp rollout and the MSE run on
``device``, which defaults to the card.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from satflow_tpu_torch import resolve_device
from satflow_tpu_torch.data import consts
from satflow_tpu_torch.ops.flow import farneback_flow, horn_schunck_flow, rollout_warp


def run_baseline(
    dataset,
    forecast_steps: int = 48,
    flow_method: str = "farneback",
    flow_channel: Optional[int] = None,
    output_dir: Optional[str] = None,
    max_batches: Optional[int] = None,
    target_view=None,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Run the flow + persistence baseline over a dataset.

    ``dataset`` yields (x, y) dicts with ``sat_data`` (B, T, H, W, C) in x
    and (B, F, H, W, C) in y. ``flow_channel``: solve the flow on that one
    channel and apply it to all, else per channel. ``target_view``: an
    optional callable (F, H, W) -> (F, H', W') on tensors, applied to the
    warped and persisted predictions and to the truth before scoring (a
    model that predicts a coarser grid scores its baselines there; the flow
    is still solved and warped at input resolution).

    Returns ``flow_loss`` and ``baseline_loss`` (C, forecast_steps) and their
    scalar means. The accumulators' geometry is fixed by the first batch.
    """
    device = resolve_device(device)
    total_flow = None
    total_persist = None
    count = 0

    def _solve_flow(prev2d, curr2d):
        if flow_method == "farneback":
            return farneback_flow(prev2d, curr2d)
        return horn_schunck_flow(prev2d, curr2d)

    for bi, (x, y) in enumerate(dataset):
        if max_batches is not None and bi >= max_batches:
            break
        past = truth_dtype(x[consts.SATELLITE_DATA]).to(device)  # (B, T, H, W, C)
        future = truth_dtype(y[consts.SATELLITE_DATA]).to(device)  # (B, F, H, W, C)
        b, _, h, w, c = past.shape
        if total_flow is None:
            steps = min(forecast_steps, future.shape[1])
            total_flow = torch.zeros((c, steps), dtype=torch.float64, device=device)
            total_persist = torch.zeros((c, steps), dtype=torch.float64, device=device)
        steps = min(steps, future.shape[1])
        if steps < total_flow.shape[1]:
            raise ValueError(
                f"batch {bi} has only {future.shape[1]} future frames; the "
                f"study accumulates {total_flow.shape[1]} lead times (set "
                "forecast_steps to the dataset minimum)"
            )

        for sample in range(b):
            prev_f = past[sample, -2]
            curr_f = past[sample, -1]
            truth = future[sample, :steps]  # (F, H, W, C)
            # one flow solve per sample on flow_channel, applied to every channel
            shared_flow = (_solve_flow(prev_f[..., flow_channel], curr_f[..., flow_channel])
                           if flow_channel is not None else None)
            for ch in range(c):
                flow = (shared_flow if shared_flow is not None
                        else _solve_flow(prev_f[..., ch], curr_f[..., ch]))
                warped = rollout_warp(curr_f[..., ch], flow, steps)  # (steps, H, W)
                persisted = curr_f[None, ..., ch].expand(steps, h, w)
                truth_ch = truth[..., ch]
                if target_view is not None:
                    warped = target_view(warped)
                    persisted = target_view(persisted.contiguous())
                    truth_ch = target_view(truth_ch)
                total_flow[ch] += torch.mean((warped - truth_ch) ** 2, dim=(1, 2))
                total_persist[ch] += torch.mean((persisted - truth_ch) ** 2, dim=(1, 2))
            count += 1

    if total_flow is None:
        raise ValueError(
            "run_baseline got an empty dataset (or max_batches=0) — "
            "nothing to score"
        )
    flow_loss = total_flow.cpu().numpy() / max(count, 1)
    persist_loss = total_persist.cpu().numpy() / max(count, 1)
    results = {
        "flow_loss": flow_loss,
        "baseline_loss": persist_loss,
        "flow_mean": float(flow_loss.mean()),
        "baseline_mean": float(persist_loss.mean()),
    }
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        np.save(os.path.join(output_dir, "flow_loss.npy"), flow_loss)
        np.save(os.path.join(output_dir, "baseline_loss.npy"), persist_loss)
    return results


def truth_dtype(a) -> torch.Tensor:
    """Frames as float32 tensors (numpy arrays or tensors in)."""
    return torch.as_tensor(a, dtype=torch.float32)


def main(argv=None):  # pragma: no cover - CLI convenience
    import argparse

    from satflow_tpu_torch.data.fake import AdvectionDataset

    p = argparse.ArgumentParser(description="Optical flow baseline harness")
    p.add_argument("--steps", type=int, default=48)
    p.add_argument("--method", default="farneback", choices=["farneback", "horn_schunck"])
    p.add_argument("--output", default="baseline_out")
    p.add_argument("--batches", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    ds = AdvectionDataset(batch_size=4, width=64, height=64,
                          history_minutes=30, forecast_minutes=args.steps * 5)
    res = run_baseline(ds, args.steps, args.method, output_dir=args.output,
                       max_batches=args.batches, device=args.device)
    print(f"Avg Total Loss: {res['flow_mean']}, Avg Baseline Loss: {res['baseline_mean']}")


if __name__ == "__main__":
    main()
