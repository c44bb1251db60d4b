"""Visualization: image grids of input/target/generated frame stacks.

Counterpart of ``satflow_tpu/train/visualize.py``. The reference logs
torchvision ``make_grid`` panels of the input, target and generated stacks
to TensorBoard at ~1% of batches (reference satflow/models/conv_lstm.py:93-118,
cloudgan.py:364-392). Here :func:`make_image_grid`, the JAX module's numpy
function as it is, and a callback that reruns the model's forward on the
current batch and ships panels to every logger (``log_image``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from satflow_tpu_torch.core.utils import get_logger
from satflow_tpu_torch.train.callbacks import Callback

log = get_logger(__name__)


def make_image_grid(frames: np.ndarray, nrow: int = 8, pad: int = 1) -> np.ndarray:
    """Tile (N, H, W, C) frames into one (rows·H, nrow·W, C) panel in [0, 1]."""
    frames = np.asarray(frames, dtype=np.float32)
    if frames.ndim == 3:
        frames = frames[..., None]
    n, h, w, c = frames.shape
    lo, hi = frames.min(), frames.max()
    if hi > lo:
        frames = (frames - lo) / (hi - lo)
    rows = (n + nrow - 1) // nrow
    grid = np.zeros((rows * (h + pad), nrow * (w + pad), c), dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        grid[r * (h + pad): r * (h + pad) + h,
             col * (w + pad): col * (w + pad) + w] = frames[i]
    if c == 1:
        grid = np.repeat(grid, 3, axis=-1)
    return grid


class VisualizationCallback(Callback):
    """Log input/target/generated grids every ``every_n_steps`` steps.

    The forward runs in eval mode without grad and leaves the model's mode
    as it was. As in the JAX package, a failure here is logged and does not
    stop the run.
    """

    def __init__(self, every_n_steps: int = 100, max_frames: int = 12):
        self.every_n_steps = every_n_steps
        self.max_frames = max_frames

    def on_train_batch_end(self, engine, metrics, step: int) -> None:
        if step % self.every_n_steps != 0 or engine.last_batch is None:
            return
        model = engine.model
        training = model.training
        try:
            x, y = model.prepare_batch(engine.last_batch)
            model.eval()
            with torch.no_grad():
                y_hat = model(x)
        except Exception:  # noqa: BLE001 - visualization must never kill a run
            log.warning("visualization at step %d failed", step, exc_info=True)
            return
        finally:
            model.train(training)
        panels = {
            "input": _first_sample_frames(x, self.max_frames),
            "target": _first_sample_frames(y, self.max_frames),
            "generated": _first_sample_frames(y_hat, self.max_frames),
        }
        for name, frames in panels.items():
            if frames is None:
                continue
            grid = make_image_grid(frames)
            for lg in engine.writers():
                lg.log_image(f"train/{name}_stack", grid, step)


def _first_sample_frames(t, max_frames: int) -> Optional[np.ndarray]:
    if isinstance(t, dict):
        t = t.get("sat_data")
        if t is None:
            return None
    arr = torch.as_tensor(t).detach().float().cpu().numpy()
    if arr.ndim == 5:  # (B, T, H, W, C) -> first sample, first channel
        return arr[0, :max_frames, :, :, :1]
    if arr.ndim == 4:  # (B, H, W, C) -> channels as frames
        return np.moveaxis(arr[0], -1, 0)[:max_frames, :, :, None]
    return None
