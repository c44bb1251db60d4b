"""FakeDataset: random batches with the production key schema.

Shape-for-shape parity with reference satflow/data/datamodules.py:157-219 — the
testing/fake backend that lets training smoke-run without cloud data:

- ``sat_data``:  (B, seq, W, H, C) with seq = history_steps + 1  (NHWC video)
- ``nwp``:       (B, 10, seq, 2, 2)
- 4 cyclic datetime features: (B, seq)
- sorted sat x/y coords and datetime index: (B, seq)
- target ``sat_data``: (B, forecast_steps, W, H, C)

Also provides ``AdvectionDataset``: a synthetic moving-blob sequence with a known
constant motion field, used by the optical-flow parity tests (a learnable signal,
unlike pure noise).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from satflow_tpu_torch.data import consts


class FakeDataset:
    """Random-tensor batches with the real key schema."""

    def __init__(
        self,
        batch_size: int = 32,
        width: int = 16,
        height: int = 16,
        number_sat_channels: int = 12,
        length: int = 10,
        history_minutes: Optional[int] = 30,
        forecast_minutes: Optional[int] = 30,
        seed: int = 0,
    ):
        if history_minutes is None or forecast_minutes is None:
            history_minutes = 30
            forecast_minutes = 240  # reference defaults (datamodules.py:169-171)
        self.batch_size = batch_size
        self.history_steps = history_minutes // consts.MINUTES_PER_STEP
        self.forecast_steps = forecast_minutes // consts.MINUTES_PER_STEP
        self.seq_length = self.history_steps + 1
        self.width = width
        self.height = height
        self.number_sat_channels = number_sat_channels
        self.length = length
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def per_worker_init(self, worker_id: int) -> None:  # parity no-op
        pass

    def __getitem__(self, idx: int) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + idx)
        b, s = self.batch_size, self.seq_length
        f32 = np.float32
        x = {
            consts.SATELLITE_DATA: rng.standard_normal(
                (b, s, self.width, self.height, self.number_sat_channels), dtype=f32
            ),
            consts.NWP_DATA: rng.standard_normal((b, 10, s, 2, 2), dtype=f32),
        }
        for name in consts.DATETIME_FEATURE_NAMES:
            x[name] = rng.standard_normal((b, s), dtype=f32)
        x[consts.SATELLITE_X_COORDS] = np.sort(
            rng.standard_normal((b, s), dtype=f32), axis=-1
        )
        x[consts.SATELLITE_Y_COORDS] = np.sort(
            rng.standard_normal((b, s), dtype=f32), axis=-1
        )[:, ::-1]
        x[consts.SATELLITE_DATETIME_INDEX] = np.sort(
            rng.standard_normal((b, s), dtype=f32), axis=-1
        )
        x[consts.TOPOGRAPHIC_DATA] = rng.standard_normal(
            (b, self.width, self.height), dtype=f32
        )
        y = {
            consts.SATELLITE_DATA: rng.standard_normal(
                (b, self.forecast_steps, self.width, self.height, self.number_sat_channels),
                dtype=f32,
            ),
        }
        return x, y

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class AdvectionDataset(FakeDataset):
    """Synthetic advection: blobs translating with a constant velocity field.

    Gives models and the optical-flow baseline a learnable/recoverable signal:
    frame t+1 is frame t rolled by (dy, dx) pixels. Used by the end-to-end
    loss-decreases test and the flow parity harness.
    """

    def __init__(self, *args, velocity: Tuple[int, int] = (1, 1), n_blobs: int = 4, **kwargs):
        super().__init__(*args, **kwargs)
        self.velocity = velocity
        self.n_blobs = n_blobs

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(self.seed + idx)
        b = self.batch_size
        total = self.seq_length + self.forecast_steps
        h, w, c = self.width, self.height, self.number_sat_channels
        yy, xx = np.mgrid[0:h, 0:w]
        frames = np.zeros((b, total, h, w, c), dtype=np.float32)
        base = np.zeros((b, h, w, c), dtype=np.float32)
        for bi in range(b):
            for _ in range(self.n_blobs):
                cy, cx = rng.integers(0, h), rng.integers(0, w)
                sigma = rng.uniform(1.5, 3.0)
                blob = np.exp(-(((yy - cy) % h) ** 2 + ((xx - cx) % w) ** 2) / (2 * sigma**2))
                base[bi] += blob[..., None].astype(np.float32)
        base = np.clip(base, 0.0, 1.0)
        dy, dx = self.velocity
        for t in range(total):
            frames[:, t] = np.roll(
                np.roll(base, shift=t * dy, axis=1), shift=t * dx, axis=2
            )
        x, y = super().__getitem__(idx)  # schema scaffold (coords, nwp, datetimes)
        x[consts.SATELLITE_DATA] = frames[:, : self.seq_length]
        y[consts.SATELLITE_DATA] = frames[:, self.seq_length :]
        return x, y


class DecayingAdvectionDataset(AdvectionDataset):
    """Advection + multiplicative intensity decay: the accuracy-gate dataset.

    Dynamics: frame(t) = roll(base, t·v) · decay^t. Persistence fails on the
    motion; an optical-flow warp recovers the motion but not the decay (warping
    preserves intensity); a trained model can learn both — so this is the
    synthetic dataset on which a *trained* model must beat BOTH baselines
    (the rebuild's analog of the reference's flow-vs-persistence MSE study,
    reference satflow/baseline/README.md:13-25).
    """

    def __init__(self, *args, decay: float = 0.92, **kwargs):
        super().__init__(*args, **kwargs)
        self.decay = decay

    def __getitem__(self, idx: int):
        x, y = super().__getitem__(idx)
        past = x[consts.SATELLITE_DATA]
        future = y[consts.SATELLITE_DATA]
        s = past.shape[1]
        t_past = self.decay ** np.arange(s, dtype=np.float32)
        t_future = self.decay ** np.arange(
            s, s + future.shape[1], dtype=np.float32
        )
        x[consts.SATELLITE_DATA] = past * t_past[None, :, None, None, None]
        y[consts.SATELLITE_DATA] = future * t_future[None, :, None, None, None]
        return x, y


class StochasticAdvectionDataset(DecayingAdvectionDataset):
    """Decaying advection whose FUTURE velocity is ambiguous given the past.

    At the history/forecast boundary the velocity is redrawn per sequence
    from ``velocity + delta`` with delta uniform over
    ``future_velocity_deltas`` — the past frames cannot reveal the draw, so
    the predictive distribution is genuinely multi-modal. This is the
    generative-family eval dataset: a probabilistic model (DGMR) should show
    inter-sample variance ~ the mode spread (a collapsed generator shows ~0),
    while its sample MEAN still beats persistence. On the deterministic
    datasets zero sample variance is the optimum, so they cannot provide
    collapse evidence.
    """

    def __init__(self, *args, future_velocity_deltas=((0, -2), (0, 0), (0, 2)),
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.future_velocity_deltas = tuple(
            tuple(d) for d in future_velocity_deltas
        )

    def __getitem__(self, idx: int):
        x, y = super().__getitem__(idx)
        past = x[consts.SATELLITE_DATA]
        future = y[consts.SATELLITE_DATA]
        rng = np.random.default_rng(self.seed + 7919 * (idx + 1))
        dy, dx = self.velocity
        b, f = future.shape[0], future.shape[1]
        last = past[:, -1]  # (B, H, W, C), already decayed to t = s-1
        decay_step = self.decay
        out = np.empty_like(future)
        for bi in range(b):
            ddy, ddx = self.future_velocity_deltas[
                rng.integers(0, len(self.future_velocity_deltas))
            ]
            vy, vx = dy + ddy, dx + ddx
            cur = last[bi]
            for t in range(f):
                cur = np.roll(np.roll(cur, vy, axis=0), vx, axis=1) * decay_step
                out[bi, t] = cur
        y[consts.SATELLITE_DATA] = out
        return x, y
