"""Data prep / geo utilities, the port's own copy of ``satflow_tpu/data/transforms.py``
(numpy only; reference satflow/data/utils/utils.py parity).

- ``eumetsat_name_to_datetime`` — EUMETSAT filename → datetime regex (:19-31).
- ``binarize_mask`` — cloud-mask binarization (:115-119).
- ``create_pixel_coord_layers`` — normalized x/y (+r) CoordConv planes (:122-160).
- ``create_time_layer`` — one-hot time-of-day plane (:99-112).
- ``check_channels`` — input-channel accounting (:163-188).
- ``crop_center`` — re-exported from nn.misc (:191-196).
- ``map_satellite_to_mercator`` — satpy/pyresample MSG-native→Transverse-Mercator
  resampling (:48-96); import-gated since the satpy stack is not a serving-host
  dependency.
- ``normalize_per_channel`` / ``Standardizer`` — the per-channel normalize of
  the ingest pipeline (BASELINE.json north-star transform set).
"""

from __future__ import annotations

import datetime
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from satflow_tpu_torch.nn.misc import crop_center  # noqa: F401  (re-export)

EUMETSAT_FILENAME_RE = re.compile(r"(\d{4})(\d{2})(\d{2})(\d{2})(\d{2})")


def eumetsat_name_to_datetime(filename: str) -> datetime.datetime:
    """Extract the acquisition datetime from an EUMETSAT product filename."""
    m = EUMETSAT_FILENAME_RE.search(filename)
    if not m:
        raise ValueError(f"No datetime found in filename {filename!r}")
    year, month, day, hour, minute = map(int, m.groups())
    return datetime.datetime(year, month, day, hour, minute)


def binarize_mask(mask: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Binarize a cloud-mask probability map (utils.py:115-119)."""
    return (np.asarray(mask) > threshold).astype(np.float32)


def create_pixel_coord_layers(
    height: int, width: int, with_r: bool = False
) -> np.ndarray:
    """Normalized [-1, 1] x/y (+radius) coordinate planes, (H, W, 2|3) NHWC."""
    yy = np.linspace(-1.0, 1.0, height, dtype=np.float32)[:, None]
    xx = np.linspace(-1.0, 1.0, width, dtype=np.float32)[None, :]
    yy = np.broadcast_to(yy, (height, width))
    xx = np.broadcast_to(xx, (height, width))
    layers = [xx, yy]
    if with_r:
        layers.append(np.sqrt(xx**2 + yy**2))
    return np.stack(layers, axis=-1)


def create_time_layer(
    dt: datetime.datetime, shape: Tuple[int, int]
) -> np.ndarray:
    """One-hot hour-of-day plane broadcast over the image (utils.py:99-112)."""
    hour_frac = (dt.hour * 60 + dt.minute) / (24 * 60)
    return np.full((*shape, 1), hour_frac, dtype=np.float32)


def check_channels(
    sat_channels: Sequence[str] = (),
    nwp_channels: Sequence[str] = (),
    use_topo: bool = False,
    use_latlon: bool = False,
    use_time: bool = False,
    use_mask: bool = True,
) -> int:
    """Total input channel count for a source combination (utils.py:163-188)."""
    channels = len(sat_channels) + len(nwp_channels)
    if use_topo:
        channels += 1
    if use_latlon:
        channels += 2
    if use_time:
        channels += 4
    if use_mask:
        channels += 1
    return channels


def map_satellite_to_mercator(
    native_satellite=None,
    frames: Optional[np.ndarray] = None,
    bands: Sequence[str] = (),
    save_scene: str = "geotiff",
    save_loc: Optional[str] = None,
    src_area=None,
    dst_area=None,
):
    """MSG native → Transverse-Mercator resample (reference utils.py:48-96).

    Two paths:
    - ``frames=`` (…, H, W) arrays already decoded from the SEVIRI native grid:
      reprojected with the in-repo numpy GEOS→TM resampler
      (:mod:`satflow_tpu_torch.data.geo` — no satpy/pyresample needed).
    - ``native_satellite=`` a .nat file: decoding MSG native files needs the
      satpy reader stack; used when available (parity with the reference's
      Scene flow), otherwise raises with a clear message.
    """
    from satflow_tpu_torch.data import geo

    src_area = src_area or geo.MSG_FULL_DISC_3KM
    dst_area = dst_area or geo.EUROPE_TM_AREA
    if frames is not None:
        out = geo.map_satellite_to_mercator_arrays(frames, src_area, dst_area)
        if save_loc is not None:
            np.save(save_loc, out)
        return out
    try:  # pragma: no cover - needs the satpy reader stack
        from satpy import Scene
    except ImportError as e:
        raise ImportError(
            "Decoding MSG .nat files needs satpy; either install the geo "
            "stack or pass decoded arrays via frames= (resampled in-repo)"
        ) from e
    scene = Scene(filenames={"seviri_l1b_native": [native_satellite]})
    scene.load(list(bands))
    arrays = np.stack([scene[b].values for b in bands])
    out = geo.map_satellite_to_mercator_arrays(arrays, src_area, dst_area)
    if save_loc is not None:
        np.save(save_loc, out)
    return out


class Standardizer:
    """Per-channel normalization: (x - mean) / std, channel-last."""

    def __init__(self, mean: np.ndarray, std: np.ndarray):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x, np.float32) - self.mean) / np.maximum(self.std, 1e-6)

    def inverse(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, np.float32) * self.std + self.mean


def normalize_per_channel(
    x: np.ndarray, stats: Optional[Dict[str, np.ndarray]] = None
) -> np.ndarray:
    """Normalize (..., C) by provided or computed per-channel stats."""
    x = np.asarray(x, np.float32)
    if stats is None:
        axes = tuple(range(x.ndim - 1))
        mean = x.mean(axis=axes)
        std = x.std(axis=axes)
    else:
        mean, std = stats["mean"], stats["std"]
    return (x - mean) / np.maximum(std, 1e-6)
