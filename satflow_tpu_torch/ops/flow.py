"""Dense optical flow and image warping for the baseline harness,
counterpart of ``satflow_tpu/ops/flow.py``.

- ``warp_flow``: a bilinear warp with ``cv2.remap`` semantics: the source
  coordinates are clipped to the image first, then floored and gathered by
  hand (``F.grid_sample``'s corner and border rules are another function);
- ``horn_schunck_flow``: the iterative dense-flow solve, 200 Jacobi
  iterations in a loop on the frames' device;
- ``farneback_flow``: OpenCV's Farneback when ``cv2`` imports, else
  Horn–Schunck: the JAX module's own documented rule
  (:func:`farneback_backend` says which runs);
- ``rollout_warp``: the warp applied ``steps`` times.

Every function runs where its input tensors are.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from satflow_tpu_torch.ops.ssim import no_tf32

# the Horn-Schunck neighbour average (symmetric, so correlation = convolution)
_HS_KERNEL = ((1 / 12, 1 / 6, 1 / 12), (1 / 6, 0.0, 1 / 6), (1 / 12, 1 / 6, 1 / 12))


def warp_flow(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``cv2.remap``-equivalent bilinear warp: out(y, x) = img(y + fy, x + fx).

    img: (H, W) or (H, W, C); flow: (H, W, 2) with (fx, fy) ordering as
    OpenCV. Out-of-range samples clamp to the border.
    """
    h, w = img.shape[:2]
    yy, xx = torch.meshgrid(torch.arange(h, dtype=flow.dtype, device=flow.device),
                            torch.arange(w, dtype=flow.dtype, device=flow.device),
                            indexing="ij")
    src_x = torch.clamp(xx + flow[..., 0], 0.0, w - 1.0)
    src_y = torch.clamp(yy + flow[..., 1], 0.0, h - 1.0)
    return _bilinear(img, src_y, src_x)


def _bilinear(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``img`` (H, W[, C]) sampled at the in-range float coordinates (y, x)
    of shape (H', W'), each channel alike."""
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = torch.clamp(y0 + 1, max=img.shape[0] - 1)
    x1 = torch.clamp(x0 + 1, max=img.shape[1] - 1)
    wy = y - y0
    wx = x - x0
    if img.dim() == 3:
        wy, wx = wy[..., None], wx[..., None]
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (
        v00 * (1 - wy) * (1 - wx)
        + v01 * (1 - wy) * wx
        + v10 * wy * (1 - wx)
        + v11 * wy * wx
    )


def horn_schunck_flow(
    prev: torch.Tensor,
    curr: torch.Tensor,
    alpha: float = 0.05,
    num_iters: int = 200,
) -> torch.Tensor:
    """Horn–Schunck extrapolation flow over (H, W) frames -> (H, W, 2) (fx, fy).

    Jacobi relaxation, ``num_iters`` steps on the frames' device. The
    derivative stencils shift with a periodic border (``torch.roll``); the
    3x3 neighbour average has a zero border. The returned flow is
    -motion(prev -> curr), so ``warp_flow(curr, flow)`` extrapolates the
    next frame.
    """
    prev = torch.as_tensor(prev).float()
    curr = torch.as_tensor(curr).float()
    ix = (_shift(curr, 0, -1) - _shift(curr, 0, 1)) * 0.5
    iy = (_shift(curr, -1, 0) - _shift(curr, 1, 0)) * 0.5
    it = curr - prev
    kernel = torch.tensor(_HS_KERNEL, dtype=torch.float32, device=curr.device)[None, None]
    den = alpha**2 + ix * ix + iy * iy

    def avg(f):
        with no_tf32():
            return F.conv2d(f[None, None], kernel, padding=1)[0, 0]

    u = v = torch.zeros_like(curr)
    with torch.no_grad():
        for _ in range(num_iters):
            u_bar = avg(u)
            v_bar = avg(v)
            num = ix * u_bar + iy * v_bar + it
            u = u_bar - ix * num / den
            v = v_bar - iy * num / den
    # the flow whose forward warp of curr extrapolates the motion
    return torch.stack([-u, -v], dim=-1)


def farneback_backend() -> str:
    """Which solve :func:`farneback_flow` runs in this process: ``"opencv"``
    when ``cv2`` imports, else ``"horn_schunck"``."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return "horn_schunck"
    return "opencv"


def farneback_flow(prev, curr) -> torch.Tensor:
    """Extrapolation flow (H, W, 2) from the (older, latest) frames, on their
    device (a numpy frame counts as on the CPU).

    With OpenCV: ``calcOpticalFlowFarneback(latest, older, ...)`` with the
    reference's parameters, the backward flow whose forward warp
    extrapolates the motion, on the pair rescaled to 0-255 (Farneback's
    thresholds assume 8-bit intensities; [0, 1] frames read as flat). Without
    ``cv2``: :func:`horn_schunck_flow`, same sign convention.
    """
    prev, curr = torch.as_tensor(prev), torch.as_tensor(curr)
    try:
        import cv2
    except ImportError:
        return horn_schunck_flow(prev, curr)
    a = curr.detach().cpu().numpy().astype(np.float32)
    b = prev.detach().cpu().numpy().astype(np.float32)
    lo = min(a.min(), b.min())
    hi = max(a.max(), b.max())
    scale = 255.0 / max(hi - lo, 1e-6)
    flow = cv2.calcOpticalFlowFarneback((a - lo) * scale, (b - lo) * scale,
                                        None, 0.5, 3, 15, 3, 5, 1.2, 0)
    return torch.from_numpy(flow).to(curr.device)


def rollout_warp(frame: torch.Tensor, flow: torch.Tensor, steps: int) -> torch.Tensor:
    """``warp_flow`` applied ``steps`` times: (H, W[, C]) -> (steps, H, W[, C])."""
    frames = []
    img = frame
    for _ in range(steps):
        img = warp_flow(img, flow)
        frames.append(img)
    return torch.stack(frames)


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(x, (dy, dx), dims=(0, 1))
