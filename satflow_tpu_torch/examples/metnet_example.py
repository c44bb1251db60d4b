"""MetNet inference example, counterpart of ``satflow_tpu/examples/metnet_example.py``.

``LitMetNet(input_channels=17, sat_channels=13, input_size=64)`` with hidden
width 32 and 24 lead times on the reference example's geometry, in NHWC:
input (1, 7, 256, 256, 17) -> output (1, 24, 16, 16, 1), the center 1/4 crop
at 1/4 resolution. The inputs are synthetic (uniform draws from a seeded
``torch.Generator``), so no release artifact is needed; the weights are the
model's own random init. It runs on the card (through K3 and K4) unless
asked for the CPU:

    python -m satflow_tpu_torch.examples.metnet_example [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from satflow_tpu_torch import resolve_device
from satflow_tpu_torch.models.metnet import LitMetNet


def main(argv: Optional[Sequence[str]] = None) -> torch.Tensor:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="where it runs (the card by default)")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    gen = torch.Generator().manual_seed(42)
    model = LitMetNet(
        input_channels=17,
        sat_channels=13,
        input_size=64,
        output_channels=1,
        hidden_dim=32,
        forecast_steps=24,
        generator=gen,
    )
    # NHWC equivalent of the reference's (B, 7, 17, 256, 256) input
    x = torch.rand(1, 7, 256, 256, 17, generator=gen).to(device)
    model = model.to(device)
    model.materialize((x, x))
    model.eval()
    with torch.no_grad():
        y_hat = model(x)
    print(f"input  {tuple(x.shape)}")
    print(f"output {tuple(y_hat.shape)}  (expected (1, 24, 16, 16, 1))")
    assert y_hat.shape == (1, 24, 16, 16, 1)
    return y_hat


if __name__ == "__main__":
    main()
