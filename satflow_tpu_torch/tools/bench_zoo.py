"""Model-zoo inference throughput on one card (frames/s, bf16 where safe).

The port's copy of the JAX package's ``tools/bench_zoo.py``. Beside the
flagship ConvLSTM (``tools/bench.py``) it forwards the other headline
families at the JAX tool's geometries:

- MetNet    — 256px input, 64px MetNet crop geometry, 24 lead times, b8 bf16
              (7 K3 and 2 K4 launches a forward);
- Perceiver — 64px, 12ch sat + topo modalities, depth 4, 256 latents of 256,
              the 24 steps together (``predict_timesteps_together``), b8 bf16;
- DGMR      — generator sampling at 128px, 24 steps, context 192, latent 384
              (``configs/model/nowcasting_gan.yaml``'s geometry), b4, its
              noise from a ``torch.Generator`` on the card;
- Unet      — 64px channels-stacked, 84 channels in, b8.

Weights come from ``torch.Generator`` seed 0 and the batch from the fake
data schema. Each iteration's input is the batch plus an epsilon computed
from the previous iteration's output (``tanh(sum(out)) * 1e-12``), so that
every forward depends on the last; one warm-up forward builds the kernels,
CUDA events time the chain and one scalar is fetched at the end.
``--tiny`` shrinks every geometry for a check on the CPU (16-32 px, 4 leads,
narrow widths). Usage::

    python -m satflow_tpu_torch.tools.bench_zoo [--iters 5] [--only metnet,...] [--device cuda]

Prints one JSON line per model: ``{"model", "geometry", "frames_per_sec",
"step_ms"}`` with ``card`` and ``kernel_launches`` (a forward's). ``--only``
refuses a name it does not know.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import torch

from satflow_tpu_torch.tools import benchkit

NAMES = ("metnet", "perceiver", "dgmr", "unet")
# the kernels each family's forward must launch on a card
KERNELS = {"litmetnet": ("K3", "K4")}


def configs(steps: int, tiny: bool) -> Dict[str, tuple]:
    """Each ``--only`` name's (registry name, model keywords, fake-data
    keywords, whether it samples as a GAN)."""
    bf16 = dict(dtype=torch.bfloat16)
    f = steps
    if tiny:
        return {
            "metnet": ("litmetnet", dict(input_channels=4, sat_channels=3, input_size=8,
                                         output_channels=3, forecast_steps=f, hidden_dim=8,
                                         **bf16),
                       dict(batch_size=2, width=32, height=32, number_sat_channels=3,
                            history_minutes=15, forecast_minutes=f * 5), False),
            "perceiver": ("perceiver", dict(
                forecast_steps=f, input_channels=3, sat_channels=3, input_size=8, depth=1,
                num_latents=8, latent_dim=16, dim=8, queries_dim=8, latent_dim_heads=8,
                cross_dim_heads=4, num_freq_bands=4, history_steps=3,
                predict_timesteps_together=True, **bf16),
                dict(batch_size=2, width=8, height=8, number_sat_channels=3,
                     history_minutes=15, forecast_minutes=f * 5), False),
            "dgmr": ("nowcastinggan", dict(
                forecast_steps=f, input_channels=1, output_shape=32, context_channels=16,
                latent_channels=16, disc_channels=4, disc_spatial_layers=2,
                disc_temporal_layers=1, num_samples=1),
                dict(batch_size=2, width=32, height=32, number_sat_channels=1,
                     history_minutes=15, forecast_minutes=f * 5), True),
            "unet": ("unet", dict(forecast_steps=f, input_channels=3 * 4,
                                  channels_per_timestep=3),
                     dict(batch_size=2, width=16, height=16, number_sat_channels=3,
                          history_minutes=15, forecast_minutes=f * 5), False),
        }
    return {
        "metnet": ("litmetnet", dict(input_channels=16, sat_channels=12, input_size=64,
                                     forecast_steps=f, hidden_dim=64, **bf16),
                   dict(batch_size=8, width=256, height=256, number_sat_channels=12,
                        history_minutes=30, forecast_minutes=f * 5), False),
        "perceiver": ("perceiver", dict(
            forecast_steps=f, input_channels=12, sat_channels=12, input_size=64, depth=4,
            num_latents=256, latent_dim=256, predict_timesteps_together=True, **bf16),
            dict(batch_size=8, width=64, height=64, number_sat_channels=12,
                 history_minutes=30, forecast_minutes=f * 5), False),
        "dgmr": ("nowcastinggan", dict(
            forecast_steps=f, input_channels=1, output_shape=128, context_channels=192,
            latent_channels=384, num_samples=1),
            dict(batch_size=4, width=128, height=128, number_sat_channels=1,
                 history_minutes=15, forecast_minutes=f * 5), True),
        "unet": ("unet", dict(forecast_steps=f, input_channels=12 * 7, channels_per_timestep=12),
                 dict(batch_size=8, width=64, height=64, number_sat_channels=12,
                      history_minutes=30, forecast_minutes=f * 5), False),
    }


def _plus(x, eps: torch.Tensor):
    if isinstance(x, dict):
        return {k: v + eps.to(v.dtype) for k, v in x.items()}
    return x + eps.to(x.dtype)


def _bench(name: str, model_kw: dict, ds_kw: dict, steps: int, iters: int, gan: bool,
           device: torch.device, card: str) -> dict:
    from satflow_tpu_torch.core.registry import create_model
    from satflow_tpu_torch.data.datamodule import to_device
    from satflow_tpu_torch.data.fake import FakeDataset

    model = create_model(name, generator=torch.Generator().manual_seed(0), **model_kw)
    batch = to_device(FakeDataset(length=1, **ds_kw)[0], device)
    model.to(device)
    model.materialize(batch)
    model.eval()
    x, _ = model.prepare_batch(batch)
    noise = torch.Generator(device=device).manual_seed(0)

    def fwd(xi):
        return model.generate(xi, False, noise) if gan else model(xi)

    def body(eps: torch.Tensor) -> torch.Tensor:
        out = fwd(_plus(x, eps))
        return torch.tanh(out.float().sum()) * 1e-12

    with torch.inference_mode():
        body(torch.zeros((), device=device))  # warm-up: builds the kernels
        eps, dt, per = benchkit.chain(body, torch.zeros((), device=device), iters, device)
        float(eps)
    benchkit.require(per, KERNELS.get(name, ()), device, f"bench_zoo {name}")
    bsz = ds_kw["batch_size"]
    return benchkit.emit({
        "model": name,
        "geometry": f"b{bsz} {ds_kw['width']}px F{steps}",
        "frames_per_sec": round(bsz * steps / dt, 1),
        "step_ms": round(dt * 1000, 2),
        "card": card,
        "kernel_launches": per,
    })


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--only", default="")
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--tiny", action="store_true",
                   help="every geometry shrunk, for a check on the CPU")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    only = set(filter(None, a.only.split(",")))
    unknown = sorted(only - set(NAMES))
    if unknown:
        raise ValueError(f"--only {', '.join(unknown)}: expected names of {NAMES}")
    import satflow_tpu_torch.models  # noqa: F401 - populate the registry

    device, card = benchkit.device_and_card(a.device)
    out = []
    for key, (name, model_kw, ds_kw, gan) in configs(a.steps, a.tiny).items():
        if not only or key in only:
            out.append(_bench(name, model_kw, ds_kw, a.steps, a.iters, gan, device, card))
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
