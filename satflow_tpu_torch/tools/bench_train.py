"""Training-step throughput bench for the flagship ConvLSTM on one card.

The port's copy of the JAX package's ``tools/bench_train.py``. It measures
frames/s of the FULL train step (forward + backward + Adam) at the
reference's 64px training shape (``--size 64 --batch 32``) and at the 256px
production shape with remat (``--size 256 --batch 8 --remat --remat-chunk
6``), bf16 compute on f32 weights from ``torch.Generator`` seed 0 (K1 and
K2: 124 K1 and 62 K2 a step under ``remat_chunk=6``, 62 and 62 without
remat). One warm-up step builds the kernels (``compile_s``, ``loss0``);
the timed steps are chained through the train state (each updates the
weights the next one reads), CUDA events time them and one scalar, the
losses' sum, is fetched at the end. Usage::

    python -m satflow_tpu_torch.tools.bench_train [--size 64] [--batch 32] [--steps 24]
        [--remat] [--remat-chunk 0] [--cell fused] [--iters 8] [--device cuda]

``--model metnet|perceiver|dgmr`` instead measures the other families'
full train step at the zoo bench's geometries (``tools/bench_zoo.py``):
MetNet 256px in / 64px crop out, b8 bf16 (7 K3 and 2 K4 a step); the
Perceiver 64px F24, b8 bf16; DGMR 128px F24, b4, float32, with its 2:1
discriminator:generator rounds (``--gan-step fused|split``: the port's
``make_gan_train_step`` modes; both are eager, ``split`` exposes the two
halves). ``--tiny`` shrinks those geometries for a check on the CPU.

``--from-store DIR`` drives the train step from an on-disk ``.sfb`` store
through ``Prefetcher`` and the native ingest library (written first with
``write_fake_store`` and ``convert`` unless DIR holds one of this
geometry; the library is built with ``make -C native``, and a failed build
raises); ``--pipeline-only`` measures the host's store -> decode -> split
-> batch rate with no device. Each prints one JSON line with the JAX
tool's keys, ``card`` and ``kernel_launches`` (a step's).
"""

from __future__ import annotations

import argparse
import os
import shutil
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from satflow_tpu_torch.tools import benchkit


def chained_steps(step: Callable, state, batch, iters: int, device: torch.device,
                  key: str = "loss") -> Tuple[torch.Tensor, float, Dict[str, float]]:
    """``iters`` train steps chained through ``state``: (the sum of their
    losses ``key``, a device scalar; seconds a step; launches a step)."""

    def body(total: torch.Tensor) -> torch.Tensor:
        return total + step(state, batch)[key].float()

    return benchkit.chain(body, torch.zeros((), device=device), iters, device)


def _warm(step: Callable, state, batch, device: torch.device, key: str):
    """The first step (it builds the kernels): (its loss, its seconds)."""
    benchkit.synchronize(device)
    t0 = time.perf_counter()
    loss0 = float(step(state, batch)[key])
    return loss0, time.perf_counter() - t0


def _record(metric: str, fps: float, dt: float, compile_s: float, loss0: float, card: str,
            per: Dict[str, float]) -> dict:
    return benchkit.emit({
        "metric": metric,
        "value": round(fps, 2),
        "unit": "frames/s",
        "step_ms": round(dt * 1000, 2),
        "compile_s": round(compile_s, 1),
        "loss0": loss0,
        "card": card,
        "kernel_launches": per,
    })


def convlstm(a, device: torch.device, dtype=torch.bfloat16):
    """The flagship model and its optimizer state, on ``device``."""
    from satflow_tpu_torch.core.registry import create_model
    import satflow_tpu_torch.models  # noqa: F401 - populate the registry
    from satflow_tpu_torch.train.state import TrainState

    model = create_model(
        "encoderdecoderconvlstm", input_channels=a.channels, out_channels=a.channels,
        forecast_steps=a.steps, hidden_dim=a.hidden, cell_impl=a.cell, remat=a.remat,
        remat_chunk=a.remat_chunk, dtype=dtype, lr=1e-3,
        generator=torch.Generator().manual_seed(0),
    ).to(device)
    return model, TrainState(model, model.make_optimizer())


def synthetic_batch(a, device: torch.device, dtype=torch.bfloat16):
    """A uniform (x, y) batch from ``torch.Generator`` seed 0, on ``device``."""
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(a.batch, a.history, a.size, a.size, a.channels, generator=gen)
    y = torch.rand(a.batch, a.steps, a.size, a.size, a.channels, generator=gen)
    return x.to(device, dtype), y.to(device, dtype)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--batch", type=int, default=None,
                   help="default 32 (ConvLSTM), or the zoo-bench geometry "
                        "for --model (metnet/perceiver 8, dgmr 4)")
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--channels", type=int, default=12)
    p.add_argument("--history", type=int, default=7)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--remat", action="store_true", default=False)
    p.add_argument("--remat-chunk", type=int, default=0)
    p.add_argument("--cell", default="fused")
    p.add_argument("--from-store", default=None, metavar="DIR",
                   help="drive the train step from an on-disk .sfb store through "
                        "Prefetcher + native ingest; writes the store first if DIR "
                        "holds none of this geometry")
    p.add_argument("--pipeline-only", action="store_true",
                   help="with --from-store: measure the host-side store->decode->split->"
                        "batch rate without touching the device")
    p.add_argument("--store-batches", type=int, default=12)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--model", default=None, choices=("metnet", "perceiver", "dgmr"),
                   help="bench another family's train step at its zoo-bench geometry")
    p.add_argument("--gan-step", default="fused", choices=("fused", "split"),
                   help="GAN step mode (--model dgmr)")
    p.add_argument("--tiny", action="store_true",
                   help="with --model: the geometry shrunk, for a check on the CPU")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    import satflow_tpu_torch.models  # noqa: F401 - populate the registry

    if a.model:
        if a.batch is None:
            a.batch = {"metnet": 8, "perceiver": 8, "dgmr": 4}[a.model]
        return bench_model(a)
    if a.batch is None:
        a.batch = 32
    if a.from_store:
        return bench_from_store(a)

    from satflow_tpu_torch.train.steps import make_train_step

    device, card = benchkit.device_and_card(a.device)
    model, state = convlstm(a, device)
    batch = synthetic_batch(a, device)
    step = make_train_step(model)
    loss0, compile_s = _warm(step, state, batch, device, "loss")
    total, dt, per = chained_steps(step, state, batch, a.iters, device)
    float(total)
    benchkit.require(per, [benchkit.step_kernel(), "K2"], device, "bench_train")
    return _record(f"train frames/s/chip {a.size}px b{a.batch} F{a.steps} {a.cell} "
                   f"remat={a.remat}" + (f" chunk={a.remat_chunk}" if a.remat_chunk else ""),
                   a.batch * a.steps / dt, dt, compile_s, loss0, card, per)


def bench_model(a) -> dict:
    """The full train step of MetNet, the Perceiver or DGMR at the zoo
    bench's geometry, chained through the (GAN) train state."""
    from satflow_tpu_torch.core.registry import create_model
    from satflow_tpu_torch.data.datamodule import to_device
    from satflow_tpu_torch.data.fake import FakeDataset
    from satflow_tpu_torch.tools.bench_zoo import configs
    from satflow_tpu_torch.train.state import GANTrainState, TrainState
    from satflow_tpu_torch.train.steps import make_gan_train_step, make_train_step

    device, card = benchkit.device_and_card(a.device)
    f = a.steps
    registry_name, model_kw, ds_kw, gan = configs(f, a.tiny)[a.model]
    ds_kw = dict(ds_kw, batch_size=a.batch)
    model_kw = dict(model_kw, disc_steps=2) if gan else dict(model_kw, lr=1e-3)
    label = {"metnet": f"metnet {ds_kw['width']}px->crop b{a.batch} F{f}",
             "perceiver": f"perceiver {ds_kw['width']}px b{a.batch} F{f}",
             "dgmr": f"dgmr {ds_kw['width']}px b{a.batch} F{f} disc2:1"}[a.model]
    model = create_model(registry_name, generator=torch.Generator().manual_seed(0), **model_kw)
    batch = to_device(FakeDataset(length=1, **ds_kw)[0], device)
    model.to(device)
    model.materialize(batch)
    if gan:
        state = GANTrainState.create(model, *model.make_optimizers(),
                                     noise=torch.Generator(device=device).manual_seed(0))
        step = make_gan_train_step(model, mode=a.gan_step)
        key = "g_loss"
        if a.gan_step == "split":
            label += " split-D/G"
    else:
        state = TrainState(model, model.make_optimizer())
        step = make_train_step(model)
        key = "loss"
    loss0, compile_s = _warm(step, state, batch, device, key)
    total, dt, per = chained_steps(step, state, batch, a.iters, device, key)
    float(total)
    benchkit.require(per, ("K3", "K4") if a.model == "metnet" else (), device,
                     f"bench_train --model {a.model}")
    return _record(f"train frames/s/chip {label}", a.batch * f / dt, dt, compile_s, loss0,
                   card, per)


def _store(a) -> str:
    """The ``.sfb`` store under ``--from-store`` (written unless it holds one
    of this geometry: a stale store of another batch or size would be timed
    under the wrong label)."""
    from satflow_tpu_torch.data.convert import convert
    from satflow_tpu_torch.data.datasets import SfbBatchStore, write_fake_store

    seq = a.history + a.steps
    store = os.path.join(a.from_store, "train")

    def matches() -> bool:
        if not os.path.isdir(store):
            return False
        try:
            s = SfbBatchStore(store)
            return len(s) >= 1 and s.read(0)["sat_data"].shape == (
                a.batch, seq, a.size, a.size, a.channels)
        except Exception:  # noqa: BLE001 - unreadable == rebuild
            return False

    if not matches():
        shutil.rmtree(store, ignore_errors=True)
        npz = os.path.join(a.from_store, "_npz")
        shutil.rmtree(npz, ignore_errors=True)
        write_fake_store(npz, n_batches=a.store_batches, batch_size=a.batch, size=a.size,
                         seq_length=seq, sat_channels=a.channels)
        convert(npz, store, temp_path=a.from_store, verbose=False)
        print(f"# wrote {a.store_batches} sfb batches to {store}", flush=True)
    return store


def bench_from_store(a) -> dict:
    """The input pipeline feeding the card: ``--pipeline-only`` times the
    host's store -> native decode -> past/future split -> batch rate (no
    device); else the full loop, each batch put on the device by the loader
    and consumed by the train step (host clock, synchronised at the end)."""
    from satflow_tpu_torch.data.datamodule import SatFlowDataModule
    from satflow_tpu_torch.data.datasets import NativeStreamingDataset
    from satflow_tpu_torch.data.native_ingest import build_native

    device, card = benchkit.device_and_card(a.device)
    if not build_native():
        raise RuntimeError("the native ingest library did not build (make -C native): the "
                           "store bench reads through it")
    _store(a)
    seq = a.history + a.steps
    dm = SatFlowDataModule(data_path=a.from_store, num_workers=a.workers, prefetch_factor=4,
                           shard=not a.pipeline_only, history_minutes=(a.history - 1) * 5,
                           forecast_minutes=a.steps * 5)
    if not isinstance(dm.train_dataloader().dataset, NativeStreamingDataset):
        raise RuntimeError("the store is not read through the native ingest library")

    if a.pipeline_only:
        frames = 0
        for _ in dm.train_dataloader():  # one pass to warm caches and threads
            pass
        before = benchkit.launches()
        t0 = time.perf_counter()
        batches = 0
        for _ in range(3):
            for x, _ in dm.train_dataloader():
                frames += x["sat_data"].shape[0] * a.steps
                batches += 1
        dt = time.perf_counter() - t0
        mb = frames / a.steps * seq * a.size * a.size * a.channels * 4 / 1e6
        return benchkit.emit({
            "metric": f"input pipeline frames/s {a.size}px b{a.batch} ({a.workers} workers, "
                      f"native ingest)",
            "value": round(frames / dt, 2),
            "unit": "frames/s",
            "mb_per_s": round(mb / dt, 1),
            "card": card,
            "kernel_launches": benchkit.per_iteration(before, batches),
        })

    from satflow_tpu_torch.train.steps import make_train_step

    dm.device = device
    model, state = convlstm(a, device)
    step = make_train_step(model)
    first = next(iter(dm.train_dataloader()))
    _warm(step, state, first, device, "loss")

    frames = timed = 0
    t0 = before = m = None
    for _ in range(3):
        for batch in dm.train_dataloader():
            m = step(state, batch)
            if t0 is None:
                benchkit.synchronize(device)
                t0, before = time.perf_counter(), benchkit.launches()
            else:
                # count from the batch itself: it is what the card processed
                frames += batch[0]["sat_data"].shape[0] * a.steps
                timed += 1
    float(m["loss"])
    dt = time.perf_counter() - t0
    per = benchkit.per_iteration(before, timed)
    benchkit.require(per, [benchkit.step_kernel(), "K2"], device, "bench_train --from-store")
    return benchkit.emit({
        "metric": f"store-fed train frames/s {a.size}px b{a.batch} F{a.steps} "
                  f"({a.workers} workers)",
        "value": round(frames / dt, 2),
        "unit": "frames/s",
        "note": "host clock: the store's native decode, the host-to-device copies and the "
                "train steps",
        "card": card,
        "kernel_launches": per,
    })


if __name__ == "__main__":
    main()
