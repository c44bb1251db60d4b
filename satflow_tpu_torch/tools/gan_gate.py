"""GAN quality study: CloudGAN, Pix2Pix and a small DGMR trained on
advection and scored against persistence and optical flow.

The port's copy of the JAX package's ``tools/gan_gate.py``, with its data
(``DS_KW``: the accuracy gate's 32 px geometry, one channel), its eval set
(3 batches at seed 300) and its recipes:

- ``cloudgan``: the ConvLSTM generator (K1 / K2 on a card), 32 filters,
  lsgan + 100 x L1, lr 1e-3, 20 epochs;
- ``pix2pix``: the stacked-channels ``resnet_6blocks`` generator and the
  PatchGAN, the same losses and budget;
- ``dgmr``: ``nowcastinggan`` (context 24, latent 48, discriminators 6
  channels, 3 samples, grid_lambda 20, lrs 2e-4 / 5e-5, one D step) trained
  150 epochs on ``StochasticAdvectionDataset`` (the future velocity redrawn at
  the boundary, so the samples' spread means something), scored by its
  ensemble (CRPS at M=3 and the fair M=8, spread) against persistence and an
  oracle 3-mode sampler; the checkpoint of the lowest CRPS on a held-out
  batch is kept (:class:`CRPSSelect`) and fine-tuned on the fair CRPS
  (``crps_finetune``, 1600 steps at M=8, warmup-cosine). The JAX knobs
  ``SATFLOW_DGMR_EPOCHS``, ``SATFLOW_DGMR_FT_STEPS`` and
  ``SATFLOW_DGMR_FT_SAMPLES`` set those three budgets. With ``--init FILE``
  (``--arms dgmr`` only) DGMR starts from the variables in FILE instead of
  the port's own draw (:func:`load_init`; the JAX Trainer's initial ones are
  committed as ``results/dgmr_jax_init.npz``), and its three rows go under
  the suffix ``@jax_init``, each with the file's sha256.

    python -m satflow_tpu_torch.tools.gan_gate [--arms cloudgan,pix2pix]
        [--out DIR] [--device cuda] [--init FILE]

Writes ``gan_results.json`` (a rerun merges into it) and ``gan_results.md``
under ``--out`` only, and prints the results.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from satflow_tpu_torch.train.callbacks import Callback
from satflow_tpu_torch.tools.studies import (
    baseline_rows,
    card_name,
    curve,
    ensemble_row,
    full_f32,
    load_results,
    save_results,
    study_dm,
)

# The headline study geometry (tools/accuracy_gate.py DS_KW, single-channel).
DS_KW = dict(batch_size=8, width=32, height=32, number_sat_channels=1,
             history_minutes=15, forecast_minutes=60, velocity=(1, 2),
             decay=0.93, n_blobs=4)
STEPS = 12
EVAL_BATCHES = 3
ALL_ARMS = ("cloudgan", "pix2pix", "dgmr")
RESULTS = "gan_results.json"
# The recipes. CloudGAN: 20 epochs at lr 1e-3 keep the lsgan game live (at
# 30 epochs and 2e-3 the discriminator won outright in the JAX study).
# Pix2Pix: resnet_6blocks (unet_128's 7 downsamplings exceed 32 px).
CLOUDGAN = dict(forecast_steps=STEPS, input_channels=1, channels_per_timestep=1,
                generator_model="convlstm", num_filters=32, lr=1e-3, lambda_l1=100.0,
                loss="lsgan")
PIX2PIX = dict(forecast_steps=STEPS, input_channels=4, channels_per_timestep=1,
               generator_model="resnet_6blocks", num_filters=32, lr=1e-3, lambda_l1=100.0,
               loss="lsgan")
DGMR = dict(forecast_steps=STEPS, input_channels=1, output_shape=DS_KW["width"],
            context_channels=24, latent_channels=48, disc_channels=6, num_samples=3,
            grid_lambda=20.0, disc_steps=1, gen_lr=2e-4, disc_lr=5e-5)
EPOCHS = {"cloudgan": 20, "pix2pix": 20}
FINETUNE_LR = 2e-4
FINETUNE_EVERY = 400


def load_init(model, path: str) -> str:
    """Fill every parameter and buffer of the GAN ``model`` from ``path``, a
    flat ``.npz`` of its generator's and discriminator's flax variables
    (:func:`~satflow_tpu_torch.interop.jax_weights.save_gan_npz`: every
    collection, the spectral-norm ``u`` included); returns the file's
    sha256. Raises unless every array of the file lands on one of them and
    every one of them is filled, each at its shape."""
    from satflow_tpu_torch.interop.jax_weights import gan_state_dict_from_flax, read_gan_npz

    sd = gan_state_dict_from_flax(*read_gan_npz(path))
    with np.load(path) as data:
        if len(data.files) != len(sd):
            raise KeyError(f"{path}: {len(data.files)} arrays map to {len(sd)} keys")
    model.load_state_dict(sd)  # strict: a missing or unexpected key raises
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class CRPSSelect(Callback):
    """Diversity-aware checkpoint selection: after every validation, the
    generator's CRPS on one held-out batch (``model.num_samples`` eval-mode
    samples drawn from a generator seeded ``seed``); the lowest keeps a copy
    of the generator's weights and buffers in ``best["state"]``.

    Mid-training DGMR checkpoints are diverse before the grid-regularized mean
    converges and collapses them; CRPS penalizes both a miss and a collapse,
    so it picks the best point on that trajectory. The copy is a clone: the
    optimizer updates the parameters in place, so a ``state_dict()`` of
    references would follow the training past the selected epoch.
    """

    def __init__(self, model, ds, seed: int = 123):
        self.model = model
        self.batch = ds[0]
        self.seed = seed
        self.best: Optional[Dict] = None
        self.trajectory = []

    def probe(self):
        """(CRPS, mean spread) of the generator's current weights; nothing of
        its state moves."""
        from satflow_tpu_torch.data.datamodule import to_device
        from satflow_tpu_torch.eval.probabilistic import crps_ensemble
        from satflow_tpu_torch.nn.norm import frozen_state

        model = self.model
        device = next(model.parameters()).device
        x, y = model.prepare_batch(to_device(self.batch, device))
        training = model.module.training
        try:
            with torch.no_grad(), frozen_state(model):
                samples, _ = model._sample(x, torch.Generator(device=device).manual_seed(self.seed),
                                           False, model.num_samples)
        finally:
            model.module.train(training)
        return (float(torch.mean(crps_ensemble(samples, y))),
                float(torch.mean(torch.std(samples, dim=1, correction=0))))

    def on_validation_end(self, engine, metrics, epoch):
        crps, std = self.probe()
        self.trajectory.append({"epoch": epoch, "crps": crps, "std": std})
        if self.best is None or crps < self.best["crps"]:
            self.best = {"epoch": epoch, "crps": crps, "std": std,
                         "state": {k: v.detach().clone()
                                   for k, v in self.model.module.state_dict().items()}}


def _oracle_modes(x_last, ds_kw=None, steps=STEPS):
    """(B, 3, T, H, W, C) rollouts of the 3 future-velocity modes."""
    ds_kw = ds_kw or DS_KW
    dy, dx = ds_kw["velocity"]
    modes = []
    for ddy, ddx in ((0, -2), (0, 0), (0, 2)):
        cur = np.asarray(x_last).copy()
        seq = []
        for _ in range(steps):
            cur = np.roll(np.roll(cur, dy + ddy, axis=1), dx + ddx, axis=2)
            cur = cur * ds_kw["decay"]
            seq.append(cur)
        modes.append(np.stack(seq, axis=1))
    return np.stack(modes, axis=1)


def _oracle_std_and_crps(eval_ds, ds_kw=None, steps=STEPS, max_batches=EVAL_BATCHES):
    """Spread + CRPS of a PERFECT 3-mode sampler on the stochastic set."""
    from satflow_tpu_torch.eval.probabilistic import crps_ensemble

    stds, crpss = [], []
    for bi, (x, y) in enumerate(eval_ds):
        if bi >= max_batches:
            break
        ens = _oracle_modes(np.asarray(x["sat_data"])[:, -1], ds_kw, steps)
        stds.append(ens.std(axis=1).mean())
        crpss.append(float(torch.mean(crps_ensemble(
            torch.from_numpy(ens), torch.from_numpy(np.asarray(y["sat_data"]))))))
    return float(np.mean(stds)), float(np.mean(crpss))


def _persistence_rows(eval_ds, steps=STEPS, max_batches=EVAL_BATCHES):
    """Persistence's MSE curve and CRPS (= MAE, the M=1 ensemble)."""
    from satflow_tpu_torch.eval.probabilistic import crps_deterministic

    mses, crpss = [], []
    for bi, (x, y) in enumerate(eval_ds):
        if bi >= max_batches:
            break
        last = np.asarray(x["sat_data"])[:, -1]
        fut = np.asarray(y["sat_data"])
        persist = np.broadcast_to(last[:, None], (last.shape[0], steps) + last.shape[1:])
        mses.append(((persist - fut) ** 2).mean(axis=(0, 2, 3, 4)))
        crpss.append(float(torch.mean(crps_deterministic(
            torch.from_numpy(persist.copy()), torch.from_numpy(fut)))))
    return np.mean(mses, axis=0), float(np.mean(crpss))


def _persistence_crps(eval_ds):
    """CRPS (= MAE, the M=1 ensemble) of persistence on the stochastic set."""
    return _persistence_rows(eval_ds)[1]


def main(arms: Optional[Iterable[str]] = None, out: Optional[str] = None, device="cuda",
         epochs: Optional[Dict[str, int]] = None, finetune_steps: Optional[int] = None,
         finetune_samples: Optional[int] = None, length: int = 12,
         init: Optional[str] = None) -> Dict:
    """Run ``arms`` (default all) on ``device``; returns the results (merged
    into ``out``'s file if given). ``epochs`` overrides an arm's budget,
    ``finetune_steps`` / ``finetune_samples`` DGMR's fine-tune (defaults: the
    JAX knobs' environment variables, else 150 epochs, 1600 steps, M=8),
    ``length`` the batches of an epoch (the JAX tool's 12). ``init``, a file
    of DGMR's initial variables (:func:`load_init`), starts the ``dgmr`` arm
    from it; its rows take the suffix ``@jax_init``."""
    from satflow_tpu_torch import resolve_device
    from satflow_tpu_torch.baseline.optical_flow import run_baseline
    from satflow_tpu_torch.core.registry import create_model
    from satflow_tpu_torch.data.fake import DecayingAdvectionDataset, StochasticAdvectionDataset
    from satflow_tpu_torch.eval.evaluate import evaluate_model
    from satflow_tpu_torch.train import Trainer
    from satflow_tpu_torch.train.probabilistic import crps_finetune
    import satflow_tpu_torch.models  # noqa: F401 - populate the registry

    arms = set(arms or ALL_ARMS)
    unknown = arms - set(ALL_ARMS)
    if unknown:
        raise SystemExit(f"unknown --arms {sorted(unknown)}; valid: {list(ALL_ARMS)}")
    if init and arms != {"dgmr"}:
        raise SystemExit("--init holds DGMR's initial variables: run it with --arms dgmr")
    budget = {**EPOCHS, "dgmr": int(os.environ.get("SATFLOW_DGMR_EPOCHS", "150")),
              **(epochs or {})}
    if finetune_steps is None:
        finetune_steps = int(os.environ.get("SATFLOW_DGMR_FT_STEPS", "1600"))
    if finetune_samples is None:
        finetune_samples = int(os.environ.get("SATFLOW_DGMR_FT_SAMPLES", "8"))
    device = resolve_device(device)
    full_f32(device)
    card = card_name(device)
    eval_ds = DecayingAdvectionDataset(length=EVAL_BATCHES, seed=300, **DS_KW)
    load_results(out, RESULTS, card)  # a file of another card raises before any training
    results = {}

    results.update(baseline_rows(run_baseline(
        eval_ds, forecast_steps=STEPS, flow_method="farneback", max_batches=EVAL_BATCHES,
        device=device)))

    def fit(model, dm, **trainer_kw):
        trainer = Trainer(max_epochs=budget[name], log_every_n_steps=1000, device=device,
                          **trainer_kw)
        t0 = time.perf_counter()
        trainer.fit(model, dm)
        return trainer, time.perf_counter() - t0

    # the conditional-deterministic GANs on the headline geometry: the
    # generator's curves, and the adversarial health at the end
    for name, recipe in (("cloudgan", CLOUDGAN), ("pix2pix", PIX2PIX)):
        if name not in arms:
            continue
        model = create_model(name, generator=torch.Generator().manual_seed(0), **recipe)
        trainer, train_s = fit(model, study_dm(DecayingAdvectionDataset, DS_KW, length))
        curves = evaluate_model(model, eval_ds, max_batches=EVAL_BATCHES, compute_ms_ssim=False)
        results[name] = {**curve(curves["mse"]),
                         "d_loss": float(trainer.callback_metrics["train/d_loss"]),
                         "g_adv_loss": float(trainer.callback_metrics["train/g_adv_loss"]),
                         "epochs": budget[name], "train_seconds": train_s}
        print(name, "mse", results[name]["mse"], "d_loss", results[name]["d_loss"], flush=True)

    if "dgmr" in arms:
        name = "dgmr"
        eval_sto = StochasticAdvectionDataset(length=EVAL_BATCHES, seed=300, **DS_KW)
        base_sto = run_baseline(eval_sto, forecast_steps=STEPS, flow_method="farneback",
                                max_batches=EVAL_BATCHES, device=device)
        results["persistence@stochastic"] = {**curve(base_sto["baseline_loss"]),
                                             "crps": _persistence_crps(eval_sto)}
        results["oracle_sample_std"], results["oracle_crps"] = _oracle_std_and_crps(eval_sto)

        dgmr = create_model("nowcastinggan", generator=torch.Generator().manual_seed(0), **DGMR)
        # the rows of a run from a file of initial variables, and the file
        suffix, origin = ("@jax_init", {"init_sha256": load_init(dgmr, init)}) if init else ("", {})
        selector = CRPSSelect(dgmr, StochasticAdvectionDataset(length=1, seed=400, **DS_KW))
        trainer, train_s = fit(dgmr, study_dm(StochasticAdvectionDataset, DS_KW, length),
                               limit_val_batches=1, callbacks=[selector])

        def row(model):
            return ensemble_row(model, eval_sto, EVAL_BATCHES)

        final = results["dgmr" + suffix] = {
            **row(dgmr), "d_loss": float(trainer.callback_metrics["train/d_loss"]),
            "epochs": budget[name], "num_samples": dgmr.num_samples, "train_seconds": train_s,
            **origin}
        sel = selector.best
        dgmr.module.load_state_dict(sel["state"])
        selected = results["dgmr_crps_selected" + suffix] = {
            **row(dgmr), "selected_epoch": sel["epoch"], "num_samples": dgmr.num_samples,
            # the selection curve, every 10th epoch
            "trajectory": selector.trajectory[::10], **origin}
        print("dgmr" + suffix, "final", {k: final[k] for k in ("mse", "crps", "sample_std")},
              "selected (epoch", sel["epoch"], ")",
              {k: selected[k] for k in ("mse", "crps", "sample_std")}, flush=True)

        # the selected checkpoint is accurate but collapsed: a generator-only
        # fine-tune on the fair CRPS (a proper score) restores calibrated spread
        train_sto = StochasticAdvectionDataset(length=length, seed=0, **DS_KW)
        t0 = time.perf_counter()
        _, hist = crps_finetune(dgmr, list(train_sto), steps=finetune_steps,
                                num_samples=finetune_samples, lr=FINETUNE_LR,
                                lr_schedule="cosine", eval_every=FINETUNE_EVERY, eval_fn=row)
        tuned = results["dgmr_crps_finetuned" + suffix] = {
            **row(dgmr), "finetune_steps": finetune_steps,
            "finetune_num_samples": finetune_samples, "from_epoch": sel["epoch"],
            "fair_crps_history": list(hist),
            "frontier": [{"step": s, "crps": e["crps"], "sample_std": e["sample_std"],
                          "mse": e["mse"], "crps_fair_m8": e["crps_fair_m8"]}
                         for s, e in hist.frontier],
            "num_samples": dgmr.num_samples, "finetune_seconds": time.perf_counter() - t0,
            **origin}
        print("dgmr" + suffix, "fine-tuned",
              {k: tuned[k] for k in ("mse", "crps", "crps_fair_m8", "sample_std")}, flush=True)

    results = save_results(out, RESULTS, results, card, _section)
    print(json.dumps(results), flush=True)
    return results


def _frontier_lines(r, suffix: str = ""):
    """The fine-tune's CRPS / spread / MSE frontier (of the rows under
    ``suffix``), the selected checkpoint as step 0 and the oracle as the
    target row."""
    fr = r.get("dgmr_crps_finetuned" + suffix, {}).get("frontier")
    if not fr or "dgmr_crps_selected" + suffix not in r:
        return []
    sel = r["dgmr_crps_selected" + suffix]
    lines = [
        f"Fine-tune frontier{' from the JAX initial weights' if suffix else ''} (held-out "
        "stochastic set; CRPS at M=3 is the reference",
        "protocol's classic estimator, fair CRPS at M=8 the unbiased one, comparable to the",
        "oracle's):",
        "",
        "| fine-tune step | CRPS (M=3) | fair CRPS (M=8) | sample std | mean MSE |",
        "|---|---|---|---|---|",
        f"| 0 (selected) | {sel['crps']:.4f} | {sel['crps_fair_m8']:.4f} | "
        f"{sel['sample_std']:.1e} | {sel['mse']:.4f} |",
    ]
    lines += [f"| {p['step']} | {p['crps']:.4f} | {p['crps_fair_m8']:.4f} | "
              f"{p['sample_std']:.1e} | {p['mse']:.4f} |" for p in fr]
    if "oracle_crps" in r:
        lines.append(f"| oracle 3-mode sampler | {r['oracle_crps']:.4f} | {r['oracle_crps']:.4f} "
                     f"| {r['oracle_sample_std']:.1e} | - |")
    return lines + [""]


def _section(r) -> str:
    def cell(row, key, fmt):
        v = r.get(row, {}).get(key)
        return "-" if v is None else format(v, fmt)

    rows = [("persistence", "persistence"), ("optical_flow", "optical_flow"),
            ("cloudgan (generator)", "cloudgan"), ("pix2pix (generator)", "pix2pix"),
            ("persistence@stochastic", "persistence@stochastic"),
            ("dgmr final (@stochastic)", "dgmr"), ("dgmr CRPS-selected", "dgmr_crps_selected"),
            ("dgmr + fair-CRPS fine-tune", "dgmr_crps_finetuned")]
    rows += [(f"{label}, JAX init", key + "@jax_init") for label, key in rows[-3:]]
    lines = [
        "## GAN family — CloudGAN, Pix2Pix & DGMR",
        "",
        "`python -m satflow_tpu_torch.tools.gan_gate`: the JAX study's data and recipes",
        "(`tools/gan_gate.py`) on the port. CloudGAN and Pix2Pix run on the 32 px study",
        "geometry and must beat both baselines; DGMR runs on stochastic futures, where the",
        "samples' spread is a collapse probe, with CRPS checkpoint selection and the fair-CRPS",
        "fine-tune; the `@jax_init` rows start DGMR from the JAX Trainer's initial variables",
        "(`--init`).",
        "",
        "| Method | Mean MSE | CRPS | fair CRPS (M=8) | D loss (final) | sample std | Training s |",
        "|---|---|---|---|---|---|---|",
    ]
    for label, key in rows:
        if key in r:
            lines.append(" | ".join([
                f"| {label}", cell(key, "mse", ".5f"), cell(key, "crps", ".5f"),
                cell(key, "crps_fair_m8", ".5f"), cell(key, "d_loss", ".3f"),
                cell(key, "sample_std", ".5f"), cell(key, "train_seconds", ".1f")]) + " |")
    if "oracle_crps" in r:
        lines.append(f"| oracle 3-mode sampler | - | {r['oracle_crps']:.5f} | "
                     f"{r['oracle_crps']:.5f} | - | {r['oracle_sample_std']:.5f} | - |")
    return "\n".join(lines + [""] + _frontier_lines(r) + _frontier_lines(r, "@jax_init"))


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arms", default=None,
                   help=f"comma list of arms; default: all of {','.join(ALL_ARMS)}")
    p.add_argument("--out", default=None,
                   help="directory for gan_results.json (merged into) and its .md")
    p.add_argument("--device", default="cuda")
    p.add_argument("--init", default=None,
                   help="a .npz of DGMR's initial variables (with --arms dgmr): its rows "
                        "go under @jax_init")
    a = p.parse_args()
    main(a.arms.split(",") if a.arms else None, out=a.out, device=a.device, init=a.init)
