"""DGMR at the reference geometry: 128 px, 24 lead times, the shipped
``nowcasting_gan.yaml`` recipe, scored against persistence and an oracle
3-mode sampler.

The port's copy of the JAX package's ``tools/gan_128.py``: its data
(``DS128``: stochastic advection, 4 history frames, 24 lead times, the
future velocity redrawn at the boundary), eval set (``EVAL_BATCHES`` at seed
300), recipe (M=3 samples, grid_lambda 20, hinge losses and the dual
discriminator, gen_lr 5e-5 / disc_lr 2e-4, two D steps a round, the split
D / G step) and budget (60 epochs of 12 rounds at batch 4, context 384 /
latent 768 channels), with the CRPS checkpoint selection of ``gan_gate``
(:class:`~satflow_tpu_torch.tools.gan_gate.CRPSSelect`) and, with
``--finetune-steps``, the fair-CRPS fine-tune of the selected checkpoint.
The trained generator's states (selected, final, fine-tuned) are saved with
``torch.save`` as ``--state`` under ``--out`` and read back with
``weights_only=True``, so that ``--skip-train`` and ``--from-finetuned``
resume from them.

    python -m satflow_tpu_torch.tools.gan_128 [--epochs 60] [--batch 4]
        [--context-channels 384] [--latent-channels 768]
        [--finetune-steps 800] [--finetune-m 6] [--skip-train]
        [--from-finetuned] [--out DIR] [--device cuda]

Writes ``gan_128.json`` (its rows merged into the file as it stands when
the run ends, so a rerun or other runs into the same ``--out`` keep theirs),
``gan_128.md`` and the state file under ``--out`` only, and prints the
results. The trained row and the fine-tuned one record their seconds and
``kernel_launches``, the K1-K4 launches of the fit and of the fine-tune (none:
DGMR runs no kernel of the repo, as in the JAX package).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import torch

from satflow_tpu_torch.tools import gan_gate
from satflow_tpu_torch.tools.studies import (
    card_name,
    ensemble_row,
    full_f32,
    kernel_launches,
    launches_since,
    load_results,
    save_results,
    study_dm,
)

# 128px analog of the 32px study geometry: velocity (1,2)*24 = (24,48)px
# displacement (super-pixel, no torus wrap inside the horizon at 128px);
# future vx modes {0,2,4} separate by 48px at t=23. decay 0.965^24 = 0.43
# keeps the intensity signal alive across the horizon; 16 blobs ~ the 32px
# study's coverage scaled to the 16x area.
DS128 = dict(batch_size=4, width=128, height=128, number_sat_channels=1,
             history_minutes=15, forecast_minutes=120, velocity=(1, 2),
             decay=0.965, n_blobs=16)
STEPS = 24
EVAL_BATCHES = 2
RESULTS = "gan_128.json"
# nowcasting_gan.yaml's recipe (the widths come from the CLI)
DGMR = dict(forecast_steps=STEPS, input_channels=1, output_shape=DS128["width"], num_samples=3,
            grid_lambda=20.0, disc_steps=2, gen_lr=5e-5, disc_lr=2e-4)


def _oracle_modes(x_last):
    """(B, 3, T, H, W, C) rollouts of the 3 future-velocity modes."""
    return gan_gate._oracle_modes(x_last, DS128, STEPS)


def _oracle_std_and_crps(eval_ds):
    """Spread + CRPS of a PERFECT 3-mode sampler on the stochastic set."""
    return gan_gate._oracle_std_and_crps(eval_ds, DS128, STEPS, EVAL_BATCHES)


def _persistence_rows(eval_ds):
    """Persistence MSE curve + CRPS (= MAE, the M=1 ensemble)."""
    return gan_gate._persistence_rows(eval_ds, STEPS, EVAL_BATCHES)


def main(epochs: int = 60, batch: int = 4, context_channels: int = 384,
         latent_channels: int = 768, finetune_steps: int = 0, finetune_m: int = 6,
         finetune_lr: float = 1e-4, finetune_every: int = 200, skip_train: bool = False,
         from_finetuned: bool = False, state: str = "gan128_state.pt",
         out: Optional[str] = None, device="cuda", length: int = 12) -> Dict:
    """Train (or, with ``skip_train``, load) and score DGMR on ``device``;
    ``length`` is the rounds of an epoch (the JAX tool's 12). Returns the
    results (merged into ``out``'s file if given)."""
    from satflow_tpu_torch import resolve_device
    from satflow_tpu_torch.core.registry import create_model
    from satflow_tpu_torch.data.datamodule import to_device
    from satflow_tpu_torch.data.fake import StochasticAdvectionDataset
    from satflow_tpu_torch.train import Trainer
    from satflow_tpu_torch.train.probabilistic import crps_finetune
    import satflow_tpu_torch.models  # noqa: F401 - populate the registry

    if (skip_train or from_finetuned) and not out:
        raise ValueError("--skip-train and --from-finetuned read the state file under --out")
    device = resolve_device(device)
    full_f32(device)
    card = card_name(device)
    state_path = os.path.join(out, state) if out else None
    eval_ds = StochasticAdvectionDataset(length=EVAL_BATCHES, seed=300, **DS128)
    # the rows found (a file of another card raises before any training)
    found = load_results(out, RESULTS, card)
    results = {}

    mse_t, p_crps = _persistence_rows(eval_ds)
    results["persistence@128px"] = {"mse_t": mse_t.tolist(), "mse": float(mse_t.mean()),
                                    "crps": p_crps}
    o_std, o_crps = _oracle_std_and_crps(eval_ds)
    results["oracle_sample_std@128px"] = o_std
    results["oracle_crps@128px"] = o_crps
    print("persistence mse", results["persistence@128px"]["mse"], "crps", p_crps,
          "| oracle std", o_std, "crps", o_crps, flush=True)

    dgmr = create_model("nowcastinggan", context_channels=context_channels,
                        latent_channels=latent_channels,
                        generator=torch.Generator().manual_seed(0), **DGMR)

    def row(model):
        return ensemble_row(model, eval_ds, EVAL_BATCHES)

    common = {"epochs": epochs, "batch": batch, "num_samples": dgmr.num_samples,
              "context_channels": context_channels, "latent_channels": latent_channels}
    ds_kw = {**DS128, "batch_size": batch}

    saved: Dict = {}
    if skip_train:
        # the generator from an earlier run; its train rows stay as they are
        saved = torch.load(state_path, map_location="cpu", weights_only=True)
        dgmr.to(device)
        dgmr.materialize(to_device(eval_ds[0], device))
        dgmr.module.load_state_dict(saved["selected"])
        sel_epoch = saved["selected_epoch"]
    else:
        selector = gan_gate.CRPSSelect(dgmr, StochasticAdvectionDataset(
            length=1, seed=400, **{**DS128, "batch_size": 2}))
        trainer = Trainer(max_epochs=epochs, log_every_n_steps=1000, limit_val_batches=1,
                          callbacks=[selector], gan_step_mode="split", device=device)
        before, t0 = kernel_launches(), time.perf_counter()
        trainer.fit(dgmr, study_dm(StochasticAdvectionDataset, ds_kw, length))
        train_s = time.perf_counter() - t0
        results["dgmr@128px"] = {**row(dgmr),
                                 "d_loss": float(trainer.callback_metrics["train/d_loss"]),
                                 "train_seconds": train_s,
                                 "kernel_launches": launches_since(before), **common}
        final = {k: v.detach().clone() for k, v in dgmr.module.state_dict().items()}
        sel = selector.best
        sel_epoch = sel["epoch"]
        dgmr.module.load_state_dict(sel["state"])
        results["dgmr_crps_selected@128px"] = {**row(dgmr), "selected_epoch": sel_epoch,
                                               "trajectory": selector.trajectory[::5], **common}
        print("dgmr@128px final", {k: v for k, v in results["dgmr@128px"].items()
                                   if not isinstance(v, list)}, flush=True)
        print("dgmr@128px selected (epoch", sel_epoch, ")",
              {k: v for k, v in results["dgmr_crps_selected@128px"].items()
               if not isinstance(v, list)}, flush=True)
        saved = {"selected": sel["state"], "selected_epoch": sel_epoch, "final": final}
        if state_path:
            os.makedirs(out, exist_ok=True)
            torch.save(_on_cpu(saved), state_path)

    if finetune_steps:
        # the 32 px study's spread-restoring fine-tune at this geometry; a
        # --from-finetuned leg continues the saved fine-tune (steps and the
        # frontier cumulative)
        prev_steps, prev_frontier = 0, []
        if from_finetuned:
            dgmr.module.load_state_dict(saved["finetuned"])
            prev_steps = int(saved.get("finetuned_steps", 0))
            prev_frontier = list(found.get("dgmr_crps_finetuned@128px", {})
                                 .get("frontier", []))
        train_sto = StochasticAdvectionDataset(length=length, seed=0, **ds_kw)
        before, t0 = kernel_launches(), time.perf_counter()
        _, hist = crps_finetune(dgmr, list(train_sto), steps=finetune_steps,
                                num_samples=finetune_m, lr=finetune_lr, lr_schedule="cosine",
                                eval_every=finetune_every, eval_fn=row, seed=prev_steps)
        finetune = {"finetune_seconds": time.perf_counter() - t0,
                    "kernel_launches": launches_since(before)}
        results["dgmr_crps_finetuned@128px"] = {
            **row(dgmr), "from_epoch": sel_epoch, "finetune_steps": prev_steps + finetune_steps,
            "finetune_num_samples": finetune_m, "finetune_lr": finetune_lr,
            "fair_crps_history": list(hist),
            "frontier": prev_frontier + [
                {"step": prev_steps + s, "crps": e["crps"], "sample_std": e["sample_std"],
                 "mse": e["mse"], "crps_fair_m8": e["crps_fair_m8"]} for s, e in hist.frontier],
            **finetune, **common}
        saved["finetuned"] = {k: v.detach().clone() for k, v in dgmr.module.state_dict().items()}
        saved["finetuned_steps"] = prev_steps + finetune_steps
        if state_path:
            torch.save(_on_cpu(saved), state_path)
        m = results["dgmr_crps_finetuned@128px"]
        print("dgmr@128px fine-tuned", {k: m[k] for k in ("mse", "crps", "crps_fair_m8",
                                                          "sample_std")}, flush=True)

    results = save_results(out, RESULTS, results, card, _section)
    print(json.dumps(results), flush=True)
    return results


def _on_cpu(saved: Dict) -> Dict:
    """The state file's tree with every tensor on the CPU."""
    return {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v)
            for k, v in saved.items()}


def _section(r) -> str:
    p = r["persistence@128px"]
    lines = [
        "## DGMR at the reference geometry (128px, 24 steps)",
        "",
        "`python -m satflow_tpu_torch.tools.gan_128`: DGMR at `nowcasting_gan.yaml`'s geometry",
        "and recipe (128 px, 24 lead times, M=3, grid_lambda 20, hinge losses and the dual",
        "discriminator, gen_lr 5e-5 / disc_lr 2e-4, the split D / G step) on stochastic",
        "advection, with CRPS checkpoint selection. CRPS (M=3) is the reference protocol's",
        "estimator; fair CRPS (M=8) is unbiased and comparable to the oracle's.",
        "",
        "| Method | Mean MSE | CRPS (M=3) | fair CRPS (M=8) | sample std |",
        "|---|---|---|---|---|",
        f"| persistence@128px | {p['mse']:.5f} | {p['crps']:.4f} | {p['crps']:.4f} | - |",
    ]
    for name in ("dgmr@128px", "dgmr_crps_selected@128px", "dgmr_crps_finetuned@128px"):
        if name in r:
            m = r[name]
            lines.append(f"| {name} | {m['mse']:.5f} | {m['crps']:.4f} | "
                         f"{m['crps_fair_m8']:.4f} | {m['sample_std']:.1e} |")
    lines.append(f"| oracle 3-mode sampler | - | - | {r['oracle_crps@128px']:.4f} | "
                 f"{r['oracle_sample_std@128px']:.1e} |")
    m = r.get("dgmr@128px")
    if m:
        lines += ["", f"Budget: {m['epochs']} epochs, batch {m['batch']}, context "
                      f"{m['context_channels']} / latent {m['latent_channels']} channels; "
                      f"training {m.get('train_seconds', float('nan')):.1f} s."]
    ft = r.get("dgmr_crps_finetuned@128px")
    if ft:
        o_std = r["oracle_sample_std@128px"]
        lines += ["", f"Fair-CRPS fine-tune ({ft['finetune_steps']} generator-only Adam steps, "
                      f"M={ft['finetune_num_samples']}, warmup-cosine lr {ft['finetune_lr']:g}, "
                      f"from the epoch-{ft['from_epoch']} checkpoint; "
                      f"{ft.get('finetune_seconds', float('nan')):.1f} s):", "",
                  "| step | fair CRPS (M=8) | sample std | % of oracle std | mean MSE |",
                  "|---|---|---|---|---|"]
        lines += [f"| {q['step']} | {q['crps_fair_m8']:.4f} | {q['sample_std']:.1e} | "
                  f"{100 * q['sample_std'] / o_std:.0f}% | {q['mse']:.5f} |"
                  for q in ft["frontier"]]
    return "\n".join(lines + [""])


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--context-channels", type=int, default=384)
    p.add_argument("--latent-channels", type=int, default=768)
    p.add_argument("--finetune-steps", type=int, default=0)
    p.add_argument("--finetune-m", type=int, default=6)
    p.add_argument("--finetune-lr", type=float, default=1e-4)
    p.add_argument("--finetune-every", type=int, default=200)
    p.add_argument("--skip-train", action="store_true",
                   help="load the generator from --state instead of training (the train "
                        "rows stay as they are)")
    p.add_argument("--from-finetuned", action="store_true",
                   help="continue the fine-tune from the saved fine-tuned state "
                        "(cumulative frontier)")
    p.add_argument("--state", default="gan128_state.pt",
                   help="the generator's state file, under --out")
    p.add_argument("--out", default=None,
                   help="directory for gan_128.json (merged into), its .md and the state")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.epochs, a.batch, a.context_channels, a.latent_channels,
         finetune_steps=a.finetune_steps, finetune_m=a.finetune_m,
         finetune_lr=a.finetune_lr, finetune_every=a.finetune_every,
         skip_train=a.skip_train, from_finetuned=a.from_finetuned, state=a.state,
         out=a.out, device=a.device)
