"""Train-step ceiling study: where do the milliseconds go?

The port's copy of the JAX package's ``tools/exp_train_ceiling.py``. It
decomposes the ConvLSTM train step (forward + backward + Adam; bf16 compute
on f32 weights from ``torch.Generator`` seed 0, remat per step or by
``--remat-chunk``) into a measured ladder at one geometry:

  fwd        the loss value alone, no autograd (62 K1 a rung)
  fwd+bwd    the loss and its gradients, no optimizer update (K1 for the
             forward and its recompute, 62 K2)
  step       the full train step (``tools/bench_train.py``'s)
  opt        ``TrainState.apply_gradients`` alone on gradients computed once

Each rung chains its iterations: the loss is folded back into the weights
(``fwd``: ``+ loss * 1e-30``; ``fwd+bwd``: ``- 0 * grad``), or the train
state carries on, so that every iteration depends on the last. One warm-up
iteration builds the kernels, CUDA events time the chain and one scalar is
fetched at the end. The JAX tool's ablation rungs (``step[xla-gate-bwd]``,
``step[unmerged-conv-bwd]``, ``step[save-gates]``,
``step[save-gates+unmerged]``) switch TPU kernels through environment
variables; the port has one backward (K2), so they are not ported, and
``--skip`` takes only ``fwd``, ``bwd``, ``step`` and ``opt``. Usage::

    python -m satflow_tpu_torch.tools.exp_train_ceiling [--size 64 --batch 32] [--iters 8]
        [--device cuda]

Prints one JSON line: ``geometry``, each rung's ``{"ms", "fps"}``, ``card``
and ``kernel_launches`` (each rung's, an iteration).
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional, Sequence

import torch

from satflow_tpu_torch.tools import benchkit

RUNGS = ("fwd", "bwd", "step", "opt")  # the --skip names ("bwd" is fwd+bwd)
KERNELS = {"fwd": ("K1",), "fwd+bwd": ("K1", "K2"), "step": ("K1", "K2"), "opt": ()}


def build(a, device: torch.device, dtype=torch.bfloat16):
    """The fused-cell model with remat on ``device``, its train state and a
    batch of ``dtype``: ``tools/bench_train.py``'s."""
    from satflow_tpu_torch.tools.bench_train import convlstm, synthetic_batch

    a = argparse.Namespace(**{**vars(a), "cell": "fused", "remat": True})
    model, state = convlstm(a, device, dtype)
    return model, state, synthetic_batch(a, device, dtype)


def loss_value(model, batch) -> torch.Tensor:
    """The ``fwd`` rung's value: the training loss of ``batch``, no autograd."""
    model.train()
    with torch.no_grad():
        return model.loss(batch)[0]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--channels", type=int, default=12)
    p.add_argument("--history", type=int, default=7)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--remat-chunk", type=int, default=0)
    p.add_argument("--skip", default="", help="comma list of rows to skip: fwd, bwd, step, opt")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    skip = set(filter(None, a.skip.split(",")))
    if skip - set(RUNGS):
        raise ValueError(f"--skip {', '.join(sorted(skip - set(RUNGS)))}: the rungs are "
                         f"{RUNGS}; the JAX tool's TPU-kernel ablations are not ported")
    from satflow_tpu_torch.train.steps import make_train_step

    device, card = benchkit.device_and_card(a.device)
    model, state, batch = build(a, device)
    params = state.params()
    frames = a.batch * a.steps
    results: Dict[str, tuple] = {}

    def run(name: str, body: Callable, carry) -> None:
        body(carry)  # warm-up: builds the kernels
        out, dt, per = benchkit.chain(body, carry, a.iters, device)
        float(out)
        benchkit.require(per, [benchkit.step_kernel() if k == "K1" else k
                               for k in KERNELS[name]], device, f"exp_train_ceiling {name}")
        results[name] = (dt, per)

    zero = torch.zeros((), device=device)
    if "fwd" not in skip:
        def fwd(total):
            loss = loss_value(model, batch)
            # fold the loss back into the weights: the next forward reads them
            with torch.no_grad():
                for w in params:
                    w.add_(loss * 1e-30)
            return total + loss.float()
        run("fwd", fwd, zero)

    if "bwd" not in skip:
        def fwd_bwd(total):
            model.train()
            loss, _ = model.loss(batch)
            loss.backward()
            with torch.no_grad():
                for w in params:  # fold the gradients back: a real data dependence
                    w.sub_(0.0 * w.grad)
                    w.grad = None
            return total + loss.detach().float()
        run("fwd+bwd", fwd_bwd, zero)

    if "step" not in skip:
        step = make_train_step(model)
        run("step", lambda total: total + step(state, batch)["loss"].float(), zero)

    if "opt" not in skip:
        model.train()
        model.loss(batch)[0].backward()
        grads = [w.grad.detach().clone() for w in params]

        def opt(_):
            for w, g in zip(params, grads):
                w.grad = g  # Adam reads the gradients and leaves them as they are
            state.apply_gradients()
            return params[0].detach().sum()
        run("opt", opt, zero)

    return benchkit.emit({
        "geometry": f"{a.size}px b{a.batch} F{a.steps} chunk={a.remat_chunk}",
        **{k: {"ms": round(dt * 1000, 2), "fps": round(frames / dt, 1)}
           for k, (dt, _) in results.items()},
        "card": card,
        "kernel_launches": {k: per for k, (_, per) in results.items()},
    })


if __name__ == "__main__":
    main()
