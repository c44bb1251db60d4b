"""Time the int8 step (K5), the pad-row prototype step (T3) and the int8
forward on the card, for one checkout of the package.

It prints the milliseconds per call of ``fused_convlstm_step_int8`` (bf16 c;
Cx 12 and 64 at hidden 64, Cx = Ch = 32) and of the bfloat16 ``cmajor_step``
(C = 64, block_h 4 and 8), the best of ``--repeats`` means over ``--calls``
back-to-back launches (CUDA events), with their TOP/s (TFLOP/s) against the
bound, and the b8 int8 forward of a hidden-64 ConvLSTM (7 x 256x256x12 in,
24 out, random weights from a seed) the same way. ``--root`` times another
checkout (a directory that holds ``satflow_tpu_torch/``; by default the one
this file lies in), so that two commits can be read on one card in one
session, in turns; run it by path::

    python satflow_tpu_torch/tools/time_int8.py [--root DIR] [--calls 20] [--repeats 3]

It needs a CUDA card and imports the package only after ``--root`` is known;
it calls only entry points that the port has had since its int8 and
prototype steps were ported.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path
from typing import Dict, Optional

B, H, W, CIN, HIDDEN, STEPS, T = 8, 256, 256, 12, 64, 24, 7
# published dense peaks of one H100 SXM and its memory rate
PEAK = {"int8": 1979e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def bound_ms(tensors, ops: float, kind: str) -> float:
    """The larger of the tensors' bytes at the memory rate and ``ops`` at the
    peak rate of ``kind``, in ms."""
    moved = sum(t.numel() * t.element_size() for t in tensors)
    return max(moved / HBM_BYTES_PER_S, ops / PEAK[kind]) * 1e3


def main(root: Optional[str] = None, calls: int = 20, repeats: int = 3) -> Dict[str, float]:
    # by default the checkout this file lies in (run by path, it is not on sys.path)
    sys.path.insert(0, root or str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_int8 needs a CUDA card")
    from satflow_tpu_torch.models.conv_lstm import ConvLSTMCore
    from satflow_tpu_torch.ops import _build
    from satflow_tpu_torch.ops import fused_convlstm_int8 as Q
    from satflow_tpu_torch.tools import exp_cmajor as XC
    from satflow_tpu_torch.tools.time_step import mean_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"package: {Q.__file__}; card: {card}", flush=True)
    _build.load_all(["fused_convlstm_int8", "exp_cmajor"])  # the two nvcc runs side by side
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}

    def rand(*shape):
        return torch.rand(*shape, generator=g, device="cuda")

    with torch.inference_mode():
        for cx, ch in ((CIN, HIDDEN), (HIDDEN, HIDDEN), (32, 32)):
            w3q, dq, b = Q.quantize_weights((rand(3, 3, cx, 4 * ch) - 0.5) * 0.2,
                                            (rand(3, 3, ch, 4 * ch) - 0.5) * 0.2,
                                            (rand(4 * ch) - 0.5) * 0.2)
            args = (Q.quantize_activations(rand(B, H, W, cx)),
                    Q.quantize_activations(rand(B, H, W, ch) * 2 - 1),
                    (rand(B, H, W, ch) * 2 - 1).to(torch.bfloat16), w3q, dq, b,
                    Q.pack_weights(w3q, cx))
            ms = mean_ms(torch, lambda: Q.fused_convlstm_step_int8(*args), calls, repeats)
            ops = 2 * B * H * W * 4 * ch * 9 * (cx + ch)
            bound = bound_ms(args[:6] + (args[1], args[2]), ops, "int8")
            out[f"K5 Cx={cx} Ch={ch}"] = ms
            print(f"K5, int8 x/h, bf16 c, B={B} {H}x{W} Cx={cx} Ch={ch}: {ms:.4f} ms "
                  f"({ops / ms / 1e9:.1f} TOP/s; bound {bound:.4f} ms, {100 * bound / ms:.1f} %) "
                  f"[{card}]", flush=True)

        for block_h in (4, 8):
            x, h, c = ((rand(B, H, W, HIDDEN) - 0.5).to(torch.bfloat16) for _ in range(3))
            wx, wh = ((rand(3, 3, HIDDEN, 4 * HIDDEN) - 0.5).mul(0.08).to(torch.bfloat16)
                      for _ in range(2))
            bias = ((rand(4 * HIDDEN, 1) - 0.5) * 0.2).to(torch.bfloat16)
            args = (*(XC.to_cmajor(t, block_h) for t in (x, h, c)), XC.weights_cmajor(wx, wh),
                    bias)
            ms = mean_ms(torch, lambda: XC.cmajor_step(*args, block_h, H, W), calls, repeats)
            ops = 2 * B * H * W * 4 * HIDDEN * 9 * 2 * HIDDEN
            bound = bound_ms(args + (args[1], args[2]), ops, "bf16")
            out[f"T3 block_h={block_h}"] = ms
            print(f"T3, bf16, B={B} {H}x{W} C={HIDDEN} block_h={block_h}: {ms:.4f} ms "
                  f"({ops / ms / 1e9:.1f} TFLOP/s; bound {bound:.4f} ms, {100 * bound / ms:.1f} %) "
                  f"[{card}]", flush=True)

        core = ConvLSTMCore(hidden_dim=HIDDEN, in_channels=CIN, out_channels=CIN,
                            forecast_steps=STEPS,
                            generator=torch.Generator().manual_seed(0)).cuda().eval()
        qparams = Q.quantize_convlstm_params(core)
        x = rand(B, T, H, W, CIN)
        before = Q.fused_convlstm_step_int8.launches
        ms = mean_ms(torch, lambda: Q.int8_rollout(qparams, x, STEPS), 2, repeats)
        launches = (Q.fused_convlstm_step_int8.launches - before) // (3 + 2 * repeats)
        out["int8 forward"] = ms
        print(f"int8 forward, b{B} {T} x {H}x{W}x{CIN} in, {STEPS} out, hidden {HIDDEN}: {ms:.2f} ms "
              f"({launches} K5 launches a forward) [{card}]", flush=True)
    return out


def _cli(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=None,
                   help="a checkout holding satflow_tpu_torch/ (default: this file's)")
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--repeats", type=int, default=3)
    a = p.parse_args(argv)
    main(a.root, a.calls, a.repeats)


if __name__ == "__main__":
    _cli()
