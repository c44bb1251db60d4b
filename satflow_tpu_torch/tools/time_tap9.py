"""Time the study steps T1, T2, their yardstick K1p and the main step K1 per
call on the card, and read the machine code of every kernel source, for one
checkout of the package.

It prints the milliseconds per call of ``fused_convlstm_step`` (K1),
``step_padded`` (K1p), ``step_tap9`` (T1) and ``step_nogate`` (T2) at B=8,
256x256, Cx=Ch=64, the best of ``--repeats`` means over ``--calls``
back-to-back calls (CUDA events), in each of ``--dtypes``, with their TFLOP/s
and the share of their bound reached. Then, for every source under ``csrc/``
(all are built, one nvcc each, side by side), ptxas' registers and spills of
each kernel (where this process built the library: the first run of a
checkout in a fresh machine), a digest of the library's SASS
(``cuobjdump``: its functions' names and instructions), and the instruction,
HMMA and FFMA count of each study-kernel instantiation, so that two
checkouts' machine code can be compared. ``--root`` reads
another checkout (a directory that holds ``satflow_tpu_torch/``; by default
the one this file lies in), so that two commits can be read on one card in
one session, in turns; run it by path::

    python satflow_tpu_torch/tools/time_tap9.py [--root DIR] [--calls 20]
        [--repeats 3] [--dtypes bfloat16 float32]

It needs a CUDA card and imports the package only after ``--root`` is known;
it calls only entry points that the port has had since the study steps were
ported.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

B, H, W, C = 8, 256, 256, 64
# published dense peaks of one H100 SXM and its memory rate
PEAK = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_ms(tensors, ops: float, dtype: str) -> float:
    """The larger of the tensors' bytes at the memory rate and ``ops`` at the
    peak rate of ``dtype``, in ms."""
    moved = sum(t.numel() * t.element_size() for t in tensors)
    return max(moved / HBM_BYTES_PER_S, ops / PEAK[dtype]) * 1e3


def sass_report(_build, name: str) -> str:
    """"sass <digest>" of library ``name``'s machine code (its functions' names
    and instructions, ``cuobjdump``), and for the study kernels each
    instantiation's instruction, HMMA and FFMA count."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", _build.load(name)._name], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    # instruction lines ("/*0040*/ ... ;") and function names only: the rest
    # of the listing names the file the library was built from, and so does
    # the hash nvcc gives an anonymous namespace
    code = [re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}", "_GLOBAL__N_",
                   line.strip()) for line in text.splitlines()
            if "Function :" in line or re.match(r"\s*/\*[0-9a-f]{4,}\*/", line)]
    lines = [f"{name}: sass {hashlib.sha256(chr(10).join(code).encode()).hexdigest()[:16]}"]
    if name == "exp_tap9":
        function, counts = None, {}
        for line in code:
            kernel = re.search(r"Function : \w*?(padded_\w+?_kernel)I(\w+?)EEv", line)
            if "Function :" in line:
                function = kernel and f"{kernel.group(1)}<{kernel.group(2)}>"
                if function:
                    counts[function] = {"instructions": 0, "HMMA": 0, "FFMA": 0}
            elif function:
                counts[function]["instructions"] += 1
                for op in ("HMMA", "FFMA"):
                    counts[function][op] += bool(re.search(rf"\b{op}\b", line))
        for function, ops in counts.items():
            lines.append(f"  {function}: " + ", ".join(f"{op} {n}" for op, n in ops.items()))
    return "\n".join(lines)


def registers(log: str) -> list:
    """(kernel, registers, spilled bytes) of every function in a build log."""
    out = []
    for block in re.split(r"(?=ptxas info\s*:\s*Compiling entry function)", log):
        name = re.search(r"Compiling entry function '(\w+)'", block)
        regs = re.search(r"Used (\d+) registers", block)
        if name and regs:
            spill = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", block)]
            out.append((name.group(1), int(regs.group(1)), sum(spill)))
    return out


def main(root: Optional[str] = None, calls: int = 20, repeats: int = 3,
         dtypes: Sequence[str] = ("bfloat16", "float32")) -> Dict[str, float]:
    # by default the checkout this file lies in (run by path, it is not on sys.path)
    sys.path.insert(0, root or str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_tap9 needs a CUDA card")
    from satflow_tpu_torch.ops import _build
    from satflow_tpu_torch.ops import fused_convlstm_step as P
    from satflow_tpu_torch.tools import exp_tap9 as XT
    from satflow_tpu_torch.tools.time_step import mean_ms

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"package: {XT.__file__}; card: {card}", flush=True)
    sources = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    _build.load_all(sources)  # one nvcc per source, side by side
    g = torch.Generator(device="cuda").manual_seed(0)
    ops = 2 * B * H * W * 4 * C * 9 * (C + C)
    out = {}
    for name in dtypes:
        dtype = getattr(torch, name)

        def rand(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

        x, h, c = rand(B, H, W, C), rand(B, H, W, C, scale=0.5), rand(B, H, W, C)
        wx, wh = (rand(3, 3, C, 4 * C, scale=(9 * C) ** -0.5) for _ in range(2))
        b = rand(4 * C, scale=0.1)
        padded = (XT.pad_w(x).contiguous(), XT.pad_w(h).contiguous(), c, wx, wh, b)
        steps = {"K1": (P.fused_convlstm_step, (x, h, c, wx, wh, b)),
                 "K1p": (XT.step_padded, padded), "T1": (XT.step_tap9, padded),
                 "T2": (XT.step_nogate, padded)}
        with torch.no_grad():
            for what, (fn, args) in steps.items():
                ms = mean_ms(torch, lambda: fn(*args), calls, repeats)
                # inputs read once, h' and c' written once (w9 / w3 as wx, wh)
                bound = bound_ms(args + (args[1], args[2]), ops, name)
                out[f"{what}.{name}"] = ms
                print(f"{what} {name} B={B} {H}x{W} Cx=Ch={C}: {ms:.4f} ms "
                      f"({ops / ms / 1e9:.1f} TFLOP/s; bound {bound:.4f} ms, "
                      f"{100 * bound / ms:.1f} %) [{card}]", flush=True)
    for source in sources:
        for kernel, regs, spill in registers(_build.build_logs.get(source, "")):
            print(f"  ptxas {source} {kernel}: {regs} registers, {spill} bytes spilled",
                  flush=True)
        print(sass_report(_build, source), flush=True)
    return out


def _cli(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=None,
                   help="a checkout holding satflow_tpu_torch/ (default: this file's)")
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"],
                   choices=("bfloat16", "float32"))
    a = p.parse_args(argv)
    main(a.root, a.calls, a.repeats, a.dtypes)


if __name__ == "__main__":
    _cli()
