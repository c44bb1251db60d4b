"""Export: ship a trained nowcaster as ONE artifact, counterpart of
``satflow_tpu/serve/export.py``.

``torch.export`` records the model's eval forward, weights included, at a
fixed input shape, and the artifact carries it beside the JAX format's
header: the magic ``SFXP0001``, the length of the JSON metadata (little-endian
u32), the metadata (``model``, ``in_shape``, ``out_shape``, ``platforms`` —
here the device type the program was recorded on — and ``forecast_steps``),
then the ``torch.export.save`` bytes. :func:`load_exported` needs no model
class, registry or config: the program holds the port's kernels as the
dispatcher ops ``satflow::fused_convlstm_step`` (K1),
``satflow::fused_lstm_gates`` (K3) and ``satflow::axial_attention`` (K4),
which importing :mod:`satflow_tpu_torch.ops` registers (the counterpart of
the JAX artifact's Mosaic custom calls). The zoo's convs, pools and resizes
are aten ops.

Like ``InferenceSession``, the batch dimension is FIXED at export time: pad
requests to ``batch``. A model whose forward runs a kernel that has no
dispatcher op yet raises ``NotImplementedError`` (ROADMAP queue 1 item 8):
the halo step K1h (``SATFLOW_STEP_VARIANT=halo``), the channel-major decoder
K6a / K6b (``cell_impl="cmajor"``) and the int8 step K5 (``quantize="int8"``
sessions).

CLI:
    python -m satflow_tpu_torch.serve.export local:<ckpt_dir> model.pt2 \\
        --batch 8 --history 7 --size 256 [--bf16] [--device cuda]
"""

from __future__ import annotations

import io
import json
import struct
from typing import Any, Optional, Sequence

import numpy as np
import torch

_MAGIC = b"SFXP0001"


class _Forward(torch.nn.Module):
    """The served function: cast in, the model's eval forward, cast out."""

    def __init__(self, model, dtype: Optional[torch.dtype], out_dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.dtype = dtype
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.to(self.dtype or torch.float32)).to(self.out_dtype)


def _refuse_unexportable(model, size: int, quantize: Optional[str]) -> None:
    from satflow_tpu_torch.ops.fused_convlstm_step import step_variant

    why = None
    if quantize:
        why = "the int8 step (K5)"
    elif step_variant() == "halo" and getattr(getattr(model, "module", None), "is_fused", False):
        why = "the halo step (K1h, SATFLOW_STEP_VARIANT=halo)"
    elif getattr(getattr(model, "module", None), "runs_cmajor", lambda h, w: False)(size, size):
        why = "the channel-major decoder (K6a, K6b, cell_impl='cmajor')"
    if why:
        raise NotImplementedError(
            f"export of a model that runs {why} is not ported yet: its kernels have no "
            "dispatcher op (ROADMAP queue 1 item 8)")


def export_model(
    model,
    state_dict: Optional[dict],
    path: str,
    *,
    batch: int,
    history: Optional[int] = None,
    size: Optional[int] = None,
    channels: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    out_dtype: Optional[torch.dtype] = None,
    device: Any = None,
) -> dict:
    """Record ``model``'s eval forward with ``torch.export`` and write the
    artifact to ``path``; returns its metadata.

    ``model`` is a task model or an ``InferenceSession``. A session's model is
    recorded, in the session's ``dtype`` and ``out_dtype`` where those
    arguments are None; a ``quantize="int8"`` session raises (its rollout,
    not its model's forward, is what it serves).
    ``state_dict`` (the core's, as the model's flax converter returns it) is
    loaded first; None keeps the weights the model holds. The input geometry
    defaults come from the model (``history_steps`` / ``input_channels``),
    ``size`` (H = W) to 256. ``dtype`` is the compute dtype (the input is
    cast to it and the model computes in it, f32 weights kept), ``out_dtype``
    the reply's (float32 by default). The program runs where the model's
    parameters are, or on ``device``.
    """
    from satflow_tpu_torch.serve.session import InferenceSession

    quantize = None
    if isinstance(model, InferenceSession):
        quantize = model.quantize
        dtype = model.dtype if dtype is None else dtype
        out_dtype = out_dtype or model.out_dtype
        model = model.model
    out_dtype = out_dtype or torch.float32
    if out_dtype not in (torch.float32, torch.float16):
        raise ValueError(f"out_dtype must be float32 or float16 (numpy has no bfloat16), "
                         f"got {out_dtype}")
    history = history or int(getattr(model, "history_steps", 0)) or 7
    channels = channels or int(getattr(model, "input_channels", 12))
    size = size or 256
    _refuse_unexportable(model, size, quantize)
    if state_dict is not None:
        model.module.load_state_dict(state_dict)
    if device is not None:
        model = model.to(device)
    device = next(model.parameters()).device
    if dtype is not None:
        model.set_compute_dtype(dtype)
    model.eval()
    x = torch.zeros(batch, history, size, size, channels, device=device)
    if hasattr(model, "materialize"):  # widths that come from the data
        model.materialize((x, x))
    fwd = _Forward(model, dtype, out_dtype).eval()
    with torch.no_grad():  # the kernels' ops without their autograd Functions
        program = torch.export.export(fwd, (x,))
    out_shape = [int(d) for d in _output_shape(program)]
    program.example_inputs = None  # the b8 input would be most of the file
    buf = io.BytesIO()
    torch.export.save(program, buf)
    meta = {
        "model": type(model).__name__,
        "in_shape": list(x.shape),
        "out_shape": out_shape,
        "platforms": [device.type],
        "forecast_steps": int(getattr(model, "forecast_steps", 0)),
    }
    meta_b = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(meta_b)))
        f.write(meta_b)
        f.write(buf.getvalue())
    return meta


def _output_shape(program) -> list:
    """The recorded program's (single) output shape."""
    node = next(n for n in program.graph.nodes if n.op == "output")
    return list(node.args[0][0].meta["val"].shape)


class ExportedModel:
    """A loaded artifact: ``.meta`` and ``__call__`` on numpy batches."""

    def __init__(self, meta: dict, program):
        self.meta = meta
        self.program = program
        self._fn = program.module()
        self.device = torch.device(meta["platforms"][0])

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        want = tuple(self.meta["in_shape"])
        if x.shape != want:
            raise ValueError(
                f"exported artifact expects input {want}, got {x.shape} "
                "(the batch dimension is fixed at export time — pad)"
            )
        with torch.no_grad():
            y = self._fn(torch.from_numpy(x).to(self.device))
        return y.cpu().numpy()


def load_exported(path: str) -> ExportedModel:
    """Load an artifact written by :func:`export_model`.

    Needs only torch and :mod:`satflow_tpu_torch.ops` (the kernels' ops):
    no model class, registry or config."""
    import satflow_tpu_torch.ops  # noqa: F401 - registers the kernels' dispatcher ops

    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a satflow_tpu export (magic {magic!r})")
        (n,) = struct.unpack("<I", f.read(4))
        meta = json.loads(f.read(n).decode())
        blob = f.read()
    return ExportedModel(meta, torch.export.load(io.BytesIO(blob)))


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    from satflow_tpu_torch.core.registry import create_model
    import satflow_tpu_torch.models  # noqa: F401  (populate the registry)

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("source", help="model source, e.g. local:<ckpt_dir>")
    p.add_argument("out", help="output artifact path")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--history", type=int, default=None)
    p.add_argument("--size", type=int, default=None)
    p.add_argument("--channels", type=int, default=None)
    p.add_argument("--bf16", action="store_true",
                   help="compute in bfloat16 (output stays f32)")
    p.add_argument("--device", default="cuda",
                   help="where the program runs (the card unless asked otherwise)")
    a = p.parse_args(argv)

    model = create_model(a.source)
    if getattr(model, "is_gan", False):
        raise SystemExit("export supports forward models only (the GAN "
                         "samplers thread an RNG — serve them with "
                         "InferenceSession instead)")
    if getattr(model, "restored_from", None) is None:
        raise SystemExit(
            "model has no restored_variables; export from a checkpoint "
            "source (local:/torch:/hf_hub:)"
        )
    from satflow_tpu_torch import resolve_device

    meta = export_model(
        model, None, a.out, batch=a.batch, history=a.history,
        size=a.size, channels=a.channels,
        dtype=torch.bfloat16 if a.bf16 else None, device=resolve_device(a.device),
    )
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
