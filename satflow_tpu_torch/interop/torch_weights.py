"""Reference-format torch state_dicts -> the port's modules (the ``torch:`` source).

The port's own copy of the ConvLSTM part of
``satflow_tpu/interop/torch_weights.py``. The reference's checkpoints are
PyTorch state dicts of its own module tree; the JAX package maps them into a
flax tree, and this module maps them into the port's ``ConvLSTMCore``
state dict, whose names and layouts differ by ``cell_impl``.

Layout rules (reference torch -> port):

- a reference ``nn.Conv2d`` weight (O, I, kh, kw) stays OIHW in the port's
  convs (``Conv``, ``nn.Conv2d``), and becomes HWIO (:func:`conv_kernel`,
  the flax layout) in the fused cells, whose CUDA kernel takes that layout;
- the reference head, an ``nn.Conv3d`` (O, I, 1, kh, kw), drops its depth
  axis;
- :func:`linear_kernel` and :func:`conv3d_kernel` are the JAX module's
  layout rules for ``nn.Linear`` and ``nn.Conv3d``, kept for the converters
  of the models still to come (the Perceiver, ROADMAP queue 1 item 10).

The JAX package reads the target tree's geometry from ``module.init``; here
the target is the port's own module, so :func:`load_torch_convlstm` reads
which cell formulation it holds from its parameter names and takes the
input width from their shapes.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch


def _tensor(value) -> torch.Tensor:
    """A torch tensor or numpy array as a float32 CPU tensor."""
    return torch.as_tensor(value).detach().to("cpu", torch.float32)


def conv_kernel(w) -> torch.Tensor:
    """(O, I, kh, kw) -> (kh, kw, I, O)."""
    return _tensor(w).permute(2, 3, 1, 0).contiguous()


def conv3d_kernel(w) -> torch.Tensor:
    """(O, I, kd, kh, kw) -> (kd, kh, kw, I, O)."""
    return _tensor(w).permute(2, 3, 4, 1, 0).contiguous()


def linear_kernel(w) -> torch.Tensor:
    """(O, I) -> (I, O)."""
    return _tensor(w).t().contiguous()


def _set(target: Dict[str, torch.Tensor], key: str, value: torch.Tensor) -> None:
    """``target[key] = value`` where the key exists and the shapes agree."""
    if key not in target:
        raise KeyError(f"the port's state dict has no {key!r}")
    if tuple(target[key].shape) != tuple(value.shape):
        raise ValueError(f"shape mismatch at {key!r}: the port's {tuple(target[key].shape)} "
                         f"vs converted torch {tuple(value.shape)}")
    target[key] = value.to(target[key].dtype).contiguous()


def load_torch_state_dict(
    target: Mapping[str, torch.Tensor],
    state_dict: Mapping[str, Any],
    rules: Dict[str, tuple],
    strict: bool = True,
) -> Dict[str, torch.Tensor]:
    """Apply conversion ``rules`` {torch_key: (port_key, transform)} onto a
    copy of the port's state dict ``target``; every assignment is
    shape-checked. With ``strict``, a torch key missing from ``state_dict``
    raises."""
    out = dict(target)
    missing = []
    for torch_key, (port_key, transform) in rules.items():
        if torch_key not in state_dict:
            missing.append(torch_key)
            continue
        _set(out, port_key, transform(state_dict[torch_key]))
    if missing and strict:
        raise KeyError(f"state_dict is missing keys: {missing}")
    return out


# -----------------------------------------------------------------------------
# EncoderDecoderConvLSTM (reference satflow/models/conv_lstm.py naming)
# -----------------------------------------------------------------------------

_CELL_NAMES = {
    "encoder_1_convlstm": "encoder.encoder_1",
    "encoder_2_convlstm": "encoder.encoder_2",
    "decoder_1_convlstm": "decoder.decoder_1",
    "decoder_2_convlstm": "decoder.decoder_2",
}


def load_torch_convlstm(model, state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert a reference-format EncoderDecoderConvLSTM torch state_dict
    into ``model.module`` and load it.

    Expects the reference's naming (conv_lstm.py:131-168):
    ``model.{encoder_1,encoder_2,decoder_1,decoder_2}_convlstm.conv.{weight,bias}``,
    each a 3x3 conv over ``[x | h]`` to the four gates in i, f, o, g order,
    and ``model.decoder_CNN.{weight,bias}`` (a (1, 3, 3) Conv3d head).

    For every ``cell_impl`` of the port, by the parameters its cells hold:

    - fused and cmajor (``x_gates_kernel``): the kernel sliced at the input
      width into the x and h kernels, HWIO;
    - split with the input conv in the cell (``x_gates.weight``): x and h
      convs, the bias on ``x_gates``;
    - split or hybrid, the hoisted encoder input conv (the cell holds only
      ``h_gates``): the h part in the cell, the x part and the bias on
      ``encoder_input_gates.x_gates``;
    - concat (``gates.weight``): the reference layout, kept whole.

    Sets ``model.restored_from``; returns the converted state dict.
    """
    target = model.module.state_dict()
    out = dict(target)
    hoisted = None
    for torch_cell, cell in _CELL_NAMES.items():
        w = _tensor(state_dict[f"model.{torch_cell}.conv.weight"])  # (4H, Cin + H, 3, 3)
        b = _tensor(state_dict[f"model.{torch_cell}.conv.bias"])
        if f"{cell}.x_gates_kernel" in target:  # FusedConvLSTMCell
            cin = target[f"{cell}.x_gates_kernel"].shape[2]
            _set(out, f"{cell}.x_gates_kernel", conv_kernel(w[:, :cin]))
            _set(out, f"{cell}.h_gates_kernel", conv_kernel(w[:, cin:]))
            _set(out, f"{cell}.bias", b)
        elif f"{cell}.x_gates.weight" in target:  # SplitConvLSTMCell, input conv in the cell
            cin = target[f"{cell}.x_gates.weight"].shape[1]
            _set(out, f"{cell}.x_gates.weight", w[:, :cin])
            _set(out, f"{cell}.x_gates.bias", b)
            _set(out, f"{cell}.h_gates.weight", w[:, cin:])
        elif f"{cell}.h_gates.weight" in target:  # split cell with the hoisted input conv
            cin = w.shape[1] - target[f"{cell}.h_gates.weight"].shape[1]
            _set(out, f"{cell}.h_gates.weight", w[:, cin:])
            if hoisted is not None:
                raise KeyError(f"two cells without their input conv: {hoisted[0]}, {cell}")
            hoisted = (cell, w[:, :cin], b)
        else:  # concat ConvLSTMCell: the reference layout
            _set(out, f"{cell}.gates.weight", w)
            _set(out, f"{cell}.gates.bias", b)
    if hoisted is not None:
        # split and hybrid hoist only encoder_1's input conv (its x is the data)
        cell, wx, b = hoisted
        if cell != "encoder.encoder_1":
            raise KeyError(f"unmapped hoisted input conv of {cell}")
        _set(out, "encoder_input_gates.x_gates.weight", wx)
        _set(out, "encoder_input_gates.x_gates.bias", b)
    head_w = _tensor(state_dict["model.decoder_CNN.weight"])  # (O, H, 1, 3, 3)
    _set(out, "decoder.head.weight", head_w[:, :, 0])
    _set(out, "decoder.head.bias", _tensor(state_dict["model.decoder_CNN.bias"]))
    model.module.load_state_dict(out)
    model.restored_from = "torch state_dict"
    return out
