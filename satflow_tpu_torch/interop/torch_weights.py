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
- the Perceiver family's ``Dense`` and conv weights take torch's layouts
  too, so an ``nn.Linear`` weight (O, I) stays as it is; its attention keeps
  flax's DenseGeneral kernels, so a q/k/v projection (inner, D) becomes one
  of (D, heads, dh) (:func:`qkv_kernel`) and an out-projection (O, inner)
  one of (heads, dh, O) (:func:`attn_out_kernel`); an
  ``nn.ConvTranspose2d`` weight (I, O, kh, kw) becomes the port's
  ``ConvTranspose`` weight (O, I, kh, kw) (:func:`conv_transpose_kernel`,
  the JAX rule read through the port's layout), a LayerNorm ``weight`` its
  ``scale``;
- :func:`linear_kernel` and :func:`conv3d_kernel` are the JAX module's
  layout rules for ``nn.Linear`` and ``nn.Conv3d`` into flax's layouts.

The JAX package reads the target tree's geometry from ``module.init``; here
the target is the port's own module, so :func:`load_torch_convlstm` reads
which cell formulation it holds from its parameter names and takes the
input width from their shapes, and the Perceiver's rules read the core's
depth, heads and tying from the port's :class:`MultiPerceiverIO`.

Perceiver maps:

- :func:`load_torch_perceiver`: the PerceiverIO naming of the reference's
  perceiver package (``latents``, ``cross_attend_blocks.{0,1}``,
  ``layers.{i}.{0,1}``, ``decoder_cross_attn``, ``decoder_ff``,
  ``to_logits``), a fused ``to_kv`` or split ``to_k`` / ``to_v``;
- :func:`load_hf_optical_flow`: HF transformers' ``PerceiverForOpticalFlow``
  (``deepmind/optical-flow-perceiver``), its whole transformer core.
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


def conv_transpose_kernel(w) -> torch.Tensor:
    """(I, O, kh, kw) -> (O, I, kh, kw), the port's ``ConvTranspose``
    weight (the JAX rule's flax (kh, kw, I, O), laid out as the port lays
    that kernel out)."""
    return _tensor(w).transpose(0, 1).contiguous()


def qkv_kernel(w, heads: int) -> torch.Tensor:
    """Torch (inner, D) q/k/v linear -> DenseGeneral kernel (D, heads, dh)."""
    w = linear_kernel(w)  # (D, inner)
    d, inner = w.shape
    return w.reshape(d, heads, inner // heads)


def attn_out_kernel(w, heads: int) -> torch.Tensor:
    """Torch (O, inner) out-projection -> DenseGeneral kernel (heads, dh, O)."""
    w = linear_kernel(w)  # (inner, O)
    inner, o = w.shape
    return w.reshape(heads, inner // heads, o)


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


# -----------------------------------------------------------------------------
# PerceiverIO core (the naming of the reference's perceiver package)
# -----------------------------------------------------------------------------


def _attn_rules(torch_prefix: str, port_prefix: str, heads: int) -> Dict[str, tuple]:
    return {
        f"{torch_prefix}.to_q.weight": (f"{port_prefix}.to_q.kernel",
                                        lambda w, h=heads: qkv_kernel(w, h)),
        f"{torch_prefix}.to_k.weight": (f"{port_prefix}.to_k.kernel",
                                        lambda w, h=heads: qkv_kernel(w, h)),
        f"{torch_prefix}.to_v.weight": (f"{port_prefix}.to_v.kernel",
                                        lambda w, h=heads: qkv_kernel(w, h)),
        f"{torch_prefix}.to_out.weight": (f"{port_prefix}.to_out.kernel",
                                          lambda w, h=heads: attn_out_kernel(w, h)),
        f"{torch_prefix}.to_out.bias": (f"{port_prefix}.to_out.bias", _tensor),
    }


def _ln_rules(torch_prefix: str, port_prefix: str) -> Dict[str, tuple]:
    return {
        f"{torch_prefix}.weight": (f"{port_prefix}.scale", _tensor),
        f"{torch_prefix}.bias": (f"{port_prefix}.bias", _tensor),
    }


def _ff_rules(torch_prefix: str, port_prefix: str) -> Dict[str, tuple]:
    return {
        f"{torch_prefix}.net.0.weight": (f"{port_prefix}.in_.weight", _tensor),
        f"{torch_prefix}.net.0.bias": (f"{port_prefix}.in_.bias", _tensor),
        f"{torch_prefix}.net.2.weight": (f"{port_prefix}.out.weight", _tensor),
        f"{torch_prefix}.net.2.bias": (f"{port_prefix}.out.bias", _tensor),
    }


def _split_fused_kv(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """A fused ``to_kv.weight`` (2 inner, D) split into ``to_k`` / ``to_v``."""
    out = dict(state_dict)
    for key in list(state_dict):
        if key.endswith(".to_kv.weight"):
            w = _tensor(state_dict[key])
            half = w.shape[0] // 2
            base = key[: -len(".to_kv.weight")]
            out.setdefault(f"{base}.to_k.weight", w[:half])
            out.setdefault(f"{base}.to_v.weight", w[half:])
            del out[key]
    return out


def perceiver_core_rules(core) -> Dict[str, tuple]:
    """Conversion rules {torch key: (port key, transform)} for the port's
    :class:`~satflow_tpu_torch.nn.perceiver.MultiPerceiverIO` ``core``, keys
    relative to it."""
    rules: Dict[str, tuple] = {"latents": ("latents", _tensor)}
    # encoder cross-attention: block 0 = PreNorm(attn), block 1 = PreNorm(ff)
    rules.update(_ln_rules("cross_attend_blocks.0.norm", "encode.ln_q"))
    rules.update(_ln_rules("cross_attend_blocks.0.norm_context", "encode.ln_kv"))
    rules.update(_attn_rules("cross_attend_blocks.0.fn", "encode.attn", core.cross_heads))
    rules.update(_ln_rules("cross_attend_blocks.1.norm", "encode.ln_ff"))
    rules.update(_ff_rules("cross_attend_blocks.1.fn", "encode.ff"))
    for i in range(1 if core.weight_tie_layers else core.depth):
        block = "latent" if core.weight_tie_layers else f"latent{i}"
        rules.update(_ln_rules(f"layers.{i}.0.norm", f"{block}.ln"))
        rules.update(_attn_rules(f"layers.{i}.0.fn", f"{block}.attn", core.latent_heads))
        rules.update(_ln_rules(f"layers.{i}.1.norm", f"{block}.ln_ff"))
        rules.update(_ff_rules(f"layers.{i}.1.fn", f"{block}.ff"))
    rules.update(_ln_rules("decoder_cross_attn.norm", "decode.ln_q"))
    rules.update(_ln_rules("decoder_cross_attn.norm_context", "decode.ln_kv"))
    rules.update(_attn_rules("decoder_cross_attn.fn", "decode.attn", core.cross_heads))
    if core.decoder_ff:
        rules.update(_ln_rules("decoder_ff.norm", "decode.ln_ff"))
        rules.update(_ff_rules("decoder_ff.fn", "decode.ff"))
    rules["to_logits.weight"] = ("to_logits.weight", _tensor)
    rules["to_logits.bias"] = ("to_logits.bias", _tensor)
    return rules


def load_torch_perceiver(core, state_dict: Mapping[str, Any],
                         strict: bool = False) -> Dict[str, torch.Tensor]:
    """Convert a PerceiverIO-naming torch state_dict (fused ``to_kv``
    accepted) into the port's ``MultiPerceiverIO`` ``core`` and load it;
    returns the converted state dict. ``strict=False`` skips absent torch
    keys (real checkpoints carry preprocessor weights the core replaces)."""
    out = load_torch_state_dict(core.state_dict(), _split_fused_kv(state_dict),
                                perceiver_core_rules(core), strict=strict)
    core.load_state_dict(out)
    return out


# -----------------------------------------------------------------------------
# HF transformers PerceiverForOpticalFlow (deepmind/optical-flow-perceiver)
# -----------------------------------------------------------------------------


def _ff_hf_rules(tp: str, pp: str) -> Dict[str, tuple]:
    return {
        f"{tp}.dense1.weight": (f"{pp}.in_.weight", _tensor),
        f"{tp}.dense1.bias": (f"{pp}.in_.bias", _tensor),
        f"{tp}.dense2.weight": (f"{pp}.out.weight", _tensor),
        f"{tp}.dense2.bias": (f"{pp}.out.bias", _tensor),
    }


def _hf_attn_rules(tp: str, pp: str, heads: int) -> Dict[str, tuple]:
    """An HF ``PerceiverLayer`` (attention and MLP) -> one of the port's
    attention blocks: ``attention.self.{query,key,value}`` carry biases,
    ``attention.output.dense`` is the out-projection, ``layernorm`` and
    ``mlp.dense{1,2}`` the feed-forward."""

    def qkv_bias(b, h=heads):
        return _tensor(b).reshape(h, -1)

    def qkv(w, h=heads):
        return qkv_kernel(w, h)

    return {
        f"{tp}.attention.self.query.weight": (f"{pp}.attn.to_q.kernel", qkv),
        f"{tp}.attention.self.query.bias": (f"{pp}.attn.to_q.bias", qkv_bias),
        f"{tp}.attention.self.key.weight": (f"{pp}.attn.to_k.kernel", qkv),
        f"{tp}.attention.self.key.bias": (f"{pp}.attn.to_k.bias", qkv_bias),
        f"{tp}.attention.self.value.weight": (f"{pp}.attn.to_v.kernel", qkv),
        f"{tp}.attention.self.value.bias": (f"{pp}.attn.to_v.bias", qkv_bias),
        f"{tp}.attention.output.dense.weight": (
            f"{pp}.attn.to_out.kernel", lambda w, h=heads: attn_out_kernel(w, h)),
        f"{tp}.attention.output.dense.bias": (f"{pp}.attn.to_out.bias", _tensor),
        **_ln_rules(f"{tp}.layernorm", f"{pp}.ln_ff"),
        **_ff_hf_rules(f"{tp}.mlp", f"{pp}.ff"),
    }


def hf_flow_rules(core, prefix: str = "") -> Dict[str, tuple]:
    """Conversion rules: an HF ``PerceiverForOpticalFlow`` state_dict (its
    leading ``perceiver.`` stripped) -> the port's ``MultiPerceiverIO``
    ``core`` at ``prefix`` (e.g. ``"core.steps.core"`` in
    ``HuggingFacePerceiver``'s module): the latents, the encoder's
    cross-attention, every self-attention, the decoder's cross-attention and
    ``final_layer`` -> ``to_logits``. The HF image preprocessor and the
    port's modality projections differ in kind (project-then-concat against
    concat-then-project) and are left to fine-tuning."""
    p = f"{prefix}." if prefix else ""
    rules: Dict[str, tuple] = {"embeddings.latents": (f"{p}latents", _tensor)}
    enc = "encoder.cross_attention"
    rules.update(_ln_rules(f"{enc}.attention.self.layernorm1", f"{p}encode.ln_q"))
    rules.update(_ln_rules(f"{enc}.attention.self.layernorm2", f"{p}encode.ln_kv"))
    rules.update(_hf_attn_rules(enc, f"{p}encode", core.cross_heads))
    for i in range(1 if core.weight_tie_layers else core.depth):
        sa = f"encoder.self_attends.{i}"
        block = f"{p}latent" if core.weight_tie_layers else f"{p}latent{i}"
        rules.update(_ln_rules(f"{sa}.attention.self.layernorm1", f"{block}.ln"))
        rules.update(_hf_attn_rules(sa, block, core.latent_heads))
    dec = "decoder.decoder.decoding_cross_attention"
    rules.update(_ln_rules(f"{dec}.attention.self.layernorm1", f"{p}decode.ln_q"))
    rules.update(_ln_rules(f"{dec}.attention.self.layernorm2", f"{p}decode.ln_kv"))
    rules.update(_hf_attn_rules(dec, f"{p}decode", core.cross_heads))
    rules["decoder.decoder.final_layer.weight"] = (f"{p}to_logits.weight", _tensor)
    rules["decoder.decoder.final_layer.bias"] = (f"{p}to_logits.bias", _tensor)
    return rules


def strip_hf_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop the top-level ``perceiver.`` module prefix HF models carry."""
    return {(k[len("perceiver."):] if k.startswith("perceiver.") else k): v
            for k, v in state_dict.items()}


def load_hf_optical_flow(module, core, state_dict: Mapping[str, Any], prefix: str = "",
                         strict: bool = True) -> Dict[str, torch.Tensor]:
    """Convert an HF ``PerceiverForOpticalFlow`` state_dict into ``module``,
    whose ``MultiPerceiverIO`` ``core`` sits at ``prefix``, and load it;
    returns the converted state dict. ``strict=True`` requires every key of
    the transformer core (the preprocessor's keys are not read)."""
    out = load_torch_state_dict(module.state_dict(), strip_hf_prefix(state_dict),
                                hf_flow_rules(core, prefix), strict=strict)
    module.load_state_dict(out)
    return out
