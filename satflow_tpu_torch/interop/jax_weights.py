"""flax variables -> PyTorch state dicts of the port's ConvLSTM, MetNet, zoo and Perceiver cores.

The inverse direction of ``satflow_tpu/interop/torch_weights.py``. Its
layout rule, read backwards: a flax conv kernel (kh, kw, I, O) becomes an
``nn.Conv2d`` weight (O, I, kh, kw). The fused cells keep the flax HWIO
layout as they are (the CUDA kernel takes it).

The flax tree of ``EncoderDecoderConvLSTM`` is, by ``cell_impl``::

    fused, cmajor:  {encoder/encoder_N, decoder/decoder_N}/{x_gates_kernel,
                    h_gates_kernel, bias}
    concat:         …/gates/{kernel, bias}; with ``conv_type`` "coord" or
                    "antialiased" …/gates/Conv_0/{kernel, bias}
    split:          encoder_input_gates/x_gates/{kernel, bias};
                    encoder/encoder_1/h_gates/kernel; every other cell
                    …/x_gates/{kernel, bias} and …/h_gates/kernel
    hybrid:         the split encoder (with encoder_input_gates) and the
                    concat decoder
    all:            decoder/head/{kernel, bias}

with two other nestings that the JAX model's ``adapt_restored_params``
relocates and this bridge normalises the same way: ``encoder/steps/…`` and
``decoder/steps/…`` (``remat_chunk`` > 1), and ``head/…`` at the top level
(``head_in_scan=False``).

:func:`metnet_state_dict_from_flax` converts ``LitMetNet``'s variables,
params and the BatchNorm ``batch_stats``, leaf by leaf: conv kernels HWIO ->
OIHW, Dense kernels (in, out) -> (out, in), the attention's DenseGeneral
kernels (C, heads, d) and (heads, d, C) -> ``nn.Linear`` weights, LayerNorm
``scale`` -> ``weight``; BatchNorm ``scale``/``bias``, ``pos_emb`` and the
running ``mean``/``var`` keep their names.

:func:`flax_tree_state_dict` converts the channels-stacked zoo (the U-Net
family, FCN / DeepLabV3, PixelCNN) and each GAN network by one walk of the
tree, :func:`perceiver_state_dict_from_flax` the Perceiver family the same
way (its DenseGeneral kernels kept as they are), and
:func:`gan_state_dict_from_flax` the GAN family's two networks with their
``batch_stats`` and ``spectral`` collections.

A flat ``.npz`` (:func:`save_npz`) holds the params under their paths and a
``batch_stats`` collection under ``batch_stats/``. Pure numpy: no jax is
needed to read the weights.
"""

from __future__ import annotations

import keyword
from collections import OrderedDict
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_FUSED_LEAVES = ("x_gates_kernel", "h_gates_kernel", "bias")
_CELLS = {"encoder": ("encoder_1", "encoder_2"), "decoder": ("decoder_1", "decoder_2")}
# a cell's conv modules by formulation, and what may nest below one
_CONVS = ("gates", "x_gates", "h_gates")


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict of arrays -> {"a/b/leaf": array}."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def unflatten_tree(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{"a/b/leaf": array} -> nested dict of arrays."""
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = np.asarray(value)
    return tree


def _normalise(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """Strip ``params``/``steps`` nesting and move the head under ``decoder``."""
    params = dict(tree.get("params", tree))
    out = {}
    for block in ("encoder", "decoder"):
        if block not in params:
            raise KeyError(f"flax params have no {block!r} subtree: {sorted(params)}")
        sub = dict(params.pop(block))
        if "steps" in sub:
            sub = dict(sub.pop("steps"))
        out[block] = sub
    if "encoder_input_gates" in params:
        out["encoder_input_gates"] = params.pop("encoder_input_gates")
    if "head" in params:
        if "head" in out["decoder"]:
            raise KeyError("flax params hold two heads (top level and decoder/head)")
        out["decoder"]["head"] = params.pop("head")
    if params:
        raise KeyError(f"unexpected flax params: {sorted(params)}")
    return out


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv_leaves(prefix: str, conv: Mapping[str, Any], where: str):
    """A flax conv's ``kernel`` (kh, kw, I, O) and optional ``bias`` as the
    port's ``weight`` (O, I, kh, kw) and ``bias``; a ``Conv_0`` level (the
    coord and antialiased convs) is kept."""
    conv = dict(conv)
    if "Conv_0" in conv:
        yield from _conv_leaves(f"{prefix}.Conv_0", conv.pop("Conv_0"), f"{where}/Conv_0")
    else:
        kernel = np.asarray(conv.pop("kernel"), dtype=np.float32)
        yield f"{prefix}.weight", torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        if "bias" in conv:
            yield f"{prefix}.bias", _f32(conv.pop("bias"))
    if conv:
        raise KeyError(f"unexpected flax params in {where}: {sorted(conv)}")


def _cell_leaves(prefix: str, cell: Mapping[str, Any], where: str):
    """One cell's leaves: the fused cell's three arrays as they are (the CUDA
    kernel takes the flax HWIO layout), or the concat and split cells' convs."""
    cell = dict(cell)
    if any(leaf in cell for leaf in _FUSED_LEAVES):
        for leaf in _FUSED_LEAVES:
            yield f"{prefix}.{leaf}", _f32(cell.pop(leaf))
    else:
        for name in _CONVS:
            if name in cell:
                yield from _conv_leaves(f"{prefix}.{name}", cell.pop(name), f"{where}/{name}")
    if cell:
        raise KeyError(f"unexpected flax params in {where}: {sorted(cell)}")


def params_from_flax(tree: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Flax params of ``EncoderDecoderConvLSTM``, whatever its ``cell_impl``
    and ``conv_type`` (numpy leaves, with or without the top ``params`` key)
    -> state_dict of the port's ``ConvLSTMCore`` of the same configuration."""
    params = _normalise(tree)
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for block, cells in _CELLS.items():
        for cell in cells:
            sd.update(_cell_leaves(f"{block}.{cell}", params[block].pop(cell),
                                   f"{block}/{cell}"))
        if block == "encoder" and "encoder_input_gates" in params:
            sd.update(_cell_leaves("encoder_input_gates", params.pop("encoder_input_gates"),
                                   "encoder_input_gates"))
    sd.update(_conv_leaves("decoder.head", params["decoder"].pop("head"), "decoder/head"))
    extra = [f"{block}/{k}" for block, sub in params.items() for k in sub]
    if extra:
        raise KeyError(f"unexpected flax params: {sorted(extra)}")
    return sd


def metnet_state_dict_from_flax(variables: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """flax variables of ``LitMetNet`` (``{"params": ..., "batch_stats":
    ...}``, numpy leaves) -> state_dict of the port's ``MetNetCore``."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for path, a in flatten_tree(variables["params"]).items():
        *mods, leaf = path.split("/")
        key = ".".join(mods)
        a = np.asarray(a, dtype=np.float32)
        if leaf == "kernel":
            if a.ndim == 4:  # conv (kh, kw, I, O) -> (O, I, kh, kw)
                a = a.transpose(3, 2, 0, 1)
            elif mods[-1] == "out" and a.ndim == 3:  # DenseGeneral (h, d, C)
                a = a.reshape(-1, a.shape[-1]).T
            elif a.ndim == 3:  # DenseGeneral (C, h, d)
                a = a.reshape(a.shape[0], -1).T
            else:  # Dense (in, out)
                a = a.T
            leaf = "weight"
        elif leaf == "bias":
            a = a.reshape(-1)  # DenseGeneral (h, d)
        elif leaf == "scale" and mods[-1].startswith("ln"):
            leaf = "weight"  # LayerNorm
        elif leaf not in ("scale", "pos_emb"):
            raise KeyError(f"unexpected flax param {path!r}")
        sd[f"{key}.{leaf}"] = torch.from_numpy(np.array(a, order="C"))
    for path, a in flatten_tree(variables.get("batch_stats", {})).items():
        sd[path.replace("/", ".")] = torch.from_numpy(np.array(a, dtype=np.float32))
    return sd


def perceiver_state_dict_from_flax(variables: Mapping[str, Any]
                                   ) -> "OrderedDict[str, torch.Tensor]":
    """flax variables (``{"params": ...}``, numpy leaves) of ``Perceiver`` or
    ``HuggingFacePerceiver`` -> the state_dict of the port's core, by one
    walk of the tree: a leaf's path is its key (``in`` -> ``in_``), its
    array the value as float32, but for a kernel that the port lays out as
    torch does, which becomes ``weight``: a Dense's (in, out) -> (out, in), a
    conv's or a transposed conv's (*k, I, O) -> (O, I, *k). The attention's
    DenseGeneral kernels, the only 3-D ones, keep their name and shape. The
    per-lead core sits under ``steps/core/...`` (the scan's, shared by the
    lead steps) or ``perceiver/...``, with ``query/...`` or
    ``query_from_sat/...``, ``preprocessor/...``, ``postprocessor/...``; the
    HF head's under ``core/...`` and ``channel_change/...``."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for path, a in flatten_tree(variables.get("params", {})).items():
        *mods, leaf = path.split("/")
        a = np.asarray(a, dtype=np.float32)
        if leaf == "kernel" and a.ndim != 3:
            a, leaf = np.moveaxis(a, (-1, -2), (0, 1)), "weight"
        sd[_module_key(mods + [leaf])] = torch.from_numpy(np.array(a, order="C"))
    return sd


def flax_tree_state_dict(variables: Mapping[str, Any], dtype=np.float32
                         ) -> "OrderedDict[str, torch.Tensor]":
    """flax variables (``{"params": ..., "batch_stats": ..., "spectral":
    ...}``, numpy leaves) of a channels-stacked zoo model (``Unet``,
    ``RUnet``, ``AttentionUnet``, ``AttentionRUnet``, ``FCN``, ``DeeplabV3``,
    ``PixelCNN``) or of one GAN network -> the state_dict of the port's
    module, by one walk of each collection: the port names its submodules as
    flax does, so a leaf's path is its key, and a module named as a Python
    keyword takes a trailing underscore (``in`` -> ``in_``). A ``kernel``
    becomes ``weight`` in torch's layout: a Dense's (I, O) -> (O, I), a
    conv's or transposed conv's (*k, I, O) -> (O, I, *k), flax's 1-D conv
    kernel (k, I, O) (an int kernel size) -> (O, I, 1, k) (the port's (1, k)
    conv along W). Every other leaf keeps its name and array: biases,
    scales, ``gamma``, ``embedding``, the fused ConvLSTM cells' HWIO
    kernels, the BatchNorm ``mean`` / ``var`` and the spectral-norm ``u``
    (the buffers ``...bn.mean``, ``...sn.u``). MaskedConv's kernel is a plain
    conv kernel (its mask is applied per call). Leaves are cast to ``dtype``
    (the port's weights are float32)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for coll, tree in variables.items():
        for path, a in flatten_tree(tree).items():
            *mods, leaf = path.split("/")
            a = np.asarray(a, dtype=dtype)
            if coll == "params" and leaf == "kernel":
                if a.ndim == 3:
                    a = a.transpose(2, 1, 0)[:, :, None, :]
                else:
                    a = np.moveaxis(a, (-1, -2), (0, 1))
                leaf = "weight"
            sd[_module_key(mods + [leaf])] = torch.from_numpy(np.array(a, order="C"))
    return sd


def gan_state_dict_from_flax(g_vars: Mapping[str, Any], d_vars: Optional[Mapping[str, Any]] = None
                             ) -> "OrderedDict[str, torch.Tensor]":
    """flax variables of a GAN model's generator and discriminator (each
    ``{"params": ..., <state collections>}``, as ``init_gan_variables``
    returns them) -> the state_dict of the port's GAN model: the generator
    under ``module.``, the discriminator under ``disc_module.``
    (:func:`flax_tree_state_dict` for each)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for prefix, variables in (("module.", g_vars), ("disc_module.", d_vars)):
        if variables is not None:
            sd.update((prefix + k, v)
                      for k, v in flax_tree_state_dict(variables).items())
    return sd


def _module_key(names) -> str:
    """A flax path's state_dict key; a flax module name that is a Python
    keyword (PixelCNN's ``in``) takes a trailing underscore in the port,
    where module names are attributes."""
    return ".".join(f"{n}_" if keyword.iskeyword(n) else n for n in names)


def save_npz(path, tree: Mapping[str, Any]) -> None:
    """Write flax variables (numpy leaves) as the flat ``.npz`` that
    :func:`read_npz` reads: params under their paths, like
    ``"encoder/encoder_1/x_gates_kernel"``, and a ``batch_stats`` collection
    under ``"batch_stats/..."``."""
    flat = flatten_tree(tree.get("params", tree))
    if "batch_stats" in tree:
        flat.update(flatten_tree(tree["batch_stats"], "batch_stats/"))
    np.savez(path, **flat)


def read_npz(path) -> Dict[str, Any]:
    """The flax variables of a flat ``.npz``: ``{"params": ...}``, with
    ``"batch_stats"`` when the file holds that collection."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    stats = {k[len("batch_stats/"):]: v for k, v in flat.items() if k.startswith("batch_stats/")}
    variables = {"params": unflatten_tree({k: v for k, v in flat.items()
                                           if not k.startswith("batch_stats/")})}
    if stats:
        variables["batch_stats"] = unflatten_tree(stats)
    return variables


def save_gan_npz(path, g_vars: Mapping[str, Any], d_vars: Mapping[str, Any]) -> None:
    """Write a GAN's flax variables (numpy leaves), every collection of the
    generator's and the discriminator's (``params``, ``spectral``, ...), as
    one flat ``.npz``: ``"generator/<collection>/<path>"`` and
    ``"discriminator/<collection>/<path>"`` (:func:`flatten_tree`)."""
    np.savez(path, **flatten_tree({"generator": g_vars, "discriminator": d_vars}))


def read_gan_npz(path):
    """The (generator, discriminator) flax variables of a
    :func:`save_gan_npz` file, for :func:`gan_state_dict_from_flax`."""
    with np.load(path, allow_pickle=False) as data:
        tree = unflatten_tree({k: data[k] for k in data.files})
    if set(tree) != {"generator", "discriminator"}:
        raise KeyError(f"{path}: top-level keys {sorted(tree)}, expected "
                       "['discriminator', 'generator']")
    return tree["generator"], tree["discriminator"]


def load_npz(path) -> "OrderedDict[str, torch.Tensor]":
    """Read a flat ``.npz`` of ``EncoderDecoderConvLSTM``'s flax params and
    convert it with :func:`params_from_flax`."""
    return params_from_flax(read_npz(path))
