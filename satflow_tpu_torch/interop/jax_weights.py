"""flax variables -> PyTorch state_dict for the port's ConvLSTM and MetNet cores.

The inverse direction of ``satflow_tpu/interop/torch_weights.py``. Its
layout rule, read backwards: a flax conv kernel (kh, kw, I, O) becomes an
``nn.Conv2d`` weight (O, I, kh, kw). The fused cells keep the flax HWIO
layout as they are (the CUDA kernel takes it).

The flax tree of ``EncoderDecoderConvLSTM`` is::

    encoder/encoder_{1,2}/{x_gates_kernel, h_gates_kernel, bias}
    decoder/decoder_{1,2}/{x_gates_kernel, h_gates_kernel, bias}
    decoder/head/{kernel, bias}

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

A flat ``.npz`` (:func:`save_npz`) holds the params under their paths and a
``batch_stats`` collection under ``batch_stats/``. Pure numpy: no jax is
needed to read the weights.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch

_CELL_LEAVES = ("x_gates_kernel", "h_gates_kernel", "bias")
_CELLS = {"encoder": ("encoder_1", "encoder_2"), "decoder": ("decoder_1", "decoder_2")}


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
    if "head" in params:
        if "head" in out["decoder"]:
            raise KeyError("flax params hold two heads (top level and decoder/head)")
        out["decoder"]["head"] = params.pop("head")
    if params:
        raise KeyError(f"unexpected flax params: {sorted(params)}")
    return out


def params_from_flax(tree: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Flax params of ``EncoderDecoderConvLSTM`` (numpy leaves, with or without
    the top ``params`` key) -> state_dict of the port's ``ConvLSTMCore``."""
    params = _normalise(tree)
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for block, cells in _CELLS.items():
        for cell in cells:
            leaves = dict(params[block].pop(cell))
            for leaf in _CELL_LEAVES:
                sd[f"{block}.{cell}.{leaf}"] = torch.from_numpy(
                    np.array(leaves.pop(leaf), dtype=np.float32))
            if leaves:
                raise KeyError(f"unexpected flax params in {block}/{cell}: {sorted(leaves)}")
    head = dict(params["decoder"].pop("head"))
    kernel = np.asarray(head.pop("kernel"), dtype=np.float32)  # (3, 3, I, O)
    sd["decoder.head.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
    sd["decoder.head.bias"] = torch.from_numpy(np.array(head.pop("bias"), dtype=np.float32))
    extra = [f"{block}/{k}" for block, sub in params.items() for k in sub]
    extra += [f"decoder/head/{k}" for k in head]
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


def load_npz(path) -> "OrderedDict[str, torch.Tensor]":
    """Read a flat ``.npz`` of ``EncoderDecoderConvLSTM``'s flax params and
    convert it with :func:`params_from_flax`."""
    return params_from_flax(read_npz(path))
