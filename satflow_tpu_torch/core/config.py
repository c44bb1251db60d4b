"""Hydra-style YAML config composition, without Hydra.

Counterpart of ``satflow_tpu/core/config.py``, kept as this package's own
copy; the YAML tree itself (``satflow_tpu/configs``) is data and is read in
place (:func:`default_config_dir`).

The reference composes its run config from 9 YAML groups via Hydra's defaults list
(reference satflow/configs/config.yaml:4-14) and instantiates every object from
``_target_`` strings (reference satflow/experiments/train.py:39-70). This module
reimplements that surface on plain dicts + PyYAML:

- ``compose(config_dir, config_name, overrides)`` — defaults-list composition with
  group overrides (``model=convlstm``), dotted value overrides (``model.lr=0.01``),
  additions (``+model.new_key=1``) and deletions (``~logger``).
- ``# @package _global_`` experiment overlays merge at the config root (the
  reference's ``configs/experiment/*.yaml`` pattern).
- ``instantiate(cfg, **kwargs)`` — builds the object named by ``_target_``,
  imported by path unless the caller maps targets itself (``locate``).
"""

from __future__ import annotations

import copy
import functools
import importlib
import os
import re
from typing import Any, Callable, Dict, List, Optional, Sequence

import yaml

PACKAGE_GLOBAL_RE = re.compile(r"^#\s*@package\s+_global_\s*$", re.MULTILINE)


class _Yaml12Loader(yaml.SafeLoader):
    """SafeLoader + a YAML-1.2-style float resolver: PyYAML (YAML 1.1) only
    floats '1.0e-4', but hydra users write '1e-4' (run.py's own docstring
    does) — without this, such values reach optimizers as strings. Resolving
    at PARSE time (not post-hoc) keeps explicitly quoted scalars ("1e5" as a
    version id) as the strings the user wrote."""


_Yaml12Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$"),
    list("-+0123456789."),
)


def _yaml_load(text: str) -> Any:
    return yaml.load(text, Loader=_Yaml12Loader)


def _read_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        text = f.read()
    data = _yaml_load(text) or {}
    if not isinstance(data, dict):
        raise ValueError(f"Config file {path} must contain a mapping, got {type(data)}")
    data["__package_global__"] = bool(PACKAGE_GLOBAL_RE.search(text))
    return data


def merge(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive dict merge; overlay wins, nested dicts merge, lists replace."""
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _set_dotted(cfg: Dict[str, Any], dotted: str, value: Any, allow_new: bool = True):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            if not allow_new:
                raise KeyError(f"Override path {dotted!r}: missing key {k!r}")
            node[k] = {}
        node = node[k]
    if not allow_new and keys[-1] not in node:
        raise KeyError(
            f"Override {dotted!r} refers to a key that does not exist; "
            f"use '+{dotted}=...' to add a new key"
        )
    node[keys[-1]] = value


def _del_dotted(cfg: Dict[str, Any], dotted: str):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.get(k, {})
        if not isinstance(node, dict):
            return
    node.pop(keys[-1], None)


def _parse_value(raw: str) -> Any:
    try:
        return _yaml_load(raw)
    except yaml.YAMLError:
        return raw


def _load_group_file(config_dir: str, group: str, name: str) -> Dict[str, Any]:
    name = str(name)
    if not name.endswith(".yaml"):
        name = name + ".yaml"
    path = os.path.join(config_dir, group, name) if group else os.path.join(config_dir, name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"Config group file not found: {path}")
    return _read_yaml(path)


def _apply_group(cfg: Dict[str, Any], config_dir: str, group: str, name: Optional[str]):
    """Merge one defaults-list entry into cfg (under its group key, or at root)."""
    if name is None or name == "null":
        cfg.pop(group, None)
        return
    data = _load_group_file(config_dir, group, name)
    pkg_global = data.pop("__package_global__", False)
    # Experiment overlays and any `@package _global_` file merge at the root;
    # experiment files may themselves carry a defaults list of group overrides.
    nested_defaults = data.pop("defaults", None)
    if nested_defaults:
        for entry in nested_defaults:
            if entry == "_self_":
                continue
            if isinstance(entry, dict):
                for g, n in entry.items():
                    g = str(g).removeprefix("override ").removeprefix("/")
                    _apply_group(cfg, config_dir, g, n)
            # bare strings in nested defaults are ignored (hydra self-refs)
    if pkg_global or not group or group in ("experiment", "configurations_global"):
        # @package _global_ overlays AND bare-string defaults entries (root
        # config files, group "") merge at the ROOT — a bare entry under
        # cfg[""] would be invisible to every consumer
        cfg.update(merge(cfg, data))
    else:
        cfg[group] = merge(cfg.get(group, {}), data)


def compose(
    config_dir: str,
    config_name: str = "config.yaml",
    overrides: Sequence[str] = (),
) -> Dict[str, Any]:
    """Compose the run config: root file + defaults list + CLI-style overrides."""
    root = _read_yaml(os.path.join(config_dir, config_name))
    root.pop("__package_global__", None)
    defaults: List[Any] = root.pop("defaults", [])

    # Partition overrides into group selections vs value overrides.
    group_overrides: Dict[str, Optional[str]] = {}
    value_overrides: List[str] = []
    deletions: List[str] = []
    for ov in overrides:
        ov = ov.strip()
        if ov.startswith("~"):
            deletions.append(ov[1:])
            continue
        if "=" not in ov:
            raise ValueError(f"Malformed override {ov!r} (expected key=value)")
        key, raw = ov.split("=", 1)
        key = key.lstrip("+")
        # `+experiment=foo` selects a group not in the defaults list — still a
        # group selection as long as a matching group directory exists.
        if "." not in key and _group_exists(config_dir, key):
            group_overrides[key] = None if raw in ("null", "None") else raw
        else:
            value_overrides.append(f"{key}={raw}")

    cfg: Dict[str, Any] = {}
    seen_groups = []
    merged_self = False
    for entry in defaults:
        if entry == "_self_":
            cfg = merge(cfg, root)
            merged_self = True
            continue
        if isinstance(entry, str):
            _apply_group(cfg, config_dir, "", entry)
            continue
        for group, name in entry.items():
            group = str(group).removeprefix("override ").removeprefix("/")
            if group in group_overrides:
                name = group_overrides.pop(group)
            seen_groups.append(group)
            if name is not None:
                _apply_group(cfg, config_dir, group, name)

    # Root-file keys when the defaults list has no explicit _self_ entry.
    # When _self_ WAS present, root already merged at its position — merging
    # again here would clobber overlays from groups processed after _self_
    # (hydra's _self_-first pattern).
    if root and not merged_self:
        cfg = merge(cfg, root)

    # Group overrides for groups not present in the defaults list (e.g. +experiment=x).
    for group, name in group_overrides.items():
        if name is not None:
            _apply_group(cfg, config_dir, group, name)
        else:
            cfg.pop(group, None)

    for ov in value_overrides:
        key, raw = ov.split("=", 1)
        _set_dotted(cfg, key, _parse_value(raw))
    for key in deletions:
        _del_dotted(cfg, key)
    return cfg


def _group_exists(config_dir: str, group: str) -> bool:
    return os.path.isdir(os.path.join(config_dir, group))


def default_config_dir() -> str:
    """The YAML tree the JAX package ships (``satflow_tpu/configs``): data,
    read in place beside this package, found by path without an import."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "satflow_tpu", "configs")


# ---------------------------------------------------------------------------
# _target_ instantiation
# ---------------------------------------------------------------------------


def _locate(target: str) -> Any:
    """Import ``module.path.Class`` (reference's hydra.utils.instantiate lookup)."""
    parts = target.split(".")
    for split in range(len(parts) - 1, 0, -1):
        mod_name = ".".join(parts[:split])
        try:
            obj: Any = importlib.import_module(mod_name)
        except ImportError:
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
            return obj
        except AttributeError:
            continue
    raise ImportError(f"Cannot locate target {target!r}")


def instantiate(cfg: Any, locate: Callable[[str], Any] = _locate, **kwargs) -> Any:
    """Build the object described by a ``_target_`` config node.

    Mirrors ``hydra.utils.instantiate`` semantics used by the reference train script
    (reference satflow/experiments/train.py:39-70): nested ``_target_`` nodes are
    instantiated recursively; ``_partial_: true`` returns a partial. ``locate``
    maps a target string to its class (``experiments/train.py`` passes the
    mapping from the config tree's targets to this package's classes).
    """
    if isinstance(cfg, list):
        return [instantiate(v, locate) for v in cfg]
    if not isinstance(cfg, dict):
        return cfg
    if "_target_" not in cfg:
        return {k: instantiate(v, locate) for k, v in cfg.items()}
    cfg = dict(cfg)
    target = cfg.pop("_target_")
    partial = cfg.pop("_partial_", False)
    cfg.pop("_convert_", None)
    cls = locate(target)
    built = {k: instantiate(v, locate) for k, v in cfg.items()}
    built.update(kwargs)
    if partial:
        return functools.partial(cls, **built)
    return cls(**built)
