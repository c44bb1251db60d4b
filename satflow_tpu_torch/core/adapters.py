"""The JAX package's framework-free modules, imported without jax.

``satflow_tpu.train.loggers`` and ``satflow_tpu.train.callbacks`` need no
framework, but their package's ``__init__`` imports the JAX engine. The
port uses them as they are: :func:`framework_free` loads such a module from
its file, under its own name, without running its parent package's
``__init__`` (the top package ``satflow_tpu`` imports nothing of jax).
"""

from __future__ import annotations

import importlib
import importlib.util
import sys
import threading
from pathlib import Path
from types import ModuleType

#: the modules that may be loaded this way (checked: no jax, flax or optax)
FRAMEWORK_FREE = ("satflow_tpu.train.loggers", "satflow_tpu.train.callbacks")

_lock = threading.Lock()


def framework_free(name: str) -> ModuleType:
    """The module ``name`` (one of :data:`FRAMEWORK_FREE`); imported normally
    if its package is already loaded, else from its file alone."""
    if name not in FRAMEWORK_FREE:
        raise ValueError(f"{name!r} is not one of the framework-free modules {FRAMEWORK_FREE}")
    with _lock:
        if name in sys.modules:
            return sys.modules[name]
        parent = name.rpartition(".")[0]
        if parent in sys.modules:
            return importlib.import_module(name)
        import satflow_tpu

        path = Path(satflow_tpu.__file__).parent.joinpath(*name.split(".")[1:]).with_suffix(".py")
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[name]
            raise
        return module
