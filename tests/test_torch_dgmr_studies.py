"""PyTorch port, DGMR in the quality studies: the horizon study's
``dgmr_stoch`` arm trained without per-epoch validation, and ``gan_gate
--init``, the 32-px DGMR arm started from the JAX Trainer's initial
variables (``satflow_tpu_torch/tools/results/dgmr_jax_init.npz``).

- the validation-free fit (``horizon_gate.dgmr_stoch``) against the same fit
  validated every epoch, at a small geometry: every tensor of G and D (the
  spectral-norm ``u`` included), both optimizers' states, the noise
  generator's state and the row, bit for bit;
- the committed ``.npz``: its keys and shapes those of the port's 32-px
  DGMR at ``gan_gate.DGMR``; ``gan_gate.load_init`` fills every parameter
  and buffer from it and refuses a file with a key missing or one too many;
- ``slow``: the file regenerated from the JAX package (the JAX tool's
  ``dgmr`` arm, stopped at the Trainer's ``init_gan_variables``) equal to
  the committed one, array for array.
"""

import hashlib
import os

import numpy as np
import pytest
import torch
import torch._dynamo  # noqa: F401 - a process's first optimizer imports it (~3 s): here, once

import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.core.registry import create_model
from satflow_tpu_torch.data.fake import StochasticAdvectionDataset
from satflow_tpu_torch.interop.jax_weights import gan_state_dict_from_flax, read_gan_npz
from satflow_tpu_torch.tools import gan_gate, horizon_gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIT = os.path.join(REPO, "satflow_tpu_torch", "tools", "results", "dgmr_jax_init.npz")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: a GAN round of small ops runs many times slower
    with threads that contend with the other xdist workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(a, b, where: str) -> None:
    """``a`` and ``b`` equal bit for bit: tensors, and the dicts, lists and
    scalars of an optimizer's ``state_dict``."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def test_dgmr_stoch_fit_without_validation_equals_the_validated_fit(monkeypatch):
    """The horizon arm at 32 px (DGMR's smallest), 2 lead times, b1,
    narrowed, 2 epochs of 1 split round (so a validation falls between
    two rounds), once validated every epoch and once not: the same trained
    state and row, bit for bit."""
    r = horizon_gate.RECIPES
    monkeypatch.setattr(horizon_gate, "RECIPES", {**r, "dgmr": (r["dgmr"][0], 60, {
        **r["dgmr"][2], "forecast_steps": 2, "output_shape": 32, "context_channels": 8,
        "latent_channels": 16, "disc_channels": 4})})
    monkeypatch.setattr(horizon_gate, "DS48", {**horizon_gate.DS48, "batch_size": 1,
                                               "width": 32, "height": 32,
                                               "forecast_minutes": 10})
    monkeypatch.setattr(horizon_gate, "EVAL_BATCHES", 1)
    eval_set = StochasticAdvectionDataset(length=1, seed=300, **horizon_gate.DS48)
    runs = {v: horizon_gate.dgmr_stoch("cpu", eval_set, epochs=2, length=1, validate=v)
            for v in (True, False)}
    (m_val, t_val, row_val), (m, t, row) = runs[True], runs[False]
    # the validated fit did validate (val/ metrics logged), the other did not
    assert any(k.startswith("val/") for k in t_val.callback_metrics)
    assert not any(k.startswith("val/") for k in t.callback_metrics)
    assert t.global_step == t_val.global_step == 2
    sd = m.state_dict()
    assert any(k.startswith("disc_module.") and k.endswith(".u") for k in sd)
    _same(m_val.state_dict(), sd, "model")
    _same(t_val.state.g.optimizer.state_dict(), t.state.g.optimizer.state_dict(), "g optimizer")
    _same(t_val.state.d.optimizer.state_dict(), t.state.d.optimizer.state_dict(), "d optimizer")
    assert torch.equal(t_val.state.noise.get_state(), t.state.noise.get_state())
    assert (row_val["validation"], row["validation"]) == ("every epoch", "none")
    for k in ("mse_t", "mse", "crps", "sample_std", "d_loss", "epochs", "kernel_launches"):
        assert row_val[k] == row[k], k
    assert len(row["mse_t"]) == 2 and np.isfinite(row["mse_t"]).all()


def _dgmr():
    return create_model("nowcastinggan", generator=torch.Generator().manual_seed(0),
                        **gan_gate.DGMR)


def test_committed_jax_init_fills_the_32px_dgmr():
    """Every array of the file lands on a parameter or buffer of the port's
    32-px DGMR (``gan_gate.DGMR``), every one of those is filled, each equal
    to the file's array; the file's sha256 comes back."""
    g, d = read_gan_npz(INIT)
    assert {"params", "spectral"} <= set(g) and {"params", "spectral"} <= set(d)
    model = _dgmr()
    sha = gan_gate.load_init(model, INIT)
    with open(INIT, "rb") as f:
        assert sha == hashlib.sha256(f.read()).hexdigest()
    want = gan_state_dict_from_flax(g, d)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    with np.load(INIT) as data:
        assert len(data.files) == len(got)
    assert os.path.getsize(INIT) < 8 << 20


@pytest.mark.parametrize("change", ["missing", "extra"])
def test_jax_init_loader_refuses_a_key_missing_or_extra(change, tmp_path):
    with np.load(INIT) as data:
        flat = {k: data[k] for k in data.files}
    if change == "missing":
        flat.pop(sorted(k for k in flat if k.endswith("/u"))[0])
    else:
        flat["generator/params/no_such_module/kernel"] = np.zeros((3, 3), np.float32)
    path = tmp_path / "init.npz"
    np.savez(path, **flat)
    with pytest.raises(RuntimeError, match="Missing key" if change == "missing"
                       else "Unexpected key"):
        gan_gate.load_init(_dgmr(), str(path))


class _Captured(Exception):
    """Raised once the JAX Trainer's initial variables are copied out."""


@pytest.mark.slow
def test_jax_init_file_regenerates_from_the_jax_package(tmp_path):
    """The JAX tool's ``dgmr`` arm (``tools/gan_gate.py``) run up to its
    Trainer's ``NowcastingGAN.init_gan_variables``, then stopped: G's and
    D's variables, every collection, equal to the committed file's, array
    for array and bit for bit (``np.savez`` stamps its zip members with the
    time, so the file's bytes differ)."""
    path = tmp_path / "dgmr_jax_init.npz"
    write_jax_init(str(path), tmp_path)
    want, got = _read_flat(INIT), _read_flat(str(path))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _read_flat(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def write_jax_init(path: str, workdir) -> None:
    """Write the JAX Trainer's initial DGMR variables, those of the JAX
    ``tools/gan_gate.py`` ``dgmr`` arm, as ``path`` (``save_gan_npz``). The
    JAX tool runs in ``workdir`` (it writes ``docs/`` under the working
    directory) and stops at the Trainer's ``init_gan_variables``."""
    import importlib.util

    import jax
    import satflow_tpu.models.dgmr as jax_dgmr
    from flax.core import unfreeze

    from satflow_tpu_torch.interop.jax_weights import save_gan_npz

    init = jax_dgmr.NowcastingGAN.init_gan_variables

    def capture(self, rng, batch):
        g, d = jax.tree_util.tree_map(np.array, tuple(map(unfreeze, init(self, rng, batch))))
        save_gan_npz(path, g, d)
        raise _Captured

    spec = importlib.util.spec_from_file_location(
        "jax_gan_gate", os.path.join(REPO, "tools", "gan_gate.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dgmr.NowcastingGAN, "init_gan_variables", capture)
        mp.chdir(workdir)
        with pytest.raises(_Captured):
            jax_tool.main(["dgmr"])


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python -m tests.test_torch_dgmr_studies OUT.npz (from the repo root)
    import sys
    import tempfile

    with tempfile.TemporaryDirectory() as work:
        write_jax_init(os.path.abspath(sys.argv[1]), work)
