"""PyTorch port, spatial (H-axis) parallelism of the ConvLSTM rollout:
``parallel/spatial.py`` against the JAX package's ``convlstm_spatial_forward``
and ``ConvLSTMCore.apply`` on the same weights.

The multi-rank results come from one launch of 4 gloo ranks on the CPU
(``tests/_torch_parallel_worker.py``, job "spatial"), made once for the
module: the rollout over a (1, 4) mesh (M = 4) and a (2, 2) mesh (M = 2,
the batch over ``data``), the chunked-remat core, the gradients through the
halo exchange and one Adam step from them, and ``Trainer(spatial="2x2")``.
Each rank returns its block; the blocks are stitched here. The per-block
step against the whole image's, without a process group
(``spatial.WholeHalos``), runs in this process: the CPU mirror of the chip
smoke's check of K1 and K2 on halo-extended blocks.

Tolerances, as the JAX gates ``tests/test_sharding.py:291-371``: the
rollout to atol 2e-5, rtol 1e-4 (float32: the same convs and gates in
another order over 14 recurrent steps); gradients and the updated weights
to 1e-4. The block step against the whole step: 1e-5 (the same f32 conv on
rows in another layout); the Trainer against one process, float64: 1e-9
(its losses, which mse averages in float32: rtol 1e-6).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from satflow_tpu.models.conv_lstm import ConvLSTMCore as JaxCore
from satflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from satflow_tpu.parallel.spatial import convlstm_spatial_forward as jax_spatial_forward
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.core import registry
from satflow_tpu_torch.interop.jax_weights import params_from_flax
from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step
from satflow_tpu_torch.parallel import spatial
from tests._torch_parallel_worker import launch

B, T, H, W, C, HID, F = 2, 3, 32, 16, 4, 8, 4
WORLD = 4


def _random_like(tree, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32), tree)


def _jax_core(**kw):
    return JaxCore(hidden_dim=HID, out_channels=C, forecast_steps=F, cell_impl="fused", **kw)


@pytest.fixture(scope="module")
def ref():
    r = {}
    x = np.random.default_rng(1).random((B, T, H, W, C), dtype=np.float32)
    core = _jax_core()
    v = _random_like(core.init(jax.random.PRNGKey(0), x), 2)
    chunked = _jax_core(remat=True, remat_chunk=2)
    vc = _random_like(chunked.init(jax.random.PRNGKey(0), x), 3)
    r.update(x=x, variables=v, want=np.asarray(core.apply(v, x)),
             want_chunked=np.asarray(chunked.apply(vc, x)))
    for m in (2, 4):
        mesh = jax_make_mesh(axis_shapes=[8 // m, m])
        r[f"jax_spatial{m}"] = np.asarray(jax_spatial_forward(v["params"], x, F, mesh,
                                                              axis="model"))

    def loss(p):
        return jnp.sum((core.apply({"params": p}, x) - 0.5) ** 2)

    value, grads = jax.value_and_grad(loss)(v["params"])
    tx = optax.adam(1e-3)
    updates, _ = tx.update(grads, tx.init(v["params"]), v["params"])
    r["jax_loss"] = float(value)
    r["jax_grads"] = {k: t.numpy() for k, t in params_from_flax({"params": grads}).items()}
    r["jax_adam"] = {k: t.numpy() for k, t in params_from_flax(
        {"params": optax.apply_updates(v["params"], updates)}).items()}

    # the Trainer in one process: 2 steps and a validation, float64 compute
    from satflow_tpu_torch.data.datamodule import SatFlowDataModule
    from satflow_tpu_torch.train import Trainer

    kw = dict(input_channels=4, out_channels=1, forecast_steps=2, hidden_dim=8, remat=False)
    model = registry.create_model("encoderdecoderconvlstm", dtype=torch.float64,
                                  generator=torch.Generator().manual_seed(5), **kw)
    fit_init = {k: t.numpy().copy() for k, t in model.module.state_dict().items()}
    model.double()
    trainer = Trainer(max_steps=2, log_every_n_steps=1, device="cpu", seed=0)
    trainer.fit(model, SatFlowDataModule(
        fake_data=True, num_workers=0, n_train_data=2, n_val_data=1, history_minutes=10,
        forecast_minutes=10, fake_kwargs=dict(batch_size=4, width=16, height=16,
                                              number_sat_channels=4)))
    r["fit_losses"] = [e["train/loss"] for e in trainer.history.history if "train/loss" in e]
    r["fit_val_loss"] = trainer.callback_metrics["val/loss"]
    r["fit_params"] = {n: p.detach().numpy() for n, p in model.module.named_parameters()}
    r["inputs"] = {"core_x": x,
                   **{f"core/{k}": t.numpy() for k, t in params_from_flax(v).items()},
                   **{f"chunk/{k}": t.numpy() for k, t in params_from_flax(vc).items()},
                   **{f"fit/{k}": t for k, t in fit_init.items()}}
    return r


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    return launch("spatial", WORLD, tmp_path_factory.mktemp("spatial"), ref["inputs"])


def _stitch(ranks, key):
    """The global forecast from every rank's block: rows over ``model``, the
    batch over ``data``."""
    d = 1 + max(int(out[f"{key}_coords"][0]) for out in ranks)
    m = 1 + max(int(out[f"{key}_coords"][1]) for out in ranks)
    rows = [[None] * m for _ in range(d)]
    for out in ranks:
        i, j = (int(c) for c in out[f"{key}_coords"])
        rows[i][j] = out[key]
    return np.concatenate([np.concatenate(r, axis=2) for r in rows], axis=0)


def test_ranks_import_no_jax(ranks):
    assert not any(bool(out["imports_jax"]) for out in ranks)


@pytest.mark.parametrize("m", [2, 4])
def test_spatial_rollout_matches_jax(ref, ranks, m):
    """The H-sharded rollout at M = 2 (batch over data, D = 2) and M = 4,
    the blocks stitched: equal to JAX's ``convlstm_spatial_forward`` and to
    the unsharded ``ConvLSTMCore.apply``."""
    got = _stitch(ranks, "sp_1x4" if m == 4 else "sp_2x2")
    assert got.shape == ref["want"].shape
    np.testing.assert_allclose(got, ref[f"jax_spatial{m}"], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, ref["want"], atol=2e-5, rtol=1e-4)


def test_spatial_block_shapes(ranks):
    for out in ranks:
        assert out["sp_1x4"].shape == (B, F, H // 4, W, C)
        assert out["sp_2x2"].shape == (B // 2, F, H // 2, W, C)


def test_spatial_rollout_chunked_layout(ref, ranks):
    """The chunked-remat core (``remat_chunk=2``) holds the same fused cells:
    its spatial rollout equals the JAX chunked core."""
    got = np.concatenate([out["sp_chunked"] for out in ranks], axis=2)
    np.testing.assert_allclose(got, ref["want_chunked"], atol=2e-5, rtol=1e-4)


def test_spatial_rollout_rejects_indivisible_h(ranks):
    for out in ranks:
        assert "must divide" in str(out["sp_odd_h"]) and "'model'" in str(out["sp_odd_h"])


def test_spatial_loss_and_gradients_match_jax(ref, ranks):
    """sum((y - 0.5)^2) over the global forecast: the loss and every
    parameter's gradient (the halo exchange's backward sends each halo's
    cotangent back into its rank's edge row) equal jax.grad of the dense
    rollout."""
    for out in ranks:
        np.testing.assert_allclose(float(out["sp_loss"]), ref["jax_loss"], rtol=1e-5)
        for k, want in ref["jax_grads"].items():
            np.testing.assert_allclose(out[f"sp_grad/{k}"], want, atol=1e-4, rtol=1e-4,
                                       err_msg=k)


def test_spatial_adam_step_matches_jax(ref, ranks):
    for out in ranks:
        for k, want in ref["jax_adam"].items():
            np.testing.assert_allclose(out[f"sp_adam/{k}"], want, atol=1e-4, rtol=1e-4,
                                       err_msg=k)


def test_spatial_trainer_fit(ref, ranks):
    """``Trainer(spatial="2x2")`` on 4 ranks: the loader gives each rank its
    (B/2, T, H/2, W, C) block, the mesh is unbound after ``fit``, and the
    losses and the weights equal the same fit in one process on the whole
    batch (float64 compute)."""
    for out in ranks:
        assert out["fit_mesh_restored"]
        assert list(out["fit_block_shape"]) == [2, 3, 8, 16, 4]
        np.testing.assert_allclose(out["fit_losses"], ref["fit_losses"], rtol=1e-6)
        np.testing.assert_allclose(out["fit_val_loss"], ref["fit_val_loss"], rtol=1e-6)
        for k, want in ref["fit_params"].items():
            np.testing.assert_allclose(out[f"fit/{k}"], want, rtol=0,
                                       atol=1e-9 * np.abs(want).max(), err_msg=k)


# -- in this process -------------------------------------------------------------------


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("cx", [4, 8])
def test_block_step_matches_whole_step(m, cx):
    """``_cell_step`` on each of M blocks, its halos cut from the whole
    tensors, stitched: the fused step on the whole image, forward and one
    backward (the CPU mirror of the chip smoke's K1 / K2 check)."""
    rng = np.random.default_rng(cx + m)
    x, h, c = (torch.from_numpy(rng.normal(size=(2, 16, 8, ch)).astype(np.float32))
               .requires_grad_() for ch in (cx, 8, 8))
    cell = registry.create_model("encoderdecoderconvlstm", input_channels=cx, hidden_dim=8,
                                 forecast_steps=1).module.encoder["encoder_1"]
    dh, dc = (torch.from_numpy(rng.normal(size=(2, 16, 8, 8)).astype(np.float32))
              for _ in range(2))
    want = fused_convlstm_step(x, h, c, cell.x_gates_kernel, cell.h_gates_kernel, cell.bias)
    want_grads = torch.autograd.grad(want, (x, h, c, cell.x_gates_kernel), (dh, dc))
    hl = 16 // m
    blocks = [spatial._cell_step(x[:, i * hl:(i + 1) * hl], h[:, i * hl:(i + 1) * hl],
                                 c[:, i * hl:(i + 1) * hl], cell,
                                 spatial.WholeHalos([x, h], i, m), torch.float32)
              for i in range(m)]
    got = [torch.cat([b[k] for b in blocks], dim=1) for k in (0, 1)]
    got_grads = torch.autograd.grad(got, (x, h, c, cell.x_gates_kernel), (dh, dc))
    for g, w in zip(got + list(got_grads), list(want) + list(want_grads)):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), atol=1e-5, rtol=1e-5)


def test_spatial_needs_fused_cells():
    """``enable_spatial`` and the rollout refuse another cell formulation,
    naming ``cell_impl='fused'``; the Trainer's DxM parse keeps its JAX
    message."""
    from satflow_tpu_torch.train import Trainer

    model = registry.create_model("encoderdecoderconvlstm", cell_impl="concat")
    with pytest.raises(ValueError, match="cell_impl='fused'"):
        model.enable_spatial(mesh=None)
    with pytest.raises(ValueError, match="cell_impl='fused'"):
        spatial.spatial_rollout(model.module, torch.zeros(1, 1, 4, 4, 12), 1,
                                spatial.WholeHalos([], 0, 1))
    with pytest.raises(ValueError, match="expected 'DxM'"):
        Trainer(spatial="2by4", device="cpu")._bind_spatial_mesh()
    fused = registry.create_model("encoderdecoderconvlstm")
    fused.enable_spatial(mesh="a mesh", axis="model")
    assert fused.spatial_mesh == "a mesh"


def test_spatial_trainer_builds_without_jax():
    """A process that builds a spatial Trainer and imports the parallel
    package imports nothing of jax or the JAX package."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import satflow_tpu_torch.parallel, satflow_tpu_torch.parallel.spatial\n"
            "import satflow_tpu_torch.parallel.zero, satflow_tpu_torch.parallel.distributed\n"
            "from satflow_tpu_torch.train import Trainer\n"
            "Trainer(spatial='2x4', zero_sharding=True, device='cpu')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'satflow_tpu'))\n"
            "assert not bad, bad\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=repo, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
