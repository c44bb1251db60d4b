"""PyTorch port, the parallel paths: process-group start-up, the mesh and
batch placement, data parallelism (global gradients and BatchNorm
statistics), ZeRO and FSDP sharding, the GAN round and the Trainer across
ranks, and mesh serving, against the JAX package and against the port in
one process.

The multi-rank results come from one launch of 2 gloo ranks on the CPU
(``tests/_torch_parallel_worker.py``, job "dp"), made once for the module:
each rank joins through a ``file://`` store under ``tmp_path``, reads the
global batches and weights this module wrote, and saves what it computed;
the cases below read it. The ranks import no jax; JAX runs here only.

Tolerances:
- against JAX (float32): the loss, frame losses and grad_norm to rtol 1e-5
  (means over ~10^4 elements summed in another order, here split over two
  ranks too); the weights after 1-3 Adam steps to atol 1e-5 (an update is
  at most lr = 1e-3 an element and agrees to ~1e-7 where |g| is not near
  Adam's eps); BatchNorm's running statistics to 1e-4 x max|ref|, as the
  JAX gate ``tests/test_sharding.py::test_sharded_batch_stats_match_global``.
- against the port in one process, in float64 (fcn's gradients, the
  CloudGAN round, the Trainer fit's weights; its losses, which the mse
  criterion averages in float32, to rtol 1e-6): 1e-9 relative (the round's state: 1e-9
  of max(1, max|param|), since a bias before a BatchNorm moves by rounding
  noise); the two differ only in the order of the sums over the ranks.
- ZeRO against the plain optimizer, the same arithmetic on each
  parameter: 1e-7 (a resumed step: bit for bit).
"""

import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from satflow_tpu.core import registry as jax_registry
from satflow_tpu.train.state import TrainState as JaxTrainState
from satflow_tpu.train.steps import make_train_step as jax_make_train_step
import satflow_tpu.models  # noqa: F401 - populate the JAX registry
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.core import registry
from satflow_tpu_torch.interop.jax_weights import flax_tree_state_dict, params_from_flax
from tests._torch_parallel_worker import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, HW, C, F = 8, 3, 8, 4, 2
KW = dict(input_channels=C, out_channels=C, forecast_steps=F, hidden_dim=8, remat=False)
WORLD = 2


def _random_like(tree, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32), tree)


def _batch(seed, b=B, t=T, hw=HW, c=C, f=F):
    rng = np.random.default_rng(seed)
    return (rng.random((b, t, hw, hw, c), dtype=np.float32),
            rng.random((b, f, hw, hw, c), dtype=np.float32))


def _fcn_backbones():
    """FCN on a ResNet of stages (1, 1, 1, 1) and width 4 in both packages,
    as tests/test_torch_zoo.py builds it."""
    import satflow_tpu.models.segmentation as jax_seg
    from satflow_tpu.nn.resnet import ResNetBackbone as JaxResNetBackbone
    import satflow_tpu_torch.models.segmentation as seg
    from satflow_tpu_torch.nn.resnet import ResNetBackbone

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_seg, "ResNetBackbone", lambda stages, **kw: JaxResNetBackbone(
        (1, 1, 1, 1), width=4, **kw))
    mp.setattr(seg, "ResNetBackbone", lambda stages, **kw: ResNetBackbone(
        (1, 1, 1, 1), width=4, **kw))
    return mp


def _cloudgan():
    return registry.create_model("cloudgan", forecast_steps=2, input_channels=2,
                                 channels_per_timestep=2, num_filters=4, features_start=4,
                                 unet_depth=2)


@pytest.fixture(scope="module")
def ref():
    """Everything the ranks read, and the references computed here."""
    r = {}
    jmodel = jax_registry.create_model("encoderdecoderconvlstm", **KW)
    variables = _random_like(jmodel.module.init(jax.random.PRNGKey(0),
                                                np.zeros((1, T, HW, HW, C), np.float32)), 0)
    r["variables"] = variables
    inputs = {f"cl/{k}": v.numpy() for k, v in params_from_flax(variables).items()}
    jstate = JaxTrainState.create(variables["params"], {}, jmodel.make_optimizer())
    step = jax_make_train_step(jmodel)
    for i, name in enumerate(("cl", "cl2", "cl3")):
        inputs[f"{name}_x"], inputs[f"{name}_y"] = _batch(10 + i)
        jstate, metrics = step(jstate, _batch(10 + i), jax.random.PRNGKey(0))
        r[f"jax_params{i + 1}"] = {k: v.numpy() for k, v in params_from_flax(
            {"params": jstate.params}).items()}
        r[f"jax_metrics{i + 1}"] = {k: np.asarray(v) for k, v in metrics.items()}
    rng = np.random.default_rng(3)
    inputs["mesh_x"] = rng.random((4, 2, 8, 6, 3), dtype=np.float32)
    inputs["mesh_nwp"] = rng.random((4, 10, 2, 2, 2), dtype=np.float32)
    for k, shape in (("lamb_w0", (5, 6)), ("lamb_b0", (5,)), ("lamb_w1", (3, 5)),
                     ("lamb_b1", (3,)), ("lamb_x", (3, 4, 6))):
        inputs[k] = rng.normal(size=shape).astype(np.float32)

    # fcn: JAX's global-batch statistics and the port's float64 gradients in
    # one process, on the same weights
    mp = _fcn_backbones()
    try:
        fx, fy = _batch(20, b=4, t=2, hw=32, c=3)
        inputs["fcn_x"], inputs["fcn_y"] = fx, fy
        jfcn = jax_registry.create_model("fcn", input_channels=3, forecast_steps=2)
        fvars = _random_like(jax.eval_shape(jfcn.init_variables, jax.random.PRNGKey(0),
                                            (fx, fy)), 21, scale=0.2)
        fvars = {**fvars, "batch_stats": jax.tree_util.tree_map(
            lambda a: np.abs(a) + 0.5, fvars["batch_stats"])}
        fcn = registry.create_model("fcn", input_channels=3, forecast_steps=2)
        fcn.module.load_state_dict(fcn.state_dict_from_flax(fvars))
        inputs.update({f"fcn/{k}": v.numpy() for k, v in fcn.module.state_dict().items()})
        xs, _ = jfcn.prepare_batch((fx, fy))
        _, new_state = jax.jit(functools.partial(jfcn.module.apply, train=True,
                                                 mutable=["batch_stats"]))(fvars, xs)
        r["jax_bn_stats"] = {k: v.numpy() for k, v in flax_tree_state_dict(
            {"params": {}, **new_state}).items()}
        fcn = fcn.double().train()
        loss, _ = fcn.loss(tuple(torch.from_numpy(a).double() for a in (fx, fy)))
        loss.backward()
        r["fcn_grads"] = {n: p.grad.numpy() for n, p in fcn.module.named_parameters()}
    finally:
        mp.undo()

    # CloudGAN: one round in one process on the global batch, float64
    from satflow_tpu_torch.data.fake import AdvectionDataset
    from satflow_tpu_torch.train.state import GANTrainState
    from satflow_tpu_torch.train.steps import make_gan_train_step

    gx, gy = AdvectionDataset(batch_size=8, width=16, height=16, number_sat_channels=2,
                              history_minutes=15, forecast_minutes=10, length=1, seed=0)[0]
    inputs["gan_x"], inputs["gan_y"] = gx["sat_data"], gy["sat_data"]
    torch.manual_seed(0)
    gan = _cloudgan()
    gan.materialize((torch.from_numpy(gx["sat_data"][:1]), torch.from_numpy(gy["sat_data"][:1])))
    inputs.update({f"gan/{k}": v.numpy() for k, v in gan.state_dict().items()})
    gan.double()
    state = GANTrainState.create(gan, *gan.make_optimizers(), torch.Generator())
    metrics = make_gan_train_step(gan)(state, tuple(
        torch.from_numpy(a).double() for a in (gx["sat_data"], gy["sat_data"])))
    r["gan_metrics"] = {k: v.numpy() for k, v in metrics.items()}
    r["gan_state"] = {k: v.numpy() for k, v in gan.state_dict().items()}

    # the Trainer in one process: 2 steps and a validation, float64 compute
    from satflow_tpu_torch.data.datamodule import SatFlowDataModule
    from satflow_tpu_torch.train import Trainer

    model = registry.create_model("encoderdecoderconvlstm", dtype=torch.float64, **KW)
    model.module.load_state_dict(params_from_flax(variables))
    model.double()
    trainer = Trainer(max_steps=2, log_every_n_steps=1, device="cpu", seed=0)
    trainer.fit(model, SatFlowDataModule(
        fake_data=True, num_workers=0, n_train_data=2, n_val_data=1, history_minutes=10,
        forecast_minutes=10, fake_kwargs=dict(batch_size=4, width=16, height=16,
                                              number_sat_channels=4)))
    r["fit_losses"] = [e["train/loss"] for e in trainer.history.history if "train/loss" in e]
    r["fit_val_loss"] = trainer.callback_metrics["val/loss"]
    r["fit_params"] = {n: p.detach().numpy() for n, p in model.module.named_parameters()}
    r["inputs"] = inputs
    return r


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    return launch("dp", WORLD, tmp_path_factory.mktemp("dp"), ref["inputs"])


def _params(out, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in out.items() if k.startswith(prefix + "/")}


def _same_on_every_rank(ranks, prefix):
    for out in ranks[1:]:
        for k, v in _params(out, prefix).items():
            np.testing.assert_array_equal(v, ranks[0][f"{prefix}/{k}"], err_msg=k)


def _close(got, want, rel, what=""):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


# -- the mesh and batch placement (tests/test_sharding.py:21-32, :264-288) --------------


def test_ranks_import_no_jax(ranks):
    assert not any(bool(out["imports_jax"]) for out in ranks)


def test_mesh_has_every_rank_on_data(ranks):
    for out in ranks:
        assert list(out["mesh_shape"]) == [WORLD, 1]
        assert list(out["mesh_names"]) == ["data", "model"]


@pytest.mark.parametrize("rank", range(WORLD))
def test_shard_batch_places_on_data_axis(ref, ranks, rank):
    """Rank r holds rows [r B/D, (r+1) B/D) of every batch leaf, the DTensor
    block of ``batch_sharding``; a non-array leaf passes through, an
    indivisible batch dim stays whole."""
    out, x, nwp = ranks[rank], ref["inputs"]["mesh_x"], ref["inputs"]["mesh_nwp"]
    n = x.shape[0] // WORLD
    np.testing.assert_array_equal(out["mesh_block"], x[rank * n:(rank + 1) * n])
    np.testing.assert_array_equal(out["mesh_nwp_block"], nwp[rank * n:(rank + 1) * n])
    assert out["mesh_passthrough"] and out["mesh_dtensor_equal"] and out["mesh_replicated_equal"]
    assert list(out["mesh_odd_batch"]) == [3, *x.shape[1:]]


@pytest.mark.parametrize("rank", range(WORLD))
def test_spatial_shard_batch_places_h_on_model_axis(ref, ranks, rank):
    """Inside a spatial mesh_scope over a (1, 2) mesh, image leaves (and bare
    arrays) are cut on H over ``model``, the NWP leaf is not; an H that does
    not divide raises (the rollout would read a whole image as a block);
    outside the scope the same mesh gives the plain placement."""
    out, x, nwp = ranks[rank], ref["inputs"]["mesh_x"], ref["inputs"]["mesh_nwp"]
    h = x.shape[2] // WORLD
    np.testing.assert_array_equal(out["mesh_spatial_block"], x[:, :, rank * h:(rank + 1) * h])
    np.testing.assert_array_equal(out["mesh_spatial_bare"], x[:, :, rank * h:(rank + 1) * h])
    np.testing.assert_array_equal(out["mesh_spatial_nwp"], nwp)
    assert "must divide" in str(out["mesh_odd_h_raises"])
    assert out["mesh_scope_restored"]
    np.testing.assert_array_equal(out["mesh_outside_scope"], x)  # data axis of size 1


def test_make_mesh_needs_a_group_and_covers_the_world():
    from satflow_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()


# -- data parallelism (tests/test_sharding.py:150-176) -----------------------------------


@pytest.mark.parametrize("rank", range(WORLD))
def test_dp_step_matches_jax_single_device(ref, ranks, rank):
    """One train step on 2 ranks, each on its half of the batch, against the
    JAX step on one device and the whole batch: the same loss, metrics and
    updated weights on every rank."""
    out, jm = ranks[rank], ref["jax_metrics1"]
    for k in ("loss", "grad_norm", "frame_loss"):
        np.testing.assert_allclose(out[f"dp_{k}"], jm[k], rtol=1e-5, err_msg=k)
    assert out["dp_finite"]
    for k, v in _params(out, "dp").items():
        np.testing.assert_allclose(v, ref["jax_params1"][k], rtol=0, atol=1e-5, err_msg=k)


def test_dp_ranks_stay_in_sync(ranks):
    _same_on_every_rank(ranks, "dp")
    _same_on_every_rank(ranks, "fit")


def test_dp_trainer_fit_matches_one_process(ref, ranks):
    """Trainer.fit on 2 ranks (the data module cuts each rank's block of the
    fake batches) against the same fit in one process: losses, the
    validation loss and the weights, float64."""
    for out in ranks:
        assert list(out["fit_block_shape"]) == [2, T, 16, 16, C]
        # the mse criterion takes its mean in float32, on each rank's half here
        np.testing.assert_allclose(out["fit_losses"], ref["fit_losses"], rtol=1e-6)
        np.testing.assert_allclose(out["fit_val_loss"], ref["fit_val_loss"], rtol=1e-6)
        for k, v in _params(out, "fit").items():
            _close(v, ref["fit_params"][k], 1e-9, k)


# -- BatchNorm (tests/test_sharding.py:114-147) ------------------------------------------


def test_sharded_batch_stats_match_global(ref, ranks):
    """fcn's train-mode BatchNorm statistics on 2 ranks, each on half the
    batch, equal JAX's on the whole batch: the statistics are global."""
    want = ref["jax_bn_stats"]
    for out in ranks:
        got = _params(out, "bn_stats")
        assert set(got) == set(want) and len(got) > 0
        for k, v in want.items():
            _close(got[k], v, 1e-4, k)


def test_sharded_batchnorm_gradients_match_one_process(ref, ranks):
    """The gradients through the global statistics (their all-reduces'
    backward), averaged over the ranks, equal the one-process gradients on
    the whole batch, float64."""
    for out in ranks:
        got = _params(out, "bn_grad")
        assert set(got) == set(ref["fcn_grads"])
        for k, v in ref["fcn_grads"].items():
            _close(got[k], v, 1e-9, k)


# -- ZeRO (tests/test_sharding.py:59-75) --------------------------------------------------


@pytest.mark.parametrize("steps", [2, 3])
def test_zero_sharded_steps_match_jax(ref, ranks, steps):
    """ZeroRedundancyOptimizer steps on 2 ranks: each rank holds the moments
    of its share of the parameters only, and the weights after 2 and 3 steps
    equal JAX's single-device steps."""
    for out in ranks:
        assert 0 < int(out["zero_local_moments"]) < int(out["zero_all_params"])
        for k, v in _params(out, f"zero{steps}").items():
            np.testing.assert_allclose(v, ref[f"jax_params{steps}"][k], rtol=0, atol=1e-5,
                                       err_msg=k)
    assert sum(int(out["zero_local_moments"]) for out in ranks) == int(ranks[0]["zero_all_params"])


def test_zero_checkpoint_resumes(ranks):
    """The ZeRO checkpoint (moments gathered to rank 0) resumes into a plain
    optimizer with the same moments, and into a ZeRO one whose next step is
    the uninterrupted run's, bit for bit."""
    out0 = ranks[0]
    for out in ranks:
        assert int(out["resumed_step"]) == 2 and out["resumed_zero_is_zero"]
        for k, v in _params(out, "resumed3").items():
            np.testing.assert_array_equal(v, out[f"zero3/{k}"], err_msg=k)
        for k, v in _params(out, "resumed_plain_m").items():
            np.testing.assert_array_equal(v, out0[f"resumed_zero_m/{k}"], err_msg=k)
    assert "resumed_zero_m/0" not in ranks[1]


def test_zero_lamb_under_a_schedule_matches_plain(ranks):
    """LAMB rebuilt from its class under ZeRO, its warmup_cosine hook moved
    to the wrapper: 3 steps equal the plain optimizer's."""
    for out in ranks:
        assert float(out["lamb_zero_lr"]) == float(out["lamb_plain_lr"]) != 1e-2
        for k, v in _params(out, "lamb_zero").items():
            np.testing.assert_allclose(v, out[f"lamb_plain/{k}"], rtol=0, atol=1e-7, err_msg=k)


def test_zero_sharded_fit(ranks):
    """Trainer(zero_sharding=True) on 2 ranks: the optimizer is ZeRO and it
    trains."""
    for out in ranks:
        assert out["zero_fit_is_zero"] and np.isfinite(out["zero_fit_loss"])


@pytest.mark.parametrize("steps", [1, 2])
def test_fsdp_shard_params_steps_match_jax(ref, ranks, steps):
    """``shard_params=True`` (FSDP2): each rank holds part of the parameters,
    and one and two steps equal JAX's."""
    total = sum(v.size for v in ref["jax_params1"].values())
    for out in ranks:
        assert int(out["fsdp_local_numel"]) < total
        np.testing.assert_allclose(out["fsdp_loss"], ref["jax_metrics1"]["loss"], rtol=1e-5)
        for k, v in _params(out, "fsdp" if steps == 1 else "fsdp2").items():
            np.testing.assert_allclose(v, ref[f"jax_params{steps}"][k], rtol=0, atol=1e-5,
                                       err_msg=k)


def test_fsdp_checkpoint_resumes(ranks):
    """The FSDP checkpoint holds full tensors: it loads into a plain state
    (the weights after the step) and into an FSDP state whose next step is
    the uninterrupted run's."""
    for out in ranks:
        for k, v in _params(out, "fsdp_resumed_plain").items():
            np.testing.assert_array_equal(v, out[f"fsdp/{k}"], err_msg=k)
        for k, v in _params(out, "fsdp_resumed2").items():
            np.testing.assert_array_equal(v, out[f"fsdp2/{k}"], err_msg=k)


# -- the GAN round (tests/test_sharding.py:78-111) ---------------------------------------


@pytest.mark.parametrize("variant", ["gan", "gan_zero"])
def test_gan_round_on_two_ranks_matches_one_process(ref, ranks, variant):
    """One CloudGAN round (a discriminator and a generator update, BatchNorm
    in both networks) on 2 ranks, plain and under ZeRO (both optimizers),
    against the round in one process on the whole batch, float64."""
    for out in ranks:
        np.testing.assert_allclose(out[f"{variant}_d_loss"], ref["gan_metrics"]["d_loss"],
                                   rtol=1e-9)
        np.testing.assert_allclose(out[f"{variant}_g_loss"], ref["gan_metrics"]["g_loss"],
                                   rtol=1e-9)
        got = _params(out, variant)
        assert set(got) == set(ref["gan_state"])
        for k, v in ref["gan_state"].items():
            # a bias before a BatchNorm has a zero gradient up to rounding: 1e-9
            # of a weight's scale, not of its own
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-9 * max(np.abs(v).max(), 1),
                                       err_msg=k)


# -- process-group start-up (tests/test_sharding.py:199-260) -------------------------------


@pytest.fixture
def dist_module(monkeypatch):
    import torch.distributed as tdist

    import satflow_tpu_torch.parallel.distributed as pdist

    monkeypatch.setattr(pdist, "_INITIALIZED", False)
    calls = []
    monkeypatch.setattr(tdist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(tdist, "get_rank", lambda group=None: calls[-1]["rank"] if calls and
                        "rank" in calls[-1] else 0)
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    yield pdist, calls, monkeypatch
    from satflow_tpu_torch.core.utils import set_logging_process_index

    set_logging_process_index(0)


def test_distributed_noop_on_single_host(dist_module):
    pdist, calls, _ = dist_module
    assert pdist.maybe_initialize_distributed(backend="cpu") is False
    assert calls == []


def test_distributed_explicit_triplet(dist_module):
    pdist, calls, monkeypatch = dist_module
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 4)
    assert pdist.maybe_initialize_distributed("10.0.0.1:1234", 4, 2, backend="cpu") is True
    assert calls == [{"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                      "world_size": 4, "rank": 2}]
    # a second call reports the group and makes none
    assert pdist.maybe_initialize_distributed() is True
    assert len(calls) == 1
    from satflow_tpu_torch.core import utils

    assert utils._PROCESS_INDEX == 2


def test_distributed_env_triplet(dist_module):
    pdist, calls, monkeypatch = dist_module
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "host-0:8476")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    assert pdist.maybe_initialize_distributed(backend="cpu") is True
    assert calls == [{"backend": "gloo", "init_method": "tcp://host-0:8476",
                      "world_size": 2, "rank": 1}]


def test_distributed_torchrun_autodetect(dist_module):
    """torchrun's environment takes the place of the TPU pod's: the group
    comes up from ``env://``."""
    pdist, calls, monkeypatch = dist_module
    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", "29500"), ("WORLD_SIZE", "2"),
                 ("RANK", "0")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    assert pdist.maybe_initialize_distributed(backend="cpu") is True
    assert calls == [{"backend": "gloo", "init_method": "env://"}]


def test_distributed_init_failure_is_single_host(dist_module, caplog):
    pdist, _, monkeypatch = dist_module

    def explode(**kw):
        raise RuntimeError("no coordinator")

    monkeypatch.setattr(torch.distributed, "init_process_group", explode)
    assert pdist.maybe_initialize_distributed("x:1", 2, 0, backend="cpu") is False
    assert "FAILED" in caplog.text


def test_distributed_rank_is_required_and_backend_follows_the_device(dist_module):
    """A coordinator and a count without a rank raise; ``cpu`` takes gloo,
    ``cuda`` NCCL, and ``cuda`` without a card raises (no gloo fallback)."""
    pdist, calls, _ = dist_module
    with pytest.raises(ValueError, match="JAX_PROCESS_ID"):
        pdist.maybe_initialize_distributed("x:1", 2, None, backend="cpu")
    assert pdist.backend_for("cpu") == "gloo" and pdist.backend_for("nccl") == "nccl"
    if torch.cuda.is_available():
        assert pdist.backend_for("cuda") == "nccl"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            pdist.maybe_initialize_distributed("x:1", 2, 0)
    assert calls == []


def test_logging_gate_is_rank_zero_and_lazy(caplog):
    from satflow_tpu_torch.core.utils import get_logger, set_logging_process_index

    logger = get_logger("satflow_tpu_torch.test_gate")
    try:
        set_logging_process_index(1)
        logger.warning("from rank 1")
        set_logging_process_index(0)
        logger.warning("from rank 0")
    finally:
        set_logging_process_index(0)
    assert "from rank 0" in caplog.text and "from rank 1" not in caplog.text


# -- mesh serving (tests/test_serve.py:299-315) -------------------------------------------


def test_session_dp_sharded_serving(ref):
    """``mesh=["cpu", "cpu"]``: one replica a device, the padded batch split
    in two; the reply equals the unsharded session's and the JAX session's
    with a mesh; a max_batch the mesh does not divide raises."""
    from satflow_tpu.parallel.mesh import get_mesh
    from satflow_tpu.serve.session import InferenceSession as JaxSession
    from satflow_tpu_torch.serve.session import InferenceSession

    variables = ref["variables"]
    model = registry.create_model("encoderdecoderconvlstm", **KW)
    s1 = InferenceSession(model, max_batch=8, variables=variables, device="cpu")
    s2 = InferenceSession(registry.create_model("encoderdecoderconvlstm", **KW), max_batch=8,
                          variables=variables, mesh=["cpu", "cpu"])
    assert len(s2.replicas) == 2
    x = np.random.default_rng(7).random((3, T, HW, HW, C)).astype(np.float32)
    got = s2.predict(x)
    np.testing.assert_array_equal(got, s1.predict(x))
    jmodel = jax_registry.create_model("encoderdecoderconvlstm", **KW)
    want = JaxSession(jmodel, max_batch=8, variables=variables, mesh=get_mesh()).predict(x)
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(ValueError, match="data axis"):
        InferenceSession(model, max_batch=3, variables=variables, mesh=["cpu", "cpu"])
    with pytest.raises(ValueError, match="int8"):
        InferenceSession(model, variables=variables, mesh=["cpu"], quantize="int8")


# -- the CLI under torchrun ------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("overrides", [["trainer=zero"],
                                       ["trainer=spatial", "trainer.spatial=1x2"]],
                         ids=["zero", "spatial"])
def test_cli_under_torchrun(tmp_path, overrides):
    """``python -m satflow_tpu_torch.run`` under ``torch.distributed.run
    --nproc-per-node 2`` on the CPU: the process group from torchrun's
    environment, the shipped trainer configs, checkpoints and logs from rank
    0 only."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "satflow_tpu_torch.run", *overrides, "datamodule=fake", "callbacks=default",
           "model.hidden_dim=8", "model.forecast_steps=2", "trainer.max_steps=2",
           "trainer.max_epochs=1", "trainer.precision=32", "trainer.device=cpu",
           "datamodule.fake_kwargs.batch_size=4", "datamodule.fake_kwargs.width=16",
           "datamodule.fake_kwargs.height=16", "datamodule.num_workers=0",
           f"work_dir={tmp_path / 'runs'}", "print_config=false"]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert len(list((tmp_path / "runs").rglob("metrics.csv"))) == 1
    assert len(list((tmp_path / "runs").rglob("state.pt"))) >= 1
