"""PyTorch port, the rest of the engine: schedules, the batch-size and LR
probes, sweeps, image grids, profiling and the default entry point, against
the JAX package where it has the same function.

Tolerances:
- schedules: atol 1e-7 at lr 1e-2 (optax evaluates in float32, the port in
  float64: a few f32 roundings of values below 1e-2).
- ``tune``: the LR of each step to rtol 1e-6 (the same exponential in f32
  and f64); the losses to rtol 1e-4 (f32 forwards of the same weights, in
  another order, after up to 8 SGD steps at rates to 0.18).
- TPE, ``sample_params``, ``make_image_grid``: equal (the same numpy code
  on the same generator).
"""

import json
import math

import jax
import numpy as np
import optax
import pytest
import torch

from satflow_tpu.core import registry as jax_registry
from satflow_tpu.data.datamodule import SatFlowDataModule as JaxDataModule
from satflow_tpu.experiments import sweep as jax_sweep
from satflow_tpu.train import schedules as jax_schedules
from satflow_tpu.train import steps as jax_steps
from satflow_tpu.train.engine import Trainer as JaxTrainer
from satflow_tpu.train.visualize import make_image_grid as jax_make_image_grid
import satflow_tpu.models  # noqa: F401 - populate the JAX registry
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.core import registry
from satflow_tpu_torch.data.datamodule import SatFlowDataModule
from satflow_tpu_torch.experiments import sweep
from satflow_tpu_torch.interop.jax_weights import params_from_flax
from satflow_tpu_torch.train import Trainer
from satflow_tpu_torch.train import engine as engine_mod
from satflow_tpu_torch.train import profiling, schedules
from satflow_tpu_torch.train.loggers import BaseLogger
from satflow_tpu_torch.train.visualize import VisualizationCallback, make_image_grid

KW = dict(input_channels=2, out_channels=2, forecast_steps=2, hidden_dim=8)
DM_KW = dict(fake_data=True, num_workers=0, n_train_data=3, n_val_data=1, history_minutes=10,
             forecast_minutes=10, fake_kwargs=dict(batch_size=2, width=16, height=16,
                                                   number_sat_channels=2))
COUNTS = [0, 1, 3, 10, 37, 99, 100, 101, 250, 10_000]


# -- schedules ------------------------------------------------------------------


@pytest.mark.parametrize("name, kwargs", [
    (None, {}), ("constant", {}), ("none", {}),
    ("cosine", dict(total_steps=100)), ("cosine", dict(total_steps=250, eta_min=1e-4)),
    ("warmup_cosine", dict(warmup_steps=10, total_steps=100)),
])
def test_schedules_match_optax(name, kwargs):
    """``make_schedule`` (constant, cosine, warmup_cosine) against the JAX
    package's optax schedules over counts in and past each phase."""
    mine = schedules.make_schedule(name, 1e-2, **kwargs)
    ref = jax_schedules.make_schedule(name, 1e-2, **kwargs)
    np.testing.assert_allclose([mine(c) for c in COUNTS], [float(ref(c)) for c in COUNTS],
                               rtol=0, atol=1e-7)


def test_schedule_factories_and_errors():
    np.testing.assert_allclose([schedules.cosine(0.1, 50)(c) for c in COUNTS],
                               [float(jax_schedules.cosine(0.1, 50)(c)) for c in COUNTS],
                               rtol=0, atol=1e-7)
    assert schedules.constant(3e-4)(12345) == 3e-4
    with pytest.raises(ValueError, match="Unknown schedule"):
        schedules.make_schedule("plateau", 1e-3)
    with pytest.raises(ValueError, match="total_steps"):
        schedules.cosine(1e-3, 0)


def test_scheduled_count_survives_the_state_dict():
    """The schedule's position is part of the optimizer's state_dict: an
    optimizer loaded from it goes on at the next count."""
    sched = schedules.warmup_cosine(1e-2, 3, 10)
    p = torch.nn.Parameter(torch.ones(3))
    opt = schedules.scheduled(torch.optim.Adam([p], lr=1e-2), sched)
    for _ in range(4):
        p.grad = torch.ones(3)
        opt.step()
    q = torch.nn.Parameter(p.detach().clone())
    other = schedules.scheduled(torch.optim.Adam([q], lr=1e-2), sched)
    other.load_state_dict(opt.state_dict())
    q.grad = torch.ones(3)
    other.step()
    assert other.param_groups[0]["lr"] == sched(4)
    assert other.param_groups[0]["schedule_count"] == 5


# -- scale_batch_size and tune ---------------------------------------------------


def _flax_params(seed=0):
    model = jax_registry.create_model("encoderdecoderconvlstm", **KW)
    tree = model.module.init(jax.random.PRNGKey(0), np.zeros((1, 3, 16, 16, 2), np.float32))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: (rng.normal(size=a.shape) * 0.3).astype(np.float32),
                                  tree)


def _port(params):
    model = registry.create_model("encoderdecoderconvlstm", **KW)
    model.module.load_state_dict(params_from_flax(params))
    return model


def _failing_step(error, above):
    """``make_train_step`` whose steps raise ``error`` on batches larger
    than ``above``."""
    real = engine_mod.make_train_step

    def make(model, **kw):
        step = real(model, **kw)

        def train_step(state, batch):
            if batch[0]["sat_data"].shape[0] > above:
                raise error
            return step(state, batch)

        return train_step

    return make


def test_scale_batch_size_backs_off_on_out_of_memory(monkeypatch):
    """Doubling stops at the first ``torch.OutOfMemoryError`` and keeps the
    last size that ran; the model's weights do not move."""
    monkeypatch.setattr(engine_mod, "make_train_step",
                        _failing_step(torch.OutOfMemoryError("CUDA out of memory"), 4))
    model, dm = _port(_flax_params()), SatFlowDataModule(**DM_KW)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert Trainer().scale_batch_size(model, dm, init_val=2, max_trials=5) == 4
    assert dm.batch_size == 4 and dm.fake_kwargs["batch_size"] == 4
    assert next(iter(dm.train_dataloader()))[0]["sat_data"].shape[0] == 4  # the loaders take it
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_scale_batch_size_lets_other_errors_through(monkeypatch):
    """A failure that is not out-of-memory (a kernel that does not build or
    launch) raises instead of shrinking the batch."""
    monkeypatch.setattr(engine_mod, "make_train_step",
                        _failing_step(RuntimeError("kernel failed to launch"), 4))
    with pytest.raises(RuntimeError, match="kernel failed to launch"):
        Trainer().scale_batch_size(_port(_flax_params()), SatFlowDataModule(**DM_KW), max_trials=5)
    monkeypatch.setattr(engine_mod, "make_train_step",
                        _failing_step(torch.OutOfMemoryError("CUDA out of memory"), 0))
    with pytest.raises(RuntimeError, match="even batch 2"):
        Trainer().scale_batch_size(_port(_flax_params()), SatFlowDataModule(**DM_KW))


def test_scale_batch_size_grows_to_the_cap_like_jax():
    """As the JAX ``test_scale_batch_size_grows_and_sets_attr``: 2 -> 4 -> 8,
    capped by ``max_batch_size``, set on the datamodule."""
    jdm = JaxDataModule(**DM_KW)
    jdm.batch_size = 0
    want = JaxTrainer(seed=0).scale_batch_size(
        jax_registry.create_model("encoderdecoderconvlstm", **KW), jdm, init_val=2,
        max_trials=3, max_batch_size=8)
    dm = SatFlowDataModule(**DM_KW)
    got = Trainer().scale_batch_size(_port(_flax_params()), dm, init_val=2, max_trials=3,
                                     max_batch_size=8)
    assert got == want == dm.batch_size == jdm.batch_size == 8


def test_datamodule_batch_size_reaches_the_loaders(caplog):
    """The fake data's batch is ``batch_size``, read and set through the
    property; data read from files keeps the batch its files fix."""
    dm = SatFlowDataModule(**DM_KW)
    assert dm.batch_size == 2
    dm.batch_size = 3
    assert next(iter(dm.train_dataloader()))[0]["sat_data"].shape[0] == 3
    assert DM_KW["fake_kwargs"]["batch_size"] == 2  # the config's dict is not written
    assert SatFlowDataModule(fake_data=True).batch_size == 32  # FakeDataset's default
    files = SatFlowDataModule(data_path="nowhere")
    with caplog.at_level("WARNING"):
        files.batch_size = 8
    assert files.batch_size is None and "fixed by the files" in caplog.text


def test_tune_matches_jax(monkeypatch):
    """The LR range test from the same weights on the same batches: the LR
    of each step equals optax's ``exponential_decay``, the losses agree, and
    so does the suggestion, which becomes ``model.lr``."""
    params = _flax_params()
    jax_losses, losses, lrs = [], [], []
    real_jax = jax_steps.make_train_step

    def jax_make(model):
        step = real_jax(model)

        def recorded(state, batch, rng):
            state, metrics = step(state, batch, rng)
            jax_losses.append(float(metrics["loss"]))
            return state, metrics

        return recorded

    real = engine_mod.make_train_step

    def make(model):
        step = real(model)

        def recorded(state, batch):
            metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            lrs.append(state.optimizer.param_groups[0]["lr"])
            return metrics

        return recorded

    monkeypatch.setattr(jax_steps, "make_train_step", jax_make)
    monkeypatch.setattr(engine_mod, "make_train_step", make)
    jmodel = jax_registry.create_model("encoderdecoderconvlstm", **KW)
    jmodel.init_variables = lambda rng, batch: params
    want = JaxTrainer(seed=0).tune(jmodel, JaxDataModule(**DM_KW), num_steps=8)
    model = _port(params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = Trainer().tune(model, SatFlowDataModule(**DM_KW), num_steps=8)
    schedule = optax.exponential_decay(1e-6, transition_steps=8, decay_rate=1e6)
    np.testing.assert_allclose(lrs, [float(schedule(i)) for i in range(8)], rtol=1e-6)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    assert got == pytest.approx(want, rel=1e-6) and model.lr == got and math.isfinite(got)
    for k, v in model.state_dict().items():  # the probe trained a copy
        assert torch.equal(v, before[k]), k


def test_train_entry_point_runs_tune(monkeypatch):
    """``trainer.auto_lr_find`` / ``auto_scale_batch_size`` call
    ``Trainer.tune`` before fit, as the JAX ``experiments.train`` does."""
    from satflow_tpu_torch.experiments.train import train

    calls = []
    monkeypatch.setattr(engine_mod.Trainer, "tune",
                        lambda self, model, dm, **kw: calls.append(kw) or model.lr)
    train({"seed": 0, "datamodule": {"_target_": "satflow_tpu.data.datamodule.SatFlowDataModule",
                                     **DM_KW},
           "model": {"_target_": "satflow_tpu.models.conv_lstm.EncoderDecoderConvLSTM", **KW},
           "trainer": {"fast_dev_run": True, "auto_lr_find": True,
                       "auto_scale_batch_size": True, "device": "cpu"}})
    assert calls == [dict(auto_lr_find=True, auto_scale_batch_size=True)]


def test_train_entry_point_defaults_to_the_card(monkeypatch):
    """A config that names no ``trainer.device`` trains on the card: without
    one the entry point raises and does not fall back to the CPU."""
    from satflow_tpu_torch.experiments.train import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        train({"seed": 0,
               "datamodule": {"_target_": "satflow_tpu.data.datamodule.SatFlowDataModule",
                              **DM_KW},
               "model": {"_target_": "satflow_tpu.models.conv_lstm.EncoderDecoderConvLSTM",
                         **KW},
               "trainer": {"fast_dev_run": True}})


# -- sweeps ------------------------------------------------------------------------

SPACE = {
    "model.lr": {"type": "loguniform", "low": 1e-5, "high": 1e-1},
    "model.width": {"type": "uniform", "low": -1.0, "high": 1.0},
    "trainer.k": {"type": "int", "low": 1, "high": 8},
    "model.h": {"type": "categorical", "choices": [32, 64, 128]},
    "model.p": {"type": "float", "low": 0.0, "high": 0.5},
}


def _objective(params):
    return ((math.log10(params["model.lr"]) + 3.0) ** 2 + (params["model.width"] - 0.3) ** 2
            + 0.1 * params["trainer.k"] + (params["model.h"] != 64))


@pytest.mark.parametrize("seed, startup", [(0, 3), (1, 5), (7, 2)])
def test_tpe_sampler_matches_jax(seed, startup):
    """The same seed and history give the same suggestions, trial after
    trial (random startup, then l(x)/g(x) over the Parzen mixtures), and
    failed trials (None) are skipped alike."""
    mine = sweep.TPESampler(seed=seed, n_startup_trials=startup)
    ref = jax_sweep.TPESampler(seed=seed, n_startup_trials=startup)
    history = []
    for trial in range(14):
        got, want = mine.suggest(SPACE, history), ref.suggest(SPACE, history)
        assert got == want, trial
        history.append((got, None if trial == 4 else _objective(got)))


def test_sample_params_matches_jax():
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(5):
        assert sweep.sample_params(SPACE, a) == jax_sweep.sample_params(SPACE, b)
    with pytest.raises(ValueError, match="search-space type"):
        sweep.sample_params({"x": {"type": "normal"}}, a)


def test_multirun_runs_the_hparams_search(tmp_path, monkeypatch):
    """``run.main(["--multirun", "hparams_search=convlstm_optuna", ...])``:
    two tiny trials, each trained through the port, best written to
    results.json."""
    from satflow_tpu_torch.run import main

    monkeypatch.chdir(tmp_path)  # main chdirs into the run dir; undone at teardown
    best = main(["--multirun", "hparams_search=convlstm_optuna", "hparams_search.n_trials=2",
                 "model.forecast_steps=2", "trainer.fast_dev_run=true", "trainer.device=cpu",
                 "callbacks=none", f"work_dir={tmp_path / 'runs'}", "print_config=false"])
    results = json.loads(next((tmp_path / "runs").rglob("results.json")).read_text())
    assert len(results["trials"]) == 2 and math.isfinite(best)
    assert best == results["best_value"] == min(t["value"] for t in results["trials"])
    for trial in results["trials"]:
        assert set(trial["params"]) == {"model.lr", "model.hidden_dim"}
        assert trial["params"]["model.hidden_dim"] in (32, 64, 128)


# -- visualisation -------------------------------------------------------------------


@pytest.mark.parametrize("shape, nrow", [((5, 8, 6, 1), 8), ((3, 4, 4, 3), 2), ((9, 7, 5), 4),
                                         ((2, 3, 3, 1), 1)])
def test_make_image_grid_matches_jax(shape, nrow):
    frames = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(make_image_grid(frames, nrow=nrow),
                                  jax_make_image_grid(frames, nrow=nrow))
    flat = np.full(shape, 0.5, np.float32)  # constant frames: no normalisation
    np.testing.assert_array_equal(make_image_grid(flat, nrow=nrow),
                                  jax_make_image_grid(flat, nrow=nrow))


class ImageLogger(BaseLogger):
    def __init__(self):
        self.images = []

    def log_metrics(self, metrics, step):
        pass

    def log_image(self, tag, image, step):
        self.images.append((tag, image.shape, step))


def test_visualization_callback_logs_three_panels():
    lg = ImageLogger()
    model = _port(_flax_params())
    Trainer(max_steps=2, logger=[lg], callbacks=[VisualizationCallback(every_n_steps=2)]).fit(
        model, SatFlowDataModule(**DM_KW))
    assert [(tag, step) for tag, _, step in lg.images] == [
        ("train/input_stack", 2), ("train/target_stack", 2), ("train/generated_stack", 2)]
    assert lg.images[0][1] == (17, 8 * 17, 3)  # 3 history frames in one row of 8


# -- profiling -------------------------------------------------------------------------


def test_op_breakdown_of_a_cpu_forward(tmp_path):
    """A CPU forward's trace gives rows by aten op with host self time."""
    model = _port(_flax_params()).eval()
    x = torch.rand(2, 3, 16, 16, 2)
    with torch.no_grad():
        trace_dir, rows = profiling.profile_fn(lambda: model(x), top_k=5,
                                               out_dir=str(tmp_path / "p"))
    assert (tmp_path / "p" / profiling.TRACE_FILE).exists() and trace_dir == str(tmp_path / "p")
    assert 0 < len(rows) <= 5 and all(r["device"] == "cpu" for r in rows)
    assert all(r["name"].startswith("aten::") and r["op"] == r["name"] for r in rows)
    assert all(r["caller"] == "(none)" or r["caller"].startswith("aten::") for r in rows)
    assert rows == sorted(rows, key=lambda r: -r["us"]) and rows[0]["calls"] >= 1
    assert 0 < sum(r["share"] for r in rows) <= 1 + 1e-9


def test_op_breakdown_names_the_op_behind_each_kernel(tmp_path):
    """A chrome trace with device kernels (written here by hand, in the
    layout ``torch.profiler`` exports on a card): each kernel goes to the
    aten op of its ``External id``, or through its launch's correlation id."""
    def op(name, ext, ts):
        return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": 5,
                "args": {"External id": ext}}

    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::_to_copy", "ts": -1, "dur": 8,
         "args": {"External id": 9}},
        op("aten::copy_", 1, 0), op("aten::mul", 2, 10), op("aten::conv2d", 3, 20),
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 21, "dur": 1,
         "args": {"External id": 3, "correlation": 90}},
        {"ph": "X", "cat": "kernel", "name": "elementwise_kernel", "ts": 30, "dur": 70.0,
         "args": {"External id": 1, "correlation": 70}},
        {"ph": "X", "cat": "kernel", "name": "elementwise_kernel", "ts": 110, "dur": 10.0,
         "args": {"External id": 2, "correlation": 80}},
        {"ph": "X", "cat": "kernel", "name": "elementwise_kernel", "ts": 130, "dur": 30.0,
         "args": {"External id": 1, "correlation": 71}},
        {"ph": "X", "cat": "kernel", "name": "implicit_gemm", "ts": 170, "dur": 40.0,
         "args": {"correlation": 90}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 220, "dur": 50.0,
         "args": {"correlation": 99}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    rows = profiling.op_breakdown(str(path))
    assert [(r["name"], r["op"], r["caller"], r["us"], r["calls"]) for r in rows] == [
        ("elementwise_kernel", "aten::copy_", "aten::_to_copy", 100.0, 2),
        ("Memset", "(none)", "(none)", 50.0, 1),
        ("implicit_gemm", "aten::conv2d", "(none)", 40.0, 1),
        ("elementwise_kernel", "aten::mul", "(none)", 10.0, 1)]
    assert all(r["device"] == "cuda" for r in rows) and rows[0]["share"] == 0.5
    assert profiling.op_breakdown(str(tmp_path), top_k=1) == rows[:1]


def test_trainer_profiler_writes_one_trace(tmp_path):
    """``Trainer(profiler=...)`` traces the fit into ``profile_dir``."""
    trainer = Trainer(max_steps=1, profiler="pytorch", profile_dir=str(tmp_path / "prof"))
    trainer.fit(_port(_flax_params()), SatFlowDataModule(**DM_KW))
    assert trainer.profile_path == str(tmp_path / "prof" / profiling.TRACE_FILE)
    rows = profiling.op_breakdown(trainer.profile_path, top_k=3)
    assert len(rows) == 3 and rows[0]["device"] == "cpu"


# -- the normal entry point ----------------------------------------------------------------


def test_run_with_the_default_callbacks_writes_checkpoints(tmp_path, monkeypatch):
    """``python -m satflow_tpu_torch.run`` with the default ``callbacks``
    group (tiny widths, on the CPU): it trains, tests and leaves
    ``checkpoints/best``, ``checkpoints/last`` and ``artifacts/final``, each
    loadable through ``local:``."""
    from satflow_tpu_torch.run import main

    monkeypatch.chdir(tmp_path)
    result = main(["model.hidden_dim=8", "model.forecast_steps=2", "trainer.max_steps=2",
                   "trainer.device=cpu", f"work_dir={tmp_path / 'runs'}", "print_config=false"])
    assert result is not None and math.isfinite(result)
    (run_dir,) = [p.parent for p in (tmp_path / "runs").rglob("checkpoints")]
    for sub in ("checkpoints/best", "checkpoints/last", "artifacts/final"):
        model = registry.create_model(f"local:{run_dir / sub}")
        assert model.hidden_dim == 8 and model.forecast_steps == 2, sub
    meta = json.loads((run_dir / "checkpoints" / "best" / "hparams.json").read_text())
    assert meta["metrics"]["val/loss"] == pytest.approx(result)
