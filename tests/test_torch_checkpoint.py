"""PyTorch port, checkpoints: save, resume, the ``local:`` / ``torch:`` /
``hf_hub:`` model sources and preemption, against the JAX package.

Weights come from numpy seeds in the flax layout; the JAX Trainer starts
from them through its model's ``init_variables`` (patched on the instance),
the port's through ``params_from_flax``. Both train on the same fake
datamodule. On the CPU the JAX model runs its fused cells through the XLA
reference step, the port through the plain versions of K1 and K2.

Tolerances, resume against the JAX package (k + j steps through a
checkpoint):
- Adam's moments: ``exp_avg`` atol 1e-5 x max|mu| over the model (the
  float32 gradient bar of ``tests/test_torch_train.py``; measured 6.4e-7 for
  the ConvLSTM, 9.2e-6 for MetNet); ``exp_avg_sq`` 2e-5 x max|nu|: squares
  double the relative rounding (measured 1.3e-5, 1.2e-5).
- parameters, as ``tests/test_torch_train.py::_assert_updates`` holds one
  update: Adam scales every update to about lr, so an element whose
  gradient lies within rounding of zero (MetNet's key biases and first
  conv bias, whose gradients vanish in exact arithmetic) moves by rounding
  noise scaled up to lr, and is held only to 2 x lr a update. Every other
  element (root-mean-square gradient, sqrt of Adam's nu, above 1e-6) to
  atol 2e-2 x lr; measured 1.8e-3 x lr (ConvLSTM at lr 1e-3) and 1.6e-2 x
  lr (MetNet at lr 1e-4, which keeps its six steps out of the chaotic
  regime a larger rate gives on random weights).
- the step counter and the schedule's count exactly; the learning rate of
  each step to rtol 1e-6 (optax evaluates the schedule in float32).
The port's resumed run against its own uninterrupted run: bit for bit.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch

from satflow_tpu.core import registry as jax_registry
from satflow_tpu.data.datamodule import SatFlowDataModule as JaxDataModule
from satflow_tpu.train.callbacks import ModelCheckpoint as JaxModelCheckpoint
from satflow_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from satflow_tpu.train.engine import Trainer as JaxTrainer
from satflow_tpu.train.state import TrainState as JaxTrainState
import satflow_tpu.models  # noqa: F401 - populate the JAX registry
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.core import registry
from satflow_tpu_torch.data.datamodule import SatFlowDataModule, to_device
from satflow_tpu_torch.interop.jax_weights import metnet_state_dict_from_flax, params_from_flax
from satflow_tpu_torch.serve import InferenceSession
from satflow_tpu_torch.train import Trainer, TrainState
from satflow_tpu_torch.train.callbacks import Callback, ModelArtifactLogger, ModelCheckpoint
from satflow_tpu_torch.train.checkpoint import (
    HPARAMS_FILE,
    load_model_from_checkpoint,
    restore_checkpoint,
    restore_params_into,
    save_checkpoint,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 3  # train batches a epoch: k = j = K steps either side of the checkpoint
CONVLSTM = ("encoderdecoderconvlstm",
            dict(input_channels=2, out_channels=2, forecast_steps=2, hidden_dim=8))
METNET = ("litmetnet", dict(forecast_steps=2, hidden_dim=8, output_channels=2,
                            temporal_dropout=0.0, warmup_steps=4, total_steps=20, lr=1e-4))
DM_KW = {
    "encoderdecoderconvlstm": dict(
        fake_data=True, num_workers=0, n_train_data=K, n_val_data=1, history_minutes=10,
        forecast_minutes=10, fake_kwargs=dict(batch_size=2, width=16, height=16,
                                              number_sat_channels=2)),
    # the fake schema's 12 satellite + 1 topography + 10 NWP channels
    "litmetnet": dict(
        fake_data=True, num_workers=0, n_train_data=K, n_val_data=1, history_minutes=5,
        forecast_minutes=10, fake_kwargs=dict(batch_size=2, width=32, height=32)),
}
X_SHAPE = (2, 3, 16, 16, 2)  # a ConvLSTM input: B, T, H, W, C


def _variables(name, kw, seed=0):
    """numpy-seeded flax variables of the JAX model, at the shapes its own
    init gives on the first fake batch (running variances in [0.5, 1.5])."""
    model = jax_registry.create_model(name, **kw)
    first = next(iter(JaxDataModule(**DM_KW[name]).train_dataloader()))
    tree = jax.tree_util.tree_map(np.asarray, model.init_variables(jax.random.PRNGKey(0), first))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if "var" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 1.5, size=np.shape(a)).astype(np.float32)
        return (rng.normal(size=np.shape(a)) * 0.3).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _to_port(name, tree):
    """flax params (or a same-shaped tree of moments) as the port's names."""
    if name == "litmetnet":
        return metnet_state_dict_from_flax({"params": tree})
    return params_from_flax({"params": tree})


def _port_model(name, kw, variables):
    model = registry.create_model(name, **kw)
    if name == "litmetnet":
        model.module.load_state_dict(metnet_state_dict_from_flax(variables))
    else:
        model.module.load_state_dict(params_from_flax(variables))
    return model


def _jax_model(name, kw, variables):
    model = jax_registry.create_model(name, **kw)
    model.init_variables = lambda rng, batch: variables
    return model


class LrPerStep(Callback):
    """The learning rate each optimizer update ran at (the port's param group)."""

    def __init__(self):
        self.lrs = []

    def on_train_batch_end(self, engine, metrics, step):
        self.lrs.append(engine.state.optimizer.param_groups[0]["lr"])


def _adam(opt_state):
    """The ``ScaleByAdamState`` inside an optax state (chains, MultiSteps)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    children = (opt_state if type(opt_state) is tuple
                else [getattr(opt_state, f) for f in getattr(opt_state, "_fields", ())])
    for child in children:
        found = _adam(child)
        if found is not None:
            return found
    return None


@pytest.fixture(scope="module")
def resumed_runs(tmp_path_factory):
    """For each case: the JAX Trainer and the port's each train K steps
    from the same weights, checkpoint through ModelCheckpoint, resume in a
    fresh Trainer and train K more; the port also runs 2K steps straight."""
    runs = {}
    for case, (name, kw), acc in (("convlstm", CONVLSTM, 1), ("convlstm_accumulate", CONVLSTM, 2),
                                  ("metnet", METNET, 1)):
        variables = _variables(name, kw)
        root = tmp_path_factory.mktemp(case)
        fit_kw = dict(accumulate_grad_batches=acc, log_every_n_steps=1)
        jt = JaxTrainer(max_epochs=1, callbacks=[JaxModelCheckpoint(dirpath=str(root / "j"))],
                        seed=0, **fit_kw)
        jt.fit(_jax_model(name, kw, variables), JaxDataModule(**DM_KW[name]))
        jt = JaxTrainer(max_epochs=1, max_steps=2 * K, seed=0,
                        resume_from_checkpoint=str(root / "j" / "last"), **fit_kw)
        jt.fit(_jax_model(name, kw, variables), JaxDataModule(**DM_KW[name]))

        first = Trainer(max_epochs=1, callbacks=[ModelCheckpoint(dirpath=str(root / "p"))],
                        **fit_kw)
        first.fit(_port_model(name, kw, variables), SatFlowDataModule(**DM_KW[name]))
        lrs = LrPerStep()
        pt = Trainer(max_epochs=1, max_steps=2 * K, callbacks=[lrs],
                     resume_from_checkpoint=str(root / "p" / "last"), **fit_kw)
        pt.fit(_port_model(name, kw, variables), SatFlowDataModule(**DM_KW[name]))
        straight = Trainer(max_epochs=2, max_steps=2 * K, **fit_kw)
        straight.fit(_port_model(name, kw, variables), SatFlowDataModule(**DM_KW[name]))
        runs[case] = dict(name=name, kw=kw, acc=acc, jax=jt, port=pt, first=first,
                          straight=straight, lrs=lrs.lrs, root=root)
    return runs


@pytest.mark.parametrize("case", ["convlstm", "convlstm_accumulate", "metnet"])
def test_resume_matches_jax(resumed_runs, case):
    """Parameters, Adam's moments and the step counter after k + j steps
    through a checkpoint, against the JAX Trainer's resume (accumulate:
    ``accumulate_grad_batches=2``, the checkpoint after step 3 holding half
    an accumulation)."""
    run = resumed_runs[case]
    _assert_matches_jax(run["jax"], run["port"], run["name"], updates=2 * K // run["acc"])


def _assert_matches_jax(jt, pt, name, updates):
    """The port's Trainer ``pt`` against the JAX Trainer ``jt`` after 2K steps
    and ``updates`` optimizer updates, to the module docstring's tolerances."""
    assert jt.global_step == pt.global_step == pt.state.step == int(jt.state.step) == 2 * K
    want = _to_port(name, jax.device_get(jt.state.params))
    adam = _adam(jt.state.opt_state)
    assert int(adam.count) == updates
    mu = _to_port(name, jax.device_get(adam.mu))
    nu = _to_port(name, jax.device_get(adam.nu))
    lr = pt.model.lr
    for n, p in pt.model.module.named_parameters():
        diff = np.abs(p.detach().numpy() - want[n].numpy())
        big = np.sqrt(nu[n].numpy()) > 1e-6
        assert np.all(diff[big] <= 2e-2 * lr), (n, diff[big].max() / lr)
        assert np.all(diff <= 2 * updates * lr), n
    mu_max = max(float(m.abs().max()) for m in mu.values())
    nu_max = max(float(v.abs().max()) for v in nu.values())
    names = {id(p): n for n, p in pt.model.module.named_parameters()}
    for p, st in pt.state.optimizer.state.items():
        n = names[id(p)]
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[n].numpy(), rtol=0,
                                   atol=1e-5 * mu_max, err_msg=n)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[n].numpy(), rtol=0,
                                   atol=2e-5 * nu_max, err_msg=n)
        assert int(st["step"]) == updates


@pytest.mark.parametrize("case", ["convlstm", "convlstm_accumulate", "metnet"])
def test_resume_equals_the_uninterrupted_run(resumed_runs, case):
    """The port resumed after K steps equals its own 2K-step run bit for bit:
    weights, buffers, the optimizer's state and the accumulation."""
    run = resumed_runs[case]
    got, want = run["port"].state.state_dict(), run["straight"].state.state_dict()
    assert got["step"] == want["step"] and got["mini_step"] == want["mini_step"]
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(got["optimizer"]["state"][i][k], v), (i, k)
    assert got["optimizer"]["param_groups"] == want["optimizer"]["param_groups"]


def test_metnet_resume_keeps_the_schedule_and_batch_stats(resumed_runs):
    """warmup_cosine goes on from the checkpoint's count: each resumed step
    runs at the schedule of its global step, as optax's restored count gives
    it; the BatchNorm running statistics come back as saved."""
    from satflow_tpu.train.schedules import warmup_cosine as jax_warmup_cosine

    run = resumed_runs["metnet"]
    kw = run["kw"]
    schedule = jax_warmup_cosine(kw["lr"], kw["warmup_steps"], kw["total_steps"])
    np.testing.assert_allclose(run["lrs"], [float(schedule(i)) for i in range(K, 2 * K)],
                               rtol=1e-6)
    assert run["port"].state.optimizer.param_groups[0]["schedule_count"] == 2 * K
    saved = restore_checkpoint(run["root"] / "p" / "last")
    assert saved["step"] == K and saved["optimizer"]["param_groups"][0]["schedule_count"] == K
    first = run["first"].model.state_dict()
    for key in ("module.image_encoder.bn0.mean", "module.image_encoder.bn1.var"):
        assert torch.equal(saved["model"][key], first[key]), key
    fresh = Trainer(max_epochs=0, resume_from_checkpoint=str(run["root"] / "p" / "last"))
    fresh.fit(_port_model("litmetnet", kw, _variables("litmetnet", kw, seed=1)),
              SatFlowDataModule(**DM_KW["litmetnet"]))
    assert fresh.global_step == K
    for key, value in fresh.model.state_dict().items():
        assert torch.equal(value, first[key]), key


def test_hparams_json_matches_jax(tmp_path):
    """The JAX ``save_checkpoint`` and the port's write the same hparams.json."""
    name, kw = CONVLSTM
    variables = _variables(name, kw)
    metrics = {"val/loss": 0.25, "val/frame_0_loss": 0.5}
    jmodel = jax_registry.create_model(name, **kw)
    jstate = JaxTrainState.create(variables["params"], {}, jmodel.make_optimizer())
    jax_save_checkpoint(str(tmp_path / "j"), jstate, jmodel, metrics)
    model = _port_model(name, kw, variables)
    save_checkpoint(str(tmp_path / "p"), TrainState(model, model.make_optimizer()), model,
                    metrics)
    want = json.loads((tmp_path / "j" / HPARAMS_FILE).read_text())
    assert json.loads((tmp_path / "p" / HPARAMS_FILE).read_text()) == want
    assert want["hparams"]["class"] == "EncoderDecoderConvLSTM"


@pytest.mark.parametrize("name, kw", [CONVLSTM, METNET], ids=["convlstm", "metnet"])
def test_local_source_rebuilds_the_model(resumed_runs, name, kw):
    """``create_model("local:<dir>")`` builds the saved configuration with
    the saved weights and buffers (MetNet's lazy input conv takes its width
    from the saved tensor): its forward equals the trained model's."""
    run = resumed_runs["convlstm" if name == CONVLSTM[0] else "metnet"]
    trained = run["first"].model  # K steps, as saved at the epoch's validation
    path = run["root"] / "p" / "best"
    loaded = registry.create_model(f"local:{path}")
    assert type(loaded) is type(trained) and loaded.hparams() == trained.hparams()
    assert loaded.restored_from == str(path)
    loaded_sd, trained_sd = loaded.state_dict(), trained.state_dict()
    assert set(loaded_sd) == set(trained_sd)
    for k, v in trained_sd.items():
        assert torch.equal(loaded_sd[k], v), k
    batch = next(iter(SatFlowDataModule(**DM_KW[name]).train_dataloader()))
    x, _ = loaded.prepare_batch(to_device(batch, torch.device("cpu")))
    with torch.no_grad():
        assert torch.equal(loaded.eval()(x), trained.eval()(x))


@pytest.mark.parametrize("saved, loaded", [(False, True), (True, False)],
                         ids=["scan_to_top", "top_to_scan"])
def test_checkpoint_head_layout_both_ways(tmp_path, saved, loaded):
    """After the JAX ``test_checkpoint_head_layout_adaptation``: a checkpoint
    saved with one ``head_in_scan`` loads into a model with the other (the
    port's parameter names do not depend on it), and its forward equals the
    source model's."""
    name, kw = CONVLSTM
    variables = _variables(name, kw)
    old = _port_model(name, {**kw, "head_in_scan": saved}, variables)
    trainer = Trainer(max_epochs=1, limit_train_batches=1, limit_val_batches=1)
    trainer.fit(old, SatFlowDataModule(**DM_KW[name]))
    save_checkpoint(str(tmp_path / "ck"), trainer.state, old)
    new = registry.create_model(name, **{**kw, "head_in_scan": loaded})
    restore_params_into(new, str(tmp_path / "ck"))
    x = torch.from_numpy(np.random.default_rng(2).random(X_SHAPE, dtype=np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(new.eval()(x).numpy(), old.eval()(x).numpy(), atol=2e-5)
    also = registry.create_model(name, pretrained=True, checkpoint_path=str(tmp_path / "ck"),
                                 **{**kw, "head_in_scan": loaded})
    assert also.restored_from == str(tmp_path / "ck")


def _reference_state_dict(cin, hidden, cout, seed=0):
    """A reference-format EncoderDecoderConvLSTM state dict (reference
    satflow/models/conv_lstm.py naming), numpy-seeded."""
    rng = np.random.default_rng(seed)
    sd = {}
    for cell, c in (("encoder_1", cin), ("encoder_2", hidden), ("decoder_1", hidden),
                    ("decoder_2", hidden)):
        sd[f"model.{cell}_convlstm.conv.weight"] = torch.from_numpy(
            (rng.normal(size=(4 * hidden, c + hidden, 3, 3)) * 0.2).astype(np.float32))
        sd[f"model.{cell}_convlstm.conv.bias"] = torch.from_numpy(
            (rng.normal(size=4 * hidden) * 0.1).astype(np.float32))
    sd["model.decoder_CNN.weight"] = torch.from_numpy(
        (rng.normal(size=(cout, hidden, 1, 3, 3)) * 0.2).astype(np.float32))
    sd["model.decoder_CNN.bias"] = torch.from_numpy(
        (rng.normal(size=cout) * 0.1).astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def lightning_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("lightning") / "ref.ckpt"
    _, kw = CONVLSTM
    torch.save({"state_dict": _reference_state_dict(kw["input_channels"], kw["hidden_dim"],
                                                    kw["out_channels"]),
                "hyper_parameters": dict(kw)}, path)
    return path


@pytest.mark.parametrize("cell_impl", ["fused", "cmajor", "concat", "split", "hybrid"])
def test_torch_source_matches_jax(lightning_ckpt, cell_impl):
    """A reference-format Lightning ``.ckpt`` through ``create_model("torch:…")``
    in both packages: forward outputs agree to 1e-5 (f32)."""
    jmodel = jax_registry.create_model(f"torch:{lightning_ckpt}", cell_impl=cell_impl)
    model = registry.create_model(f"torch:{lightning_ckpt}", cell_impl=cell_impl)
    assert model.cell_impl == cell_impl and model.restored_from == str(lightning_ckpt)
    x = np.random.default_rng(3).random(X_SHAPE, dtype=np.float32)
    want = np.asarray(jmodel.forward(jmodel.restored_variables, jax.numpy.asarray(x)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_torch_source_checks_shapes_and_names(lightning_ckpt):
    """A state dict whose widths do not fit the model raises naming the
    parameter; a model with no converter raises; a user converter is used."""
    from satflow_tpu_torch.interop import lightning
    from satflow_tpu_torch.interop.torch_weights import load_torch_convlstm

    with pytest.raises(ValueError, match="encoder.encoder_1"):
        registry.create_model(f"torch:{lightning_ckpt}", input_channels=3)
    with pytest.raises(NotImplementedError, match="litmetnet"):
        lightning.load_lightning_checkpoint(str(lightning_ckpt), model_name="litmetnet")
    seen = []
    lightning.register_converter("litmetnet")(lambda m, sd: seen.append(len(sd)))
    try:
        model = lightning.load_lightning_checkpoint(str(lightning_ckpt), model_name="litmetnet",
                                                    forecast_steps=3)
    finally:
        lightning._CONVERTERS.pop("litmetnet")
    assert seen == [10] and model.forecast_steps == 3 and model.hidden_dim == 8
    model = registry.create_model("encoderdecoderconvlstm", **CONVLSTM[1])
    out = load_torch_convlstm(model, torch.load(lightning_ckpt, weights_only=True)["state_dict"])
    assert set(out) == set(model.module.state_dict())


def test_hf_hub_source_without_the_network(tmp_path, monkeypatch, lightning_ckpt):
    """``hf_hub:`` takes what ``snapshot_download`` returns (stubbed here: no
    download): a checkpoint directory loads as ``local:``, a directory of a
    Lightning file as ``torch:``."""
    name, kw = CONVLSTM
    model = _port_model(name, kw, _variables(name, kw))
    save_checkpoint(str(tmp_path / "local"), TrainState(model, model.make_optimizer()), model)
    (tmp_path / "lightning").mkdir()
    (tmp_path / "lightning" / "ref.ckpt").write_bytes(lightning_ckpt.read_bytes())
    asked = []
    hub = types.ModuleType("huggingface_hub")
    hub.snapshot_download = lambda repo_id: asked.append(repo_id) or str(tmp_path / repo_id)
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub)
    from_dir = registry.create_model("hf_hub:local")
    from_ckpt = registry.create_model("hf_hub:lightning")
    assert asked == ["local", "lightning"]
    assert from_dir.restored_from == str(tmp_path / "local")
    assert from_ckpt.restored_from == str(tmp_path / "lightning" / "ref.ckpt")


def test_session_serves_restored_weights_or_raises(resumed_runs):
    """``InferenceSession(model)`` with no weights serves what a loader
    restored, and raises the JAX message for a model that holds none."""
    path = resumed_runs["convlstm"]["root"] / "p" / "best"
    x = np.random.default_rng(4).random(X_SHAPE, dtype=np.float32)
    session = InferenceSession(f"local:{path}", max_batch=2, device="cpu")
    model = load_model_from_checkpoint(str(path))
    with torch.no_grad():
        np.testing.assert_array_equal(session.predict(x),
                                      model.eval()(torch.from_numpy(x)).numpy())
    with pytest.raises(ValueError, match="has no restored_variables"):
        InferenceSession(registry.create_model(*CONVLSTM[:1], **CONVLSTM[1]), device="cpu")
    with pytest.raises(ValueError, match="at most one"):
        InferenceSession(model, variables={}, state_dict={}, device="cpu")


def test_resume_with_another_accumulation_restores_the_weights_only(resumed_runs, caplog):
    """A checkpoint of ``accumulate_grad_batches=2`` resumed at 1: the weights
    and step load, the optimizer starts afresh, with the JAX warning."""
    path = resumed_runs["convlstm_accumulate"]["root"] / "p" / "last"
    name, kw = CONVLSTM
    trainer = Trainer(max_epochs=0, resume_from_checkpoint=str(path))
    with caplog.at_level("WARNING"):
        trainer.fit(_port_model(name, kw, _variables(name, kw, seed=1)),
                    SatFlowDataModule(**DM_KW[name]))
    assert "optimizer moments and schedule position will RESET" in caplog.text
    assert trainer.global_step == K and not trainer.state.optimizer.state
    saved = restore_checkpoint(path)
    assert saved["mini_step"] == 1 and len(saved["acc"]) == len(trainer.state.params())
    for k, v in saved["model"].items():
        assert torch.equal(trainer.model.state_dict()[k], v), k


def test_resume_with_another_k_keeps_the_optimizer_and_matches_jax(resumed_runs, caplog):
    """A checkpoint of ``accumulate_grad_batches=2`` taken mid-accumulation
    (step 3: one update, one mini-step), resumed at 3 for K more steps: as
    in JAX, whose ``MultiSteps`` state has one structure for every k > 1,
    Adam's moments, the step and the accumulation all come back, and the
    update at step 5 averages steps 3-5. Held against the JAX Trainer's
    resume of its own checkpoint."""
    run = resumed_runs["convlstm_accumulate"]
    name, kw, root = run["name"], run["kw"], run["root"]
    variables = _variables(name, kw, seed=1)  # overwritten by the resume
    with caplog.at_level("WARNING"):
        jt = JaxTrainer(max_epochs=1, max_steps=2 * K, seed=0, accumulate_grad_batches=3,
                        resume_from_checkpoint=str(root / "j" / "last"))
        jt.fit(_jax_model(name, kw, variables), JaxDataModule(**DM_KW[name]))
        pt = Trainer(max_epochs=1, max_steps=2 * K, accumulate_grad_batches=3,
                     resume_from_checkpoint=str(root / "p" / "last"))
        pt.fit(_port_model(name, kw, variables), SatFlowDataModule(**DM_KW[name]))
    assert "will RESET" not in caplog.text
    assert pt.state.mini_step == 1 and int(jt.state.opt_state.mini_step) == 1
    _assert_matches_jax(jt, pt, name, updates=2)


def test_preemption_sigterm_checkpoints_and_stops(tmp_path):
    """After the JAX ``test_preemption_sigterm_checkpoints_and_stops``:
    SIGTERM mid-fit finishes the step, writes ``last`` with the step counter,
    stops; the run resumes from it; the SIGTERM disposition is restored."""
    ckpt_dir = str(tmp_path / "ckpts")

    class PreemptAtStep2(Callback):
        def on_train_batch_end(self, engine, metrics, step):
            if step == 2:
                os.kill(os.getpid(), signal.SIGTERM)

    name, kw = CONVLSTM
    before = signal.getsignal(signal.SIGTERM)
    trainer = Trainer(max_epochs=50,
                      callbacks=[PreemptAtStep2(), ModelCheckpoint(dirpath=ckpt_dir)])
    trainer.fit(_port_model(name, kw, _variables(name, kw)), SatFlowDataModule(**DM_KW[name]))
    assert trainer.preempted and trainer.should_stop and trainer.global_step == 2
    last = os.path.join(ckpt_dir, "last")
    assert restore_checkpoint(last)["step"] == trainer.global_step
    resumed = Trainer(max_epochs=1, max_steps=3, resume_from_checkpoint=last)
    resumed.fit(_port_model(name, kw, _variables(name, kw, seed=1)),
                SatFlowDataModule(**DM_KW[name]))
    assert resumed.global_step == 3 and resumed.state.step == 3
    assert signal.getsignal(signal.SIGTERM) == before


def test_model_artifact_logger_writes_final(tmp_path):
    name, kw = CONVLSTM
    trainer = Trainer(max_steps=1, callbacks=[ModelArtifactLogger(dirpath=str(tmp_path))])
    model = _port_model(name, kw, _variables(name, kw))
    trainer.fit(model, SatFlowDataModule(**DM_KW[name]))
    loaded = registry.create_model(f"local:{tmp_path / 'final'}")
    assert loaded.hidden_dim == model.hidden_dim
    assert restore_checkpoint(tmp_path / "final")["step"] == 1


def test_checkpoints_and_local_serving_import_no_jax(tmp_path):
    """A process that trains through ModelCheckpoint, resumes, serves from
    ``local:`` and runs a two-trial sweep imports neither jax, flax, optax,
    orbax nor any module of the JAX package."""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import satflow_tpu_torch.models
        from satflow_tpu_torch.core.registry import create_model
        from satflow_tpu_torch.data.datamodule import SatFlowDataModule, to_device
        from satflow_tpu_torch.experiments.sweep import sweep
        from satflow_tpu_torch.serve import InferenceSession
        from satflow_tpu_torch.train import Trainer
        from satflow_tpu_torch.train.callbacks import ModelCheckpoint

        dm_kw = {DM_KW["encoderdecoderconvlstm"]!r}
        kw = {CONVLSTM[1]!r}
        Trainer(max_steps=2, callbacks=[ModelCheckpoint(dirpath="ck")]).fit(
            create_model("encoderdecoderconvlstm", **kw), SatFlowDataModule(**dm_kw))
        Trainer(max_steps=3, resume_from_checkpoint="ck/last").fit(
            create_model("encoderdecoderconvlstm", **kw), SatFlowDataModule(**dm_kw))
        y = InferenceSession("local:ck/best", max_batch=2, device="cpu").predict(
            np.zeros((1, 3, 16, 16, 2), np.float32))
        assert y.shape == (1, 2, 16, 16, 2)
        sweep({{"seed": 0, "sweep_dir": "sweep", "optimized_metric": "val/loss",
                "datamodule": {{"_target_": "satflow_tpu.data.datamodule.SatFlowDataModule",
                                **dm_kw}},
                "model": {{"_target_": "satflow_tpu.models.conv_lstm.EncoderDecoderConvLSTM",
                           **kw}},
                "trainer": {{"fast_dev_run": True}},
                "hparams_search": {{"n_trials": 2, "search_space": {{
                    "model.lr": {{"type": "loguniform", "low": 1e-4, "high": 1e-2}}}}}}}})
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "satflow_tpu")))
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert len(json.loads((tmp_path / "sweep" / "results.json").read_text())["trials"]) == 2


@pytest.mark.parametrize("rule, shape", [("conv_kernel", (6, 4, 3, 3)),
                                         ("conv3d_kernel", (5, 4, 1, 3, 3)),
                                         ("linear_kernel", (7, 3))])
def test_layout_rules_match_jax(rule, shape):
    """The port's copies of the JAX module's torch -> flax layout rules give
    the same arrays, from a torch tensor or a numpy array."""
    from satflow_tpu.interop import torch_weights as jax_torch_weights
    from satflow_tpu_torch.interop import torch_weights

    w = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    want = getattr(jax_torch_weights, rule)(torch.from_numpy(w))
    for given in (torch.from_numpy(w), w):
        got = getattr(torch_weights, rule)(given)
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
