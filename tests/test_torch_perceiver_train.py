"""PyTorch port, the Perceiver family's training and weight sources: LAMB
against ``optax.lamb``, the torch converters (PerceiverIO naming with a fused
``to_kv``, HF's ``PerceiverForOpticalFlow``) against the JAX converters,
``Trainer.fit`` and ``evaluate_model`` on fake data, a checkpoint's resume
(LAMB's state bit for bit) and ``local:`` rebuild, ``experiment=perceiver_simple``
through the CLI, the accuracy gate's ``perceiver`` arm, and a process that
imports the new modules without jax.

Tolerances (each test says which it uses):
- LAMB's parameters after each of 5 updates: atol 1e-6 x max|p| (the same
  f32 operations; the bias corrections' powers and the norms may round
  differently by an ulp);
- converted weights: exact (the same transposes and reshapes);
- forwards of converted weights in float32: atol 1e-5 x max|ref|;
- resume and ``local:``: exact (the same tensors, saved and loaded).
"""

import copy
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import optax
import pytest
import torch

import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.core import registry
from satflow_tpu_torch.data.datamodule import SatFlowDataModule
from satflow_tpu_torch.interop.jax_weights import perceiver_state_dict_from_flax
from satflow_tpu_torch.train import Trainer
from satflow_tpu_torch.train.lamb import Lamb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a per-lead Perceiver at a few channels and 8², 2 lead times, 3 history
# frames in the fake schema
KW = dict(input_channels=2, sat_channels=2, input_size=8, forecast_steps=2, depth=1,
          num_latents=8, latent_dim=16, dim=8, queries_dim=8, latent_dim_heads=8,
          cross_dim_heads=4, num_freq_bands=4, history_steps=2, warmup_steps=2, total_steps=20,
          lr=1e-3)
DM_KW = dict(fake_data=True, num_workers=0, n_train_data=3, n_val_data=1, history_minutes=10,
             forecast_minutes=10, fake_kwargs=dict(batch_size=2, width=8, height=8,
                                                   number_sat_channels=2))


def _model(**kw):
    return registry.create_model("perceiver", **{**KW, **kw},
                                 generator=torch.Generator().manual_seed(0))


# -- LAMB -------------------------------------------------------------------------


def test_lamb_matches_optax_under_warmup_cosine():
    """Five updates of ``Perceiver.make_optimizer`` (LAMB, b1 0.9, b2 0.999,
    optax's eps 1e-6, the learning rate from ``warmup_cosine`` at the count
    before the update) against ``optax.lamb`` with the JAX schedule, on
    four tensors with the same numpy-seeded gradients: one zero with a zero
    first gradient (both norms 0 at update 1, its parameter's norm 0 at
    update 2: trust ratio 1), one whose gradient is always zero (its
    update's norm 0: trust ratio 1, no move), and one whose gradient is
    absent at updates 3 and 4 (``grad`` None, a modality missing from the
    batch; optax gets zeros there: its moments decay, it moves by its
    momentum, and the count is shared). Parameters after each update:
    atol 1e-6 x max|p|; the learning rates equal to the schedule's. (At
    count 0 optax's warm-up start, 1e-8, is taken in f32 as (1e-8 - lr) + lr
    and comes out 9.3e-9; the port's is 1e-8: a 7e-10 move either way.)"""
    from satflow_tpu.train.schedules import warmup_cosine as jax_warmup_cosine

    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3, 2), "zero": (5,), "still": (3, 3), "absent": (2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    params["zero"][:] = 0.0
    absent = {("absent", 2), ("absent", 3)}
    grads = [{k: (np.zeros(s) if k == "still" or (k, i) in {("zero", 0)} | absent
                  else rng.normal(size=s)).astype(np.float32)
              for k, s in shapes.items()} for i in range(5)]

    model = _model(lr=2e-2, warmup_steps=2, total_steps=8)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    model.parameters = lambda: iter(tparams.values())  # the optimizer over these four
    opt = model.make_optimizer()
    assert isinstance(opt, Lamb) and opt.defaults["eps"] == 1e-6

    tx = optax.lamb(jax_warmup_cosine(2e-2, 2, 8), b1=0.9, b2=0.999)
    jparams = dict(params)
    state = tx.init(jparams)
    for i, g in enumerate(grads):
        updates, state = tx.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = tparams["absent"].detach().clone()
        for k, p in tparams.items():
            p.grad = None if (k, i) in absent else torch.from_numpy(g[k])
        opt.step()
        if ("absent", i) in absent:
            assert not torch.equal(tparams["absent"], before)  # moved by its momentum
        assert opt.param_groups[0]["lr"] == model.lr_schedule(i)
        for k, p in tparams.items():
            want = np.asarray(jparams[k])
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(), err_msg=f"{i} {k}")
        if i == 0:
            assert not tparams["zero"].any()
    np.testing.assert_array_equal(tparams["still"].detach().numpy(), params["still"])
    assert opt.state_dict()["param_groups"][0]["schedule_count"] == 5
    assert opt.state_dict()["param_groups"][0]["count"] == 5


# -- the torch converters -------------------------------------------------------------


def test_load_torch_perceiver_with_fused_kv_matches_jax():
    """A PerceiverIO-naming state dict whose attentions carry one fused
    ``to_kv`` goes through the JAX ``load_torch_perceiver`` and the port's:
    every converted leaf equal (exact), and the port's core on them equal to
    the JAX core's forward (atol 1e-5 x max|ref|)."""
    from satflow_tpu.interop import load_torch_perceiver as jax_load
    from satflow_tpu.nn import perceiver as jp
    from satflow_tpu_torch.interop import load_torch_perceiver
    from satflow_tpu_torch.nn import perceiver as tp
    from tests.test_torch_interop import TorchPerceiverIO

    kw = dict(dim=16, queries_dim=16, logits_dim=5, depth=2, num_latents=8, latent_dim=24,
              cross_heads=2, latent_heads=2, cross_dim_head=8, latent_dim_head=8)
    torch.manual_seed(0)
    sd = TorchPerceiverIO(**kw).state_dict()
    for key in [k for k in sd if k.endswith(".to_k.weight")]:
        base = key[: -len(".to_k.weight")]
        sd[f"{base}.to_kv.weight"] = torch.cat([sd.pop(key), sd.pop(f"{base}.to_v.weight")])
    assert sum(k.endswith(".to_kv.weight") for k in sd) == 4

    rng = np.random.default_rng(1)
    inputs = {"sat": rng.standard_normal((2, 6, 3)).astype(np.float32)}
    queries = rng.standard_normal((2, 7, 16)).astype(np.float32)
    mods = (jp.InputModality("sat", 3, 1, 4, fourier_encode=False),)
    jcore = jp.MultiPerceiverIO(mods, **kw)
    variables = jcore.init(jax.random.PRNGKey(0), inputs, queries)
    jparams = jax_load(variables["params"], jcore, sd)
    want = perceiver_state_dict_from_flax({"params": jparams})

    core = tp.MultiPerceiverIO((tp.InputModality("sat", 3, 1, 4, fourier_encode=False),), **kw)
    core.load_state_dict(perceiver_state_dict_from_flax(variables))
    converted = load_torch_perceiver(core, sd)
    assert set(converted) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(converted[k], v, rtol=0, atol=0, msg=k)
    with torch.no_grad():
        got = core({"sat": torch.from_numpy(inputs["sat"])}, torch.from_numpy(queries))
    ref = np.asarray(jcore.apply({"params": jparams}, inputs, queries))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_conv_transpose_kernel_matches_the_jax_rule():
    """A torch ``ConvTranspose2d`` weight through the port's
    ``conv_transpose_kernel`` equals the JAX rule's flax kernel brought
    into the port by ``perceiver_state_dict_from_flax`` (exact), and the
    port's ``ConvTranspose`` on it equals flax's ``ConvTranspose`` on the
    JAX rule's kernel (atol 1e-5 x max|ref|)."""
    import flax.linen as fnn

    from satflow_tpu.interop.torch_weights import conv_transpose_kernel as jax_rule
    from satflow_tpu_torch.interop.torch_weights import conv_transpose_kernel
    from satflow_tpu_torch.nn.perceiver import ConvTranspose

    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 5, 4, 4)).astype(np.float32)  # (I, O, kh, kw)
    b = rng.standard_normal(5).astype(np.float32)
    flax_params = {"kernel": jax_rule(w), "bias": b}
    want = perceiver_state_dict_from_flax({"params": flax_params})
    got = conv_transpose_kernel(torch.from_numpy(w))
    torch.testing.assert_close(got, want["weight"], rtol=0, atol=0)

    x = rng.standard_normal((2, 3, 5, 3)).astype(np.float32)
    ref = np.asarray(fnn.ConvTranspose(5, (4, 4), strides=(4, 4)).apply(
        {"params": flax_params}, x))
    layer = ConvTranspose(3, 5, (4, 4), (4, 4))
    layer.load_state_dict({"weight": got, "bias": torch.from_numpy(b)})
    with torch.no_grad():
        out = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("together", [False, True], ids=["per_lead", "together"])
def test_hf_optical_flow_mapping_matches_jax(monkeypatch, together):
    """``HuggingFacePerceiver(pretrained=True)`` on a tiny HF
    ``PerceiverConfig`` (``from_pretrained`` monkeypatched: nothing
    downloads), in both decode modes: the geometry read from the checkpoint
    (322-wide tokens, 16 x 32 latents, depth 2, q/k/v biases, no decoder
    query residual) as the JAX model reads it, every mapped leaf equal to
    the JAX model's (exact), the forward finite, ``pretrained`` false after
    the load and a rebuild from the hparams without the hub."""
    import transformers
    from transformers import PerceiverConfig, PerceiverForOpticalFlow

    from satflow_tpu.models.hf_perceiver import HuggingFacePerceiver as JaxHF
    from satflow_tpu_torch.interop.torch_weights import hf_flow_rules
    from satflow_tpu_torch.models.hf_perceiver import HuggingFacePerceiver
    from satflow_tpu_torch.train.checkpoint import _ctor_kwargs

    cfg = PerceiverConfig(num_latents=16, d_latents=32, d_model=64, num_blocks=1,
                          num_self_attends_per_block=2, num_self_attention_heads=2,
                          num_cross_attention_heads=1, qk_channels=32, v_channels=32,
                          train_size=[8, 8], hidden_act="gelu")
    torch.manual_seed(0)
    hf = PerceiverForOpticalFlow(cfg).eval()
    calls = []

    def fake_from_pretrained(name, **kw):
        calls.append(name)
        return hf

    monkeypatch.setattr(transformers.PerceiverForOpticalFlow, "from_pretrained",
                        fake_from_pretrained)
    kw = dict(pretrained=True, train_size=8, forecast_steps=2, input_channels=3,
              sat_channels=3, num_freq_bands=4, predict_timesteps_together=together)
    jmodel = JaxHF(**kw)
    model = HuggingFacePerceiver(**kw)
    assert calls == ["deepmind/optical-flow-perceiver"] * 2
    for attr in ("dim", "queries_dim", "num_latents", "latent_dim", "depth", "qkv_bias",
                 "decoder_query_residual", "flow_channels", "latent_heads", "cross_heads",
                 "latent_dim_heads", "cross_dim_heads", "latent_ff_mult", "cross_ff_mult"):
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert (model.dim, model.num_latents, model.depth) == (322, 16, 2)
    want = perceiver_state_dict_from_flax(jmodel.restored_variables)
    got = model.module.state_dict()
    prefix = "core.perceiver" if together else "core.steps.core"
    mapped = {port_key for port_key, _ in hf_flow_rules(model.module.core.core, prefix).values()}
    assert len(mapped) > 40 and mapped <= set(got)
    for k in mapped:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    x = np.random.default_rng(0).standard_normal((1, 6, 8, 8, 3)).astype(np.float32)
    inputs, _ = model.prepare_batch(({"sat_data": x}, x))
    with torch.no_grad():
        y = model(inputs)
    assert y.shape == (1, 2, 8, 8, 3) and torch.isfinite(y).all()

    hp = model.hparams()
    assert hp == jmodel.hparams()
    assert hp["pretrained"] is False and hp["dim"] == 322
    rebuilt = HuggingFacePerceiver(**_ctor_kwargs(hp.pop("class"), hp))
    assert len(calls) == 2
    assert (rebuilt.dim, rebuilt.num_latents, rebuilt.qkv_bias) == (322, 16, True)
    assert not rebuilt.decoder_query_residual


def test_hf_pretrained_without_transformers_raises(monkeypatch):
    """Without ``transformers`` installed, ``pretrained=True`` raises
    ImportError, as the JAX model does."""
    from satflow_tpu_torch.models.hf_perceiver import HuggingFacePerceiver

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="requires the transformers package"):
        HuggingFacePerceiver(pretrained=True, train_size=8)


# -- the engine -------------------------------------------------------------------------


def test_trainer_fit_and_evaluate_on_fake_data():
    """``Trainer.fit`` on the fake datamodule (the dict schema): the
    projections made from the first batch, LAMB over every parameter that
    exists (none left lazy: the fake schema has every modality of the
    config), the losses finite, every parameter moved; then
    ``evaluate_model``'s per-lead curves and ``scale_batch_size``, whose
    probes step the model's own LAMB."""
    from satflow_tpu.data.fake import FakeDataset
    from satflow_tpu_torch.eval.evaluate import evaluate_model
    from torch.nn.parameter import is_lazy

    model = _model()
    trainer = Trainer(max_steps=3, log_every_n_steps=1, device="cpu")
    before = None

    class Snapshot:
        def __getattr__(self, name):
            return lambda *a, **k: None

        def on_train_start(self, tr):
            nonlocal before
            before = {k: v.detach().clone() for k, v in model.state_dict().items()}

    trainer.callbacks.append(Snapshot())
    trainer.fit(model, SatFlowDataModule(**DM_KW))
    assert not any(is_lazy(p) for p in model.parameters())
    assert isinstance(trainer.state.optimizer, Lamb)
    assert len(trainer.state.params()) == len(list(model.parameters()))
    hist = trainer.history.history
    assert all(np.isfinite(r["train/loss"]) for r in hist if "train/loss" in r)
    for k, v in model.state_dict().items():
        assert not torch.equal(v, before[k]), k
    ds = FakeDataset(batch_size=2, width=8, height=8, number_sat_channels=2, history_minutes=10,
                     forecast_minutes=10, length=2)
    curves = evaluate_model(model, ds, max_batches=2, compute_ms_ssim=False)
    assert np.asarray(curves["mse"]).shape == (2, 2) and np.isfinite(curves["mse_mean"])

    stepped = []
    orig = Lamb.step

    def counting_step(self, *a, **k):
        stepped.append(self)
        return orig(self, *a, **k)

    Lamb.step = counting_step
    try:
        dm = SatFlowDataModule(**DM_KW)
        assert Trainer(device="cpu").scale_batch_size(model, dm, init_val=2, max_trials=2) == 4
    finally:
        Lamb.step = orig
    assert len(stepped) == 2 and dm.batch_size == 4


def test_checkpoint_resume_restores_lamb_bit_for_bit_and_local_rebuilds(tmp_path):
    """3 steps through ``ModelCheckpoint``, then a fresh model resumed from
    ``last`` for 2 more: the restored state (weights, LAMB's moments and
    shared count, the schedule's count) equal to the saved one bit for bit, the
    resumed weights equal to those of an uninterrupted 5-step run; then
    ``create_model("local:...")`` rebuilds the model (no lazy weight left)
    with the checkpoint's weights and forward."""
    from satflow_tpu_torch.train.callbacks import ModelCheckpoint
    from satflow_tpu_torch.train.checkpoint import restore_checkpoint

    dm_kw = dict(DM_KW, n_train_data=5)
    ck = str(tmp_path / "ck")
    Trainer(max_steps=3, device="cpu", callbacks=[ModelCheckpoint(dirpath=ck)]).fit(
        _model(), SatFlowDataModule(**dm_kw))
    saved = restore_checkpoint(os.path.join(ck, "last"))
    assert saved["step"] == 3

    class Capture:
        def __getattr__(self, name):
            return lambda *a, **k: None

        def on_train_start(self, tr):
            self.state = {"model": {k: v.clone() for k, v in tr.state.model.state_dict().items()},
                          "optimizer": copy.deepcopy(tr.state.optimizer.state_dict())}

    cap = Capture()
    # the resumed run starts its data loader over: batches 0-1 after 0-2
    resumed_model = _model()
    Trainer(max_steps=5, device="cpu", resume_from_checkpoint=os.path.join(ck, "last"),
            callbacks=[cap]).fit(resumed_model, SatFlowDataModule(**dict(dm_kw, n_train_data=2)))
    for k, v in saved["model"].items():
        torch.testing.assert_close(cap.state["model"][k], v, rtol=0, atol=0, msg=k)
    opt = cap.state["optimizer"]
    assert opt["param_groups"][0]["schedule_count"] == 3
    assert opt["param_groups"][0]["count"] == saved["optimizer"]["param_groups"][0]["count"] == 3
    for i, s in saved["optimizer"]["state"].items():
        for name in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(opt["state"][i][name], s[name], rtol=0, atol=0)

    class Replay:
        """Batches 0-2, then 0-1: the data the resumed run saw."""

        def train_dataloader(self):
            dm3, dm2 = SatFlowDataModule(**dm_kw), SatFlowDataModule(**dict(dm_kw,
                                                                             n_train_data=2))
            return list(dm3.train_dataloader())[:3] + list(dm2.train_dataloader())

        def val_dataloader(self):
            return SatFlowDataModule(**dm_kw).val_dataloader()

    straight = _model()
    Trainer(max_steps=5, device="cpu").fit(straight, Replay())
    for k, v in straight.state_dict().items():
        torch.testing.assert_close(resumed_model.state_dict()[k], v, rtol=0, atol=0, msg=k)

    from torch.nn.parameter import is_lazy

    loaded = registry.create_model(f"local:{os.path.join(ck, 'last')}")
    assert type(loaded).__name__ == "Perceiver" and loaded.hparams() == _model().hparams()
    assert not any(is_lazy(p) for p in loaded.parameters())
    for k, v in saved["model"].items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0, msg=k)
    batch = next(iter(SatFlowDataModule(**dm_kw).train_dataloader()))
    batch = tuple({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in part.items()}
                  for part in batch)
    ref = _model()
    ref.load_state_dict(saved["model"])
    x, _ = ref.prepare_batch(batch)
    with torch.no_grad():
        torch.testing.assert_close(loaded(x), ref(x), rtol=0, atol=0)


def test_experiment_perceiver_simple_through_the_cli(tmp_path):
    """``python -m satflow_tpu_torch.run experiment=perceiver_simple`` on the
    CPU, two steps: the default model config's ``out_channels``,
    ``hidden_dim`` and ``conv_type`` dropped from the Perceiver's node (the
    JAX package raises TypeError on them), the datamodule following the
    model's 6 lead times, train / val / test losses per lead logged, the
    checkpoints written."""
    out = subprocess.run(
        [sys.executable, "-m", "satflow_tpu_torch.run", "experiment=perceiver_simple",
         "trainer.device=cpu", "trainer.max_steps=2", "datamodule.n_train_data=2",
         "datamodule.n_val_data=1", "work_dir=runs", "print_config=false"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "takes no out_channels, hidden_dim, conv_type" in out.stderr + out.stdout
    csvs = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path) for f in fs
            if f == "metrics.csv"]
    assert len(csvs) == 1
    header = open(csvs[0]).read().splitlines()[0].split(",")
    assert {"train/loss", "val/loss", "test/loss", "train/frame_5_loss"} <= set(header)
    run = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(csvs[0]))))
    hp = json.load(open(os.path.join(run, "checkpoints", "last", "hparams.json")))["hparams"]
    assert (hp["class"], hp["forecast_steps"], hp["depth"], hp["latent_dim"]) == (
        "Perceiver", 6, 2, 128)


def test_perceiver_modules_import_no_jax(tmp_path):
    """A process that builds every config's model of the family, trains the
    Perceiver one step under LAMB, converts a torch state dict and runs the
    accuracy gate's module imports neither jax, flax, optax nor any module of
    the JAX package."""
    code = textwrap.dedent(f"""
        import sys
        import torch
        import satflow_tpu_torch.models
        import satflow_tpu_torch.tools.accuracy_gate
        from satflow_tpu_torch.core.registry import create_model
        from satflow_tpu_torch.data.datamodule import SatFlowDataModule
        from satflow_tpu_torch.interop import load_torch_perceiver
        from satflow_tpu_torch.interop.torch_weights import load_hf_optical_flow
        from satflow_tpu_torch.nn.perceiver import MultiPerceiverIO
        from satflow_tpu_torch.train import Trainer
        from satflow_tpu_torch.train.lamb import Lamb

        model = create_model("perceiver", **{KW!r})
        Trainer(max_steps=1, device="cpu").fit(model, SatFlowDataModule(**{DM_KW!r}))
        create_model("huggingfaceperceiver", train_size=8, depth=1, num_latents=4,
                     latent_dim=8)
        load_torch_perceiver(model.module.core, {{"latents": model.module.core.latents}})
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "satflow_tpu")))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# -- the accuracy gate ---------------------------------------------------------------------


def test_accuracy_gate_perceiver_arm_runs(monkeypatch, tmp_path):
    """The gate's ``perceiver`` arm (the JAX tool's recipe: LAMB under
    ``warmup_cosine``, every lead time decoded at once, 32², 12 lead times)
    trains and scores on the CPU at 1 epoch on 16² batches of 2 with the
    query grid at 16², depth 1 and 2 warm-up steps: the curves' length,
    finite values, the epochs recorded."""
    from satflow_tpu_torch.tools import accuracy_gate

    assert "perceiver" in accuracy_gate.PORTED_ARMS
    monkeypatch.setattr(accuracy_gate, "PERCEIVER_EPOCHS", 1)
    monkeypatch.setattr(accuracy_gate, "PERCEIVER", {**accuracy_gate.PERCEIVER, "input_size": 16,
                                                     "depth": 1, "warmup_steps": 2})
    monkeypatch.setattr(accuracy_gate, "DS_KW", {**accuracy_gate.DS_KW, "batch_size": 2,
                                                 "width": 16, "height": 16})
    monkeypatch.chdir(tmp_path)
    row = accuracy_gate.main(["perceiver"], device="cpu")["perceiver"]
    assert len(row["mse_t"]) == len(row["ms_ssim_t"]) == accuracy_gate.STEPS
    assert np.isfinite(row["mse"]) and np.isfinite(row["ms_ssim"]) and row["epochs"] == 1


@pytest.mark.slow
def test_port_trained_perceiver_beats_persistence_and_flow():
    """``tests/test_accuracy.py``'s Perceiver gate through the port on the
    CPU (slow, as its JAX counterpart): 16², 1 channel, 6 lead times decoded
    together, LAMB at 2e-3 under ``warmup_cosine`` (40 warm-up steps of
    160), 20 epochs of 8 batches, decay 0.8; the trained model's mean MSE
    below the Farneback flow's, which is below persistence's."""
    from satflow_tpu_torch.baseline import optical_flow as baseline
    from satflow_tpu_torch.data.fake import DecayingAdvectionDataset
    from satflow_tpu_torch.eval import evaluate
    from satflow_tpu_torch.tools import accuracy_gate

    kw = dict(batch_size=8, width=16, height=16, number_sat_channels=1, history_minutes=15,
              forecast_minutes=30, velocity=(1, 1), decay=0.8, n_blobs=3)

    class DecayDM(SatFlowDataModule):
        def __init__(self):
            super().__init__(fake_data=True, num_workers=0, shard=False)

        def _dataset(self, split, n):
            return DecayingAdvectionDataset(length=8, seed=accuracy_gate.SPLIT_SEEDS[split],
                                            **kw)

    eval_ds = DecayingAdvectionDataset(length=2, seed=300, **kw)
    base = baseline.run_baseline(eval_ds, forecast_steps=6, flow_method="farneback",
                                 max_batches=2, device="cpu")
    persist, flow = float(np.mean(base["baseline_loss"])), float(np.mean(base["flow_loss"]))
    model = registry.create_model(
        "perceiver", input_channels=1, sat_channels=1, base_channels=1, input_size=16,
        forecast_steps=6, history_steps=4, depth=2, num_latents=32, latent_dim=64, dim=32,
        queries_dim=32, num_freq_bands=8, predict_timesteps_together=True, lr=2e-3,
        warmup_steps=40, total_steps=160, generator=torch.Generator().manual_seed(0))
    Trainer(max_epochs=20, log_every_n_steps=1000, device="cpu").fit(model, DecayDM())
    mse = evaluate.evaluate_model(model, eval_ds, max_batches=2, compute_ms_ssim=False)
    assert mse["mse_mean"] < flow < persist, (mse["mse_mean"], flow, persist)
