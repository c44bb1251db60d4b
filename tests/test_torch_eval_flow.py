"""PyTorch port, eval and baselines: CRPS and ``evaluate_ensemble``
(``eval/probabilistic.py``), ``evaluate_model`` (``eval/evaluate.py``), the
flow ops (``ops/flow.py``), ``run_baseline`` (``baseline/optical_flow.py``)
and the accuracy gate (``tools/accuracy_gate.py``) against the JAX package
on the same numpy-seeded inputs; then the package exports (F5) read from
the JAX ``__init__``s by ``ast``.

On the CPU the JAX ConvLSTM runs its XLA reference step and the port its
plain step; both flow solves run their loops on the CPU.

Tolerances (each test says which it uses):
- CRPS, the warp and the rollouts: atol 1e-6 (the same f32 elementwise
  math; the means in another order);
- Horn–Schunck: atol 1e-5 on the flow (200 Jacobi steps of the same f32
  update; the 3x3 average summed by another conv, measured ~1e-7);
- ``run_baseline``: rtol 1e-5 on the per-lead MSE curves;
- ``evaluate_model``: rtol 1e-4 on MSE, atol 1e-5 on SSIM and MS-SSIM (the
  rollouts agree to ~1e-6, ``test_torch_convlstm.py``).
"""

import ast
import importlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satflow_tpu.baseline import optical_flow as jax_baseline
from satflow_tpu.core import registry as jax_registry
from satflow_tpu.data.fake import AdvectionDataset as JaxAdvection
from satflow_tpu.eval import evaluate as jax_evaluate
from satflow_tpu.eval import probabilistic as jax_prob
from satflow_tpu.ops import flow as jax_flow
import satflow_tpu.models  # noqa: F401 - populate the JAX registry
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.baseline import optical_flow as baseline
from satflow_tpu_torch.core import registry
from satflow_tpu_torch.data.fake import AdvectionDataset
from satflow_tpu_torch.eval import evaluate, probabilistic as prob
from satflow_tpu_torch.interop.jax_weights import params_from_flax
from satflow_tpu_torch.ops import flow
from satflow_tpu_torch.tools import accuracy_gate

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are tiny, and the flow solves and
    rollouts are thousands of small ops, which threads only slow down when
    the suite runs in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# -- CRPS ---------------------------------------------------------------------


@pytest.mark.parametrize("m, fair", [(1, False), (2, False), (2, True), (5, False), (5, True)])
def test_crps_ensemble_matches_jax(m, fair):
    """(B, M, T, H, W, C) members against (B, T, H, W, C): atol 1e-6 (the
    fair coefficient needs M >= 2)."""
    rng = np.random.default_rng(m)
    samples = rng.standard_normal((2, m, 3, 4, 5, 2)).astype(np.float32)
    y = rng.standard_normal((2, 3, 4, 5, 2)).astype(np.float32)
    want = np.asarray(jax_prob.crps_ensemble(jnp.asarray(samples), jnp.asarray(y), fair=fair))
    got = prob.crps_ensemble(_t(samples), _t(y), fair=fair)
    assert tuple(got.shape) == want.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_crps_analytic_two_atom_and_deterministic():
    """The closed forms of ``tests/test_eval.py``: the two-atom forecast
    {-1, +1} against y = +1 scores 0.5 (classic) and 0 (fair), the collapsed
    {0, 0} 1.0; a hit scores 0 and M = 1 is the MAE."""
    y = torch.ones(1, 1)
    diverse = torch.tensor([[[+1.0], [-1.0]]])
    np.testing.assert_allclose(prob.crps_ensemble(diverse, y).numpy(), [0.5], atol=1e-6)
    np.testing.assert_allclose(prob.crps_ensemble(torch.zeros(1, 2, 1), y).numpy(), [1.0],
                               atol=1e-6)
    np.testing.assert_allclose(prob.crps_ensemble(diverse, y, fair=True).numpy(), [0.0],
                               atol=1e-6)
    obs = _t(np.random.default_rng(0).normal(size=(2, 3, 4, 4, 1)))
    np.testing.assert_allclose(prob.crps_ensemble(obs[:, None], obs).numpy(), np.zeros(3),
                               atol=1e-6)
    np.testing.assert_allclose(prob.crps_deterministic(obs + 0.5, obs).numpy(),
                               np.full(3, 0.5), atol=1e-5)


class _SamplerBase:
    """A sampling model's surface: ``prepare_batch`` and ``_sample``, drawing
    members that are fixed offsets of the last input frame (no randomness,
    so both packages see the same samples)."""

    num_samples = 3

    @staticmethod
    def offsets(n):
        return np.linspace(-0.2, 0.3, n, dtype=np.float32)

    def prepare_batch(self, batch):
        x, y = batch
        return x["sat_data"], y["sat_data"]


class _JaxSampler(_SamplerBase):
    def _sample(self, variables, x, rng, train, n):
        last = x[:, -1:]  # (B, 1, H, W, C), repeated over the lead times
        f = 2
        members = [jnp.repeat(last, f, axis=1) + o for o in self.offsets(n)]
        return jnp.stack(members, axis=1), None


class _PortSampler(_SamplerBase, torch.nn.Module):
    def __init__(self):
        torch.nn.Module.__init__(self)
        self.dummy = torch.nn.Parameter(torch.zeros(1))

    def _sample(self, x, generator, train, n):
        assert isinstance(generator, torch.Generator)
        last = x[:, -1:]
        members = [last.repeat(1, 2, 1, 1, 1) + float(o) for o in self.offsets(n)]
        return torch.stack(members, dim=1), None


@pytest.mark.parametrize("n, fair", [(None, False), (4, True)])
def test_evaluate_ensemble_matches_jax(n, fair):
    """CRPS, ensemble-mean MSE and spread over 2 batches of the same stub
    samples: atol 1e-6."""
    ds = JaxAdvection(batch_size=2, width=8, height=8, number_sat_channels=2,
                      history_minutes=10, forecast_minutes=10, length=3)
    want = jax_prob.evaluate_ensemble(_JaxSampler(), {}, ds, num_samples=n, max_batches=2,
                                      fair=fair)
    got = prob.evaluate_ensemble(_PortSampler(), ds, num_samples=n, max_batches=2, fair=fair)
    for key in ("crps", "mse"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, err_msg=key)
    for key in ("crps_mean", "mse_mean", "sample_std"):
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
    with pytest.raises(ValueError, match="empty"):
        prob.evaluate_ensemble(_PortSampler(), ds, max_batches=0)


# -- evaluate_model -------------------------------------------------------------

EV = dict(input_channels=2, out_channels=2, forecast_steps=3, hidden_dim=8)


@pytest.fixture(scope="module")
def convlstm_pair():
    """The JAX ConvLSTM (hidden 8) with random weights, and the port's on
    the same weights through the flax bridge."""
    jmodel = jax_registry.create_model("encoderdecoderconvlstm", **EV)
    variables = jmodel.module.init(jax.random.PRNGKey(0), np.zeros((1, 4, 16, 16, 2), np.float32))
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.3).astype(np.float32), variables)
    model = registry.create_model("encoderdecoderconvlstm", **EV)
    model.module.load_state_dict(params_from_flax(variables))
    return jmodel, variables, model


@pytest.mark.parametrize("ms", [True, False])
def test_evaluate_model_matches_jax(convlstm_pair, ms, tmp_path):
    """The (C, T) MSE, (T,) SSIM and MS-SSIM curves and their means over 2
    batches of 16x16 advection: MSE rtol 1e-4, SSIM and MS-SSIM atol 1e-5;
    then ``save_results``."""
    jmodel, variables, model = convlstm_pair
    ds = AdvectionDataset(batch_size=2, width=16, height=16, number_sat_channels=2,
                          history_minutes=15, forecast_minutes=15, length=3)
    want = jax_evaluate.evaluate_model(jmodel, variables, ds, max_batches=2,
                                       compute_ms_ssim=ms)
    model.train()
    got = evaluate.evaluate_model(model, ds, max_batches=2, compute_ms_ssim=ms)
    assert model.training  # the mode is restored
    assert set(got) == set(want)
    assert got["mse"].shape == (2, 3) and got["ssim"].shape == (3,)
    np.testing.assert_allclose(got["mse"], want["mse"], rtol=1e-4)
    np.testing.assert_allclose(got["ssim"], want["ssim"], atol=1e-5)
    assert got["mse_mean"] == pytest.approx(want["mse_mean"], rel=1e-4)
    assert got["ssim_mean"] == pytest.approx(want["ssim_mean"], abs=1e-5)
    if ms:
        np.testing.assert_allclose(got["ms_ssim"], want["ms_ssim"], atol=1e-5)
    evaluate.save_results(got, str(tmp_path))
    assert (tmp_path / "mse.npy").exists()
    assert json.loads((tmp_path / "summary.json").read_text())["mse_mean"] == got["mse_mean"]


def test_evaluate_model_forward_kwargs_and_errors(convlstm_pair, tmp_path):
    """``forward_kwargs`` reach the forward (here the plain step itself);
    an empty dataset raises; the CLI scores a ``local:`` checkpoint of the
    model as ``evaluate_model`` scores the model."""
    from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step_ref
    from satflow_tpu_torch.train import TrainState
    from satflow_tpu_torch.train.checkpoint import save_checkpoint

    _, _, model = convlstm_pair
    ds = AdvectionDataset(batch_size=2, width=16, height=16, number_sat_channels=2,
                          history_minutes=15, forecast_minutes=15, length=1)
    a = evaluate.evaluate_model(model, ds)
    b = evaluate.evaluate_model(model, ds, step=fused_convlstm_step_ref)
    np.testing.assert_allclose(a["mse"], b["mse"], rtol=1e-6)
    with pytest.raises(ValueError, match="empty"):
        evaluate.evaluate_model(model, ds, max_batches=0)
    save_checkpoint(str(tmp_path / "ck"), TrainState(model, model.make_optimizer()), model)
    evaluate.main(["--checkpoint", str(tmp_path / "ck"), "--device", "cpu", "--size", "16",
                   "--channels", "2", "--history-minutes", "15", "--batches", "1",
                   "--output", str(tmp_path / "out")])
    ds = AdvectionDataset(batch_size=4, width=16, height=16, number_sat_channels=2,
                          history_minutes=15, forecast_minutes=15, length=1)
    want = evaluate.evaluate_model(model, ds, 1)
    np.testing.assert_allclose(np.load(tmp_path / "out" / "mse.npy"), want["mse"], rtol=1e-6)
    summary = json.loads((tmp_path / "out" / "summary.json").read_text())
    assert summary["ssim_mean"] == pytest.approx(want["ssim_mean"], rel=1e-6)


# -- flow ops -------------------------------------------------------------------


def _frames(seed=0, hw=(24, 20), shift=(0, 1)):
    """A smooth random frame and its copy shifted by ``shift``."""
    from scipy.ndimage import gaussian_filter

    base = gaussian_filter(np.random.default_rng(seed).random(hw), 2.0).astype(np.float32)
    return base, np.roll(base, shift, axis=(0, 1)).astype(np.float32)


@pytest.mark.parametrize("channels", [None, 3])
def test_warp_flow_and_rollout_match_jax(channels):
    """A flow of up to 4 px either way (samples beyond the border clamp):
    warp and a 5-step rollout, (H, W) and (H, W, C); atol 1e-6."""
    rng = np.random.default_rng(1)
    shape = (12, 10) if channels is None else (12, 10, channels)
    img = rng.random(shape, dtype=np.float32)
    f = rng.uniform(-4, 4, size=(12, 10, 2)).astype(np.float32)
    want = np.asarray(jax_flow.warp_flow(jnp.asarray(img), jnp.asarray(f)))
    got = flow.warp_flow(_t(img), _t(f))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    want = np.asarray(jax_flow.rollout_warp(jnp.asarray(img), jnp.asarray(f), 5))
    got = flow.rollout_warp(_t(img), _t(f), 5)
    assert tuple(got.shape) == want.shape == (5, *shape)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("shift", [(0, 1), (1, -1)])
def test_horn_schunck_matches_jax(shift):
    """200 Jacobi iterations, alpha 0.05, on a translating smooth frame:
    atol 1e-5; the flow extrapolates (warping the latest frame by it is
    closer to the next frame than persistence)."""
    prev, curr = _frames(shift=shift)
    want = np.asarray(jax_flow.horn_schunck_flow(jnp.asarray(prev), jnp.asarray(curr)))
    got = flow.horn_schunck_flow(_t(prev), _t(curr))
    assert tuple(got.shape) == want.shape == (*prev.shape, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    nxt = np.roll(curr, shift, axis=(0, 1))
    warped = flow.warp_flow(_t(curr), got).numpy()
    inner = (slice(3, -3), slice(3, -3))
    assert np.mean((warped - nxt)[inner] ** 2) < np.mean((curr - nxt)[inner] ** 2)


def test_farneback_with_opencv_matches_jax():
    """With cv2 both packages make the same OpenCV call: equal flows."""
    pytest.importorskip("cv2")
    prev, curr = _frames(seed=2, hw=(32, 32), shift=(0, 2))
    want = jax_flow.farneback_flow(prev, curr)
    got = flow.farneback_flow(_t(prev), _t(curr))
    assert flow.farneback_backend() == "opencv"
    np.testing.assert_array_equal(got.numpy(), want)


def test_farneback_without_opencv_is_horn_schunck(monkeypatch):
    """With cv2 hidden, both packages' rule takes Horn–Schunck: atol 1e-5
    against the JAX package, and equal to the port's own solve."""
    prev, curr = _frames(seed=3, shift=(1, 0))
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 -> ImportError
    assert flow.farneback_backend() == "horn_schunck"
    want = jax_flow.farneback_flow(prev, curr)
    got = flow.farneback_flow(_t(prev), _t(curr))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(got.numpy(), flow.horn_schunck_flow(_t(prev), _t(curr)).numpy())


# -- run_baseline ---------------------------------------------------------------


def _crop_np(frames):
    return frames[:, 2:-2, 3:-3]


def _crop_torch(frames):
    return frames[:, 2:-2, 3:-3]


@pytest.mark.parametrize("method, flow_channel, view", [
    ("farneback", None, False), ("horn_schunck", None, False),
    ("horn_schunck", 1, False), ("horn_schunck", None, True),
])
def test_run_baseline_matches_jax(method, flow_channel, view, tmp_path, monkeypatch):
    """Flow and persistence curves (C, F) over 2 batches of advection, per
    channel or with one flow channel, with and without a target view:
    rtol 1e-5. Farneback runs as resolved in this process in both (cv2 here:
    the same OpenCV call)."""
    ds = AdvectionDataset(batch_size=1, width=16, height=16, number_sat_channels=2,
                          history_minutes=15, forecast_minutes=25, velocity=(1, 1), length=3)
    want = jax_baseline.run_baseline(ds, forecast_steps=4, flow_method=method,
                                     flow_channel=flow_channel, max_batches=2,
                                     target_view=_crop_np if view else None)
    got = baseline.run_baseline(ds, forecast_steps=4, flow_method=method,
                                flow_channel=flow_channel, max_batches=2,
                                target_view=_crop_torch if view else None,
                                output_dir=str(tmp_path), device="cpu")
    for key in ("flow_loss", "baseline_loss"):
        assert got[key].shape == want[key].shape == (2, 4)
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    assert got["flow_mean"] == pytest.approx(want["flow_mean"], rel=1e-5)
    assert got["baseline_mean"] == pytest.approx(want["baseline_mean"], rel=1e-5)
    np.testing.assert_array_equal(np.load(tmp_path / "flow_loss.npy"), got["flow_loss"])


def test_run_baseline_errors_and_device():
    """Empty data and a batch shorter than the first raise as in the JAX
    harness; the default device is the card, so without one it raises."""
    short = AdvectionDataset(batch_size=1, width=8, height=8, number_sat_channels=1,
                             history_minutes=10, forecast_minutes=10, length=1)
    long = AdvectionDataset(batch_size=1, width=8, height=8, number_sat_channels=1,
                            history_minutes=10, forecast_minutes=20, length=1)
    with pytest.raises(ValueError, match="empty"):
        baseline.run_baseline(long, max_batches=0, device="cpu")
    with pytest.raises(ValueError, match="future frames"):
        baseline.run_baseline([long[0], short[0]], forecast_steps=4,
                              flow_method="horn_schunck", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            baseline.run_baseline(long)


# -- the accuracy gate -----------------------------------------------------------


def test_accuracy_gate_keeps_the_jax_study():
    """The port's tool reads the JAX tool's data and arms by value."""
    jax_gate = _load_jax_gate()
    assert accuracy_gate.DS_KW == jax_gate.DS_KW and accuracy_gate.STEPS == jax_gate.STEPS
    assert accuracy_gate.ALL_ARMS == jax_gate.ALL_ARMS
    assert accuracy_gate.EXTRA_ARMS == jax_gate.EXTRA_ARMS
    assert accuracy_gate.PORTED_ARMS == jax_gate.ALL_ARMS + jax_gate.EXTRA_ARMS


def _load_jax_gate():
    spec = importlib.util.spec_from_file_location("jax_accuracy_gate",
                                                  REPO / "tools" / "accuracy_gate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arm, item", [("metnet_stoch", 7), ("metnet", 7),
                                       ("metnet_baselines", 7)])
def test_accuracy_gate_unported_arms_raise(arm, item):
    """The arms that raised naming ROADMAP item ``item`` until it was done are
    ported: listed, no refusal naming the item left in the tool; an unknown
    arm still stops the run before any work."""
    assert arm in accuracy_gate.PORTED_ARMS
    source = Path(accuracy_gate.__file__).read_text()
    assert "NotImplementedError" not in source and f"item {item}" not in source
    with pytest.raises(SystemExit):
        accuracy_gate.main(["no_such_arm", arm], device="cpu")


def test_accuracy_gate_runs_and_writes_only_under_out(tmp_path, monkeypatch, capsys):
    """The baselines and the ConvLSTM arm on the CPU, cut to b2 16x16 and 1
    epoch (the study's own data and recipe are held above): the JAX study's
    row names and curve lengths, the baselines equal to ``run_baseline`` on
    the eval set, the JSON printed and written under ``--out`` only."""
    monkeypatch.setattr(accuracy_gate, "CONVLSTM_EPOCHS", 1)
    monkeypatch.setattr(accuracy_gate, "DS_KW", {**accuracy_gate.DS_KW, "batch_size": 2,
                                                 "width": 16, "height": 16})
    docs = {p: p.stat().st_mtime_ns for p in (REPO / "docs").glob("accuracy*")}
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "gate"
    res = accuracy_gate.main(["baselines", "convlstm"], out=str(out), device="cpu")
    assert set(res) == {"persistence", "optical_flow", "optical_flow_hs", "convlstm"}
    for row in res.values():
        assert len(row["mse_t"]) == accuracy_gate.STEPS and np.isfinite(row["mse"])
    assert res["optical_flow"]["solve"] == flow.farneback_backend()
    assert len(res["convlstm"]["ms_ssim_t"]) == accuracy_gate.STEPS
    assert res["convlstm"]["epochs"] == 1
    assert json.loads((out / "accuracy_results.json").read_text()) == {**res, "card": "cpu"}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert sorted(p.name for p in tmp_path.iterdir()) == ["gate"]
    assert docs == {p: p.stat().st_mtime_ns for p in (REPO / "docs").glob("accuracy*")}
    from satflow_tpu_torch.data.fake import DecayingAdvectionDataset

    base = baseline.run_baseline(
        DecayingAdvectionDataset(length=3, seed=300, **accuracy_gate.DS_KW),
        forecast_steps=accuracy_gate.STEPS, flow_method="horn_schunck", max_batches=3,
        device="cpu")
    np.testing.assert_allclose(res["optical_flow_hs"]["mse_t"],
                               np.mean(base["flow_loss"], axis=0), rtol=1e-12)


@pytest.mark.slow
def test_port_trained_convlstm_beats_persistence_and_flow():
    """``tests/test_accuracy.py``'s gate through the port on the CPU (slow,
    as its JAX counterpart): 16x16, 1 channel, hidden 16, 6 lead times, 12
    epochs, decay 0.8; the trained model's mean MSE below persistence and
    below both flow arms."""
    from satflow_tpu_torch.data.datamodule import SatFlowDataModule
    from satflow_tpu_torch.data.fake import DecayingAdvectionDataset
    from satflow_tpu_torch.train import Trainer

    kw = dict(batch_size=8, width=16, height=16, number_sat_channels=1,
              history_minutes=15, forecast_minutes=30, velocity=(1, 1),
              decay=0.8, n_blobs=3)

    class DecayDM(SatFlowDataModule):
        def __init__(self):
            super().__init__(fake_data=True, num_workers=0, shard=False)

        def _dataset(self, split, n):
            return DecayingAdvectionDataset(length=8, seed=accuracy_gate.SPLIT_SEEDS[split],
                                            **kw)

    eval_ds = DecayingAdvectionDataset(length=2, seed=300, **kw)
    flows = {m: baseline.run_baseline(eval_ds, forecast_steps=6, flow_method=m,
                                      max_batches=2, device="cpu")
             for m in ("farneback", "horn_schunck")}
    persist = float(np.mean(flows["farneback"]["baseline_loss"]))
    model = registry.create_model("encoderdecoderconvlstm", input_channels=1, out_channels=1,
                                  forecast_steps=6, hidden_dim=16, lr=5e-3,
                                  generator=torch.Generator().manual_seed(0))
    Trainer(max_epochs=12, log_every_n_steps=50, device="cpu").fit(model, DecayDM())
    mse = evaluate.evaluate_model(model, eval_ds, max_batches=2, compute_ms_ssim=False)
    assert mse["mse_mean"] < persist
    for m, res in flows.items():
        assert mse["mse_mean"] < res["flow_mean"], m


# -- the package exports (F5) ------------------------------------------------------

# names a JAX __init__ exports from a module the port has, whose definition
# comes with a later ROADMAP queue 1 item (not stubbed before it); none is left
PENDING: dict = {}


def _jax_exports():
    """(port package, port module, name) of every ``from satflow_tpu.x
    import name`` in the JAX ``__init__``s, read by ast (no jax import)."""
    for init in sorted((REPO / "satflow_tpu").rglob("__init__.py")):
        package = ".".join(init.relative_to(REPO).parent.parts)
        for node in ast.walk(ast.parse(init.read_text())):
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("satflow_tpu"):
                port_module = node.module.replace("satflow_tpu", "satflow_tpu_torch", 1)
                for alias in node.names:
                    yield package.replace("satflow_tpu", "satflow_tpu_torch", 1), port_module, \
                        alias.name


def _port_has(module: str) -> bool:
    path = REPO.joinpath(*module.split("."))
    return path.with_suffix(".py").exists() or (path / "__init__.py").exists()


def test_package_exports_match_the_jax_package():
    """Every name a JAX package ``__init__`` exports from a module the port
    has imports from the port's package of the same name (F5), save the
    pending ones, which their module does not define yet."""
    checked = []
    for package, module, name in _jax_exports():
        if not _port_has(module):
            continue
        if name in PENDING:
            assert not hasattr(importlib.import_module(module), name), (
                f"{module}.{name} is ported: export it from {package} and drop it from PENDING")
            continue
        assert hasattr(importlib.import_module(package), name), f"{package} lacks {name}"
        checked.append(f"{package}.{name}")
    for must in ("satflow_tpu_torch.models.create_model", "satflow_tpu_torch.models.BaseModel",
                 "satflow_tpu_torch.core.register_model", "satflow_tpu_torch.nn.get_loss",
                 "satflow_tpu_torch.data.write_fake_store", "satflow_tpu_torch.eval.evaluate_model",
                 "satflow_tpu_torch.baseline.run_baseline",
                 "satflow_tpu_torch.experiments.train",
                 "satflow_tpu_torch.interop.load_torch_convlstm",
                 "satflow_tpu_torch.interop.load_torch_state_dict",
                 "satflow_tpu_torch.train.Trainer",
                 "satflow_tpu_torch.nn.GANLoss", "satflow_tpu_torch.nn.gradient_penalty",
                 "satflow_tpu_torch.nn.ConvGRUCell", "satflow_tpu_torch.nn.SpectralNorm",
                 "satflow_tpu_torch.models.NowcastingGAN", "satflow_tpu_torch.models.CloudGAN",
                 "satflow_tpu_torch.models.Pix2Pix"):
        assert must in checked, must
    from satflow_tpu_torch.models import BaseModel, create_model, list_models  # noqa: F401

    assert list_models() == ["attentionrunet", "attentionunet", "cloudgan", "deeplabv3",
                             "encoderdecoderconvlstm", "fcn", "huggingfaceperceiver",
                             "litmetnet", "nowcastinggan", "perceiver", "pix2pix", "pixelcnn",
                             "runet", "unet"]


def test_count_parameters_matches_jax():
    """Over the module and over its state dict, the JAX counts of the same
    model's flax params."""
    from satflow_tpu.core.utils import count_parameters as jax_count
    from satflow_tpu_torch.core.utils import count_parameters

    jmodel = jax_registry.create_model("encoderdecoderconvlstm", **EV)
    params = jmodel.module.init(jax.random.PRNGKey(0), np.zeros((1, 2, 8, 8, 2), np.float32))
    want = jax_count(params["params"])
    model = registry.create_model("encoderdecoderconvlstm", **EV)
    assert count_parameters(model) == want
    assert count_parameters(model.module.state_dict()) == want
    model.module.decoder["head"].weight.requires_grad_(False)
    got = count_parameters(model)
    assert got["params/total"] == want["params/total"]
    assert got["params/trainable"] == want["params/total"] - model.module.decoder["head"].weight.numel()
