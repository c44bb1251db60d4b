"""PyTorch port, MetNet serving and training entry points on the CPU: the
session and the HTTP server against the JAX session on the same flax
variables (params and ``batch_stats``), the ``.npz`` round trip, the
``metnet`` server config, the Trainer on the fake datamodule (whose 23 input
channels the model infers) and the ``run`` CLI. Tolerance of the served
forecasts against the JAX session: 1e-4, as for the f32 model forward."""

import io
import urllib.request

import jax
import numpy as np
import pytest
import torch

from satflow_tpu.core.registry import create_model as jax_create_model
import satflow_tpu.models  # noqa: F401 - populate the JAX registry
from satflow_tpu.serve.session import InferenceSession as JaxSession
from satflow_tpu_torch.core.registry import create_model
from satflow_tpu_torch.data import SatFlowDataModule
from satflow_tpu_torch.interop.jax_weights import (
    metnet_state_dict_from_flax,
    read_npz,
    save_npz,
)
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.serve import InferenceSession, NowcastServer
from satflow_tpu_torch.serve.server import build_model
from satflow_tpu_torch.train import Trainer

B, T, H, W, C, F = 3, 2, 32, 32, 12, 2
KW = dict(forecast_steps=F, hidden_dim=8, output_channels=C, temporal_dropout=0.0)


def _variables(seed=0, **kw):
    model = jax_create_model("litmetnet", **{**KW, **kw})
    v = model.module.init(jax.random.PRNGKey(0), np.zeros((1, T, H, W, C), np.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        scale = 0.3 if "kernel" in jax.tree_util.keystr(path) else 0.1
        out = rng.normal(size=np.shape(a)) * scale
        return (np.abs(out) + 0.5 if "var" in jax.tree_util.keystr(path) else out).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, v))


@pytest.fixture(scope="module")
def variables():
    return _variables()


def _x(seed=1, b=B):
    return np.random.default_rng(seed).random((b, T, H, W, C)).astype(np.float32)


def test_session_matches_jax_session(variables):
    """Padding (3 -> 2 x max_batch 2) and chunking on both sides, float32;
    the BatchNorm running statistics come with the variables."""
    x = _x()
    want = JaxSession(jax_create_model("litmetnet", **KW), max_batch=2,
                      variables=variables).predict(x)
    s = InferenceSession(create_model("litmetnet", **KW), max_batch=2, variables=variables)
    got = s.predict(x)
    assert got.shape == want.shape == (B, F, H // 16, W // 16, C)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(s.predict(x[0]), want[0], atol=1e-4)


def test_session_by_registry_name_and_bf16():
    """``InferenceSession("litmetnet", variables=...)`` builds the registry's
    default model (hidden 64, 48 steps) and takes its widths from the
    variables; ``dtype=bf16`` computes in bf16 and serves the f32 head's
    output as float16 when asked."""
    v = _variables(seed=2, forecast_steps=48, hidden_dim=64)
    s = InferenceSession("litmetnet", max_batch=1, variables=v, dtype=torch.bfloat16,
                         out_dtype=torch.float16)
    assert s.model.module.dtype == torch.bfloat16
    y = s.predict(_x(seed=3, b=1))
    assert y.shape == (1, 48, H // 16, W // 16, C) and y.dtype == np.float16
    assert np.isfinite(y).all()


def test_npz_round_trip_keeps_batch_stats(tmp_path, variables):
    path = tmp_path / "metnet.npz"
    save_npz(path, variables)
    back = read_npz(path)
    assert set(back) == {"params", "batch_stats"}
    want, got = metnet_state_dict_from_flax(variables), metnet_state_dict_from_flax(back)
    assert list(got) == list(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_server_config_and_http_round_trip(variables):
    model = build_model("metnet")
    assert type(model).__name__ == "LitMetNet" and model.forecast_steps == 24
    assert model.hidden_dim == 64 and model.output_channels == 12 and model.input_size == 64
    srv = NowcastServer(create_model("litmetnet", **KW), port=0, max_batch=2,
                        variables=variables)
    srv.start()
    try:
        x = _x(seed=4, b=1)[0]
        buf = io.BytesIO()
        np.save(buf, x)
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/predict",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            y = np.load(io.BytesIO(r.read()))
        assert y.shape == (F, H // 16, W // 16, C)
        np.testing.assert_allclose(y, srv.session.predict(x), atol=1e-6)
    finally:
        srv.close()


def test_trainer_fits_metnet_on_fake_data_with_inferred_width():
    """The fake datamodule gives 12 satellite + 1 topography + 10 NWP = 23
    channels while the model says 12: the Trainer creates the input conv from
    the first batch (4 x 23 + F input channels), then trains."""
    dm = SatFlowDataModule(fake_data=True, num_workers=0, n_train_data=2, n_val_data=1,
                           history_minutes=5 * (T - 1), forecast_minutes=5 * F,
                           fake_kwargs=dict(batch_size=2, width=W, height=H))
    model = create_model("litmetnet", warmup_steps=1, total_steps=10, **KW)
    trainer = Trainer(max_steps=2, log_every_n_steps=1)
    trainer.fit(model, dm)
    assert trainer.global_step == 2
    assert model.module.image_encoder.c0.weight.shape[1] == 4 * 23 + F
    losses = [e["train/loss"] for e in trainer.history.history if "train/loss" in e]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert np.isfinite(trainer.callback_metrics["val/loss"])
    assert trainer.current_lr() == pytest.approx(model.lr_schedule(2))
    assert model.module.image_encoder.bn0.mean.abs().sum() > 0  # running statistics moved


def test_cli_trains_metnet(tmp_path, monkeypatch):
    """``python -m satflow_tpu_torch.run model=metnet datamodule=fake
    trainer=minimal`` at small widths: 2 steps, then a metrics.csv."""
    from satflow_tpu_torch.run import main

    monkeypatch.chdir(tmp_path)
    result = main(["model=metnet", "datamodule=fake", "trainer=minimal", "callbacks=none",
                   "model.hidden_dim=8", "model.forecast_steps=2", "trainer.max_steps=2",
                   "trainer.log_every_n_steps=1", f"work_dir={tmp_path / 'runs'}",
                   "print_config=false"])
    assert result is not None and np.isfinite(result)
    csvs = list((tmp_path / "runs").rglob("metrics.csv"))
    assert len(csvs) == 1
    header = csvs[0].read_text().splitlines()[0].split(",")
    assert {"train/loss", "val/loss", "test/loss"} <= set(header)
