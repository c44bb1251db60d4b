"""PyTorch port, serving: ``InferenceSession`` against the JAX session on the
same weights, the HTTP server, the device rules and the no-jax import rule.
(The card-only kernel test is ``tests/test_torch_gpu.py``.)"""

import io
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from satflow_tpu.core.registry import create_model as jax_create_model
import satflow_tpu.models  # noqa: F401 - populate the JAX registry
from satflow_tpu.serve.session import InferenceSession as JaxSession
import satflow_tpu_torch
from satflow_tpu_torch.core.registry import create_model
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.serve import InferenceSession, MicroBatcher, NowcastServer

B, T, H, W, C, STEPS = 3, 3, 16, 16, 4, 2
KW = dict(input_channels=C, out_channels=C, forecast_steps=STEPS, hidden_dim=8)


@pytest.fixture(scope="module")
def variables():
    model = jax_create_model("encoderdecoderconvlstm", **KW)
    v = model.module.init(jax.random.PRNGKey(0), np.zeros((1, T, H, W, C), np.float32))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.3).astype(np.float32), v)


def _session(variables, device="cpu", **kwargs):
    return InferenceSession(create_model("encoderdecoderconvlstm", **KW),
                            variables=variables, device=device, **kwargs)


def test_predict_matches_jax_session(variables):
    """Padding (3 -> 2 x max_batch 2) and chunking on both sides, float32;
    tolerance 1e-5 as for the model forward (measured ~2e-7)."""
    x = np.random.default_rng(1).random((B, T, H, W, C)).astype(np.float32)
    want = JaxSession(jax_create_model("encoderdecoderconvlstm", **KW), max_batch=2,
                      variables=variables).predict(x)
    s = _session(variables, max_batch=2)
    got = s.predict(x)
    assert got.shape == want.shape == (B, STEPS, H, W, C) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(s.predict(x[0]), want[0], atol=1e-5)  # single sample


def test_session_options(variables):
    s = _session(variables, max_batch=2, dtype=torch.bfloat16, out_dtype=torch.float16)
    y = s.predict(np.zeros((1, T, H, W, C), np.float32))
    assert y.dtype == np.float16 and y.shape == (1, STEPS, H, W, C)
    assert s.info()["max_batch"] == 2 and s.info()["device"] == "cpu"
    with pytest.raises(ValueError, match="expected"):
        s.predict(np.zeros((1, T, H, W, C + 1), np.float32))
    model = create_model("encoderdecoderconvlstm", **KW)
    # no weights given and none restored into the model: the JAX message
    with pytest.raises(ValueError, match="has no restored_variables"):
        InferenceSession(model)
    with pytest.raises(ValueError, match="at most one"):
        InferenceSession(model, variables=variables, state_dict={})
    with pytest.raises(NotImplementedError, match="item 13"):
        InferenceSession(model, variables=variables, mesh=object())
    with pytest.raises(ValueError, match="unknown quantize mode"):
        InferenceSession(model, variables=variables, quantize="int4")


def test_cuda_without_a_card_raises(variables, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        satflow_tpu_torch.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        _session(variables, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):  # the card by default
        InferenceSession(create_model("encoderdecoderconvlstm", **KW), variables=variables)


def test_microbatcher_coalesces_concurrent_requests(variables):
    mb = MicroBatcher(_session(variables, max_batch=8), window_ms=100.0)
    try:
        x = np.random.default_rng(2).random((T, H, W, C)).astype(np.float32)
        results, errs = [None] * 6, []

        def call(i):
            try:
                results[i] = mb.submit(x, timeout=60.0)
            except Exception as e:  # noqa: BLE001 - asserted below
                errs.append(e)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errs and not any(t.is_alive() for t in threads)
        for r in results:
            np.testing.assert_allclose(r, results[0], atol=1e-6)
        assert mb.batches_run <= 3  # 6 concurrent singles did not run as 6 forwards
    finally:
        mb.close()


def test_http_round_trip(variables):
    srv = NowcastServer(create_model("encoderdecoderconvlstm", **KW), port=0,
                        max_batch=2, variables=variables, device="cpu")
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert r.status == 200 and r.read() == b"ok"
        with urllib.request.urlopen(base + "/info", timeout=30) as r:
            info = json.loads(r.read())
        assert info["class"] == "EncoderDecoderConvLSTM" and info["max_batch"] == 2
        x = np.random.default_rng(3).random((T, H, W, C)).astype(np.float32)
        buf = io.BytesIO()
        np.save(buf, x)
        req = urllib.request.Request(base + "/predict", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            y = np.load(io.BytesIO(r.read()))
        np.testing.assert_allclose(y, srv.session.predict(x), atol=1e-6)
        assert y.shape == (STEPS, H, W, C)
        bad = urllib.request.Request(base + "/predict", data=b"not npy", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 400
        buf = io.BytesIO()
        np.save(buf, np.zeros((T, H, W, C + 1), np.float32))  # wrong channel count
        wrong = urllib.request.Request(base + "/predict", data=buf.getvalue(), method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(wrong, timeout=30)
        assert e.value.code == 400
    finally:
        srv.close()


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import satflow_tpu_torch, satflow_tpu_torch.models, satflow_tpu_torch.serve.server\n"
        "import satflow_tpu_torch.interop.jax_weights, satflow_tpu_torch.ops._build\n"
        "import satflow_tpu_torch.eval, satflow_tpu_torch.baseline, satflow_tpu_torch.ops.ssim\n"
        "import satflow_tpu_torch.ops.flow, satflow_tpu_torch.tools.accuracy_gate\n"
        "import satflow_tpu_torch.core, satflow_tpu_torch.nn, satflow_tpu_torch.data\n"
        "import satflow_tpu_torch.experiments\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert not any(m.startswith('satflow_tpu.') or m == 'satflow_tpu' for m in sys.modules)\n"
        "assert not {'flax', 'optax'} & set(sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr

