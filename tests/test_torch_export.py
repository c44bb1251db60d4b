"""PyTorch port, ``serve/export.py``: one artifact (the JAX format's header,
then a ``torch.export`` program) from the ConvLSTM, MetNet and the zoo,
loaded without any model module, against the ``InferenceSession`` reply on
the same input (the same ops on the same weights: bit-equal on the CPU);
the CLI from a ``local:`` checkpoint, mirroring ``tests/test_serve.py``'s
StableHLO tests; the refusals; and the kernels' dispatcher ops (K1, K1h, K3,
K4, K6a, K6b) checked by ``torch.library.opcheck``: their fake
implementations against the real outputs, on the CPU, where the op runs the
plain version. The halo step is exported under ``SATFLOW_STEP_VARIANT=halo``
and its program called without it (it runs the recorded op); the
channel-major decoder at W = 128, the least width it runs at."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import satflow_tpu_torch.models  # noqa: F401 - populate the registry
from satflow_tpu_torch.core import registry
from satflow_tpu_torch.serve.export import export_model, load_exported, main as export_main
from satflow_tpu_torch.serve.session import InferenceSession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, H, W, C, STEPS = 2, 3, 16, 16, 2, 3
# (registry name, keywords, image size, the ops the program holds)
MODELS = {
    "convlstm": ("encoderdecoderconvlstm", dict(hidden_dim=8, out_channels=C), 16,
                 {"satflow.fused_convlstm_step.default"}),
    "convlstm_halo": ("encoderdecoderconvlstm", dict(hidden_dim=8, out_channels=C), 16,
                      {"satflow.fused_convlstm_step_halo.default"}),
    "convlstm_cmajor": ("encoderdecoderconvlstm",
                        dict(hidden_dim=8, out_channels=C, cell_impl="cmajor"), 128,
                        {"satflow.fused_convlstm_step.default",
                         "satflow.cmajor_convlstm_step.default", "satflow.cmajor_conv3x3.default"}),
    "convlstm_concat": ("encoderdecoderconvlstm",
                        dict(hidden_dim=8, out_channels=C, cell_impl="concat"), 16,
                        {"satflow.fused_lstm_gates.default"}),
    "metnet": ("litmetnet", dict(hidden_dim=8, output_channels=C, temporal_dropout=0.0), 64,
               {"satflow.fused_lstm_gates.default", "satflow.axial_attention.default"}),
    "unet": ("unet", dict(features_start=4, depth=3), 16, set()),
    "deeplabv3": ("deeplabv3", {}, 64, set()),
    "pixelcnn": ("pixelcnn", dict(hidden_channels=8, num_blocks=1), 16, set()),
}


def _model(key, seed=0):
    name, kw, size, _ = MODELS[key]
    torch.manual_seed(seed)
    model = registry.create_model(name, input_channels=C, forecast_steps=STEPS,
                                  generator=torch.Generator().manual_seed(seed), **kw)
    x = np.random.default_rng(seed).random((B, T, size, size, C)).astype(np.float32)
    model.materialize((torch.from_numpy(x), torch.from_numpy(x)))
    return model, x


def _ops(program):
    return {str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("satflow.")}


@pytest.fixture(autouse=True)
def _small_backbone(monkeypatch):
    """DeepLabV3 on a ResNet of stages (1, 1, 1, 1) and width 4 (ResNet-50
    costs seconds a forward on the CPU); its blocks are the same."""
    import satflow_tpu_torch.models.segmentation as seg
    from satflow_tpu_torch.nn.resnet import ResNetBackbone

    monkeypatch.setattr(seg, "ResNetBackbone", lambda stages, **kw: ResNetBackbone(
        (1, 1, 1, 1), width=4, **kw))


@pytest.mark.parametrize("key", list(MODELS))
def test_export_roundtrip_matches_the_session(tmp_path, monkeypatch, key):
    """The artifact's reply equals the session's on the same weights and
    input, bit for bit; the metadata holds the JAX keys; the program holds
    the kernels' ops (none for the zoo); a wrong shape and a bad magic raise
    the JAX package's errors. The halo model is served and exported under
    ``SATFLOW_STEP_VARIANT=halo`` and its program called without it."""
    if key == "convlstm_halo":
        monkeypatch.setenv("SATFLOW_STEP_VARIANT", "halo")
    model, x = _model(key)
    want = InferenceSession(model, max_batch=B, state_dict=model.module.state_dict(),
                            device="cpu").predict(x)
    path = str(tmp_path / "model.pt2")
    meta = export_model(model, None, path, batch=B, history=T, size=x.shape[2], channels=C)
    monkeypatch.delenv("SATFLOW_STEP_VARIANT", raising=False)
    assert set(meta) == {"model", "in_shape", "out_shape", "platforms", "forecast_steps"}
    assert meta["in_shape"] == list(x.shape) and meta["out_shape"] == list(want.shape)
    assert meta["platforms"] == ["cpu"] and meta["forecast_steps"] == STEPS
    art = load_exported(path)
    assert art.meta == meta
    assert _ops(art.program) == MODELS[key][3]
    np.testing.assert_array_equal(art(x), want)
    with pytest.raises(ValueError, match="fixed at export time"):
        art(x[:1])
    bad = tmp_path / "bad.pt2"
    bad.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="magic"):
        load_exported(str(bad))


def test_export_bf16_and_half_reply():
    """``dtype=bfloat16`` computes in bf16 on the f32 weights, as the
    session does (same reply), and the reply may leave in float16; bfloat16
    cannot (numpy has none). A session passed as the model is exported in
    its own dtypes, with the same reply."""
    import tempfile

    model, x = _model("unet")
    sd = {k: v.clone() for k, v in model.module.state_dict().items()}
    session = InferenceSession(model, max_batch=B, state_dict=sd, dtype=torch.bfloat16,
                               out_dtype=torch.float16, device="cpu")
    want = session.predict(x)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "m.pt2")
        export_model(model, sd, path, batch=B, history=T, size=H, channels=C,
                     dtype=torch.bfloat16, out_dtype=torch.float16)
        got = load_exported(path)(x)
        assert got.dtype == np.float16
        np.testing.assert_array_equal(got, want)
        export_model(session, None, path, batch=B, history=T, size=H, channels=C)
        np.testing.assert_array_equal(load_exported(path)(x), want)
        with pytest.raises(ValueError, match="numpy has no bfloat16"):
            export_model(model, None, path, batch=B, history=T, size=H, channels=C,
                         out_dtype=torch.bfloat16)


def test_export_cli_from_checkpoint(tmp_path):
    """End to end: a train-state checkpoint -> ``python -m
    satflow_tpu_torch.serve.export local:<dir> out --device cpu`` -> load ->
    predict, equal to the session served from the same ``local:`` source."""
    from satflow_tpu_torch.train import TrainState
    from satflow_tpu_torch.train.checkpoint import save_checkpoint

    model = registry.create_model("encoderdecoderconvlstm", input_channels=C, out_channels=C,
                                  forecast_steps=STEPS, hidden_dim=4,
                                  generator=torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, TrainState(model, model.make_optimizer()), model)
    out = str(tmp_path / "model.pt2")
    export_main([f"local:{ckpt}", out, "--batch", "1", "--history", str(T), "--size", str(H),
                 "--channels", str(C), "--device", "cpu"])
    art = load_exported(out)
    xr = np.random.default_rng(5).random((1, T, H, W, C)).astype(np.float32)
    y = art(xr)
    assert y.shape == (1, STEPS, H, W, C) and np.isfinite(y).all()
    np.testing.assert_array_equal(
        y, InferenceSession(f"local:{ckpt}", max_batch=1, device="cpu").predict(xr))


def test_export_cli_refusals(tmp_path, monkeypatch):
    """The CLI refuses a GAN model (as the JAX one) and a model without
    restored weights; ``export_model`` refuses an int8 session only (the JAX
    ``export_model`` has no int8 export), and exports the halo step and the
    channel-major decoder, which it refused before they had dispatcher ops."""
    import satflow_tpu_torch.core.registry as reg

    class Gan:
        is_gan = True

    unrestored = _model("unet")[0]
    monkeypatch.setattr(reg, "create_model", lambda source: Gan())
    with pytest.raises(SystemExit, match="forward models only"):
        export_main(["local:x", str(tmp_path / "o.pt2"), "--device", "cpu"])
    monkeypatch.setattr(reg, "create_model", lambda source: unrestored)
    with pytest.raises(SystemExit, match="no restored_variables"):
        export_main(["local:x", str(tmp_path / "o.pt2"), "--device", "cpu"])
    monkeypatch.undo()

    model, x = _model("convlstm")
    kw = dict(batch=1, history=1, channels=C)
    monkeypatch.setenv("SATFLOW_STEP_VARIANT", "halo")
    meta = export_model(model, None, str(tmp_path / "h.pt2"), size=8, **kw)  # H % 8 == 0
    monkeypatch.delenv("SATFLOW_STEP_VARIANT")
    assert meta["in_shape"] == [1, 1, 8, 8, C]
    assert _ops(load_exported(str(tmp_path / "h.pt2")).program) == {
        "satflow.fused_convlstm_step_halo.default"}
    cm = registry.create_model("encoderdecoderconvlstm", input_channels=C, out_channels=C,
                               forecast_steps=1, hidden_dim=8, cell_impl="cmajor")
    meta = export_model(cm, None, str(tmp_path / "c.pt2"), size=128, **kw)  # W % 128 == 0
    assert meta["out_shape"] == [1, 1, 128, 128, C]
    assert {"satflow.cmajor_convlstm_step.default", "satflow.cmajor_conv3x3.default"} <= _ops(
        load_exported(str(tmp_path / "c.pt2")).program)
    # an int8 session serves its rollout, not its model's forward: passed
    # itself, it is refused (its model alone is the float32 model it was built from)
    session = InferenceSession(model, max_batch=B, state_dict=model.module.state_dict(),
                               quantize="int8", device="cpu")
    with pytest.raises(NotImplementedError, match="JAX export_model has no int8 export"):
        export_model(session, None, str(tmp_path / "q.pt2"), batch=B, history=T, size=H,
                     channels=C)


def test_loading_an_artifact_imports_no_model_module_and_no_jax(tmp_path):
    """A fresh process that imports ``torch`` and loads the artifacts of
    MetNet and of the channel-major ConvLSTM (which import
    ``satflow_tpu_torch.ops`` for the kernels' ops) gives the same replies and
    imports no model, registry or config module, and no jax."""
    paths = []
    for key in ("metnet", "convlstm_cmajor"):
        model, x = _model(key)
        path = str(tmp_path / f"{key}.pt2")
        export_model(model, None, path, batch=B, history=T, size=x.shape[2], channels=C)
        np.save(tmp_path / f"{key}_x.npy", x)
        np.save(tmp_path / f"{key}_y.npy", load_exported(path)(x))
        paths.append((path, str(tmp_path / f"{key}_x.npy"), str(tmp_path / f"{key}_y.npy")))
    code = (
        "import sys, numpy as np, torch\n"
        "from satflow_tpu_torch.serve.export import load_exported\n"
        f"for path, x, y in {paths!r}:\n"
        "    assert np.array_equal(load_exported(path)(np.load(x)), np.load(y)), path\n"
        "mods = sorted(m for m in sys.modules if m.startswith('satflow_tpu_torch.'))\n"
        "bad = [m for m in mods if m.split('.')[1] in ('models', 'core', 'nn', 'train',\n"
        "                                               'experiments', 'interop', 'data')]\n"
        "assert not bad, bad\n"
        "assert not {m.split('.')[0] for m in sys.modules} & {'jax', 'flax', 'optax',\n"
        "                                                    'satflow_tpu'}\n"
        "print(','.join(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "satflow_tpu_torch.ops.fused_lstm" in out.stdout
    assert "satflow_tpu_torch.ops.cmajor_convlstm" in out.stdout


def _ops_args():
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    return {
        # K1 at a width it is built for and at one the launch pads (12)
        "fused_convlstm_step": [(t(2, 5, 6, 3), t(2, 5, 6, ch), t(2, 5, 6, ch),
                                 t(3, 3, 3, 4 * ch), t(3, 3, ch, 4 * ch), t(4 * ch))
                                for ch in (8, 12)],
        # K1h: H a multiple of its 8-row blocks, at a built width and a padded one
        "fused_convlstm_step_halo": [(t(2, 16, 6, 3), t(2, 16, 6, ch), t(2, 16, 6, ch),
                                      t(3, 3, 3, 4 * ch), t(3, 3, ch, 4 * ch), t(4 * ch))
                                     for ch in (8, 12)],
        "fused_lstm_gates": [(t(7, 5, 32), t(7, 5, 8)), (t(3, 16), t(3, 4))],
        "axial_attention": [(t(6, 16, 8), t(6, 16, 8), t(6, 16, 8))],
        # K6a and K6b on (B, C, H*W) carries of a 5 x 6 image
        "cmajor_convlstm_step": [(t(2, 3, 30), t(2, ch, 30), t(2, ch, 30), t(3, 3, 3, 4 * ch),
                                  t(3, 3, ch, 4 * ch), t(4 * ch), 5, 6) for ch in (8, 12)],
        "cmajor_conv3x3": [(t(2, 8, 30), t(3, 3, 8, 4), t(4), 5, 6)],
    }


OPS = ["fused_convlstm_step", "fused_convlstm_step_halo", "fused_lstm_gates", "axial_attention",
       "cmajor_convlstm_step", "cmajor_conv3x3"]


@pytest.mark.parametrize("op", OPS)
def test_kernel_ops_pass_opcheck(op):
    """``torch.library.opcheck``: the schema, the fake implementation's
    shapes, strides and dtypes against the real (CPU: plain) outputs, and
    the op under tracing; float32 and bfloat16."""
    for args in _ops_args()[op]:
        for dtype in (torch.float32, torch.bfloat16):
            torch.library.opcheck(getattr(torch.ops.satflow, op).default,
                                  tuple(a.to(dtype) if isinstance(a, torch.Tensor) else a
                                        for a in args),
                                  test_utils=("test_schema", "test_faketensor"))
