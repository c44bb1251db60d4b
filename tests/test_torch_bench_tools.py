"""The port's bench tools (``satflow_tpu_torch/tools/{bench,bench_int8,
bench_axial,bench_zoo,bench_serve,bench_train,exp_train_ceiling}.py``) on
the CPU at a small size (hidden 8, 16², 4 leads, 2 iterations), where the
kernels' wrappers run their plain versions: each prints the JAX tool's keys
plus ``card`` and ``kernel_launches``; the rollout chain, the ceiling's
``fwd`` value and the train bench's chained loss equal the JAX package's on
the same weights; unknown names and a missing card are refused."""

from __future__ import annotations

import json
import math
import types

import jax
import numpy as np
import pytest
import torch

from satflow_tpu.core import registry as jax_registry
from satflow_tpu.models.conv_lstm import ConvLSTMCore as JaxCore
import satflow_tpu.models  # noqa: F401 - populate the JAX registry
from satflow_tpu.train.state import TrainState as JaxTrainState
from satflow_tpu.train.steps import make_train_step as jax_make_train_step
from satflow_tpu_torch.interop.jax_weights import params_from_flax
from satflow_tpu_torch.tools import (
    bench,
    bench_axial,
    bench_int8,
    bench_serve,
    bench_train,
    bench_zoo,
    benchkit,
    exp_train_ceiling,
)
from satflow_tpu_torch.train.steps import make_train_step

B, T, S, C, HID, F, ITERS = 2, 3, 16, 4, 8, 4, 2
SMALL = ["--device", "cpu", "--size", str(S), "--history", str(T), "--steps", str(F),
         "--channels", str(C), "--hidden", str(HID)]
# float32 on both sides: the same convs and gate math in another order over
# the chained rollouts and steps; measured max |diff| below 1e-6
ATOL = 1e-5
KERNEL_IDS = {"K1", "K1h", "K2", "K3", "K4", "K5", "K6a", "K6b"}
ADDED = {"card", "kernel_launches"}

# (tool, argv, each printed line's JAX keys)
TRAIN = ["--batch", str(B), "--iters", str(ITERS)]
MODEL = ["--device", "cpu", "--tiny", "--batch", str(B), "--steps", str(F),
         "--iters", str(ITERS)]
STORE = SMALL + ["--batch", str(B), "--store-batches", "2", "--workers", "2"]
TRAIN_KEYS = {"metric", "value", "unit", "step_ms", "compile_s", "loss0"}
CASES = {
    "bench": (bench, SMALL + ["--iters", str(ITERS)], [{"metric", "value", "unit"}]),
    "bench_int8": (bench_int8, SMALL + ["--batch", str(B), "--iters", str(ITERS)],
                   [{"metric", "value", "unit"}, {"metric", "value", "unit", "vs_bf16"}]),
    "bench_axial": (bench_axial, ["--device", "cpu", "--iters", str(ITERS),
                                  "--shapes", "64,16,8;16,32,16"],
                    [{"N", "L", "d", "xla_ms", "pallas_ms", "speedup"}] * 2),
    "bench_zoo": (bench_zoo, ["--device", "cpu", "--tiny", "--steps", str(F),
                              "--iters", str(ITERS)],
                  [{"model", "geometry", "frames_per_sec", "step_ms"}] * 4),
    "bench_serve": (bench_serve, SMALL + ["--max-batch", "4", "--clients", "4",
                                          "--requests", "8"],
                    [{"metric", "p50_single_request_ms", "concurrent_clients", "requests",
                      "requests_per_sec", "frames_per_sec", "forwards_issued",
                      "coalescing"}]),
    "bench_train": (bench_train, SMALL + TRAIN, [TRAIN_KEYS]),
    "bench_train --model metnet": (bench_train, MODEL + ["--model", "metnet"], [TRAIN_KEYS]),
    "bench_train --model perceiver": (bench_train, MODEL + ["--model", "perceiver"],
                                      [TRAIN_KEYS]),
    "bench_train --model dgmr": (bench_train, MODEL + ["--model", "dgmr"], [TRAIN_KEYS]),
    "bench_train --gan-step split": (bench_train, MODEL + ["--model", "dgmr", "--gan-step",
                                                           "split"], [TRAIN_KEYS]),
    "bench_train --from-store": (bench_train, STORE + ["--from-store"],
                                 [{"metric", "value", "unit", "note"}]),
    "bench_train --pipeline-only": (bench_train, STORE + ["--pipeline-only", "--from-store"],
                                    [{"metric", "value", "unit", "mb_per_s"}]),
    "exp_train_ceiling": (exp_train_ceiling, SMALL + TRAIN,
                          [{"geometry", "fwd", "fwd+bwd", "step", "opt"}]),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are tiny, and a tool's iteration is
    thousands of small ops, which threads only slow down when the suite runs
    in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _finite(value) -> bool:
    if isinstance(value, dict):
        return all(_finite(v) for v in value.values())
    return not isinstance(value, float) or math.isfinite(value)


@pytest.mark.parametrize("case", list(CASES))
def test_tool_prints_the_jax_keys(case, capsys, monkeypatch, tmp_path):
    tool, argv, want = CASES[case]
    if argv[-1] == "--from-store":
        argv = argv + [str(tmp_path)]
    monkeypatch.setenv("BENCH_BATCH", str(B))
    tool.main(argv)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [set(r) for r in lines] == [keys | ADDED for keys in want]
    for r in lines:
        assert r["card"] == "cpu" and _finite(r)
        per = r["kernel_launches"]
        # a CPU run launches no kernel: each wrapper took its plain version
        for counts in (per.values() if case == "exp_train_ceiling" else [per]):
            assert counts == dict.fromkeys(KERNEL_IDS, 0)


@pytest.fixture(scope="module")
def jax_weights():
    """The JAX core's initial variables at the small size, randomised."""
    core = JaxCore(hidden_dim=HID, out_channels=C, forecast_steps=F)
    shapes = jax.eval_shape(core.init, jax.random.PRNGKey(0),
                            np.zeros((1, T, S, S, C), np.float32))
    rng = np.random.default_rng(0)
    return core, jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.3).astype(np.float32), shapes)


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.random((B, T, S, S, C), dtype=np.float32),
            rng.random((B, F, S, S, C), dtype=np.float32))


def _args():
    return types.SimpleNamespace(channels=C, steps=F, hidden=HID, cell="fused", remat=True,
                                 remat_chunk=0, batch=B, history=T, size=S)


def test_rollout_chain_matches_jax(jax_weights):
    """bench's chain: ITERS rollouts, each fed its first T output frames."""
    core, variables = jax_weights
    x = _batch(1)[0]
    want, apply = x, jax.jit(core.apply)
    for _ in range(ITERS):
        want = np.asarray(apply(variables, want))[:, :T]
    port = bench.build("fused", HID, C, F, True, torch.float32, torch.device("cpu"))
    port.load_state_dict(params_from_flax(variables))
    with torch.inference_mode():
        got, _, per = benchkit.chain(bench.rollout(port, T), torch.from_numpy(x), ITERS,
                                     torch.device("cpu"))
    assert got.shape == (B, T, S, S, C) and set(per) == KERNEL_IDS
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_ceiling_fwd_value_matches_jax(jax_weights):
    """exp_train_ceiling's ``fwd`` rung value: the training loss of a batch."""
    _, variables = jax_weights
    batch = _batch(2)
    jmodel = jax_registry.create_model("encoderdecoderconvlstm", input_channels=C,
                                       out_channels=C, forecast_steps=F, hidden_dim=HID)
    want = float(jmodel.loss(variables["params"], {}, batch, jax.random.PRNGKey(0))[0])
    model, _, _ = exp_train_ceiling.build(_args(), torch.device("cpu"), torch.float32)
    model.module.load_state_dict(params_from_flax(variables))
    got = exp_train_ceiling.loss_value(model, tuple(torch.from_numpy(a) for a in batch))
    assert abs(float(got) - want) <= ATOL


def test_train_bench_chained_loss_matches_jax(jax_weights):
    """bench_train's chain: the losses of ITERS Adam steps on one batch,
    summed, against the JAX make_train_step's."""
    _, variables = jax_weights
    batch = _batch(3)
    jmodel = jax_registry.create_model("encoderdecoderconvlstm", input_channels=C,
                                       out_channels=C, forecast_steps=F, hidden_dim=HID)
    jstate = JaxTrainState.create(variables["params"], {}, jmodel.make_optimizer())
    jstep, want = jax_make_train_step(jmodel), 0.0
    for _ in range(ITERS):
        jstate, m = jstep(jstate, batch, jax.random.PRNGKey(0))
        want += float(m["loss"])
    model, state = bench_train.convlstm(_args(), torch.device("cpu"), torch.float32)
    model.module.load_state_dict(params_from_flax(variables))
    total, _, _ = bench_train.chained_steps(make_train_step(model), state,
                                            tuple(torch.from_numpy(a) for a in batch), ITERS,
                                            torch.device("cpu"))
    assert state.step == ITERS
    assert abs(float(total) - want) <= ATOL


def test_unknown_cell_impl_raises(monkeypatch):
    monkeypatch.setenv("BENCH_CELL_IMPL", "bogus")
    with pytest.raises(ValueError, match="Unknown cell_impl 'bogus'"):
        bench.main(SMALL)


def test_unknown_zoo_name_raises():
    with pytest.raises(ValueError, match="--only metnett"):
        bench_zoo.main(["--device", "cpu", "--tiny", "--only", "metnet,metnett"])


def test_ceiling_refuses_the_tpu_ablations():
    with pytest.raises(ValueError, match="not ported"):
        exp_train_ceiling.main(["--device", "cpu", "--skip", "step[save-gates]"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the refusal on a machine "
                    "without a card")
@pytest.mark.parametrize("tool", [bench, bench_int8, bench_axial, bench_zoo, bench_serve,
                                  bench_train, exp_train_ceiling],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tools_default_to_the_card(tool):
    """Every tool runs on ``cuda`` unless asked for the CPU, and raises
    without a card."""
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tool.main([])
