"""PyTorch port, the quality study tools (``satflow_tpu_torch/tools``):
``accuracy_gate`` (its MetNet arms), ``accuracy_256``, ``gan_gate``,
``gan_128`` and ``horizon_gate`` against the JAX package's ``tools/*.py``.

Held here, on the CPU: the data constants, arms and recipes equal the JAX
tools' (the recipes read from the JAX sources' ``create_model`` calls);
``_to_metnet_grid`` bit-equal to JAX's; the oracle sampler's and
persistence's rows within 1e-6 of the JAX functions on the same 16 px eval
set; ``CRPSSelect`` picking the lowest CRPS and keeping that epoch's
weights bit for bit through later optimizer steps; each tool's ``main`` at 1
epoch of 1 batch on a 16 px geometry (32 px where DGMR needs it), narrowed,
writing only under ``--out``, reruns merging, each trained row's
``kernel_launches`` zero (no kernel launches on the CPU); the results file
under ``--out`` kept whole by runs side by side (each save overlays its own
rows on the file as it stands, under a lock on the directory), refused when
stamped with another card; ``tools/side_by_side.py``'s process specs. The
studies' results at their budgets are held by
``tests/test_torch_study_artifacts.py``.
"""

import ast
import copy
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.core.registry import create_model
from satflow_tpu_torch.data.fake import DecayingAdvectionDataset, StochasticAdvectionDataset
from satflow_tpu_torch.tools import accuracy_256, accuracy_gate, gan_128, gan_gate, horizon_gate
from satflow_tpu_torch.tools import studies
from satflow_tpu_torch.train import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = {"accuracy_gate": accuracy_gate, "accuracy_256": accuracy_256, "gan_gate": gan_gate,
        "gan_128": gan_128, "horizon_gate": horizon_gate}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: tiny tensors, thousands of small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tool(name):
    """The JAX package's ``tools/{name}.py`` as a module (it imports jax
    inside its functions only)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_recipes(name, model):
    """The keywords of every ``create_model(model, ...)`` call of the JAX
    tool that evaluate from its module's constants alone (a keyword built
    from a local, e.g. ``total_steps=epochs_m * 12``, is left out)."""
    mod = _jax_tool(name)
    calls = []
    for node in ast.walk(ast.parse(open(mod.__file__).read())):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "create_model"
                and isinstance(node.args[0], ast.Constant) and node.args[0].value == model):
            kw = {}
            for k in node.keywords:
                try:
                    kw[k.arg] = eval(compile(ast.Expression(k.value), "<kw>", "eval"),
                                     vars(mod))
                except NameError:
                    continue
            calls.append(kw)
    assert calls, f"no create_model({model!r}) in tools/{name}.py"
    return calls


def _jax_assigned(name, var):
    """The constants assigned to ``var`` (or passed to ``_epochs``) in the JAX tool."""
    mod = _jax_tool(name)
    values = []
    for node in ast.walk(ast.parse(open(mod.__file__).read())):
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == var
                                                for t in node.targets):
            v = node.value
            if isinstance(v, ast.Call):  # _epochs(150) / int(os.environ.get(..., "150"))
                v = v.args[-1] if getattr(v.func, "id", None) == "_epochs" else v.args[0].args[-1]
            values.append(int(ast.literal_eval(v)))
    return values


# -- the tools' data, arms and recipes -------------------------------------------------------


@pytest.mark.parametrize("tool, names", [
    ("accuracy_gate", ("DS_KW", "STEPS", "ALL_ARMS", "EXTRA_ARMS")),
    ("accuracy_256", ("DS256", "STEPS")),
    ("gan_gate", ("DS_KW", "STEPS", "ALL_ARMS")),
    ("gan_128", ("DS128", "STEPS", "EVAL_BATCHES")),
    ("horizon_gate", ("DS48", "STEPS", "ALL_ARMS")),
])
def test_data_constants_equal_the_jax_tools(tool, names):
    jax_tool = _jax_tool(tool)
    for name in names:
        assert getattr(PORT[tool], name) == getattr(jax_tool, name), name


def _port_recipes():
    h = horizon_gate.RECIPES
    return [
        ("accuracy_gate", "litmetnet", accuracy_gate.METNET),
        ("accuracy_256", "encoderdecoderconvlstm", accuracy_256.MODEL),
        ("gan_gate", "cloudgan", gan_gate.CLOUDGAN),
        ("gan_gate", "pix2pix", gan_gate.PIX2PIX),
        ("gan_gate", "nowcastinggan", gan_gate.DGMR),
        ("gan_128", "nowcastinggan", gan_128.DGMR),
        *[("horizon_gate", name, kw) for name, _, kw in h.values()],
    ]


@pytest.mark.parametrize("tool, model, recipe", _port_recipes(),
                         ids=[f"{t}-{m}" for t, m, _ in _port_recipes()])
def test_recipes_equal_the_jax_tools(tool, model, recipe):
    """Every keyword the JAX tool passes as a constant is the port's, for
    every call of that model (the deterministic and the stochastic arm)."""
    for jax_kw in _jax_recipes(tool, model):
        assert {k: recipe.get(k, "missing") for k in jax_kw} == jax_kw


def test_budgets_and_the_metnet_recipe_equal_the_jax_tools():
    """The MetNet arms: 150 epochs of 12 batches under warmup_cosine with a
    100-step warm-up (the schedule's keywords are built from locals in the
    JAX tool); the other budgets."""
    assert _jax_assigned("accuracy_gate", "epochs_m") == [150]
    assert _jax_assigned("accuracy_gate", "epochs_ms") == [150]
    assert accuracy_gate.METNET_EPOCHS == 150 and accuracy_gate.METNET["warmup_steps"] == 100
    src = open(os.path.join(REPO, "tools", "accuracy_gate.py")).read()
    assert src.count("warmup_steps=100, total_steps=epochs_m * 12") == 1
    assert src.count("warmup_steps=100, total_steps=epochs_ms * 12") == 1
    assert gan_gate.EPOCHS == {"cloudgan": _jax_assigned("gan_gate", "epochs_cg")[0],
                               "pix2pix": _jax_assigned("gan_gate", "epochs_p")[0]}
    assert _jax_assigned("gan_gate", "epochs_dg") == [150]
    assert _jax_assigned("gan_gate", "ft_steps") == [1600]
    assert _jax_assigned("gan_gate", "ft_m") == [8]
    assert sorted({e for _, e, _ in horizon_gate.RECIPES.values()}) == sorted(
        set(_jax_assigned("horizon_gate", "epochs_c") + _jax_assigned("horizon_gate", "epochs_u")
            + _jax_assigned("horizon_gate", "epochs_m") + _jax_assigned("horizon_gate", "epochs_p")
            + _jax_assigned("horizon_gate", "epochs_d")))
    assert accuracy_256.EPOCHS == {False: 8, True: 12}


def test_to_metnet_grid_is_bit_equal_to_jax():
    frames = np.random.default_rng(0).random((12, 64, 64), dtype=np.float32)
    want = _jax_tool("accuracy_gate")._to_metnet_grid(frames)
    np.testing.assert_array_equal(accuracy_gate._to_metnet_grid(frames), want)
    np.testing.assert_array_equal(_jax_tool("horizon_gate")._to_metnet_grid(frames), want)
    assert horizon_gate._to_metnet_grid is accuracy_gate._to_metnet_grid
    # run_baseline hands it tensors
    np.testing.assert_array_equal(accuracy_gate._to_metnet_grid(torch.from_numpy(frames)).numpy(),
                                  want)


# -- the oracle sampler and persistence (16 px eval sets) --------------------------------------


def _eval16(ds_kw, n):
    return StochasticAdvectionDataset(length=n, seed=300, **{**ds_kw, "width": 16, "height": 16})


@pytest.mark.parametrize("what", ["oracle_modes", "oracle_std_and_crps", "persistence_crps",
                                  "gan_128_persistence_rows", "gan_128_oracle_std_and_crps"])
def test_oracle_and_persistence_rows_match_jax(what):
    jg, j128 = _jax_tool("gan_gate"), _jax_tool("gan_128")
    ds, ds128 = _eval16(gan_gate.DS_KW, 3), _eval16(gan_128.DS128, 2)
    if what == "oracle_modes":
        x = np.asarray(ds[0][0]["sat_data"])[:, -1]
        got, want = gan_gate._oracle_modes(x), jg._oracle_modes(x)
        assert got.shape == (8, 3, gan_gate.STEPS, 16, 16, 1)
        np.testing.assert_array_equal(got, want)
        x = np.asarray(ds128[0][0]["sat_data"])[:, -1]
        np.testing.assert_array_equal(gan_128._oracle_modes(x), j128._oracle_modes(x))
        return
    got, want = {
        "oracle_std_and_crps": lambda: (gan_gate._oracle_std_and_crps(ds),
                                        jg._oracle_std_and_crps(ds)),
        "persistence_crps": lambda: (gan_gate._persistence_crps(ds), jg._persistence_crps(ds)),
        "gan_128_persistence_rows": lambda: (gan_128._persistence_rows(ds128),
                                             j128._persistence_rows(ds128)),
        "gan_128_oracle_std_and_crps": lambda: (gan_128._oracle_std_and_crps(ds128),
                                                j128._oracle_std_and_crps(ds128)),
    }[what]()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                   rtol=0, atol=1e-6)
        assert np.all(np.asarray(w) > 0)


# -- CRPSSelect -----------------------------------------------------------------------------

SMALL_DGMR = dict(forecast_steps=2, input_channels=1, output_shape=32, context_channels=8,
                  latent_channels=16, disc_channels=4, disc_spatial_layers=2,
                  disc_temporal_layers=1, num_samples=2, disc_steps=1)
SMALL_KW = dict(batch_size=2, width=32, height=32, number_sat_channels=1, history_minutes=15,
                forecast_minutes=10, velocity=(1, 2), decay=0.93, n_blobs=2)


def _small_dgmr():
    return create_model("nowcastinggan", generator=torch.Generator().manual_seed(0),
                        **SMALL_DGMR)


def test_crps_select_keeps_the_selected_weights_bit_for_bit():
    """A stubbed probe reads 0.5, 0.2, 0.3, 0.4 over four epochs of one
    round: epoch 1 is selected, and its copy of the generator's weights
    and buffers survives the two rounds after it bit for bit, while the
    live weights move on."""
    model = _small_dgmr()
    selector = gan_gate.CRPSSelect(model, StochasticAdvectionDataset(length=1, seed=400,
                                                                     **SMALL_KW))
    readings, seen = iter([0.5, 0.2, 0.3, 0.4]), []

    def probe():
        seen.append(copy.deepcopy(model.module.state_dict()))
        return next(readings), 0.1

    selector.probe = probe
    Trainer(max_epochs=4, log_every_n_steps=1000, limit_val_batches=1, callbacks=[selector],
            device="cpu").fit(model, studies.study_dm(StochasticAdvectionDataset, SMALL_KW, 1))
    assert selector.best["epoch"] == 1 and selector.best["crps"] == 0.2
    assert [t["epoch"] for t in selector.trajectory] == [0, 1, 2, 3]
    best, live = selector.best["state"], model.module.state_dict()
    assert best.keys() == seen[1].keys() == live.keys()
    for k in best:
        assert torch.equal(best[k], seen[1][k]), k
        assert best[k].data_ptr() != live[k].data_ptr(), k
    moved = [k for k in best if not torch.equal(best[k], live[k])]
    assert moved and all(k in moved for k, p in model.module.named_parameters()
                         if p.requires_grad and p.grad is not None and p.grad.abs().sum() > 0)


def test_crps_select_probe_scores_the_current_weights_without_moving_them():
    """The real probe: CRPS and spread of ``num_samples`` eval-mode samples
    from a fixed seed, the same twice, nothing of the generator's state
    moved, its train/eval mode restored."""
    from satflow_tpu_torch.data.datamodule import to_device
    from satflow_tpu_torch.eval.probabilistic import crps_ensemble

    model = _small_dgmr()
    ds = StochasticAdvectionDataset(length=1, seed=400, **SMALL_KW)
    model.materialize(to_device(ds[0], torch.device("cpu")))
    selector = gan_gate.CRPSSelect(model, ds)
    before = copy.deepcopy(model.module.state_dict())
    model.module.train(True)
    crps, std = selector.probe()
    assert (crps, std) == selector.probe() and model.module.training
    for k, v in model.module.state_dict().items():
        assert torch.equal(v, before[k]), k
    x, y = model.prepare_batch(to_device(ds[0], torch.device("cpu")))
    with torch.no_grad():
        samples, _ = model._sample(x, torch.Generator().manual_seed(123), False, 2)
    assert crps == pytest.approx(float(torch.mean(crps_ensemble(samples, y))), rel=1e-6)
    assert std == pytest.approx(float(samples.std(dim=1, correction=0).mean()), rel=1e-6)
    model.module.train(True)


def test_study_tools_run_convolutions_in_full_f32_on_a_card(monkeypatch):
    """cuDNN's default TF32 moved the accuracy gate's attentionrunet and fcn
    arms above flow on the card; every study tool pins full float32 right
    after resolving its device, on a card only."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    studies.full_f32(torch.device("cpu"))
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    studies.full_f32(torch.device("cuda"))
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    for name, tool in PORT.items():
        src = ast.get_source_segment(open(tool.__file__).read(), next(
            n for n in ast.parse(open(tool.__file__).read()).body
            if isinstance(n, ast.FunctionDef) and n.name == "main"))
        assert "device = resolve_device(device)\n    full_f32(device)\n" in src, name


# -- the results file under --out: runs side by side, the card, the launches ---------------


def _horizon_rows(names, mse, **extra):
    """Rows of ``horizon_gate``'s shape (48 lead times) at one MSE."""
    return {n: {"mse_t": [mse] * horizon_gate.STEPS, "mse": mse, **extra} for n in names}


def test_runs_side_by_side_into_one_out_keep_both_sets_of_rows(tmp_path):
    """Two ``horizon_gate`` runs into one ``--out``: both read the file
    before either saves (load, load, save, save), and the second save keeps
    the first's rows: each run overlays only the rows it computed on the file
    as it stands at save time. The ``.md`` is rendered from the merged rows,
    and nothing but the two files is left (the lock is on the directory)."""
    out, name = str(tmp_path / "hz"), horizon_gate.RESULTS
    first = _horizon_rows(["persistence", "optical_flow"], 0.002)
    second = _horizon_rows(["convlstm"], 0.001, epochs=300, train_seconds=1.0,
                           kernel_launches={"K1": 0, "K2": 0, "K3": 0, "K4": 0})
    assert studies.load_results(out, name, "cpu") == studies.load_results(out, name, "cpu") == {}
    assert studies.save_results(out, name, first, "cpu", horizon_gate._section) == first
    merged = studies.save_results(out, name, second, "cpu", horizon_gate._section)
    assert merged == {**first, **second}
    assert json.loads((tmp_path / "hz" / name).read_text()) == {**first, **second, "card": "cpu"}
    md = (tmp_path / "hz" / "horizon_results.md").read_text()
    assert all(f"| {row} | " in md for row in ("persistence", "optical_flow", "convlstm"))
    assert _written(tmp_path) == ["hz/horizon_results.json", "hz/horizon_results.md"]
    # a rerun of an arm replaces its row and keeps the others
    rerun = _horizon_rows(["convlstm"], 0.0009, epochs=300)
    assert studies.save_results(out, name, rerun, "cpu") == {**first, **rerun}


def test_saves_from_many_threads_at_once_keep_every_row(tmp_path):
    """Eight writers saving at once, each its own rows five times: the
    exclusive lock held across the read and the write loses none."""
    import threading

    out, name = str(tmp_path), horizon_gate.RESULTS

    def writer(i):
        for k in range(5):
            studies.save_results(out, name, _horizon_rows([f"arm{i}_{k}"], 0.001 * i), "cpu")

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rows = studies.load_results(out, name, "cpu")
    assert sorted(rows) == sorted(f"arm{i}_{k}" for i in range(8) for k in range(5))
    assert _written(tmp_path) == [name]


def test_a_file_stamped_with_another_card_still_raises(tmp_path):
    """At the run's start (``load_results``) and at its save, which leaves
    the other card's file as it was."""
    path = tmp_path / horizon_gate.RESULTS
    other = {**_horizon_rows(["persistence"], 0.002), "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
    path.write_text(json.dumps(other))
    with pytest.raises(ValueError, match="another --out"):
        studies.load_results(str(tmp_path), horizon_gate.RESULTS, "cpu")
    with pytest.raises(ValueError, match="another --out"):
        studies.save_results(str(tmp_path), horizon_gate.RESULTS,
                             _horizon_rows(["convlstm"], 0.001), "cpu", horizon_gate._section)
    assert json.loads(path.read_text()) == other
    assert _written(tmp_path) == [horizon_gate.RESULTS]


def test_kernel_launches_read_the_k1_to_k4_counters_and_stay_at_zero_on_the_cpu():
    """A trained row's ``kernel_launches``: the deltas of the counters that
    ``chip_smoke.py`` phase 28h reads; a CPU run launches no kernel."""
    from satflow_tpu_torch.ops.axial_attention import axial_attention
    from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step, gate_bwd
    from satflow_tpu_torch.ops.fused_lstm import fused_lstm_gates

    before = studies.kernel_launches()
    assert before == {"K1": fused_convlstm_step.launches, "K2": gate_bwd.launches,
                      "K3": fused_lstm_gates.launches, "K4": axial_attention.launches}
    x = torch.zeros(1, 4, 4, 3)
    h = c = torch.zeros(1, 4, 4, 8)
    fused_convlstm_step(x, h, c, torch.zeros(3, 3, 3, 32), torch.zeros(3, 3, 8, 32),
                        torch.zeros(32))
    assert studies.launches_since(before) == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}


def test_side_by_side_specs_give_each_process_its_threads_and_variables():
    """``tools/side_by_side.py``: a SPEC is the process's name, its thread
    share, variables and the tool with its arguments; ``--out`` is appended."""
    from satflow_tpu_torch.tools import side_by_side

    run = side_by_side.parse_spec(
        "D:2:SATFLOW_HORIZON_EPOCHS=300 horizon_gate --arms convlstm,unet", "R")
    assert run["name"] == "D"
    assert run["env"] == {"OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2",
                          "PYTHONUNBUFFERED": "1", "SATFLOW_HORIZON_EPOCHS": "300"}
    assert run["cmd"][1:] == ["-m", "satflow_tpu_torch.tools.side_by_side", "--child", "2",
                              "horizon_gate", "--arms", "convlstm,unet", "--out", "R"]
    with pytest.raises(ValueError, match="names no tool"):
        side_by_side.parse_spec("E:1:SATFLOW_HORIZON_EPOCHS=1", "R")


# -- each tool's main on the CPU, small -----------------------------------------------------


def _written(tmp_path):
    return sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*") if p.is_file())


def test_accuracy_gate_metnet_arms_run_and_merge(tmp_path, monkeypatch):
    """The three MetNet arms at 1 epoch of 1 batch, 16 px data, hidden 8:
    the JAX study's rows at the pooled grid, finite curves of 12 lead times,
    a warm-up cut to the run; a second run merges into the file."""
    monkeypatch.setattr(accuracy_gate, "DS64", {**accuracy_gate.DS64, "batch_size": 2,
                                                 "width": 16, "height": 16})
    monkeypatch.setattr(accuracy_gate, "METNET", {**accuracy_gate.METNET, "hidden_dim": 8,
                                                   "input_size": 16})
    out = tmp_path / "gate"
    res = accuracy_gate.main(["metnet", "metnet_stoch"], out=str(out), device="cpu",
                             epochs={"metnet": 1, "metnet_stoch": 1}, length=1)
    assert set(res) == {"persistence@metnet_grid", "optical_flow@metnet_grid", "metnet",
                        "persistence@metnet_grid_stoch", "optical_flow@metnet_grid_stoch",
                        "metnet@stoch"}
    for row in res.values():
        assert len(row["mse_t"]) == accuracy_gate.STEPS and np.isfinite(row["mse_t"]).all()
    assert set(res["metnet"]) >= {"mse_t", "mse", "ms_ssim_t", "ms_ssim", "epochs"}
    again = accuracy_gate.main(["metnet_baselines"], out=str(out), device="cpu")
    assert set(again) == set(res)
    saved = json.loads((out / "accuracy_results.json").read_text())
    assert saved == {**again, "card": "cpu"}
    assert _written(tmp_path) == ["gate/accuracy_results.json", "gate/accuracy_results.md"]
    assert "metnet@stoch" in (out / "accuracy_results.md").read_text()


def test_accuracy_256_runs_both_arms_and_merges(tmp_path, monkeypatch):
    """Both arms at 1 epoch of 1 batch at 16 px, hidden 8 (the recipe's
    fused cells, remat chunk 6, bf16): 24 lead times, the JAX artifact's
    row names and keys, the second run merged into the first's file; a file
    written on another device is refused."""
    monkeypatch.setattr(accuracy_256, "DS256", {**accuracy_256.DS256, "batch_size": 2,
                                                 "width": 16, "height": 16, "n_blobs": 3})
    monkeypatch.setattr(accuracy_256, "MODEL", {**accuracy_256.MODEL, "hidden_dim": 8})
    out = str(tmp_path / "a256")
    accuracy_256.main(1, out=out, device="cpu", length=1)
    res = accuracy_256.main(1, stochastic=True, out=out, device="cpu", length=1)
    jax_art = json.load(open(os.path.join(REPO, "docs", "accuracy_256.json")))
    assert set(res) == set(jax_art)
    for name, row in jax_art.items():
        assert set(row) <= set(res[name]), name
        assert len(res[name]["mse_t"]) == accuracy_256.STEPS
    assert res["convlstm@256px"]["optimizer_steps"] == 1
    assert _written(tmp_path) == ["a256/accuracy_256.json", "a256/accuracy_256.md"]
    saved = json.loads((tmp_path / "a256" / "accuracy_256.json").read_text())
    saved["card"] = "NVIDIA H100 80GB HBM3, 700.00 W"
    (tmp_path / "a256" / "accuracy_256.json").write_text(json.dumps(saved))
    with pytest.raises(ValueError, match="another --out"):
        accuracy_256.main(1, out=out, device="cpu", length=1)


def test_gan_gate_runs_every_arm(tmp_path, monkeypatch):
    """Every arm at 32 px (the smallest image Pix2Pix's 3-layer PatchGAN
    and DGMR take), 1 epoch of 1 round, narrowed, a 2-step fine-tune at M=2:
    the JAX artifact's rows and keys, finite losses."""
    monkeypatch.setattr(gan_gate, "DS_KW", {**gan_gate.DS_KW, "batch_size": 2})
    monkeypatch.setattr(gan_gate, "CLOUDGAN", {**gan_gate.CLOUDGAN, "num_filters": 4})
    monkeypatch.setattr(gan_gate, "PIX2PIX", {**gan_gate.PIX2PIX, "num_filters": 4})
    out = str(tmp_path / "gan")
    gan_gate.main(["cloudgan", "pix2pix"], out=out, device="cpu",
                  epochs={"cloudgan": 1, "pix2pix": 1}, length=1)
    monkeypatch.setattr(gan_gate, "DGMR", {**gan_gate.DGMR, "context_channels": 8,
                                           "latent_channels": 16, "disc_channels": 4})
    res = gan_gate.main(["dgmr"], out=out, device="cpu", epochs={"dgmr": 1},
                        finetune_steps=2, finetune_samples=2, length=1)
    jax_art = json.load(open(os.path.join(REPO, "docs", "gan_results.json")))
    assert set(res) == set(jax_art)
    for name, row in jax_art.items():
        if isinstance(row, dict):
            assert set(row) <= set(res[name]), name
    for arm in ("cloudgan", "pix2pix", "dgmr"):
        assert np.isfinite(res[arm]["d_loss"]) and np.isfinite(res[arm]["mse"])
    ft = res["dgmr_crps_finetuned"]
    assert ft["finetune_steps"] == 2 and [p["step"] for p in ft["frontier"]] == [2]
    assert _written(tmp_path) == ["gan/gan_results.json", "gan/gan_results.md"]


def test_gan_128_trains_then_finetunes_from_its_state_file(tmp_path, monkeypatch):
    """1 epoch of 1 round at 32 px, narrowed, with a 2-step fine-tune, then
    ``skip_train`` and ``from_finetuned`` for 2 more: the state file is a
    ``torch.save`` under ``out`` read with ``weights_only=True``, the
    frontier cumulative."""
    monkeypatch.setattr(gan_128, "DS128", {**gan_128.DS128, "batch_size": 2, "width": 32,
                                           "height": 32, "n_blobs": 2})
    monkeypatch.setattr(gan_128, "DGMR", {**gan_128.DGMR, "output_shape": 32,
                                          "disc_channels": 4})
    out = str(tmp_path / "g128")
    kw = dict(epochs=1, batch=2, context_channels=8, latent_channels=16, out=out, device="cpu",
              length=1)
    gan_128.main(**kw, finetune_steps=2, finetune_m=2, finetune_every=2)
    res = gan_128.main(**kw, finetune_steps=2, finetune_m=2, finetune_every=2, skip_train=True,
                       from_finetuned=True)
    jax_art = json.load(open(os.path.join(REPO, "docs", "gan_128.json")))
    assert set(res) == set(jax_art)
    for name, row in jax_art.items():
        if isinstance(row, dict):
            assert set(row) <= set(res[name]), name
    ft = res["dgmr_crps_finetuned@128px"]
    assert ft["finetune_steps"] == 4 and [p["step"] for p in ft["frontier"]] == [2, 4]
    zeros = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    assert res["dgmr@128px"]["kernel_launches"] == ft["kernel_launches"] == zeros
    assert ft["finetune_seconds"] > 0
    state = torch.load(os.path.join(out, "gan128_state.pt"), weights_only=True)
    assert state["finetuned_steps"] == 4 and set(state) == {"selected", "selected_epoch",
                                                            "final", "finetuned",
                                                            "finetuned_steps"}
    assert _written(tmp_path) == ["g128/gan128_state.pt", "g128/gan_128.json", "g128/gan_128.md"]


def test_horizon_gate_runs_every_arm(tmp_path, monkeypatch):
    """Every arm at 1 epoch of 1 batch, 48 lead times, narrowed, 16 px (the
    DGMR arm at 32 px, its smallest, in a second run that merges): the JAX
    artifact's rows and keys; ``SATFLOW_HORIZON_EPOCHS`` sets the budget."""
    r = horizon_gate.RECIPES
    monkeypatch.setattr(horizon_gate, "RECIPES", {
        "convlstm": (r["convlstm"][0], 150, {**r["convlstm"][2], "hidden_dim": 8}),
        "unet": (r["unet"][0], 150, {**r["unet"][2], "features_start": 4}),
        "metnet": (r["metnet"][0], 100, {**r["metnet"][2], "hidden_dim": 8, "input_size": 16}),
        "perceiver": (r["perceiver"][0], 60, {**r["perceiver"][2], "input_size": 16, "depth": 1,
                                              "num_latents": 8, "latent_dim": 16, "dim": 16,
                                              "queries_dim": 16, "num_freq_bands": 4}),
        "dgmr": (r["dgmr"][0], 60, {**r["dgmr"][2], "output_shape": 32, "context_channels": 8,
                                    "latent_channels": 16, "disc_channels": 4}),
    })
    monkeypatch.setattr(horizon_gate, "DS48", {**horizon_gate.DS48, "batch_size": 2,
                                               "width": 16, "height": 16})
    monkeypatch.setenv("SATFLOW_HORIZON_EPOCHS", "1")
    out = str(tmp_path / "hz")
    horizon_gate.main([a for a in horizon_gate.ALL_ARMS if a != "dgmr_stoch"], out=out,
                      device="cpu", length=1)
    monkeypatch.setattr(horizon_gate, "DS48", {**horizon_gate.DS48, "width": 32, "height": 32})
    res = horizon_gate.main(["dgmr_stoch"], out=out, device="cpu", length=1)
    jax_art = json.load(open(os.path.join(REPO, "docs", "horizon_results.json")))
    assert set(res) == set(jax_art)
    for name, row in jax_art.items():
        assert set(row) <= set(res[name]), name
        assert len(res[name]["mse_t"]) == horizon_gate.STEPS
        if "epochs" in row:
            assert res[name]["epochs"] == 1
    zeros = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    for name in ("convlstm", "unet", "metnet", "perceiver", "convlstm@stoch", "unet@stoch",
                 "metnet@stoch", "perceiver@stoch", "dgmr_mean@stoch"):
        assert res[name]["kernel_launches"] == zeros, name  # no kernel launches on the CPU
    assert _written(tmp_path) == ["hz/horizon_results.json", "hz/horizon_results.md"]


@pytest.mark.parametrize("arm", ("perceiver",) + tuple(accuracy_gate.STACKED_ARMS))
@pytest.mark.slow
def test_accuracy_gate_full_resolution_arm_runs(arm, tmp_path, monkeypatch):
    """The Perceiver and each stacked arm at 1 epoch of 1 batch, 16 px, b2:
    the JAX study's row with its keys (and the training seconds), a finite
    curve of 12 lead times, the epochs recorded, written only under --out
    (0.1-4 s an arm: ``slow``, which keeps tier-1's new tests under a
    second)."""
    monkeypatch.setattr(accuracy_gate, "DS_KW", {**accuracy_gate.DS_KW, "batch_size": 2,
                                                  "width": 16, "height": 16})
    monkeypatch.setattr(accuracy_gate, "PERCEIVER", {**accuracy_gate.PERCEIVER, "input_size": 16})
    res = accuracy_gate.main([arm], out=str(tmp_path), device="cpu", epochs={arm: 1}, length=1)
    with open(os.path.join(REPO, "docs", "accuracy_results.json")) as f:
        jax_row = json.load(f)[arm]
    assert set(res) == {arm}
    assert set(res[arm]) == set(jax_row) | {"train_seconds"}
    assert len(res[arm]["mse_t"]) == accuracy_gate.STEPS and np.isfinite(res[arm]["mse_t"]).all()
    assert res[arm]["epochs"] == 1
    assert _written(tmp_path) == ["accuracy_results.json", "accuracy_results.md"]
