"""PyTorch port, the quality studies' results on the card: the committed
``satflow_tpu_torch/tools/results/*.json``, written by the port's tools at
the JAX recipes and budgets on an NVIDIA H100, held to the JAX artifact
gates' bars (``tests/test_accuracy.py``):

- ``accuracy_256.json`` (``python -m satflow_tpu_torch.tools.accuracy_256
  [--stochastic] --out DIR``): deterministic, flow < persistence, the model's
  mean and its t=23 below persistence, MS-SSIM > 0.9; stochastic, model <
  flow < persistence and t=23 below persistence;
- ``accuracy_results.json`` (``...accuracy_gate --arms
  baselines,convlstm,metnet,metnet_stoch``): convlstm < flow < persistence;
  at MetNet's pooled grid the flow below half of persistence and MetNet
  below persistence; on the stochastic grid metnet < flow < persistence;
- ``gan_results.json`` (``...gan_gate --arms cloudgan,pix2pix``): each
  generator < flow < persistence, Pix2Pix's ``0.02 < d_loss < 2``,
  CloudGAN's finite.

Each file names the card and its power limit as ``nvidia-smi`` gives them.
"""

import json
import os
import re

import numpy as np
import pytest

RESULTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "satflow_tpu_torch", "tools", "results")


def _load(name):
    with open(os.path.join(RESULTS, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["accuracy_256.json", "accuracy_results.json",
                                  "gan_results.json"])
def test_artifact_names_an_nvidia_card_and_its_power_limit(name):
    card = _load(name)["card"]
    assert re.fullmatch(r"NVIDIA [^,]+, \d+(\.\d+)? W", card), card


def test_accuracy_256_deterministic_beats_persistence_with_ms_ssim():
    r = _load("accuracy_256.json")
    flow, persist = r["optical_flow@256px"]["mse"], r["persistence@256px"]["mse"]
    assert flow < persist
    m = r["convlstm@256px"]
    assert len(m["mse_t"]) == 24  # the serving rollout's length
    assert (m["epochs"], m["optimizer_steps"]) == (8, 96)  # the JAX study's budget
    assert m["mse"] < persist
    assert m["mse_t"][-1] < r["persistence@256px"]["mse_t"][-1]
    assert m["ms_ssim"] > 0.9


def test_accuracy_256_stochastic_beats_both_baselines():
    r = _load("accuracy_256.json")
    f_s, p_s = r["optical_flow@256px_stoch"]["mse"], r["persistence@256px_stoch"]["mse"]
    m = r["convlstm@256px_stoch"]
    assert len(m["mse_t"]) == 24 and (m["epochs"], m["optimizer_steps"]) == (12, 144)
    assert m["mse"] < f_s < p_s
    assert m["mse_t"][-1] < r["persistence@256px_stoch"]["mse_t"][-1]


def test_accuracy_gate_convlstm_beats_flow_and_persistence():
    r = _load("accuracy_results.json")
    flow, persist = r["optical_flow"]["mse"], r["persistence"]["mse"]
    assert r["convlstm"]["epochs"] == 30
    assert r["convlstm"]["mse"] < flow < persist


def test_accuracy_gate_metnet_beats_persistence_at_its_grid():
    """On deterministic advection the flow, solved at input resolution and
    pooled, is a near-oracle at the grid (not collapsed onto persistence);
    MetNet is held to persistence there."""
    r = _load("accuracy_results.json")
    p_grid = r["persistence@metnet_grid"]["mse"]
    assert r["optical_flow@metnet_grid"]["mse"] < 0.5 * p_grid
    assert r["metnet"]["epochs"] == 150
    assert r["metnet"]["mse"] < p_grid


def test_accuracy_gate_metnet_beats_both_baselines_on_stochastic_futures():
    r = _load("accuracy_results.json")
    f_s = r["optical_flow@metnet_grid_stoch"]["mse"]
    p_s = r["persistence@metnet_grid_stoch"]["mse"]
    assert r["metnet@stoch"]["epochs"] == 150
    assert r["metnet@stoch"]["mse"] < f_s < p_s


@pytest.mark.parametrize("arm", ["cloudgan", "pix2pix"])
def test_gan_generators_beat_flow_and_persistence(arm):
    r = _load("gan_results.json")
    assert r[arm]["epochs"] == 20
    assert r[arm]["mse"] < r["optical_flow"]["mse"] < r["persistence"]["mse"]
    assert np.isfinite(r[arm]["d_loss"]) and np.isfinite(r[arm]["g_adv_loss"])


def test_pix2pix_discriminator_neither_won_nor_diverged():
    d_loss = _load("gan_results.json")["pix2pix"]["d_loss"]
    assert 0.02 < d_loss < 2.0
