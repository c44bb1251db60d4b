"""PyTorch port, the initial weights of the accuracy gate's stacked arms
against the JAX package's: the port draws each tensor from the distribution
JAX draws it from.

The two packages cannot share a random stream, so a model's first weights
differ between them draw by draw; what must agree is the law of each draw.
For each of the accuracy gate's channels-stacked arms at its 32-px study
recipe (``tools/accuracy_gate.py``: 8 stacked input channels, 12 lead
times), the JAX Trainer's initial variables (``init_variables`` at
``PRNGKey(0)`` on the first training batch, mapped through
``state_dict_from_flax``) and the port's (``torch.Generator`` seed 0, the
lazy weights made on the same batch) have the same tensors and shapes, and
each tensor's mean and standard deviation agree within four sampling errors
(a normal sample's: sd / sqrt(n) and sd x sqrt(2 / n)); a tensor of one
element (an attention gate, say) is equal. A conv whose fan-in or truncation
were wrong would put its standard deviation off by more than that in any
tensor of more than a few hundred elements. Marked ``slow`` (0.4-12 s an arm,
JAX initialising the full-size models): ``python -m pytest
tests/test_torch_initial_draws.py -m slow``.
"""

import jax
import numpy as np
import pytest
import torch

import satflow_tpu.models  # noqa: F401 - populate the JAX registry
from satflow_tpu.core import registry as jax_registry
from satflow_tpu.data.fake import DecayingAdvectionDataset as JaxDataset
import satflow_tpu_torch.models  # noqa: F401 - populate the port's registry
from satflow_tpu_torch.core.registry import create_model
from satflow_tpu_torch.data.fake import DecayingAdvectionDataset
from satflow_tpu_torch.tools import accuracy_gate


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draws(arm):
    """(the JAX Trainer's initial state dict, the port's) for ``arm``."""
    _, lr, extra = accuracy_gate.STACKED_ARMS[arm]
    kw = dict(input_channels=8, forecast_steps=accuracy_gate.STEPS, channels_per_timestep=2,
              lr=lr, **extra)
    first = JaxDataset(length=12, seed=0, **accuracy_gate.DS_KW)[0]
    variables = jax.tree_util.tree_map(np.asarray, jax_registry.create_model(arm, **kw)
                                       .init_variables(jax.random.PRNGKey(0), first))
    model = create_model(arm, generator=torch.Generator().manual_seed(0), **kw)
    want = model.state_dict_from_flax(variables)
    x, _ = model.prepare_batch(DecayingAdvectionDataset(length=12, seed=0,
                                                        **accuracy_gate.DS_KW)[0])
    model.module.eval()
    with torch.no_grad():
        model.module(torch.as_tensor(x))  # makes the lazy weights, as a first batch does
    return want, model.module.state_dict()


@pytest.mark.parametrize("arm", list(accuracy_gate.STACKED_ARMS))
@pytest.mark.slow
def test_port_draws_each_initial_tensor_from_the_jax_distribution(arm):
    want, got = _draws(arm)
    assert set(want) == set(got)
    for k, w in want.items():
        w, g = torch.as_tensor(np.asarray(w)).double(), got[k].double()
        assert g.shape == w.shape, k
        if w.numel() < 2:
            assert torch.equal(g, w), k
            continue
        n, sd = w.numel(), w.std().item()
        assert abs(g.mean().item() - w.mean().item()) <= 4 * sd / n ** 0.5 + 1e-12, k
        assert abs(g.std().item() - sd) <= 4 * sd * (2 / n) ** 0.5 + 1e-12, k
