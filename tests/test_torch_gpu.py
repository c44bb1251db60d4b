"""PyTorch port, on a CUDA card only: the fused ConvLSTM-step kernel (K1),
its backward's kernel (K2) and the step's autograd Function against their
plain versions. It imports nothing of the JAX package, so it runs on a card's
machine that has no flax: ``python -m pytest tests/test_torch_gpu.py``.
Without a card it skips.

All at a ragged size (the 8x16 tiles do not divide 20x36) with Cx=12.
Tolerances: float32 with TF32 off, the same f32 sums in another order (and
for the step's gradients the same cuDNN linear grads fed agreeing dgates):
atol 1e-4 (x max|grad| for gradients); bf16: both store bf16 (step 2^-8)
and the plain version rounds each conv's output to bf16, atol 3e-2.
"""

import pytest
import torch

from satflow_tpu_torch.ops import fused_convlstm_step as P
from satflow_tpu_torch.nn.recurrent import FusedConvLSTMCell

SHAPES = (((2, 20, 36, 12), 1.0), ((2, 20, 36, 64), 1.0), ((2, 20, 36, 64), 1.0),
          ((3, 3, 12, 256), 0.1), ((3, 3, 64, 256), 0.04), ((256,), 0.1))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False


def _args(dtype, seed=0, cotangents=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = SHAPES + ((((2, 20, 36, 64), 1.0),) * 2 if cotangents else ())
    return [(torch.randn(*s, generator=g, device="cuda") * sc).to(dtype) for s, sc in shapes]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_kernel_matches_plain_on_card(dtype, atol):
    _card()
    args = _args(dtype)
    before = P.fused_convlstm_step.launches
    h_k, c_k = P.fused_convlstm_step(*args)
    torch.cuda.synchronize()
    assert P.fused_convlstm_step.launches == before + 1
    h_p, c_p = P.fused_convlstm_step_ref(*args)
    torch.testing.assert_close(h_k.float(), h_p.float(), atol=atol, rtol=0)
    torch.testing.assert_close(c_k.float(), c_p.float(), atol=atol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_gate_bwd_kernel_matches_plain_on_card(dtype, atol):
    """K2 against its plain version, dh' and dc' random."""
    _card()
    args = _args(dtype, seed=1, cotangents=True)
    before = P.gate_bwd.launches
    dg_k, dc_k = P.gate_bwd(*args)
    torch.cuda.synchronize()
    assert P.gate_bwd.launches == before + 1
    dg_p, dc_p = P.gate_bwd_ref(*args)
    assert dg_k.shape == (2, 20, 36, 256) and dg_k.dtype == dtype
    torch.testing.assert_close(dg_k.float(), dg_p.float(), atol=atol, rtol=atol)
    torch.testing.assert_close(dc_k.float(), dc_p.float(), atol=atol, rtol=atol)


@pytest.mark.gpu
def test_function_grads_match_plain_autograd_on_card():
    """The six gradients through K1 + K2 against torch autograd of the plain
    step; K2 launches once per backward."""
    _card()
    args = _args(torch.float32, seed=2)
    g = torch.Generator(device="cuda").manual_seed(3)
    dh, dc = (torch.randn(2, 20, 36, 64, generator=g, device="cuda") for _ in range(2))

    def grads(step):
        ts = [a.clone().requires_grad_() for a in args]
        h_next, c_next = step(*ts)
        ((h_next * dh).sum() + (c_next * dc).sum()).backward()
        return [t.grad for t in ts]

    before = P.gate_bwd.launches
    got = grads(P.fused_convlstm_step)
    assert P.gate_bwd.launches == before + 1
    want = grads(P.fused_convlstm_step_ref)
    for name, a, b in zip(("dx", "dh", "dc", "dwx", "dwh", "db"), got, want):
        torch.testing.assert_close(a, b, atol=1e-4 * b.abs().max().item(), rtol=0, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_cell_parameter_gets_a_gradient_on_card(dtype):
    """The fault this guards: the step's outputs once carried no autograd
    graph on the card, so the cell's weights got no gradient, silently."""
    _card()
    cell = FusedConvLSTMCell(12, 64, dtype=dtype).cuda()
    x, h, c = (a.to(dtype) for a in _args(torch.float32, seed=4)[:3])
    (h2, c2), _ = cell((h, c), x)
    assert h2.grad_fn is not None
    (h2.float().square().sum() + c2.float().sum()).backward()
    for name, p in cell.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert bool(torch.isfinite(p.grad).all()) and p.grad.abs().sum().item() > 0, name
