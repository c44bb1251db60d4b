"""PyTorch port, on a CUDA card only: the fused ConvLSTM-step kernel (K1),
its backward's kernel (K2), the LSTM gate tail (K3) and the axial attention
(K4), with their autograd Functions, against their plain versions, and a
small MetNet through K3 and K4. It imports nothing of the JAX package, so it
runs on a card's machine that has no flax: ``python -m pytest
tests/test_torch_gpu.py``. Without a card it skips.

K1/K2 at a ragged size (the 8x16 tiles do not divide 20x36) with Cx=12.
Tolerances: float32 with TF32 off, the same f32 sums in another order (and
for the step's gradients the same cuDNN linear grads fed agreeing dgates):
atol 1e-4 (x max|grad| for gradients); bf16: both store bf16 (step 2^-8)
and the plain version rounds each conv's output to bf16, atol 3e-2. K3 and
K4: f32 atol 1e-5 (the same f32 math; K4's online softmax sums in another
order); bf16 atol 2e-2 + one bf16 step relative (both round only the
stored output).
"""

import pytest
import torch

from satflow_tpu_torch.ops import axial_attention as A
from satflow_tpu_torch.ops import fused_convlstm_step as P
from satflow_tpu_torch.ops import fused_lstm as G
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


def _randn(*shape, seed, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=g, device="cuda") * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rows, ch", [(1001, 3), (37, 64), (1, 1), (4096, 64)])
def test_gate_tail_kernel_matches_plain_on_card(dtype, atol, rows, ch):
    _card()
    gates = _randn(rows, 4 * ch, seed=rows, scale=2.0).to(dtype)
    c = _randn(rows, ch, seed=rows + 1).to(dtype)
    before = G.fused_lstm_gates.launches
    h_k, c_k = G.fused_lstm_gates(gates, c)
    torch.cuda.synchronize()
    assert G.fused_lstm_gates.launches == before + 1 and h_k.dtype == dtype
    h_p, c_p = G.fused_lstm_gates_ref(gates, c)
    rtol = 0 if dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(h_k.float(), h_p.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(c_k.float(), c_p.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
def test_gate_tail_function_grads_on_card():
    """FusedLSTMGates (K3 forward, the f32 chain backward) against torch
    autograd of the plain version, float32: atol 1e-5."""
    _card()
    gates, c = _randn(2, 5, 7, 4 * 6, seed=10), _randn(2, 5, 7, 6, seed=11)
    dh, dc = _randn(2, 5, 7, 6, seed=12), _randn(2, 5, 7, 6, seed=13)

    def grads(fn):
        ts = [t.clone().requires_grad_() for t in (gates, c)]
        h, c_next = fn(*ts)
        ((h * dh).sum() + (c_next * dc).sum()).backward()
        return [t.grad for t in ts]

    for got, want in zip(grads(G.fused_lstm_gates), grads(G.fused_lstm_gates_ref)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n, length, d", [(300, 16, 8), (5, 33, 3), (7, 1, 1), (64, 128, 64),
                                          (4, 512, 256), (3, 77, 200)])
def test_attention_kernel_matches_plain_on_card(dtype, atol, n, length, d):
    _card()
    q, k, v = (_randn(n, length, d, seed=length + i).to(dtype) for i in range(3))
    before = A.axial_attention.launches
    out = A.axial_attention(q, k, v)
    torch.cuda.synchronize()
    assert A.axial_attention.launches == before + 1 and out.dtype == dtype
    rtol = 0 if dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(out.float(), A.axial_attention_ref(q, k, v).float(),
                               atol=atol, rtol=rtol)


@pytest.mark.gpu
def test_attention_outside_the_domain_runs_plain_on_card():
    _card()
    q = _randn(2, 600, 8, seed=20)
    before = A.axial_attention.launches
    out = A.axial_attention(q, q, q)
    assert A.axial_attention.launches == before
    torch.testing.assert_close(out, A.axial_attention_ref(q, q, q))


@pytest.mark.gpu
def test_attention_function_grads_on_card():
    """AxialAttention (K4 forward, the plain version's VJP) against torch
    autograd of the plain version, float32: atol 1e-5."""
    _card()
    q, k, v, g = (_randn(40, 16, 8, seed=30 + i) for i in range(4))

    def grads(fn):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*ts) * g).sum().backward()
        return [t.grad for t in ts]

    before = A.axial_attention.launches
    got = grads(A.axial_attention)
    assert A.axial_attention.launches == before + 1
    for a, b in zip(got, grads(A.axial_attention_ref)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_metnet_forward_through_k3_and_k4_on_card():
    """A small LitMetNet (T=3, 64x64, F=2) on the card: T K3 and 2 K4
    launches per forward, and the output of the plain versions' forward
    within 1e-4 (f32, TF32 off)."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from satflow_tpu_torch.core.registry import create_model
    import satflow_tpu_torch.models  # noqa: F401 - populate the registry

    torch.manual_seed(0)
    model = create_model("litmetnet", forecast_steps=2, hidden_dim=16, output_channels=3,
                         temporal_dropout=0.0).cuda().eval()
    x = torch.rand(2, 3, 64, 64, 4, device="cuda")
    with torch.no_grad():
        model(x)  # creates the lazy parameters
        k3, k4 = G.fused_lstm_gates.launches, A.axial_attention.launches
        y = model(x)
        torch.cuda.synchronize()
        assert (G.fused_lstm_gates.launches - k3, A.axial_attention.launches - k4) == (3, 2)
        want = model(x, gate_tail=G.fused_lstm_gates_ref, attention=A.axial_attention_ref)
    assert y.shape == (2, 2, 4, 4, 3)
    torch.testing.assert_close(y, want, atol=1e-4, rtol=0)
