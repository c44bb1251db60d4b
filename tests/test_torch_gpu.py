"""PyTorch port, on a CUDA card only: the fused ConvLSTM-step kernel (K1),
its backward's kernel (K2), the LSTM gate tail (K3), the axial attention
(K4), the int8 step (K5) and the channel-major step and head (K6a, K6b),
with their autograd Functions, against their plain versions, and a small
MetNet through K3 and K4. It imports nothing of the JAX package, so it
runs on a card's machine that has no flax: ``python -m pytest
tests/test_torch_gpu.py``. Without a card it skips.

K1/K2 at a ragged size (the 8x16 tiles do not divide 20x36) with Cx=12, and
at every hidden width they are built for (8 to 256; Cx 1, 12, 256) at 21x37;
K1h, K6a, K5 and the study kernels at every width they are built for and at
widths they zero-pad.
Tolerances: float32 with TF32 off, the same f32 sums in another order (and
for the step's gradients the same cuDNN linear grads fed agreeing dgates):
atol 1e-4 (x max|grad| for gradients); bf16: both store bf16 (step 2^-8)
and the plain version rounds each conv's output to bf16, atol 3e-2. K3 and
K4: f32 atol 1e-5 (the same f32 math; K4's online softmax sums in another
order); bf16 atol 2e-2 + one bf16 step relative (both round only the
stored output). K5: the integer sums are exact on both sides, so h'q
differs by at most one int8 step on at most 0.1 % of elements (exp/tanh
differ by an ulp between ATen and CUDA) and c' by one step of its dtype;
its integer sums, read through its sums entry point, equal the exact ones
(a float64 conv on the CPU) bit for bit.
K6a/K6b: as K1 (f32 1e-4; bf16 3e-2, the plain versions round each conv's
output to bf16). K1h, T1 and T3: as K1. T2's outputs are unbounded sums, so
bf16 is held to 3e-2 x max|plain|. The bf16 study kernels on the tensor
cores at every width are held to ``chip_smoke.py``'s bars: T1 against its
plain version (the same f32 sums of the same bf16 products) and T1 and K1p
against K1 to one bf16 step of the stored outputs (atol = rtol = 2^-7), K1p
against its plain version (which rounds each conv's output to bf16) to 3e-2,
T2 to 2^-7 x max|plain| (two bf16 roundings), and T2's f32 o + g sums to
1e-5 x max|plain| (f32 rounding of sums of up to 9 x 192 products).
"""

import pytest
import torch

from satflow_tpu_torch.ops import axial_attention as A
from satflow_tpu_torch.ops import cmajor_convlstm as CM
from satflow_tpu_torch.ops import fused_convlstm_int8 as Q
from satflow_tpu_torch.ops import fused_convlstm_step as P
from satflow_tpu_torch.ops import fused_lstm as G
from satflow_tpu_torch.nn.recurrent import FusedConvLSTMCell
from satflow_tpu_torch.tools import exp_cmajor as XC
from satflow_tpu_torch.tools import exp_tap9 as XT

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


def _width_args(cx, ch, dtype, seed=5, shape=(2, 21, 37)):
    """K1's and K2's arguments at a ragged size: 21x37 is a multiple of neither
    the 8x16 tile nor Ch=128's 4x16."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = (((*shape, cx), 1.0), ((*shape, ch), 1.0), ((*shape, ch), 1.0),
              ((3, 3, cx, 4 * ch), (9 * cx) ** -0.5), ((3, 3, ch, 4 * ch), (9 * ch) ** -0.5),
              ((4 * ch,), 0.1), ((*shape, ch), 1.0), ((*shape, ch), 1.0))
    return [(torch.randn(*s, generator=g, device="cuda") * sc).to(dtype) for s, sc in shapes]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("ch", P.KERNEL_HIDDEN_WIDTHS)
@pytest.mark.parametrize("cx", [1, 12, 20, 256])
def test_kernels_match_plain_at_every_width_on_card(cx, ch, dtype, atol):
    """K1 and K2 at every hidden width they are built for, with a 1-channel,
    a 12-channel, a 20-channel (padded to 32, rows of no whole 16-byte
    pieces) and the widest input, each launch counted."""
    _card()
    args = _width_args(cx, ch, dtype)
    before = P.fused_convlstm_step.launches, P.gate_bwd.launches
    got = P.fused_convlstm_step(*args[:6]) + P.gate_bwd(*args)
    torch.cuda.synchronize()
    assert (P.fused_convlstm_step.launches, P.gate_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = P.fused_convlstm_step_ref(*args[:6]) + P.gate_bwd_ref(*args)
    for name, a, b in zip(("h", "c", "dgates", "dc_prev"), got, want):
        assert a.shape == b.shape and a.dtype == dtype, name
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=atol, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("cx", [1, 12, 16, 20])
def test_kernels_take_an_unaligned_input_on_card(cx, dtype, atol):
    """x alone may start off a 16-byte boundary (a contiguous slice of a
    larger batch): the kernels stage it with plain loads."""
    _card()
    args = _width_args(cx, 32, dtype, seed=8)
    pad = torch.zeros(1 if dtype == torch.float32 else 3, dtype=dtype, device="cuda")
    x = torch.cat([pad, args[0].flatten()])[pad.numel():].view_as(args[0])
    assert x.is_contiguous() and x.data_ptr() % 16 and torch.equal(x, args[0])
    before = P.fused_convlstm_step.launches, P.gate_bwd.launches
    got = P.fused_convlstm_step(x, *args[1:6]) + P.gate_bwd(x, *args[1:])
    torch.cuda.synchronize()
    assert (P.fused_convlstm_step.launches, P.gate_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = P.fused_convlstm_step_ref(*args[:6]) + P.gate_bwd_ref(*args)
    for name, a, b in zip(("h", "c", "dgates", "dc_prev"), got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=atol, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("ch", [8, 16, 32, 128, 256])
def test_function_grads_at_every_width_on_card(ch):
    """The six float32 gradients through K1 + K2 at the other widths."""
    _card()
    *args, dh, dc = _width_args(12, ch, torch.float32, seed=6)

    def grads(step):
        ts = [a.clone().requires_grad_() for a in args]
        h_next, c_next = step(*ts)
        ((h_next * dh).sum() + (c_next * dc).sum()).backward()
        return [t.grad for t in ts]

    before = P.fused_convlstm_step.launches, P.gate_bwd.launches
    got = grads(P.fused_convlstm_step)
    assert (P.fused_convlstm_step.launches, P.gate_bwd.launches) == (before[0] + 1, before[1] + 1)
    for name, a, b in zip(("dx", "dh", "dc", "dwx", "dwh", "db"), got,
                          grads(P.fused_convlstm_step_ref)):
        torch.testing.assert_close(a, b, atol=1e-4 * b.abs().max().item(), rtol=0, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("cx, ch", [(12, 264), (12, 300), (300, 64)])
def test_width_outside_the_rule_is_refused_on_card(cx, ch):
    """A width above the kernels' largest (hidden 256, Cx 256) raises on the
    card and names the rule: nothing launches, and no wrapper gives way to the
    plain version, which a caller names itself
    (``step=fused_convlstm_step_ref``)."""
    _card()
    assert not P.kernel_takes(cx, ch)
    args = _width_args(cx, ch, torch.float32, seed=7)
    before = P.fused_convlstm_step.launches, P.gate_bwd.launches
    for call in (lambda: P.fused_convlstm_step(*args[:6]), lambda: P.gate_bwd(*args)):
        with pytest.raises(ValueError, match="1 <= Ch <= 256 .* and 1 <= Cx <= 256"):
            call()
    assert (P.fused_convlstm_step.launches, P.gate_bwd.launches) == before
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        P.fused_convlstm_step(*(a.half() for a in args[:6]))
    with pytest.raises(ValueError, match="is on cpu"):
        P.fused_convlstm_step(args[0], args[1].cpu(), *args[2:6])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("ch", [24, 40, 12, 1, 96, 127, 192, 136])
@pytest.mark.parametrize("cx", [1, 12])
def test_kernels_match_plain_at_padded_widths_on_card(cx, ch, dtype, atol):
    """K1 and K2 at hidden widths they are not built for: zero-padded to the
    next built width inside the wrapper, still one counted launch each, the
    outputs of the unpadded shape and within the step's tolerance of the plain
    versions at the unpadded width."""
    _card()
    assert ch not in P.KERNEL_HIDDEN_WIDTHS and P.kernel_takes(cx, ch)
    args = _width_args(cx, ch, dtype)
    before = P.fused_convlstm_step.launches, P.gate_bwd.launches
    got = P.fused_convlstm_step(*args[:6]) + P.gate_bwd(*args)
    torch.cuda.synchronize()
    assert (P.fused_convlstm_step.launches, P.gate_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = P.fused_convlstm_step_ref(*args[:6]) + P.gate_bwd_ref(*args)
    for name, a, b in zip(("h", "c", "dgates", "dc_prev"), got, want):
        assert a.shape == b.shape and a.dtype == dtype and a.is_contiguous(), name
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=atol, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("ch", [24, 12])
def test_function_grads_at_padded_widths_on_card(ch):
    """The six gradients through K1 + K2 at a padded width, float32."""
    _card()
    args = _width_args(12, ch, torch.float32, seed=9)
    dh, dc = args[6:]

    def grads(fn):
        ts = [a.clone().requires_grad_() for a in args[:6]]
        h_next, c_next = fn(*ts)
        ((h_next * dh).sum() + (c_next * dc).sum()).backward()
        return [t.grad for t in ts]

    before = P.fused_convlstm_step.launches, P.gate_bwd.launches
    got = grads(P.fused_convlstm_step)
    assert (P.fused_convlstm_step.launches, P.gate_bwd.launches) == (before[0] + 1, before[1] + 1)
    for name, a, b in zip(("dx", "dh", "dc", "dwx", "dwh", "db"), got,
                          grads(P.fused_convlstm_step_ref)):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, atol=1e-4 * b.abs().max().item(), rtol=0, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("hidden, dtype, atol", [(8, torch.float32, 1e-4), (16, torch.float32, 1e-4),
                                                 (32, torch.bfloat16, 2e-2),
                                                 (24, torch.bfloat16, 2e-2),
                                                 (12, torch.float32, 1e-4)])
def test_fused_core_at_small_widths_on_card(hidden, dtype, atol):
    """The default ``cell_impl="fused"`` core at the shipped experiments'
    hidden widths (T=2, F=3, 20x36): 2T + 2F K1 launches a forward, and the
    rollout through the plain step within the step's tolerance."""
    _card()
    from satflow_tpu_torch.models.conv_lstm import ConvLSTMCore

    core = ConvLSTMCore(hidden_dim=hidden, in_channels=12, out_channels=12, forecast_steps=3,
                        dtype=dtype, generator=torch.Generator().manual_seed(0)).cuda().eval()
    x = torch.rand(2, 2, 20, 36, 12, device="cuda")
    before = P.fused_convlstm_step.launches
    with torch.inference_mode():
        y = core(x)
        torch.cuda.synchronize()
        assert P.fused_convlstm_step.launches == before + 10
        want = core(x, step=P.fused_convlstm_step_ref)
    assert y.shape == (2, 3, 20, 36, 12)
    torch.testing.assert_close(y.float(), want.float(), atol=atol, rtol=0)


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
    _check_attention(dtype, atol, n, length, d)


# the edges of K4's three kernels (rows: L <= 32 and D <= 32; else mma in
# bfloat16, tile in float32), N = 1 and N that are no multiple of the batch
# rows a block of the rows kernel takes, and the shapes between the regimes
@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("n, length, d", [
    (1, 1, 1), (7, 17, 8), (33, 17, 24), (5, 32, 32), (3, 33, 32), (3, 32, 33), (3, 100, 100),
    (2, 512, 1), (1, 512, 256), (37, 16, 8), (4, 100, 24), (3, 130, 24), (1001, 1, 8),
    (2, 64, 256), (5, 65, 16), (64, 64, 32), (16, 64, 64), (8, 256, 64)])
def test_attention_kernels_at_the_regimes_edges_on_card(dtype, atol, n, length, d):
    assert A.regime(length, d, dtype) in ("rows", "mma", "tile")
    _check_attention(dtype, atol, n, length, d, rtol=1e-5 if dtype == torch.float32 else 2 ** -7)


def _check_attention(dtype, atol, n, length, d, rtol=None):
    _card()
    q, k, v = (_randn(n, length, d, seed=length + i).to(dtype) for i in range(3))
    before = A.axial_attention.launches
    out = A.axial_attention(q, k, v)
    torch.cuda.synchronize()
    assert A.axial_attention.launches == before + 1 and out.dtype == dtype
    if rtol is None:
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


def _int8_args(cx, c_dtype, shape=(2, 20, 36), seed=40, ch=64):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*s):
        return torch.rand(*s, generator=g, device="cuda")

    w3q, dequant, b = Q.quantize_weights((rand(3, 3, cx, 4 * ch) - 0.5) * 0.2,
                                         (rand(3, 3, ch, 4 * ch) - 0.5) * 0.2,
                                         (rand(4 * ch) - 0.5) * 0.2)
    xq = Q.quantize_activations(rand(*shape, cx))
    hq = Q.quantize_activations(rand(*shape, ch) * 2 - 1)
    c = (rand(*shape, ch) * 2 - 1).to(c_dtype)
    return xq, hq, c, w3q, dequant, b


def _int8_close(got, want, c_step):
    """K5 against the plain int8 step: h'q within one int8 step on at most
    0.1 % of elements, c' within one step of its dtype."""
    diff = (got[0].int() - want[0].int()).abs()
    assert int(diff.max()) <= 1 and float((diff != 0).float().mean()) <= 1e-3
    torch.testing.assert_close(got[1].float(), want[1].float(), atol=c_step, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("c_dtype, c_step", [(torch.bfloat16, 2.0 ** -7), (torch.float32, 1e-6)])
@pytest.mark.parametrize("cx", [12, 64])
def test_int8_kernel_matches_plain_on_card(cx, c_dtype, c_step):
    """K5 at a ragged size (the 8x16 tiles do not divide 20x36), packing its
    weights itself or handed them packed."""
    _card()
    args = _int8_args(cx, c_dtype)
    before = Q.fused_convlstm_step_int8.launches
    hq_k, c_k = Q.fused_convlstm_step_int8(*args)
    hq_k2, c_k2 = Q.fused_convlstm_step_int8(*args, Q.pack_weights(args[3], cx))
    torch.cuda.synchronize()
    assert Q.fused_convlstm_step_int8.launches == before + 2
    assert hq_k.dtype == torch.int8 and c_k.dtype == c_dtype
    assert torch.equal(hq_k, hq_k2) and torch.equal(c_k, c_k2)
    _int8_close((hq_k, c_k), Q.fused_convlstm_step_int8_ref(*args), c_step)


@pytest.mark.gpu
@pytest.mark.parametrize("c_dtype, c_step", [(torch.bfloat16, 2.0 ** -7), (torch.float32, 1e-6)])
@pytest.mark.parametrize("cx, ch", [(12, 32), (13, 24), (12, 24), (1, 8), (13, 128), (256, 100)])
def test_int8_kernel_at_padded_widths_on_card(cx, ch, c_dtype, c_step):
    """K5 at widths it is not built for, zero-padded inside the wrapper (Ch to
    64 or 128, Cx to a multiple of 4): one counted launch, outputs of the
    unpadded shape, within K5's tolerance of the plain step at the unpadded
    width; the same padded call with its weights padded once beforehand
    (``pad_quantized``, as a rollout does) gives the same bits."""
    _card()
    args = _int8_args(cx, c_dtype, ch=ch, seed=41)
    before = Q.fused_convlstm_step_int8.launches
    got = Q.fused_convlstm_step_int8(*args)
    torch.cuda.synchronize()
    assert Q.fused_convlstm_step_int8.launches == before + 1
    assert got[0].shape == args[1].shape and got[1].shape == args[2].shape
    _int8_close(got, Q.fused_convlstm_step_int8_ref(*args), c_step)
    cx_to, ch_to = Q.kernel_widths(cx, ch)
    w3q, dq, b = Q.pad_quantized(*args[3:], cx, cx_to, ch_to)
    pre = Q.fused_convlstm_step_int8(*(Q.pad_channels(t, w) for t, w in
                                       zip(args[:3], (cx_to, ch_to, ch_to))), w3q, dq, b,
                                     Q.pack_weights(w3q, cx_to))
    assert torch.equal(pre[0][..., :ch], got[0]) and torch.equal(pre[1][..., :ch], got[1])
    if ch < ch_to:
        assert int(pre[0][..., ch:].abs().max()) == 0 and float(pre[1][..., ch:].abs().max()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("ch", [8, 16, 24, 32, 64, 128])
@pytest.mark.parametrize("cx", [1, 12, 13, 64])
def test_int8_kernel_sums_are_exact_at_every_width_on_card(cx, ch):
    """K5 at every hidden width it is built for and at one it pads (24, to
    32), with inputs it pads (1, 13) and does not: the tensor cores' integer
    sums equal the exact ones bit for bit (a wrong s8 fragment map gives
    plausible sums, so nothing less than equality is a check), and the step
    is within K5's tolerance of its plain version."""
    _card()
    args = _int8_args(cx, torch.bfloat16, shape=(2, 21, 37), seed=42, ch=ch)
    before = Q.int8_gate_sums.launches, Q.fused_convlstm_step_int8.launches
    sums = Q.int8_gate_sums(args[0], args[1], args[3])
    got = Q.fused_convlstm_step_int8(*args)
    torch.cuda.synchronize()
    assert (Q.int8_gate_sums.launches, Q.fused_convlstm_step_int8.launches) == (
        before[0] + 1, before[1] + 1)
    assert sums.shape == (2, 21, 37, 4 * ch) and sums.dtype == torch.int32
    want = Q.int8_accumulate(args[0].cpu(), args[1].cpu(), args[3].cpu())
    assert torch.equal(sums.cpu(), want)
    _int8_close(got, Q.fused_convlstm_step_int8_ref(*args), 2.0 ** -7)


@pytest.mark.gpu
@pytest.mark.parametrize("cx, ch", [(256, 128), (13, 8), (64, 64)])
def test_int8_kernel_sums_at_the_extremes_on_card(cx, ch):
    """Every activation and weight at +-127: the largest sums a step can make
    (127^2 * 9 * (Cx + Ch), 5.6e7 at Cx=256, Ch=128) come out exact."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(43)
    xq = torch.full((1, 9, 17, cx), 127, dtype=torch.int8, device="cuda")
    hq = torch.full((1, 9, 17, ch), 127, dtype=torch.int8, device="cuda")
    signs = torch.randint(0, 2, (3, 3 * cx + 3 * ch, 4 * ch), generator=g, device="cuda")
    w3q = ((signs * 2 - 1) * 127).to(torch.int8)
    w3q[..., 0] = 127
    sums = Q.int8_gate_sums(xq, hq, w3q)
    want = Q.int8_accumulate(xq.cpu(), hq.cpu(), w3q.cpu())
    assert int(want[0, 4, 8, 0]) == 127 * 127 * 9 * (cx + ch)
    assert torch.equal(sums.cpu(), want)


@pytest.mark.gpu
def test_int8_kernel_dispatch_rule_on_card():
    """A CUDA tensor outside K5's rule (hidden 136) is refused and names the
    rule, not handed to the plain version; no launch is counted."""
    _card()
    args = list(_int8_args(12, torch.bfloat16))
    wide = _int8_args(12, torch.bfloat16, ch=136, shape=(1, 8, 8))
    before = Q.fused_convlstm_step_int8.launches
    with pytest.raises(ValueError, match=r"1 <= Ch <= 128 and 1 <= Cx <= 256"):
        Q.fused_convlstm_step_int8(*wide)
    with pytest.raises(TypeError, match="c must be"):
        Q.fused_convlstm_step_int8(args[0], args[1], args[2].half(), *args[3:])
    with pytest.raises(ValueError, match="is on cpu"):
        Q.fused_convlstm_step_int8(args[0], args[1].cpu(), *args[2:])
    assert Q.fused_convlstm_step_int8.launches == before


@pytest.mark.gpu
def test_int8_rollout_through_k5_on_card():
    """A hidden-64 rollout (T=2, F=3, 24x40): 2T + 2F K5 launches, and the
    rollout through the plain version within 2e-2 on the sigmoid outputs."""
    _card()
    from satflow_tpu_torch.models.conv_lstm import ConvLSTMCore

    core = ConvLSTMCore(hidden_dim=64, in_channels=12, out_channels=12, forecast_steps=3,
                        generator=torch.Generator().manual_seed(0)).cuda().eval()
    qp = Q.quantize_convlstm_params(core)
    x = torch.rand(2, 2, 24, 40, 12, device="cuda")
    before = Q.fused_convlstm_step_int8.launches
    with torch.inference_mode():
        y = Q.int8_rollout(qp, x, 3)
        torch.cuda.synchronize()
        assert Q.fused_convlstm_step_int8.launches == before + 10
        want = Q.int8_rollout(qp, x, 3, step=Q.fused_convlstm_step_int8_ref)
    assert y.shape == (2, 3, 24, 40, 12) and y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), want.float(), atol=2e-2, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("hidden", [32, 24])
def test_int8_rollout_at_other_widths_through_k5_on_card(hidden):
    """The int8 rollout at hidden widths K5 is not built for: the weights are
    padded once, by ``quantize_convlstm_params`` on the card, every cell step
    is a K5 launch, and the rollout through the plain step on the unpadded
    weights agrees within 2e-2."""
    _card()
    from satflow_tpu_torch.models.conv_lstm import ConvLSTMCore

    core = ConvLSTMCore(hidden_dim=hidden, in_channels=12, out_channels=12, forecast_steps=3,
                        generator=torch.Generator().manual_seed(1)).cuda().eval()
    qp = Q.quantize_convlstm_params(core)
    assert qp["encoder_1"].w3q.shape[-1] == 4 * 32  # built for 32; 24 padded to it
    x = torch.rand(2, 2, 24, 40, 12, device="cuda")
    before = Q.fused_convlstm_step_int8.launches
    with torch.inference_mode():
        y = Q.int8_rollout(qp, x, 3)
        torch.cuda.synchronize()
        assert Q.fused_convlstm_step_int8.launches == before + 10
        want = Q.int8_rollout(Q.quantize_convlstm_params(core, pad=False), x, 3,
                              step=Q.fused_convlstm_step_int8_ref)
    assert y.shape == (2, 3, 24, 40, 12) and y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), want.float(), atol=2e-2, rtol=0)


def _cmajor_args(dtype, cx, shape=(2, 10, 70), seed=50, ch=64):
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, h, w = shape
    shapes = (((b, cx, h * w), 1.0), ((b, ch, h * w), 1.0), ((b, ch, h * w), 1.0),
              ((3, 3, cx, 4 * ch), (9 * cx) ** -0.5), ((3, 3, ch, 4 * ch), (9 * ch) ** -0.5),
              ((4 * ch,), 0.1))
    return [(torch.randn(*s, generator=g, device="cuda") * sc).to(dtype) for s, sc in shapes]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("cx", [64, 12])
def test_cmajor_cell_kernel_matches_plain_on_card(dtype, atol, cx):
    """K6a at a ragged size (the 4x32 tiles do not divide 10x70)."""
    _card()
    args = _cmajor_args(dtype, cx)
    before = CM.cmajor_convlstm_step.launches
    h_k, c_k = CM.cmajor_convlstm_step(*args, 10, 70)
    torch.cuda.synchronize()
    assert CM.cmajor_convlstm_step.launches == before + 1
    h_p, c_p = CM.cmajor_convlstm_step_ref(*args, 10, 70)
    torch.testing.assert_close(h_k.float(), h_p.float(), atol=atol, rtol=0)
    torch.testing.assert_close(c_k.float(), c_p.float(), atol=atol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("ch", [8, 16, 32, 128, 24, 1])
@pytest.mark.parametrize("cx", [1, 12, 256])
def test_cmajor_cell_kernel_at_every_width_on_card(dtype, atol, cx, ch):
    """K6a at every hidden width it is built for and at two it is not (padded
    to 32 and 8 inside the wrapper), with 1, 12 and 256 input channels, at a
    ragged size; one counted launch, outputs of the unpadded shape."""
    _card()
    args = _cmajor_args(dtype, cx, ch=ch, seed=51)
    before = CM.cmajor_convlstm_step.launches
    h_k, c_k = CM.cmajor_convlstm_step(*args, 10, 70)
    torch.cuda.synchronize()
    assert CM.cmajor_convlstm_step.launches == before + 1
    assert h_k.shape == args[1].shape and c_k.shape == args[2].shape
    h_p, c_p = CM.cmajor_convlstm_step_ref(*args, 10, 70)
    torch.testing.assert_close(h_k.float(), h_p.float(), atol=atol, rtol=0)
    torch.testing.assert_close(c_k.float(), c_p.float(), atol=atol, rtol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-4, 0),
                                               (torch.bfloat16, 3e-2, 2.0 ** -7)])
@pytest.mark.parametrize("cin, cout", [(64, 12), (8, 16), (24, 1)])
def test_cmajor_conv_kernel_matches_plain_on_card(dtype, atol, rtol, cin, cout):
    """K6b at a ragged size; the head's outputs are not range-bound, so bf16
    is held to one bf16 step (2^-7 relative) beyond the absolute slack."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(60)
    x = torch.randn(2, cin, 10 * 70, generator=g, device="cuda").to(dtype)
    w = (torch.randn(3, 3, cin, cout, generator=g, device="cuda") * 0.05).to(dtype)
    b = (torch.randn(cout, generator=g, device="cuda") * 0.1).to(dtype)
    before = CM.cmajor_conv3x3.launches
    out = CM.cmajor_conv3x3(x, w, b, 10, 70)
    torch.cuda.synchronize()
    assert CM.cmajor_conv3x3.launches == before + 1 and out.shape == (2, cout, 700)
    torch.testing.assert_close(out.float(), CM.cmajor_conv3x3_ref(x, w, b, 10, 70).float(),
                               atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-4, 1e-5),
                                               (torch.bfloat16, 2e-2, 2e-2)])
@pytest.mark.parametrize("bsz, hgt, wdt, cin, cout", [
    (2, 10, 18, 1, 1), (2, 10, 18, 12, 16), (1, 50, 72, 12, 1), (2, 33, 40, 128, 16),
    (1, 7, 5, 64, 12), (3, 16, 64, 20, 5), (1, 64, 256, 64, 12)])
def test_cmajor_conv_kernels_at_the_edges_on_card(dtype, atol, rtol, bsz, hgt, wdt, cin, cout):
    """K6b (the tensor-core kernel in bfloat16, the CUDA-core one in float32) at
    one and many channels in and out, on images that are a multiple of no tile
    and of widths that are and are not multiples of 8."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(61)
    x = torch.randn(bsz, cin, hgt * wdt, generator=g, device="cuda").to(dtype)
    w = (torch.randn(3, 3, cin, cout, generator=g, device="cuda") * (9 * cin) ** -0.5).to(dtype)
    b = (torch.randn(cout, generator=g, device="cuda") * 0.1).to(dtype)
    before = CM.cmajor_conv3x3.launches
    out = CM.cmajor_conv3x3(x, w, b, hgt, wdt)
    torch.cuda.synchronize()
    assert CM.cmajor_conv3x3.launches == before + 1 and out.shape == (bsz, cout, hgt * wdt)
    torch.testing.assert_close(out.float(), CM.cmajor_conv3x3_ref(x, w, b, hgt, wdt).float(),
                               atol=atol, rtol=rtol)


@pytest.mark.gpu
def test_cmajor_kernels_dispatch_rule_on_card():
    """CUDA tensors outside the kernels' domain are refused; the Functions'
    backward gives the plain step's gradients."""
    _card()
    args = _cmajor_args(torch.float32, 64)
    before = CM.cmajor_convlstm_step.launches
    wide = _cmajor_args(torch.float32, 12, ch=136, shape=(1, 2, 70))
    with pytest.raises(ValueError, match=r"1 <= Ch <= 128 \(built for \(8, 16, 32, 64, 128\)"):
        CM.cmajor_convlstm_step(*wide, 2, 70)
    with pytest.raises(ValueError, match="Cout <= 16"):
        CM.cmajor_conv3x3(args[0], torch.zeros(3, 3, 64, 24, device="cuda"),
                          torch.zeros(24, device="cuda"), 10, 70)
    assert CM.cmajor_convlstm_step.launches == before
    leaves = [t.clone().requires_grad_() for t in args]
    h2, c2 = CM.cmajor_convlstm_step(*leaves, 10, 70)
    assert CM.cmajor_convlstm_step.launches == before + 1
    got = torch.autograd.grad(h2.sum() + c2.square().sum(), leaves)
    ref = [t.clone().requires_grad_() for t in args]
    h2, c2 = CM.cmajor_convlstm_step_ref(*ref, 10, 70)
    for a, b in zip(got, torch.autograd.grad(h2.sum() + c2.square().sum(), ref)):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()), rtol=0)


@pytest.mark.gpu
def test_cmajor_core_through_k6_on_card():
    """A hidden-64 ``cell_impl="cmajor"`` core (T=2, F=3, 8x128): 2T K1, 2F
    K6a and F K6b launches, and the fused rollout within 1e-4 (f32)."""
    _card()
    from satflow_tpu_torch.models.conv_lstm import ConvLSTMCore

    kw = dict(hidden_dim=64, in_channels=12, out_channels=12, forecast_steps=3)
    m_c = ConvLSTMCore(cell_impl="cmajor", generator=torch.Generator().manual_seed(0), **kw)
    m_f = ConvLSTMCore(cell_impl="fused", **kw)
    m_f.load_state_dict(m_c.state_dict())
    m_c, m_f = m_c.cuda().eval(), m_f.cuda().eval()
    x = torch.rand(2, 2, 8, 128, 12, device="cuda")
    counts = lambda: (P.fused_convlstm_step.launches, CM.cmajor_convlstm_step.launches,  # noqa: E731
                      CM.cmajor_conv3x3.launches)
    before = counts()
    with torch.inference_mode():
        y = m_c(x)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(counts(), before)) == (4, 6, 3)
        want = m_f(x)
    torch.testing.assert_close(y, want, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("hidden", [32, 24])
def test_cmajor_core_at_other_widths_on_card(hidden):
    """``cell_impl="cmajor"`` at hidden 32 (built) and 24 (padded to 32): the
    same launches as at 64, and the fused rollout within 1e-4 (f32)."""
    _card()
    from satflow_tpu_torch.models.conv_lstm import ConvLSTMCore

    kw = dict(hidden_dim=hidden, in_channels=12, out_channels=12, forecast_steps=3)
    m_c = ConvLSTMCore(cell_impl="cmajor", generator=torch.Generator().manual_seed(2), **kw)
    m_f = ConvLSTMCore(cell_impl="fused", **kw)
    m_f.load_state_dict(m_c.state_dict())
    m_c, m_f = m_c.cuda().eval(), m_f.cuda().eval()
    x = torch.rand(2, 2, 8, 128, 12, device="cuda")
    counts = lambda: (P.fused_convlstm_step.launches, CM.cmajor_convlstm_step.launches,  # noqa: E731
                      CM.cmajor_conv3x3.launches)
    before = counts()
    with torch.inference_mode():
        y = m_c(x)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(counts(), before)) == (4, 6, 3)
        want = m_f(x)
    torch.testing.assert_close(y, want, atol=1e-4, rtol=0)


def _halo_args(dtype, cx, seed=70):
    """K1's arguments at 24x36: three row blocks of 8, ragged in W."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = (((2, 24, 36, cx), 1.0), ((2, 24, 36, 64), 1.0), ((2, 24, 36, 64), 1.0),
              ((3, 3, cx, 256), 0.1), ((3, 3, 64, 256), 0.04), ((256,), 0.1))
    return [(torch.randn(*s, generator=g, device="cuda") * sc).to(dtype) for s, sc in shapes]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("cx", [12, 64])
def test_halo_kernel_matches_plain_and_k1_on_card(dtype, atol, cx):
    """K1h against its plain version and against K1 (same sums, same order:
    f32 1e-5), K1's counter untouched."""
    _card()
    args = _halo_args(dtype, cx)
    before = P.fused_convlstm_step_halo.launches, P.fused_convlstm_step.launches
    h_k, c_k = P.fused_convlstm_step_halo(*args)
    torch.cuda.synchronize()
    assert (P.fused_convlstm_step_halo.launches, P.fused_convlstm_step.launches) == (
        before[0] + 1, before[1])
    h_p, c_p = P.fused_convlstm_step_halo_ref(*args)
    torch.testing.assert_close(h_k.float(), h_p.float(), atol=atol, rtol=0)
    torch.testing.assert_close(c_k.float(), c_p.float(), atol=atol, rtol=0)
    h_1, c_1 = P._step(*args)
    k1_atol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(h_k.float(), h_1.float(), atol=k1_atol, rtol=0)
    torch.testing.assert_close(c_k.float(), c_1.float(), atol=k1_atol, rtol=2.0 ** -7)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("ch", [8, 16, 32, 128, 256, 24, 136])
@pytest.mark.parametrize("cx", [1, 12])
def test_halo_kernel_at_every_width_on_card(dtype, atol, cx, ch):
    """K1h at every hidden width it is built for and at two it is not (padded
    to 32 and 256), at 24x36 (three row blocks, two tiles a block at Ch >=
    128); one counted launch, against its plain version and against K1."""
    _card()
    args = _width_args(cx, ch, dtype, seed=72, shape=(2, 24, 36))[:6]
    before = P.fused_convlstm_step_halo.launches
    h_k, c_k = P.fused_convlstm_step_halo(*args)
    torch.cuda.synchronize()
    assert P.fused_convlstm_step_halo.launches == before + 1
    assert h_k.shape == args[1].shape and c_k.shape == args[2].shape
    h_p, c_p = P.fused_convlstm_step_halo_ref(*args)
    torch.testing.assert_close(h_k.float(), h_p.float(), atol=atol, rtol=atol)
    torch.testing.assert_close(c_k.float(), c_p.float(), atol=atol, rtol=atol)
    h_1, c_1 = P._step(*args)
    k1_atol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(h_k.float(), h_1.float(), atol=k1_atol, rtol=0)
    torch.testing.assert_close(c_k.float(), c_1.float(), atol=k1_atol, rtol=2.0 ** -7)


@pytest.mark.gpu
def test_halo_variant_switch_and_dispatch_rule_on_card(monkeypatch):
    """``SATFLOW_STEP_VARIANT=halo`` sends the step, bare and under autograd,
    through K1h (backward: K2); a geometry K1h does not take raises."""
    _card()
    args = _halo_args(torch.float32, 12, seed=71)
    counts = lambda: (P.fused_convlstm_step.launches, P.fused_convlstm_step_halo.launches,  # noqa: E731
                      P.gate_bwd.launches)
    want = P.fused_convlstm_step_ref(*args)
    monkeypatch.setenv("SATFLOW_STEP_VARIANT", "halo")
    before = counts()
    with torch.no_grad():
        got = P.fused_convlstm_step(*args)
    leaves = [a.clone().requires_grad_() for a in args]
    h2, c2 = P.fused_convlstm_step(*leaves)
    (h2.sum() + c2.square().sum()).backward()
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 2, 1)
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in leaves)
    with pytest.raises(ValueError, match="H % block_h"):
        P.fused_convlstm_step(*[a[:, :20].contiguous() if a.dim() == 4 and a.shape[0] == 2 else a
                                for a in args])
    with pytest.raises(ValueError, match="row blocks of 8"):
        P.fused_convlstm_step_halo(*args, block_h=4)
    monkeypatch.setenv("SATFLOW_STEP_VARIANT", "3pass")
    before = counts()
    with torch.no_grad():
        P.fused_convlstm_step(*args)
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 0, 0)


def _padded_args(dtype, cx, seed=80):
    """(xp, hp, c, wx, wh, b) at 20x36 (+2), ragged in H and W, zero halo columns."""
    x, h, c, wx, wh, b = _args(dtype, seed=seed) if cx == 12 else _cmajor_like(dtype, seed)
    return XT.pad_w(x).contiguous(), XT.pad_w(h).contiguous(), c, wx, wh, b


def _cmajor_like(dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = (((2, 20, 36, 64), 1.0),) * 3 + (((3, 3, 64, 256), 0.04),) * 2 + (((256,), 0.1),)
    return [(torch.randn(*s, generator=g, device="cuda") * sc).to(dtype) for s, sc in shapes]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("cx", [12, 64])
@pytest.mark.parametrize("name", ["tap9", "padded"])
def test_tap9_kernel_matches_plain_and_k1_on_card(dtype, atol, cx, name):
    """T1, and the study's yardstick K1p, against their plain versions and,
    on the interior, against K1; the halo columns of h' exactly zero."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _padded_args(dtype, cx)
    step, ref = getattr(XT, f"step_{name}"), getattr(XT, f"step_{name}_ref")
    before = step.launches
    h_k, c_k = step(*args, block_h=4)
    torch.cuda.synchronize()
    assert step.launches == before + 1 and h_k.shape == args[1].shape
    h_p, c_p = ref(*args)
    torch.testing.assert_close(h_k.float(), h_p.float(), atol=atol, rtol=0)
    torch.testing.assert_close(c_k.float(), c_p.float(), atol=atol, rtol=0)
    assert float(h_k[:, :, (0, -1)].abs().max()) == 0
    h_1, c_1 = P._step(args[0][:, :, 1:-1].contiguous(), args[1][:, :, 1:-1].contiguous(), *args[2:])
    k1_atol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(h_k[:, :, 1:-1].float(), h_1.float(), atol=k1_atol, rtol=0)
    torch.testing.assert_close(c_k.float(), c_1.float(), atol=k1_atol, rtol=2.0 ** -7)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, rel", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("cx", [12, 64])
def test_nogate_kernel_matches_plain_on_card(dtype, rel, cx):
    """T2 against its plain version, relative to max|plain| (its outputs are
    unbounded sums); the halo columns of h' exactly zero."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _padded_args(dtype, cx, seed=81)
    before = XT.step_nogate.launches
    h_k, c_k = XT.step_nogate(*args, block_h=4)
    torch.cuda.synchronize()
    assert XT.step_nogate.launches == before + 1
    h_p, c_p = XT.step_nogate_ref(*args)
    for got, want in ((h_k, h_p), (c_k, c_p)):
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=rel * float(want.float().abs().max()), rtol=0)
    assert float(h_k[:, :, (0, -1)].abs().max()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("cx, ch", [(8, 8), (12, 32), (13, 24), (1, 8)])
@pytest.mark.parametrize("name", ["tap9", "padded", "nogate"])
def test_study_kernels_at_other_widths_on_card(dtype, atol, cx, ch, name):
    """T1, K1p and T2 at the JAX tool's width (Cx = Ch = 8), at hidden 32 and
    at widths they are not built for (padded inside the wrapper): one counted
    launch, against the plain versions (T2 relative to max|plain|)."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    x, h, c, wx, wh, b = _width_args(cx, ch, dtype, seed=82, shape=(2, 20, 36))[:6]
    args = XT.pad_w(x).contiguous(), XT.pad_w(h).contiguous(), c, wx, wh, b
    step, ref = getattr(XT, f"step_{name}"), getattr(XT, f"step_{name}_ref")
    before = step.launches
    h_k, c_k = step(*args, block_h=4)
    torch.cuda.synchronize()
    assert step.launches == before + 1 and h_k.shape == args[1].shape
    h_p, c_p = ref(*args)
    for got, want in ((h_k, h_p), (c_k, c_p)):
        tol = atol * float(want.float().abs().max()) if name == "nogate" else atol
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert float(h_k[:, :, (0, -1)].abs().max()) == 0


TOL_SAME_SUMS_BF16 = dict(atol=2.0 ** -7, rtol=2.0 ** -7)
TOL_NOGATE_REL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


@pytest.mark.gpu
@pytest.mark.parametrize("ch", [8, 16, 32, 64, 128, 24])
@pytest.mark.parametrize("cx", [1, 12, 64])
@pytest.mark.parametrize("name", ["tap9", "padded", "nogate"])
def test_study_kernels_on_the_tensor_cores_at_every_width_on_card(name, cx, ch):
    """T1, K1p and T2 in bf16 (the tensor-core kernels) at every hidden width
    they are built for and at 24 (padded to 32), Cx 1, 12 and 64: one counted
    launch, the halo columns of h' exactly zero, against their plain versions
    and T1 and K1p against K1 on the interior."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    x, h, c, wx, wh, b = _width_args(cx, ch, torch.bfloat16, seed=83, shape=(2, 20, 36))[:6]
    args = XT.pad_w(x).contiguous(), XT.pad_w(h).contiguous(), c, wx, wh, b
    step, ref = getattr(XT, f"step_{name}"), getattr(XT, f"step_{name}_ref")
    before = step.launches
    h_k, c_k = step(*args, block_h=4)
    torch.cuda.synchronize()
    assert step.launches == before + 1
    assert h_k.shape == args[1].shape and c_k.shape == c.shape
    assert float(h_k[:, :, (0, -1)].abs().max()) == 0
    h_p, c_p = ref(*args)
    if name == "nogate":
        for got, want in ((h_k, h_p), (c_k, c_p)):
            scale = float(want.float().abs().max())
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=TOL_NOGATE_REL[torch.bfloat16] * scale)
        return
    tol = TOL_SAME_SUMS_BF16 if name == "tap9" else dict(atol=3e-2, rtol=0)
    torch.testing.assert_close(h_k.float(), h_p.float(), **tol)
    torch.testing.assert_close(c_k.float(), c_p.float(), **tol)
    h_1, c_1 = P._step(x, h, c, wx, wh, b)
    torch.testing.assert_close(h_k[:, :, 1:-1].float(), h_1.float(), **TOL_SAME_SUMS_BF16)
    torch.testing.assert_close(c_k.float(), c_1.float(), **TOL_SAME_SUMS_BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cx, ch", [(64, 64), (12, 32), (1, 8), (13, 24), (64, 128)])
def test_nogate_sums_hold_the_whole_contraction_on_card(dtype, cx, ch):
    """T2's sums entry point: the o + g gate slots its epilogue does not read
    against the plain sums, so the whole contraction is held; h' and c' as
    T2's; one counted launch."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    x, h, c, wx, wh, b = _width_args(cx, ch, dtype, seed=84, shape=(2, 20, 36))[:6]
    args = XT.pad_w(x).contiguous(), XT.pad_w(h).contiguous(), c, wx, wh, b
    before = XT.step_nogate.launches
    h_k, c_k, og = XT.step_nogate_sums(*args, block_h=4)
    torch.cuda.synchronize()
    assert XT.step_nogate.launches == before + 1
    assert og.dtype == torch.float32 and og.shape == c.shape
    want = XT.nogate_sums_ref(*args)
    torch.testing.assert_close(og, want, rtol=0,
                               atol=TOL_NOGATE_REL[torch.float32] * float(want.abs().max()))
    h_t2, c_t2 = XT.step_nogate(*args, block_h=4)
    assert torch.equal(h_k, h_t2) and torch.equal(c_k, c_t2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("ch", [8, 16, 32, 64, 128, 24])
@pytest.mark.parametrize("block_h", [4, 8])
def test_exp_cmajor_kernel_at_other_widths_on_card(dtype, atol, ch, block_h):
    """T3 at every width it is built for (the JAX tool's C = 8, 16 among them)
    and at 24 (padded to 32), with block_h 4 (the bf16 kernel's 8-row tiles
    straddle pad and image rows) and 8: one counted launch, against its plain
    version, pad rows zero."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    height, width = 16, 40
    x, h, c, wx, wh, b = _width_args(ch, ch, dtype, seed=91, shape=(2, height, width))[:6]
    carry = [XC.to_cmajor(t, block_h) for t in (x, h, c)]
    w9, b2 = XC.weights_cmajor(wx, wh), b.reshape(-1, 1)
    before = XC.cmajor_step.launches
    h_k, c_k = XC.cmajor_step(*carry, w9, b2, block_h, height, width)
    torch.cuda.synchronize()
    assert XC.cmajor_step.launches == before + 1 and h_k.shape == carry[1].shape
    h_p, c_p = XC.cmajor_step_ref(*carry, w9, b2, block_h, height, width)
    torch.testing.assert_close(h_k.float(), h_p.float(), atol=atol, rtol=0)
    torch.testing.assert_close(c_k.float(), c_p.float(), atol=atol, rtol=atol)
    rows = h_k.reshape(2, ch, height + 2 * block_h, width)
    assert float(rows[:, :, :block_h].abs().max()) == 0 == float(rows[:, :, -block_h:].abs().max())


@pytest.mark.gpu
def test_study_steps_dispatch_rule_on_card():
    """CUDA tensors outside the study kernels' domain are refused."""
    _card()
    args = _padded_args(torch.float32, 12)
    before = XT.step_tap9.launches, XT.step_nogate.launches
    with pytest.raises(ValueError, match="H % block_h"):
        XT.step_tap9(*args, block_h=8)
    with pytest.raises(ValueError, match="is on cpu"):
        XT.step_nogate(args[0], args[1].cpu(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        XT.step_tap9(args[0].transpose(1, 2), *args[1:])
    assert (XT.step_tap9.launches, XT.step_nogate.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("height, width, block_h", [(12, 70, 4), (16, 33, 8)])
def test_exp_cmajor_kernel_matches_plain_and_k6a_on_card(dtype, atol, height, width, block_h):
    """T3 at ragged widths against its plain version and, through the layout
    helpers, against K6a; pad rows exactly zero, and a second step on its own
    outputs stays equal to two K6a steps."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(90)
    shapes = (((2, height, width, 64), 1.0),) * 3 + (((3, 3, 64, 256), 0.04),) * 2 + (((256,), 0.1),)
    x, h, c, wx, wh, b = [(torch.randn(*s, generator=g, device="cuda") * sc).to(dtype)
                          for s, sc in shapes]
    carry = [XC.to_cmajor(t, block_h) for t in (x, h, c)]
    w9, b2 = XC.weights_cmajor(wx, wh), b.reshape(-1, 1)
    before = XC.cmajor_step.launches
    h_k, c_k = XC.cmajor_step(*carry, w9, b2, block_h, height, width)
    torch.cuda.synchronize()
    assert XC.cmajor_step.launches == before + 1
    h_p, c_p = XC.cmajor_step_ref(*carry, w9, b2, block_h, height, width)
    torch.testing.assert_close(h_k.float(), h_p.float(), atol=atol, rtol=0)
    torch.testing.assert_close(c_k.float(), c_p.float(), atol=atol, rtol=0)
    for t in (h_k, c_k):
        rows = t.reshape(2, 64, height + 2 * block_h, width)
        assert float(rows[:, :, :block_h].abs().max()) == 0
        assert float(rows[:, :, -block_h:].abs().max()) == 0
    k6 = CM.cmajor_convlstm_step(CM.to_cmajor(x), CM.to_cmajor(h), CM.to_cmajor(c), wx, wh, b,
                                 height, width)
    k6_atol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for got, want in zip((h_k, c_k), k6):
        torch.testing.assert_close(XC.from_cmajor(got, height, width, block_h).float(),
                                   CM.from_cmajor(want, height, width).float(),
                                   atol=k6_atol, rtol=2.0 ** -7)
    h_k2, _ = XC.cmajor_step(h_k, h_k, c_k, w9, b2, block_h, height, width)
    k6_2, _ = CM.cmajor_convlstm_step(k6[0], k6[0], k6[1], wx, wh, b, height, width)
    torch.testing.assert_close(XC.from_cmajor(h_k2, height, width, block_h).float(),
                               CM.from_cmajor(k6_2, height, width).float(),
                               atol=10 * k6_atol, rtol=2.0 ** -6)


@pytest.mark.gpu
def test_exp_cmajor_dispatch_rule_on_card():
    _card()
    z = torch.zeros(1, 64, (8 + 2 * 2) * 32, device="cuda")
    w9, b2 = torch.zeros(9, 256, 128, device="cuda"), torch.zeros(256, 1, device="cuda")
    before = XC.cmajor_step.launches
    with pytest.raises(ValueError, match="block_h % 4"):
        XC.cmajor_step(z, z, z, w9, b2, 2, 8, 32)
    z136 = torch.zeros(1, 136, (8 + 8) * 32, device="cuda")
    with pytest.raises(ValueError, match=r"1 <= C <= 128 \(built for"):
        XC.cmajor_step(z136, z136, z136, torch.zeros(9, 544, 272, device="cuda"),
                       torch.zeros(544, 1, device="cuda"), 4, 8, 32)
    assert XC.cmajor_step.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("tool", ["tap9", "cmajor"])
def test_study_tool_mains_run_on_card(tool, capsys):
    """The two study entry points verify and time at a small size."""
    _card()
    if tool == "tap9":
        out = XT.main(bsz=1, size=32, ch=64, steps=2)
        assert set(out) == {"k1", "k1_padded", "tap9", "nogate"}
    else:
        out = XC.main(bsz=1, height=32, width=32, ch=64, block_h=8, steps=2)
        assert set(out) == {"k6a", "t3"}
    assert all(v > 0 for v in out.values())
    assert "ms" in capsys.readouterr().out


# -- eval, losses and baselines on the card -------------------------------------
# SSIM / MS-SSIM and the flow ops against the same calls on the CPU: float32,
# the same f32 arithmetic by other library kernels: atol 1e-5 (x max|grad|
# for gradients; rtol 1e-5 for the baseline's MSE curves). evaluate_model's
# curves through K1 (float32) against the plain step on the CPU: MSE rtol
# 1e-4, SSIM and MS-SSIM atol 1e-5.


def _image_pair(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(*shape, generator=g)
    return x, (x + 0.2 * torch.randn(*shape, generator=g)).clamp(0, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("fn", ["ssim", "ms_ssim"])
def test_ssim_on_card_matches_cpu_with_tf32_allowed(fn):
    """With cuDNN's TF32 allowed process-wide, the blur still sums in full
    float32, forward and backward."""
    from satflow_tpu_torch.ops import ssim as S

    _card()
    x, y = _image_pair((2, 3, 64, 64, 4))
    want_x = x.clone().requires_grad_()
    want = getattr(S, fn)(want_x, y)
    want.backward()
    torch.backends.cudnn.allow_tf32 = True
    try:
        got_x = x.cuda().requires_grad_()
        got = getattr(S, fn)(got_x, y.cuda())
        got.backward()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert abs(got.item() - want.item()) <= 1e-5
    scale = want_x.grad.abs().max().item()
    assert (got_x.grad.cpu() - want_x.grad).abs().max().item() <= 1e-5 * scale


@pytest.mark.gpu
def test_flow_ops_on_card_match_cpu():
    from satflow_tpu_torch.ops import flow as FL

    _card()
    prev, _ = _image_pair((24, 20), seed=1)
    curr = torch.roll(prev, 1, dims=1)
    want = FL.horn_schunck_flow(prev, curr)
    got = FL.horn_schunck_flow(prev.cuda(), curr.cuda())
    assert got.device.type == "cuda"
    assert (got.cpu() - want).abs().max().item() <= 1e-5
    frames = FL.rollout_warp(curr.cuda(), got, 4).cpu()
    assert (frames - FL.rollout_warp(curr, want, 4)).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_run_baseline_on_card_matches_cpu():
    from satflow_tpu_torch.baseline import run_baseline
    from satflow_tpu_torch.data import AdvectionDataset

    _card()
    ds = AdvectionDataset(batch_size=2, width=16, height=16, number_sat_channels=2,
                          history_minutes=15, forecast_minutes=20, length=2)
    for method in ("farneback", "horn_schunck"):
        want = run_baseline(ds, forecast_steps=4, flow_method=method, device="cpu")
        got = run_baseline(ds, forecast_steps=4, flow_method=method, device="cuda")
        for key in ("flow_loss", "baseline_loss"):
            torch.testing.assert_close(torch.from_numpy(got[key]), torch.from_numpy(want[key]),
                                       rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_evaluate_model_on_card_through_k1():
    """Every cell step of the scored rollouts a K1 launch; the curves against
    the same model's on the CPU."""
    from satflow_tpu_torch.data import AdvectionDataset
    from satflow_tpu_torch.eval import evaluate_model
    from satflow_tpu_torch.models import create_model

    _card()
    model = create_model("encoderdecoderconvlstm", input_channels=2, out_channels=2,
                         forecast_steps=3, hidden_dim=8,
                         generator=torch.Generator().manual_seed(0))
    ds = AdvectionDataset(batch_size=2, width=16, height=16, number_sat_channels=2,
                          history_minutes=15, forecast_minutes=15, length=2)
    want = evaluate_model(model, ds)
    model.cuda()
    before = P.fused_convlstm_step.launches
    got = evaluate_model(model, ds)
    assert P.fused_convlstm_step.launches - before == 2 * (2 * 4 + 2 * 3)
    torch.testing.assert_close(torch.from_numpy(got["mse"]), torch.from_numpy(want["mse"]),
                               rtol=1e-4, atol=0)
    for key in ("ssim", "ms_ssim"):
        torch.testing.assert_close(torch.from_numpy(got[key]), torch.from_numpy(want[key]),
                                   rtol=0, atol=1e-5)


def _fake_dm(n_train):
    from satflow_tpu_torch.data import SatFlowDataModule

    return SatFlowDataModule(fake_data=True, num_workers=0, n_train_data=n_train, n_val_data=1,
                             history_minutes=10, forecast_minutes=10,
                             fake_kwargs=dict(batch_size=2, width=20, height=36,
                                              number_sat_channels=12))


def _small_convlstm():
    from satflow_tpu_torch.models import create_model

    return create_model("encoderdecoderconvlstm", input_channels=12, out_channels=12,
                        forecast_steps=2, hidden_dim=16,
                        generator=torch.Generator().manual_seed(0))


@pytest.mark.gpu
def test_checkpoint_saved_on_card_loads_on_the_cpu(tmp_path):
    """A state trained through K1 and K2 on the card, saved there, reads
    back with ``map_location="cpu"`` equal to the card's tensors, and
    ``local:`` rebuilds the model on the CPU."""
    from satflow_tpu_torch.models import create_model
    from satflow_tpu_torch.train import Trainer
    from satflow_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint

    _card()
    trainer = Trainer(max_steps=1, device="cuda")
    before = P.fused_convlstm_step.launches, P.gate_bwd.launches
    trainer.fit(_small_convlstm(), _fake_dm(1))
    assert P.fused_convlstm_step.launches > before[0] and P.gate_bwd.launches > before[1]
    save_checkpoint(str(tmp_path / "ck"), trainer.state, trainer.model)
    saved = restore_checkpoint(tmp_path / "ck", map_location="cpu")
    for k, v in trainer.model.state_dict().items():
        assert saved["model"][k].device.type == "cpu" and torch.equal(saved["model"][k], v.cpu())
    for i, st in trainer.state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            assert torch.equal(saved["optimizer"]["state"][i][k], v.cpu()), (i, k)
    loaded = create_model(f"local:{tmp_path / 'ck'}")
    assert next(loaded.parameters()).device.type == "cpu" and saved["step"] == 1


@pytest.mark.gpu
def test_resume_on_card_through_k1_and_k2(tmp_path):
    """2 steps, a checkpoint, 2 more through K1 and K2 on the card, against
    4 steps straight: the same step count and launches per step, and the
    weights within 2e-2 x lr (Adam scales each update to about lr; cuDNN's
    weight-grad convs may sum in another order between runs)."""
    from satflow_tpu_torch.train import Trainer
    from satflow_tpu_torch.train.callbacks import ModelCheckpoint

    _card()
    first = Trainer(max_steps=2, device="cuda",
                    callbacks=[ModelCheckpoint(dirpath=str(tmp_path / "ck"))])
    first.fit(_small_convlstm(), _fake_dm(2))
    k1, k2 = P.fused_convlstm_step.launches, P.gate_bwd.launches
    resumed = Trainer(max_steps=4, device="cuda",
                      resume_from_checkpoint=str(tmp_path / "ck" / "last"))
    resumed.fit(_small_convlstm(), _fake_dm(2))
    # 2 steps of (forward + remat recompute) K1 and backward K2, one validation forward
    per_forward = 2 * 3 + 2 * 2
    assert P.fused_convlstm_step.launches - k1 == 2 * 2 * per_forward + per_forward
    assert P.gate_bwd.launches - k2 == 2 * per_forward
    straight = Trainer(max_epochs=2, max_steps=4, device="cuda")
    straight.fit(_small_convlstm(), _fake_dm(2))
    assert resumed.global_step == resumed.state.step == straight.state.step == 4
    lr = resumed.model.lr
    want = straight.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        assert (v - want[k]).abs().max().item() <= 2e-2 * lr, k


# -- the channels-stacked zoo, export and the kernels' dispatcher ops --

# the zoo at small widths: (registry name, keywords); FCN and DeepLabV3 on a
# ResNet of stages (1, 1, 1, 1) and width 4 (the blocks are ResNet-50's)
ZOO_SMALL = {
    "unet": ("unet", dict(features_start=8, depth=3)),
    "runet": ("runet", dict(features_start=8, depth=3)),
    "runet_antialiased": ("runet", dict(features_start=8, depth=3, conv_type="antialiased")),
    "attentionunet": ("attentionunet", dict(features_start=8, depth=3)),
    "attentionrunet": ("attentionrunet", dict(features_start=8, depth=3, conv_type="coord")),
    "fcn": ("fcn", {}),
    "deeplabv3": ("deeplabv3", {}),
    "pixelcnn": ("pixelcnn", dict(hidden_channels=16, num_blocks=2)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("key", list(ZOO_SMALL))
def test_zoo_bf16_forward_on_card_matches_cpu_f32(key, monkeypatch):
    """Each zoo model's bf16 eval forward on the card (f32 weights) against
    its float32 forward on the CPU, b2 x 3 x 64x64x2: atol 5e-2 x max|cpu|
    (bf16 rounds every conv and BatchNorm output, step 2^-8, a few layers
    deep); and the float32 forward on the card to 1e-4 x max|cpu| (TF32 off)."""
    import copy

    import numpy as np

    import satflow_tpu_torch.models  # noqa: F401 - populate the registry
    import satflow_tpu_torch.models.segmentation as seg
    from satflow_tpu_torch.core.registry import create_model
    from satflow_tpu_torch.nn.resnet import ResNetBackbone

    _card()
    monkeypatch.setattr(seg, "ResNetBackbone", lambda stages, **kw: ResNetBackbone(
        (1, 1, 1, 1), width=4, **kw))
    name, kw = ZOO_SMALL[key]
    model = create_model(name, input_channels=2, forecast_steps=2,
                         generator=torch.Generator().manual_seed(0), **kw)
    x = torch.from_numpy(np.random.default_rng(1).random((2, 3, 64, 64, 2), dtype=np.float32))
    model.materialize((x, x))
    model.eval()
    with torch.no_grad():
        want = model(x)
        card = copy.deepcopy(model).cuda()
        got32 = card(x.cuda()).cpu()
        card.set_compute_dtype(torch.bfloat16)
        got = card(x.cuda()).float().cpu()
    scale = want.abs().max().item()
    assert got.shape == want.shape == (2, 2, 64, 64, 1)
    assert (got32 - want).abs().max().item() <= 1e-4 * scale
    assert (got - want).abs().max().item() <= 5e-2 * scale


@pytest.mark.gpu
def test_export_fused_convlstm_roundtrip_on_card(tmp_path):
    """The fused ConvLSTM (hidden 16) exported on the card holds K1 as the
    op ``satflow::fused_convlstm_step``; the loaded program launches it once
    a cell step (2 x 3 + 2 x 4 a call) and replies as the session does, bit
    for bit (the same kernel on the same inputs)."""
    import numpy as np

    import satflow_tpu_torch.models  # noqa: F401 - populate the registry
    from satflow_tpu_torch.core.registry import create_model
    from satflow_tpu_torch.serve.export import export_model, load_exported
    from satflow_tpu_torch.serve.session import InferenceSession

    _card()
    model = create_model("encoderdecoderconvlstm", input_channels=2, out_channels=2,
                         forecast_steps=4, hidden_dim=16,
                         generator=torch.Generator().manual_seed(0))
    session = InferenceSession(model, max_batch=2, state_dict=model.module.state_dict(),
                               dtype=torch.bfloat16, device="cuda")
    path = str(tmp_path / "m.pt2")
    meta = export_model(session.model, None, path, batch=2, history=3, size=24, channels=2,
                        dtype=torch.bfloat16)
    assert meta["platforms"] == ["cuda"]
    art = load_exported(path)
    assert {str(n.target) for n in art.program.graph.nodes if n.op == "call_function"
            and str(n.target).startswith("satflow.")} == {"satflow.fused_convlstm_step.default"}
    x = np.random.default_rng(2).random((2, 3, 24, 24, 2), dtype=np.float32)
    want = session.predict(x)
    before = P.fused_convlstm_step.launches
    got = art(x)
    assert P.fused_convlstm_step.launches - before == 2 * 3 + 2 * 4
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["fused_convlstm_step", "fused_lstm_gates", "axial_attention"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_ops_fake_match_real_on_card(op, dtype):
    """``torch.library.opcheck`` on CUDA tensors: the fake implementation's
    shapes, strides and dtypes against what the kernel returns (K1 also at a
    hidden width it zero-pads inside the launch, 12, whose fake returns the
    unpadded shapes)."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(3)

    def t(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    cases = {
        "fused_convlstm_step": [(t(2, 5, 6, 3), t(2, 5, 6, ch), t(2, 5, 6, ch),
                                 t(3, 3, 3, 4 * ch) * 0.1, t(3, 3, ch, 4 * ch) * 0.1,
                                 t(4 * ch)) for ch in (8, 12)],
        "fused_lstm_gates": [(t(7, 5, 32), t(7, 5, 8))],
        "axial_attention": [(t(6, 16, 8), t(6, 16, 8), t(6, 16, 8)),
                            (t(2, 64, 32), t(2, 64, 32), t(2, 64, 32))],
    }[op]
    for args in cases:
        torch.library.opcheck(getattr(torch.ops.satflow, op).default, args,
                              test_utils=("test_schema", "test_faketensor"))
