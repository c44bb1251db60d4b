"""PyTorch port, on a CUDA card only: the fused ConvLSTM-step kernel against
its plain version. It imports nothing of the JAX package, so it runs on a
card's machine that has no flax: ``python -m pytest tests/test_torch_gpu.py``.
Without a card it skips."""

import pytest
import torch

from satflow_tpu_torch.ops import fused_convlstm_step as P


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_kernel_matches_plain_on_card(dtype, atol):
    """The CUDA kernel against its plain version on the card, at a ragged
    size (the 8x16 tiles do not divide 20x36). float32 with TF32 off: the
    same f32 sums in another order; bf16: both store bf16 (step 2^-8) and
    the plain version rounds each conv's output to bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    args = [torch.randn(*s, generator=g, device="cuda") * sc for s, sc in (
        ((2, 20, 36, 12), 1.0), ((2, 20, 36, 64), 1.0), ((2, 20, 36, 64), 1.0),
        ((3, 3, 12, 256), 0.1), ((3, 3, 64, 256), 0.04), ((256,), 0.1))]
    args = [a.to(dtype) for a in args]
    before = P.fused_convlstm_step.launches
    h_k, c_k = P.fused_convlstm_step(*args)
    torch.cuda.synchronize()
    assert P.fused_convlstm_step.launches == before + 1
    h_p, c_p = P.fused_convlstm_step_ref(*args)
    torch.testing.assert_close(h_k.float(), h_p.float(), atol=atol, rtol=0)
    torch.testing.assert_close(c_k.float(), c_p.float(), atol=atol, rtol=0)
