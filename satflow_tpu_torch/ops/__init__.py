"""Hand-written CUDA kernels for the card, each beside its plain PyTorch version.

Importing this package registers the dispatcher ops of the kernels an
exported program may hold (:mod:`satflow_tpu_torch.serve.export`):
``satflow::fused_convlstm_step`` (K1), ``satflow::fused_convlstm_step_halo``
(K1h), ``satflow::fused_lstm_gates`` (K3), ``satflow::axial_attention`` (K4),
``satflow::cmajor_convlstm_step`` (K6a) and ``satflow::cmajor_conv3x3`` (K6b).
Nothing is built at import: a kernel is compiled at its first launch.
"""

from satflow_tpu_torch.ops import (  # noqa: F401
    axial_attention,
    cmajor_convlstm,
    fused_convlstm_step,
    fused_lstm,
)
