"""Hand-written CUDA kernels for the card, each beside its plain PyTorch version.

Importing this package registers the dispatcher ops of the kernels an
exported program may hold (:mod:`satflow_tpu_torch.serve.export`):
``satflow::fused_convlstm_step`` (K1), ``satflow::fused_lstm_gates`` (K3) and
``satflow::axial_attention`` (K4). Nothing is built at import: a kernel is
compiled at its first launch.
"""

from satflow_tpu_torch.ops import axial_attention, fused_convlstm_step, fused_lstm  # noqa: F401
