"""Layers and losses of the PyTorch port."""

from satflow_tpu_torch.nn.conv import (  # noqa: F401
    AddCoords,
    AntialiasedConv,
    BlurPool,
    CoordConv,
    get_conv_layer,
)
from satflow_tpu_torch.nn.losses import GANLoss, get_loss, gradient_penalty  # noqa: F401
from satflow_tpu_torch.nn.misc import (  # noqa: F401
    ConditionTime,
    TimeDistributed,
    condition_time,
    crop_center,
    reverse_space_to_depth,
    space_to_depth,
    time_distributed,
)
from satflow_tpu_torch.nn.norm import (  # noqa: F401
    ConditionalNorm,
    SNConv,
    SNDense,
    SNEmbed,
    SpectralNorm,
)
from satflow_tpu_torch.nn.recurrent import (  # noqa: F401
    ConvGRUCell,
    ConvLSTMCell,
    SpatioTemporalLSTMCell,
    scan_cell,
)
