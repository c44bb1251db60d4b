"""Layers and losses of the PyTorch port."""

from satflow_tpu_torch.nn.conv import (  # noqa: F401
    AddCoords,
    AntialiasedConv,
    BlurPool,
    CoordConv,
    get_conv_layer,
)
from satflow_tpu_torch.nn.losses import get_loss  # noqa: F401
from satflow_tpu_torch.nn.misc import (  # noqa: F401
    TimeDistributed,
    crop_center,
    reverse_space_to_depth,
    space_to_depth,
    time_distributed,
)
from satflow_tpu_torch.nn.recurrent import (  # noqa: F401
    ConvLSTMCell,
    SpatioTemporalLSTMCell,
    scan_cell,
)
