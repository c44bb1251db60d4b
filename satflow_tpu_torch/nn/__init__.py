"""Layers and losses of the PyTorch port."""

from satflow_tpu_torch.nn.conv import (  # noqa: F401
    AddCoords,
    AntialiasedConv,
    BlurPool,
    CoordConv,
    get_conv_layer,
)
from satflow_tpu_torch.nn.losses import get_loss  # noqa: F401
from satflow_tpu_torch.nn.misc import crop_center, space_to_depth  # noqa: F401
from satflow_tpu_torch.nn.recurrent import ConvLSTMCell  # noqa: F401
