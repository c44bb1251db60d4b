"""Model zoo of the PyTorch port; importing it fills the registry."""

from satflow_tpu_torch.models.conv_lstm import ConvLSTMCore, EncoderDecoderConvLSTM
from satflow_tpu_torch.models.metnet import LitMetNet, MetNetCore

__all__ = ["ConvLSTMCore", "EncoderDecoderConvLSTM", "LitMetNet", "MetNetCore"]
