"""Model zoo of the PyTorch port; importing it fills the registry."""

from satflow_tpu_torch.core.registry import (  # noqa: F401
    create_model,
    get_model,
    list_models,
    register_model,
)
from satflow_tpu_torch.models.base import BaseModel  # noqa: F401
from satflow_tpu_torch.models.conv_lstm import ConvLSTMCore, EncoderDecoderConvLSTM  # noqa: F401
from satflow_tpu_torch.models.cloudgan import CloudGAN  # noqa: F401
from satflow_tpu_torch.models.dgmr import DGMRGenerator, NowcastingGAN  # noqa: F401
from satflow_tpu_torch.models.hf_perceiver import HuggingFacePerceiver  # noqa: F401
from satflow_tpu_torch.models.metnet import LitMetNet, MetNetCore  # noqa: F401
from satflow_tpu_torch.models.pix2pix import Pix2Pix  # noqa: F401
from satflow_tpu_torch.models.perceiver import Perceiver, PerceiverSatFlowCore  # noqa: F401
from satflow_tpu_torch.models.pixel_cnn import PixelCNN  # noqa: F401
from satflow_tpu_torch.models.segmentation import FCN, DeeplabV3  # noqa: F401
from satflow_tpu_torch.models.unet_family import (  # noqa: F401
    AttentionRUnet,
    AttentionUnet,
    RUnet,
    Unet,
)
