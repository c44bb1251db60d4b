"""Training: train state, train/eval steps and the fit/validate/test engine."""

from satflow_tpu_torch.train.engine import Trainer  # noqa: F401
from satflow_tpu_torch.train.state import TrainState  # noqa: F401
