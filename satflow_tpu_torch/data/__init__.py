"""Data: the batch-file datasets, the fake backend and the prefetching
datamodule, counterparts of ``satflow_tpu/data`` that yield numpy and put
batches on a torch device."""

from satflow_tpu_torch.data import consts  # noqa: F401
from satflow_tpu_torch.data.datamodule import Prefetcher, SatFlowDataModule  # noqa: F401
from satflow_tpu_torch.data.datasets import (  # noqa: F401
    NpzBatchStore,
    SatFlowDataset,
    write_fake_store,
)
from satflow_tpu_torch.data.fake import AdvectionDataset, FakeDataset  # noqa: F401
