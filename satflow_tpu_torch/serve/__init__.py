"""Serving: inference sessions, a micro-batching HTTP server (stdlib only)
and the one-file export of a model's forward."""

from satflow_tpu_torch.serve.export import ExportedModel, export_model, load_exported
from satflow_tpu_torch.serve.session import InferenceSession, MicroBatcher
from satflow_tpu_torch.serve.server import NowcastServer, serve

__all__ = [
    "ExportedModel",
    "InferenceSession",
    "MicroBatcher",
    "NowcastServer",
    "export_model",
    "load_exported",
    "serve",
]
