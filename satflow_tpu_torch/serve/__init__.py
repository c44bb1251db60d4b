"""Serving: inference sessions + a micro-batching HTTP server (stdlib only)."""

from satflow_tpu_torch.serve.session import InferenceSession, MicroBatcher
from satflow_tpu_torch.serve.server import NowcastServer, serve

__all__ = ["InferenceSession", "MicroBatcher", "NowcastServer", "serve"]
