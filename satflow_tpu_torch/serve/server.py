"""Stdlib HTTP server for nowcast inference, counterpart of ``satflow_tpu/serve/server.py``.

Endpoints:

- ``POST /predict`` — body: one ``.npy`` array, ``(T, H, W, C)`` or
  ``(b, T, H, W, C)`` float32; response: the predicted frames as ``.npy``.
  Concurrent requests micro-batch into one forward (serve/session.py).
- ``GET /healthz`` — 200 "ok" once the model is loaded.
- ``GET /info`` — model hyperparameters + serving config as JSON.

Client faults answer 400, timeouts 503 and server faults 500.

Run::

    python -m satflow_tpu_torch.serve.server local:checkpoints/best [--bf16] \\
        [--out-f16] [--device cuda]
    python -m satflow_tpu_torch.serve.server {convlstm,metnet} --weights params.npz

The model is a ``create_model`` source (``local:<dir>``, a checkpoint
directory of the port's training; ``torch:<file.ckpt>``; ``hf_hub:<repo>``),
whose weights it serves, or a config name (``convlstm``, ``metnet``) or
registry name with ``--weights``, a flat ``.npz`` of the JAX model's flax
variables (:func:`satflow_tpu_torch.interop.jax_weights.save_npz` writes one).
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from satflow_tpu_torch.serve.session import InferenceSession, MicroBatcher

_MAX_BODY = 1 << 30  # 1 GiB: a full-disk batch is ~0.5 GiB f32

# model configs by name, as satflow_tpu/configs/model/<name>.yaml ships them
MODEL_CONFIGS = {
    "convlstm": ("encoderdecoderconvlstm", dict(
        hidden_dim=64, input_channels=12, out_channels=12, forecast_steps=24,
        lr=0.001, loss="mse", conv_type="standard",
    )),
    "metnet": ("litmetnet", dict(
        image_encoder="downsampler", input_channels=12, sat_channels=12, input_size=64,
        output_channels=12, hidden_dim=64, kernel_size=3, num_layers=1, num_att_layers=1,
        forecast_steps=24, temporal_dropout=0.2, lr=0.001, loss="mse",
    )),
}


def build_model(name: str):
    """A model by ``create_model`` source (``local:<dir>``, ...), config name
    (``convlstm``, ``metnet``) or registry name."""
    from satflow_tpu_torch.core.registry import create_model
    import satflow_tpu_torch.models  # noqa: F401 - populate the registry

    registry_name, kwargs = MODEL_CONFIGS.get(name, (name, {}))
    return create_model(registry_name, **kwargs)


class NowcastServer:
    """Owns the session + batcher and the threaded HTTP server."""

    def __init__(
        self,
        model,
        host: str = "127.0.0.1",
        port: int = 8500,
        max_batch: Optional[int] = None,
        window_ms: float = 5.0,
        variables: Optional[dict] = None,
        state_dict: Optional[dict] = None,
        dtype=None,
        out_dtype=None,
        device=None,
    ):
        if isinstance(model, InferenceSession):
            if any(v is not None for v in (max_batch, variables, state_dict, dtype,
                                           out_dtype, device)):
                raise ValueError(
                    "max_batch/variables/state_dict/dtype/out_dtype/device "
                    "configure a NEW session; set them on this InferenceSession "
                    "instead"
                )
            self.session = model
        else:
            self.session = InferenceSession(
                model, max_batch=max_batch if max_batch is not None else 8,
                variables=variables, state_dict=state_dict, dtype=dtype,
                out_dtype=out_dtype, device="cuda" if device is None else device,
            )
        self.batcher = MicroBatcher(self.session, window_ms=window_ms)
        handler = _make_handler(self)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def _make_handler(server: NowcastServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if self.close_connection:
                # advertise what we're about to do (set on paths that left
                # the request body unread)
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - http.server API
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/info":
                body = json.dumps(server.session.info(), default=str).encode()
                self._send(200, body, "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):  # noqa: N802
            if self.path != "/predict":
                # the body was not read: a keep-alive peer would see its own
                # body bytes parsed as the next request line
                self.close_connection = True
                self._send(404, b"not found", "text/plain")
                return
            try:
                # parse phase: OSError/EOFError here come from the client's
                # body bytes and ARE client faults (400)
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    n = -1  # malformed header: body size unknown
                if not 0 < n <= _MAX_BODY:
                    # body left unread — a kept-alive peer would see its own
                    # body bytes parsed as the next request line
                    self.close_connection = True
                    raise ValueError(
                        f"bad Content-Length "
                        f"{self.headers.get('Content-Length')!r}"
                    )
                raw = self.rfile.read(n)
                x = np.load(io.BytesIO(raw), allow_pickle=False)
                if x.ndim not in (4, 5):
                    raise ValueError(
                        f"expected (T,H,W,C) or (b,T,H,W,C), got {x.shape}"
                    )
            except Exception as e:  # noqa: BLE001 - reported to the client
                body = json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
                self._send(400, body, "application/json")
                return
            try:
                y = server.batcher.submit(x, timeout=120.0)
                buf = io.BytesIO()
                np.save(buf, np.ascontiguousarray(y))
                self._send(200, buf.getvalue(), "application/octet-stream")
            except Exception as e:  # noqa: BLE001 - reported to the client
                # serve phase: overload/timeouts are 503; a ValueError is the
                # model rejecting the request (shape mismatch, 400); anything
                # else is a server fault (500)
                if isinstance(e, TimeoutError):
                    code = 503
                elif isinstance(e, ValueError):
                    code = 400
                else:
                    code = 500
                body = json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
                self._send(code, body, "application/json")

    return Handler


def serve(model: str, weights: Optional[str] = None, host: str = "0.0.0.0", port: int = 8500,
          max_batch: int = 8, window_ms: float = 5.0, dtype=None,
          out_dtype=None, device="cuda") -> None:
    from satflow_tpu_torch.interop.jax_weights import read_npz

    srv = NowcastServer(build_model(model), host=host, port=port,
                        max_batch=max_batch, window_ms=window_ms,
                        variables=None if weights is None else read_npz(weights), dtype=dtype,
                        out_dtype=out_dtype, device=device)
    print(f"serving {model} on {host}:{srv.port} (max_batch={max_batch}, "
          f"device={srv.session.device})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.close()


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", help="create_model source (local:<dir>, torch:<file.ckpt>, "
                   "hf_hub:<repo>), config name (convlstm, metnet) or registry name")
    p.add_argument("--weights", default=None,
                   help="flat .npz of flax variables (interop.jax_weights.save_npz); "
                   "a source's own weights are served without it")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--window-ms", type=float, default=5.0)
    p.add_argument("--bf16", action="store_true", help="compute in bfloat16")
    p.add_argument("--out-f16", action="store_true",
                   help="serve float16 predictions (halves the transfer)")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    serve(a.model, a.weights, a.host, a.port, a.max_batch, a.window_ms,
          torch.bfloat16 if a.bf16 else None,
          torch.float16 if a.out_f16 else None, a.device)


if __name__ == "__main__":
    main()
