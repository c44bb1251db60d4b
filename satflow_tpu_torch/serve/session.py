"""Inference sessions and cross-request micro-batching.

Counterpart of ``satflow_tpu/serve/session.py``. ``InferenceSession`` holds
a model on one device and runs its forward at one fixed batch size:
requests are zero-padded up to ``max_batch`` and larger ones are chunked, as
in the JAX session (there the fixed shape avoids recompiles; here it keeps
the kernels' launch geometry, and the device memory a forward needs, fixed).

A GAN model (CloudGAN, NowcastingGAN, Pix2Pix) is served by sampling its
generator (``model.sample``): each call draws from a ``torch.Generator``
seeded by a per-call counter, so repeated requests get fresh samples and a
session's n-th call is reproducible. Only the generator is loaded: a GAN
checkpoint's flax variables ``{'params': {'generator', 'discriminator'},
'g', 'd'}`` give their generator subtree.

``MicroBatcher`` is framework-free and is carried over as it is: it
coalesces concurrent requests into one forward call.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from satflow_tpu_torch import resolve_device

# wire formats a prediction may leave the device in (numpy has no bfloat16)
_OUT_DTYPES = (torch.float32, torch.float16)


class InferenceSession:
    """Fixed-batch forward over a loaded model.

    Parameters
    ----------
    model: a BaseModel instance, or a ``create_model`` source string
        (``local:<dir>``, ``torch:<file.ckpt>``, ``hf_hub:<repo>``).
    max_batch: the batch every forward runs at; requests are padded up to it.
    variables: flax variables (``{"params": tree}``, with ``"batch_stats"``
        for a model that has them; numpy leaves), converted by the model's
        own converter (``model.state_dict_from_flax``).
    state_dict: the core's state_dict, as that converter returns it.
        At most one of ``variables`` and ``state_dict``; with neither, the
        session serves the weights a loader restored into the model
        (``model.restored_from``, set by ``create_model``'s sources and
        :mod:`satflow_tpu_torch.train.checkpoint`), and raises for a model
        that holds none.
    dtype: compute dtype (e.g. ``torch.bfloat16``): the input is cast to it
        and the model computes in it (``set_compute_dtype``; f32 weights
        stay); None leaves the model's own and feeds float32.
    out_dtype: wire dtype of predictions (float32 or float16).
    quantize: ``"int8"`` serves a fused-cell ``EncoderDecoderConvLSTM``
        through the int8 rollout (``ops/fused_convlstm_int8.py``: kernel K5
        on the card): weights are quantized once here, the inputs of every
        request must lie in [-1, 1] (:meth:`check_input_range`), and
        ``dtype`` does not apply, since the rollout quantizes its own inputs.
    device: where the model runs, the card unless the caller asks for
        another (``device="cpu"``); without a card ``"cuda"`` raises.
    donate: accepted for the JAX session's signature and ignored: there it
        hands the padded input's buffer to XLA, which has no counterpart in
        an eager forward. With ``quantize="int8"`` or a GAN model it raises,
        as there.
    """

    def __init__(
        self,
        model: Any,
        max_batch: int = 8,
        variables: Optional[dict] = None,
        state_dict: Optional[dict] = None,
        dtype: Optional[torch.dtype] = None,
        out_dtype: Optional[torch.dtype] = None,
        quantize: Optional[str] = None,
        mesh: Any = None,
        device: Any = "cuda",
        donate: bool = False,
    ):
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded serving is not ported yet (ROADMAP queue 1 item 13)"
            )
        if isinstance(model, str):
            from satflow_tpu_torch.core.registry import create_model
            import satflow_tpu_torch.models  # noqa: F401 - populate the registry

            model = create_model(model)
        if quantize and getattr(model, "is_gan", False):
            raise ValueError("int8 serving supports forward models only")
        if quantize and (dtype is not None or donate):
            raise ValueError(
                f"{'dtype' if dtype is not None else 'donate'} does not apply to "
                "quantize='int8' (the rollout quantizes its own inputs)"
            )
        self.is_gan = bool(getattr(model, "is_gan", False))
        if self.is_gan and donate:
            raise ValueError("donate is not supported on the GAN path")
        # MetNet has no cell_impl; a conv type other than "standard" runs the
        # concat cells whatever cell_impl says
        if quantize and (getattr(model, "cell_impl", None) != "fused"
                         or not getattr(model.module, "is_fused", False)):
            raise ValueError(
                "int8 serving requires a fused-cell ConvLSTM model "
                "(EncoderDecoderConvLSTM with cell_impl='fused')"
            )
        if variables is not None and state_dict is not None:
            raise ValueError("pass at most one of variables= (flax) or state_dict=")
        if variables is None and state_dict is None and getattr(model, "restored_from",
                                                                 None) is None:
            raise ValueError(
                "model has no restored_variables; load it from a checkpoint "
                "(local:/torch:/hf_hub:) or pass variables= explicitly"
            )
        if variables is not None:
            state_dict = model.state_dict_from_flax(variables)
        out_dtype = out_dtype or torch.float32
        if out_dtype not in _OUT_DTYPES:
            raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}, got {out_dtype}")
        self.device = resolve_device(device)
        if state_dict is not None:
            model.module.load_state_dict(state_dict)
        if dtype is not None:
            model.set_compute_dtype(dtype)
        self.model = model.to(self.device).eval()
        self.quantize = quantize
        self.qparams = None
        if quantize == "int8":
            from satflow_tpu_torch.ops.fused_convlstm_int8 import quantize_convlstm_params

            self.qparams = quantize_convlstm_params(model.module)
        self._sample_counter = 0  # the GAN path's per-call noise seed
        self.max_batch = int(max_batch)
        self.dtype = dtype
        self.out_dtype = out_dtype
        self._lock = threading.Lock()  # one in-flight forward per session

    @property
    def forecast_steps(self) -> int:
        return int(getattr(self.model, "forecast_steps", 0))

    def info(self) -> dict:
        hp = dict(self.model.hparams())
        hp["max_batch"] = self.max_batch
        hp["device"] = str(self.device)
        return hp

    def check_input_range(self, x: np.ndarray) -> None:
        """Reject out-of-range int8 inputs (a no-op for other sessions).

        The int8 activation scale is fixed for [-1, 1] inputs;
        ``quantize_activations`` would silently clip anything outside (e.g.
        standardized radiances spanning +/-3). ``MicroBatcher`` calls this
        per request before pooling, so one out-of-range client cannot fail
        a coalesced batch for everyone else."""
        if self.qparams is not None and x.size:
            amax = float(np.max(np.abs(x)))
            if amax > 1.0 + 1e-3:
                raise ValueError(
                    f"quantize='int8' expects inputs in [-1, 1]; got "
                    f"|x|max={amax:.3g} — normalize inputs or use the bf16 path"
                )

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if self.qparams is not None:
                from satflow_tpu_torch.ops.fused_convlstm_int8 import int8_rollout

                y = int8_rollout(self.qparams, x.float(), int(self.model.forecast_steps))
            elif self.is_gan:
                noise = torch.Generator(device=self.device).manual_seed(self._sample_counter)
                self._sample_counter += 1
                y = self.model.sample(x.to(self.dtype or torch.float32), noise)
            else:
                y = self.model(x.to(self.dtype or torch.float32))
            return y.to(self.out_dtype)

    def predict(self, x: np.ndarray) -> np.ndarray:
        """(B, T, H, W, C) -> (B, forecast_steps, H, W, C') for any B.

        Pads the batch to ``max_batch`` and strips the pad rows from the
        result; larger batches are chunked.
        """
        x = np.asarray(x)
        if x.ndim == 4:  # single sample convenience
            return self.predict(x[None])[0]
        cin = getattr(self.model, "input_channels", x.shape[-1])
        if x.ndim != 5 or x.shape[-1] != cin:
            raise ValueError(f"expected (B, T, H, W, {cin}) input, got {x.shape}")
        self.check_input_range(x)
        b = x.shape[0]
        if b > self.max_batch:
            outs = [
                self.predict(x[i : i + self.max_batch])
                for i in range(0, b, self.max_batch)
            ]
            return np.concatenate(outs, axis=0)
        if b < self.max_batch:
            pad = np.zeros((self.max_batch - b,) + x.shape[1:], x.dtype)
            x = np.concatenate([x, pad], axis=0)
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        with self._lock:
            y = self._forward(xt)
        return y[:b].cpu().numpy()


class _Pending:
    __slots__ = ("x", "event", "result", "error", "abandoned")

    def __init__(self, x: np.ndarray):
        self.x = x
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        # set by submit() on timeout: the caller is gone, don't burn a
        # forward on it (load shedding under sustained overload)
        self.abandoned = False


class MicroBatcher:
    """Coalesce concurrent single requests into one forward.

    A worker thread collects requests for up to ``window_ms`` (or until
    ``session.max_batch`` samples are queued) and runs them as one padded
    batch. ``submit`` blocks the calling thread until its slice is ready —
    the server handles each HTTP request on its own thread, so N concurrent
    clients fill the batch.
    """

    def __init__(self, session: InferenceSession, window_ms: float = 5.0):
        self.session = session
        self.window = window_ms / 1000.0
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self.batches_run = 0  # observability: how many forwards were issued

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        # fail queued requests immediately: their submit() callers must not
        # sit out their full timeout against a dead worker
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            p.error = RuntimeError("MicroBatcher closed")
            p.event.set()

    def submit(self, x: np.ndarray, timeout: Optional[float] = None) -> np.ndarray:
        """One (T, H, W, C) sample or (b, T, H, W, C) micro-batch."""
        if self._stop.is_set():
            raise RuntimeError("MicroBatcher closed")
        x = np.asarray(x)
        single = x.ndim == 4
        if single:
            x = x[None]
        # per-request validation BEFORE pooling: a 400-class client fault
        # must fail only its own request, not the coalesced group
        self.session.check_input_range(x)
        p = _Pending(x)
        self._q.put(p)
        if self._stop.is_set() and not p.event.is_set():
            # raced with close(): the worker may already be gone
            p.error = p.error or RuntimeError("MicroBatcher closed")
            p.event.set()
        if not p.event.wait(timeout):
            p.abandoned = True
            raise TimeoutError("inference request timed out")
        if p.error is not None:
            raise p.error
        return p.result[0] if single else p.result

    # -- worker ---------------------------------------------------------------

    def _collect(self) -> List[_Pending]:
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        group = [first]
        total = first.x.shape[0]
        deadline = _now() + self.window
        while total < self.session.max_batch:
            remaining = deadline - _now()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            group.append(nxt)
            total += nxt.x.shape[0]
        return group

    def _run(self) -> None:
        while not self._stop.is_set():
            group = self._collect()
            if not group:
                continue
            # shed requests whose submit() already timed out: under sustained
            # overload the backlog is full of abandoned work, and spending
            # forwards on it starves the live requests into timing out too
            group = [p for p in group if not p.abandoned]
            if not group:
                continue
            # one forward per distinct sample shape: a misshapen request must
            # not poison the well-formed ones sharing its window
            by_shape: dict = {}
            for p in group:
                by_shape.setdefault(p.x.shape[1:], []).append(p)
            for shaped in by_shape.values():
                try:
                    x = np.concatenate([p.x for p in shaped], axis=0)
                    y = self.session.predict(x)
                    self.batches_run += 1
                    off = 0
                    for p in shaped:
                        n = p.x.shape[0]
                        p.result = y[off : off + n]
                        off += n
                except BaseException as e:  # noqa: BLE001 - delivered to callers
                    for p in shaped:
                        p.error = e
                finally:
                    for p in shaped:
                        p.event.set()


def _now() -> float:
    import time

    return time.monotonic()
