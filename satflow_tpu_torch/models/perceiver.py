"""Perceiver IO multimodal forecaster, counterpart of ``satflow_tpu/models/perceiver.py``.

The satellite video, the optional NWP video, the topography, the 1-D
coordinate series and the optional datetime features go through a
multimodal Perceiver IO (:mod:`satflow_tpu_torch.nn.perceiver`) with a
learnable decoder query. As in the JAX model:

- the modalities, with the ``forecast_time`` one-hot series when the lead
  times are decoded one at a time;
- :class:`LearnableQuery` with optional temporally consistent Fourier
  features, or queries projected from the satellite tokens;
- the ``ImageEncoder`` / ``ImageDecoder`` pre- and post-processors;
- the per-lead decode: each of the F lead steps runs the whole
  :class:`MultiPerceiverIO` (the encoder too: the one-hot joins the
  context), each under ``torch.utils.checkpoint`` with ``remat_steps`` (the
  JAX ``nn.remat`` inside its ``nn.scan``); or every lead time decoded at
  once (``predict_timesteps_together``);
- LAMB under ``warmup_cosine`` (:mod:`satflow_tpu_torch.train.lamb`).

Parameters sit where the flax tree has them: ``steps.core.*`` (the per-lead
core, one set shared by the F steps) or ``perceiver.*``, ``query.*`` or
``query_from_sat.*``, ``preprocessor.*``, ``postprocessor.*``. The attention
is plain matmul and softmax, as the JAX package's: no kernel of the repo is
on this path.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import is_lazy
from torch.utils.checkpoint import checkpoint

from satflow_tpu_torch.core.registry import register_model
from satflow_tpu_torch.data import consts
from satflow_tpu_torch.models.base import BaseModel
from satflow_tpu_torch.nn.misc import DtypedModule
from satflow_tpu_torch.nn.perceiver import (
    Dense,
    ImageDecoder,
    ImageEncoder,
    InputModality,
    LearnableQuery,
    MultiPerceiverIO,
    encode_position,
)


def _as_tensor(value, device=None) -> torch.Tensor:
    """A batch entry as a tensor (a numpy view with negative strides, as the
    fake data's reversed coordinates, copied first)."""
    if isinstance(value, np.ndarray):
        value = np.ascontiguousarray(value)
    return torch.as_tensor(value, device=device)


class _PerLeadStep(DtypedModule):
    """One per-lead-time decode: the ``forecast_time`` one-hot joins the
    inputs, then the whole core (``core``) runs."""

    def __init__(self, core_kwargs: Dict[str, Any], generator: Optional[torch.Generator] = None):
        super().__init__()
        self.core = MultiPerceiverIO(**core_kwargs, generator=generator)

    def forward(self, inputs: Dict[str, torch.Tensor], queries: torch.Tensor,
                fstep_onehot: torch.Tensor) -> torch.Tensor:
        x = dict(inputs)
        x["forecast_time"] = fstep_onehot
        return self.core(x, queries)


class PerceiverSatFlowCore(DtypedModule):
    """(dict of modality tensors) -> (B, forecast_steps, H, W, C_out)."""

    def __init__(
        self,
        modalities: Tuple[InputModality, ...],
        forecast_steps: int,
        input_size: int,
        output_channels: int,
        queries_dim: int = 32,
        dim: int = 32,
        depth: int = 6,
        num_latents: int = 256,
        latent_dim: int = 512,
        cross_heads: int = 1,
        latent_heads: int = 8,
        cross_dim_heads: int = 8,
        latent_dim_heads: int = 64,
        weight_tie_layers: bool = False,
        decoder_ff: bool = True,
        qkv_bias: bool = False,
        cross_ff_mult: int = 2,
        latent_ff_mult: int = 2,
        decoder_query_residual: bool = True,
        max_frequency: float = 4.0,
        sin_only: bool = False,
        predict_timesteps_together: bool = False,
        use_learnable_query: bool = True,
        generate_fourier_features: bool = True,
        temporally_consistent_fourier_features: bool = False,
        preprocessor_type: Optional[str] = None,
        postprocessor_type: Optional[str] = None,
        remat_steps: bool = True,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.forecast_steps = forecast_steps
        self.input_size = input_size
        self.output_channels = output_channels
        self.max_frequency = max_frequency
        self.sin_only = sin_only
        self.predict_timesteps_together = predict_timesteps_together
        self.temporally_consistent_fourier_features = temporally_consistent_fourier_features
        self.remat_steps = remat_steps
        size = input_size
        if preprocessor_type is not None:
            self.preprocessor = ImageEncoder(prep_type=preprocessor_type, dtype=dtype,
                                             generator=generator)
        query_shape = (forecast_steps, size, size) if predict_timesteps_together else (size, size)
        self.query_shape = query_shape
        if use_learnable_query:
            self.query = LearnableQuery(
                channel_dim=queries_dim, query_shape=query_shape, max_frequency=max_frequency,
                num_frequency_bands=size, sine_only=sin_only,
                generate_fourier_features=generate_fourier_features, dtype=dtype,
                generator=generator)
        else:
            self.query_from_sat = Dense(None, queries_dim, dtype=dtype, generator=generator)
        core_kwargs = dict(
            modalities=modalities, dim=dim, queries_dim=queries_dim, logits_dim=output_channels,
            depth=depth, num_latents=num_latents, latent_dim=latent_dim,
            cross_heads=cross_heads, latent_heads=latent_heads, cross_dim_head=cross_dim_heads,
            latent_dim_head=latent_dim_heads, weight_tie_layers=weight_tie_layers,
            decoder_ff=decoder_ff, qkv_bias=qkv_bias, cross_ff_mult=cross_ff_mult,
            latent_ff_mult=latent_ff_mult, decoder_query_residual=decoder_query_residual,
            dtype=dtype)
        if predict_timesteps_together:
            self.perceiver = MultiPerceiverIO(**core_kwargs, generator=generator)
        else:
            self.steps = _PerLeadStep(core_kwargs, generator)
        if postprocessor_type is not None:
            self.postprocessor = ImageDecoder(postprocess_type=postprocessor_type,
                                              output_channels=output_channels, dtype=dtype,
                                              generator=generator)
        self.dtype = dtype

    @property
    def core(self) -> MultiPerceiverIO:
        """The one :class:`MultiPerceiverIO` of either decode mode."""
        return self.perceiver if self.predict_timesteps_together else self.steps.core

    def forward(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        inputs = dict(inputs)
        sat_key = consts.SATELLITE_DATA
        b = inputs[sat_key].shape[0]
        size = self.input_size
        f = self.forecast_steps

        if hasattr(self, "preprocessor"):
            # one module for every image input, in the JAX model's order
            for key in (sat_key, consts.TOPOGRAPHIC_DATA, consts.NWP_DATA):
                if key in inputs:
                    inputs[key] = self.preprocessor(inputs[key])

        if hasattr(self, "query"):
            fourier = None
            if self.temporally_consistent_fourier_features and self.predict_timesteps_together:
                t_hist = inputs[sat_key].shape[1]
                total_t = t_hist + f
                ff = encode_position(b, (total_t, size, size),
                                     num_frequency_bands=max(size, total_t),
                                     max_frequency=self.max_frequency, sine_only=self.sin_only,
                                     device=inputs[sat_key].device)
                fourier = ff.reshape(b, total_t, size, size, -1)[:, t_hist:]
            queries = self.query(b, fourier)
        else:
            sat = inputs[sat_key]
            n = math.prod(self.query_shape)
            queries = self.query_from_sat(sat.reshape(b, -1, sat.shape[-1])[:, :n])

        if self.predict_timesteps_together:
            out = self.perceiver(inputs, queries)
            out = out.reshape(b, f, size, size, self.output_channels)
        else:
            eye = torch.eye(f, dtype=queries.dtype, device=queries.device)
            outs = []
            for i in range(f):
                onehot = eye[i][None, :, None].expand(b, f, 1)
                if self.remat_steps and torch.is_grad_enabled():
                    outs.append(checkpoint(self.steps, inputs, queries, onehot,
                                           use_reentrant=False))
                else:
                    outs.append(self.steps(inputs, queries, onehot))
            out = torch.stack(outs, dim=1).reshape(b, f, size, size, self.output_channels)

        if hasattr(self, "postprocessor"):
            out = self.postprocessor(out)
        return out


@register_model
class Perceiver(BaseModel):
    """Registered task model, with the JAX model's hyperparameters.
    ``generator`` draws the initial weights (on the host); ``logits_dim`` is
    derived (the satellite channels) and an explicit other value raises, as
    in the JAX model."""

    def __init__(
        self,
        input_channels: int = 22,
        sat_channels: int = 12,
        nwp_channels: int = 10,
        base_channels: int = 1,
        forecast_steps: int = 48,
        history_steps: int = 6,
        input_size: int = 64,
        lr: float = 5e-4,
        visualize: bool = False,
        max_frequency: float = 4.0,
        depth: int = 6,
        num_latents: int = 256,
        cross_heads: int = 1,
        latent_heads: int = 8,
        cross_dim_heads: int = 8,
        latent_dim: int = 512,
        weight_tie_layers: bool = False,
        decoder_ff: bool = True,
        dim: int = 32,
        logits_dim: Optional[int] = None,
        queries_dim: int = 32,
        latent_dim_heads: int = 64,
        loss: str = "mse",
        sin_only: bool = False,
        encode_fourier: bool = True,
        preprocessor_type: Optional[str] = None,
        postprocessor_type: Optional[str] = None,
        encoder_kwargs: Optional[Dict[str, Any]] = None,
        decoder_kwargs: Optional[Dict[str, Any]] = None,
        pretrained: bool = False,
        predict_timesteps_together: bool = False,
        nwp_modality: bool = False,
        datetime_modality: bool = False,
        use_learnable_query: bool = True,
        generate_fourier_features: bool = True,
        temporally_consistent_fourier_features: bool = False,
        num_freq_bands: Optional[int] = None,
        warmup_steps: int = 1000,
        total_steps: int = 100_000,
        qkv_bias: bool = False,
        cross_ff_mult: int = 2,
        latent_ff_mult: int = 2,
        decoder_query_residual: bool = True,
        remat_steps: bool = True,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        self.sat_channels = sat_channels
        self.nwp_channels = nwp_channels
        self.base_channels = base_channels
        self.history_steps = history_steps
        self.input_size = input_size
        self.max_frequency = max_frequency
        self.depth = depth
        self.num_latents = num_latents
        self.cross_heads = cross_heads
        self.latent_heads = latent_heads
        self.cross_dim_heads = cross_dim_heads
        self.latent_dim = latent_dim
        self.weight_tie_layers = weight_tie_layers
        self.decoder_ff = decoder_ff
        self.dim = dim
        if logits_dim is not None and logits_dim != sat_channels:
            raise ValueError(
                f"logits_dim={logits_dim} conflicts with the derived output "
                f"width ({sat_channels} = sat_channels = output channels); "
                "leave it null/None (the reference configs do) or match it"
            )
        self.logits_dim = logits_dim
        self.queries_dim = queries_dim
        self.latent_dim_heads = latent_dim_heads
        self.sin_only = sin_only
        self.encode_fourier = encode_fourier
        self.preprocessor_type = preprocessor_type
        self.postprocessor_type = postprocessor_type
        self.predict_timesteps_together = predict_timesteps_together
        self.nwp_modality = nwp_modality
        self.datetime_modality = datetime_modality
        self.use_learnable_query = use_learnable_query
        self.generate_fourier_features = generate_fourier_features
        self.temporally_consistent_fourier_features = temporally_consistent_fourier_features
        self.num_freq_bands = num_freq_bands if num_freq_bands is not None else input_size
        self.warmup_steps = warmup_steps
        self.total_steps = total_steps
        self.qkv_bias = qkv_bias
        self.cross_ff_mult = cross_ff_mult
        self.latent_ff_mult = latent_ff_mult
        self.decoder_query_residual = decoder_query_residual
        self.remat_steps = remat_steps
        self.dtype = dtype
        self._generator = generator
        super().__init__(
            forecast_steps=forecast_steps,
            lr=lr,
            loss=loss,
            visualize=visualize,
            input_channels=input_channels,
            output_channels=sat_channels,
            pretrained=pretrained,
        )

    def _build_modalities(self) -> Tuple[InputModality, ...]:
        nf = self.num_freq_bands
        mods = [InputModality(consts.SATELLITE_DATA, self.sat_channels, 3, nf,
                              self.max_frequency, self.sin_only, self.encode_fourier)]
        if self.nwp_modality:
            mods.append(InputModality(consts.NWP_DATA, self.nwp_channels, 3, nf,
                                      self.max_frequency, self.sin_only, self.encode_fourier))
        mods.append(InputModality(consts.TOPOGRAPHIC_DATA, self.base_channels, 2, nf,
                                  self.max_frequency, self.sin_only, self.encode_fourier))
        if not self.predict_timesteps_together:
            mods.append(InputModality("forecast_time", 1, 1, self.forecast_steps,
                                      self.max_frequency, self.sin_only, self.encode_fourier))
        coord_names = [consts.SATELLITE_Y_COORDS, consts.SATELLITE_X_COORDS,
                       consts.TOPOGRAPHIC_Y_COORDS, consts.TOPOGRAPHIC_X_COORDS]
        if self.nwp_modality:
            coord_names += [consts.NWP_Y_COORDS, consts.NWP_X_COORDS]
        for name in coord_names:
            mods.append(InputModality(name, 1, 1, nf, self.max_frequency, self.sin_only,
                                      self.encode_fourier))
        if self.datetime_modality:
            for name in (consts.SATELLITE_DATETIME_INDEX,) + consts.DATETIME_FEATURE_NAMES:
                mods.append(InputModality(name, 1, 1, 2 * self.history_steps + 1,
                                          self.max_frequency, self.sin_only,
                                          self.encode_fourier))
        return tuple(mods)

    def build_core(self, output_channels: int) -> PerceiverSatFlowCore:
        """The core decoding ``output_channels`` channels."""
        return PerceiverSatFlowCore(
            modalities=self._build_modalities(),
            forecast_steps=self.forecast_steps,
            input_size=self.input_size,
            output_channels=output_channels,
            queries_dim=self.queries_dim,
            dim=self.dim,
            depth=self.depth,
            num_latents=self.num_latents,
            latent_dim=self.latent_dim,
            cross_heads=self.cross_heads,
            latent_heads=self.latent_heads,
            cross_dim_heads=self.cross_dim_heads,
            latent_dim_heads=self.latent_dim_heads,
            weight_tie_layers=self.weight_tie_layers,
            decoder_ff=self.decoder_ff,
            qkv_bias=self.qkv_bias,
            cross_ff_mult=self.cross_ff_mult,
            latent_ff_mult=self.latent_ff_mult,
            decoder_query_residual=self.decoder_query_residual,
            max_frequency=self.max_frequency,
            sin_only=self.sin_only,
            predict_timesteps_together=self.predict_timesteps_together,
            use_learnable_query=self.use_learnable_query,
            generate_fourier_features=self.generate_fourier_features,
            temporally_consistent_fourier_features=self.temporally_consistent_fourier_features,
            preprocessor_type=self.preprocessor_type,
            postprocessor_type=self.postprocessor_type,
            remat_steps=self.remat_steps,
            dtype=self.dtype,
            generator=self._generator,
        )

    def build_module(self) -> nn.Module:
        return self.build_core(self.output_channels)

    def prepare_batch(self, batch):
        """The datamodule's (x, y) dicts -> (modality dict, target): NWP
        (B, C, T, h, w) moved to channels-last, the topography given a
        channel axis, the missing topography and topographic coordinates
        zeros; ``y`` cut to the output channels."""
        x, y = batch
        inputs: Dict[str, torch.Tensor] = {}
        if isinstance(x, dict):
            sat = _as_tensor(x[consts.SATELLITE_DATA])
            inputs[consts.SATELLITE_DATA] = sat
            b, dev = sat.shape[0], sat.device
            topo = x.get(consts.TOPOGRAPHIC_DATA)
            if topo is not None:
                topo = _as_tensor(topo, device=dev)
                inputs[consts.TOPOGRAPHIC_DATA] = topo[..., None] if topo.dim() == 3 else topo
            else:
                inputs[consts.TOPOGRAPHIC_DATA] = torch.zeros(
                    (b, sat.shape[2], sat.shape[3], self.base_channels), dtype=sat.dtype,
                    device=dev)
            if self.nwp_modality and consts.NWP_DATA in x:
                inputs[consts.NWP_DATA] = _as_tensor(x[consts.NWP_DATA],
                                                          device=dev).movedim(1, -1)
            for name in (consts.SATELLITE_Y_COORDS, consts.SATELLITE_X_COORDS):
                if name in x:
                    inputs[name] = _as_tensor(x[name], device=dev)
            for name in (consts.TOPOGRAPHIC_Y_COORDS, consts.TOPOGRAPHIC_X_COORDS):
                if name in x:
                    inputs[name] = _as_tensor(x[name], device=dev)
                else:
                    inputs[name] = torch.zeros(
                        (b, inputs[consts.TOPOGRAPHIC_DATA].shape[1]), dtype=torch.float32,
                        device=dev)
            if self.nwp_modality:
                for name in (consts.NWP_Y_COORDS, consts.NWP_X_COORDS):
                    if name in x:
                        inputs[name] = _as_tensor(x[name], device=dev)
            if self.datetime_modality:
                for name in (consts.SATELLITE_DATETIME_INDEX,) + consts.DATETIME_FEATURE_NAMES:
                    if name in x:
                        inputs[name] = _as_tensor(x[name], device=dev)
        else:
            inputs[consts.SATELLITE_DATA] = _as_tensor(x)
        if isinstance(y, dict):
            y = y[consts.SATELLITE_DATA]
        y = _as_tensor(y)
        return inputs, y[..., : self.output_channels]

    def state_dict_from_flax(self, variables):
        from satflow_tpu_torch.interop.jax_weights import perceiver_state_dict_from_flax

        return perceiver_state_dict_from_flax(variables)

    @property
    def lr_schedule(self):
        from satflow_tpu_torch.train.schedules import warmup_cosine

        return warmup_cosine(self.lr, self.warmup_steps, self.total_steps)

    def make_optimizer(self) -> torch.optim.Optimizer:
        """LAMB (optax's defaults, b1 0.9, b2 0.999) with its learning rate
        set from :attr:`lr_schedule` before every update, as
        ``optax.lamb(schedule)``; over the parameters that exist (a modality
        the data never gave has no projection, as in the flax tree)."""
        from satflow_tpu_torch.train.lamb import Lamb
        from satflow_tpu_torch.train.schedules import scheduled

        params = [p for p in self.parameters() if not is_lazy(p)]
        return scheduled(Lamb(params, lr=self.lr, betas=(0.9, 0.999)), self.lr_schedule)
