"""The HuggingFace optical-flow Perceiver fine-tune, counterpart of
``satflow_tpu/models/hf_perceiver.py``.

``pretrained=True`` reads ``deepmind/optical-flow-perceiver`` through
``transformers`` (imported only then), takes the core's geometry from the
checkpoint's shapes (latents, token width, depth, heads, feed-forward
widening, q/k/v biases, no decoder query residual) and maps the whole
transformer core onto the port's :class:`MultiPerceiverIO`
(:func:`satflow_tpu_torch.interop.torch_weights.load_hf_optical_flow`). The
core decodes the HF head's ``flow_channels`` and a 1x1 ``channel_change``
conv maps them to the satellite channels. The modality projections and the
query grid are not in the HF model and train from their initial values.
Without ``transformers`` installed, ``pretrained=True`` raises
``ImportError``, as the JAX model does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from satflow_tpu_torch.core.registry import register_model
from satflow_tpu_torch.data import consts
from satflow_tpu_torch.models.perceiver import Perceiver
from satflow_tpu_torch.nn.conv import Conv
from satflow_tpu_torch.nn.misc import DtypedModule


class _FlowHead(DtypedModule):
    """The core (``core``) predicting ``flow_channels``, then the 1x1
    ``channel_change`` conv to the satellite channels."""

    def __init__(self, core: nn.Module, flow_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.core = core
        self.channel_change = Conv(flow_channels, out_channels, (1, 1), dtype=dtype,
                                   generator=generator)
        self.dtype = dtype

    def forward(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        y = self.core(inputs)  # (B, T, H, W, flow_channels)
        b, t = y.shape[:2]
        y = self.channel_change(y.reshape(b * t, *y.shape[2:]))
        return y.reshape(b, t, *y.shape[1:])


@register_model(name="huggingfaceperceiver")
class HuggingFacePerceiver(Perceiver):
    """The ``hf_perceiver`` config's model. Without ``pretrained``, a trimmed
    geometry (depth 8, 512 x 512 latents, 8 heads) with the same dense
    per-pixel decode."""

    def __init__(
        self,
        model_name: str = "deepmind/optical-flow-perceiver",
        forecast_steps: int = 24,
        input_channels: int = 12,
        sat_channels: int = 12,
        train_size: int = 64,
        lr: float = 5e-4,
        pretrained: bool = False,
        flow_channels: int = 2,
        **kwargs,
    ):
        self.model_name = model_name
        self.train_size = train_size
        self.flow_channels = flow_channels
        # a rebuild from the hparams passes every Perceiver keyword back;
        # input_size is train_size's here
        kwargs.pop("input_size", None)
        hf_state: Optional[Dict[str, Any]] = None
        if pretrained:
            hf_state, hf_kwargs, self.flow_channels = self._fetch_hf(model_name, train_size)
            kwargs.update(hf_kwargs)
        else:
            kwargs.setdefault("depth", 8)
            kwargs.setdefault("num_latents", 512)
            kwargs.setdefault("latent_dim", 512)
            kwargs.setdefault("latent_heads", 8)
            kwargs.setdefault("use_learnable_query", True)
        super().__init__(
            forecast_steps=forecast_steps,
            input_channels=input_channels,
            sat_channels=sat_channels,
            input_size=train_size,
            lr=lr,
            pretrained=pretrained,
            **kwargs,
        )
        if hf_state is not None:
            self._load_hf_weights(hf_state)
            # the mapped weights are the module's now (and a checkpoint's
            # later): a rebuild from the hparams must not fetch them again
            self.pretrained = False

    def build_module(self) -> nn.Module:
        return _FlowHead(self.build_core(self.flow_channels), self.flow_channels,
                         self.output_channels, dtype=self.dtype, generator=self._generator)

    @staticmethod
    def _fetch_hf(model_name: str, train_size: int):
        """The HF model's (state_dict, derived keywords, flow channels); the
        geometry is read from the checkpoint's shapes."""
        try:
            from transformers import PerceiverForOpticalFlow
        except ImportError as e:
            raise ImportError("pretrained=True requires the transformers package") from e
        from satflow_tpu_torch.interop.torch_weights import strip_hf_prefix

        hf = PerceiverForOpticalFlow.from_pretrained(
            model_name, ignore_mismatched_sizes=True, train_size=[train_size, train_size])
        cfg = hf.config
        if getattr(cfg, "num_blocks", 1) != 1:
            raise ValueError(
                f"num_blocks={cfg.num_blocks}: weight-shared block repetition "
                "is not mapped (deepmind/optical-flow-perceiver uses 1)")
        sd = {k: v.detach().cpu() for k, v in strip_hf_prefix(hf.state_dict()).items()}
        num_latents, latent_dim = sd["embeddings.latents"].shape
        token_dim = sd["encoder.cross_attention.attention.self.layernorm2.weight"].shape[0]
        latent_heads = int(cfg.num_self_attention_heads)
        cross_heads = int(cfg.num_cross_attention_heads)
        qk_self = sd["encoder.self_attends.0.attention.self.query.weight"].shape[0]
        v_self = sd["encoder.self_attends.0.attention.self.value.weight"].shape[0]
        qk_cross = sd["encoder.cross_attention.attention.self.query.weight"].shape[0]
        v_cross = sd["encoder.cross_attention.attention.self.value.weight"].shape[0]
        if qk_self != v_self or qk_cross != v_cross:
            raise ValueError(f"qk_channels != v_channels ({qk_self}/{v_self} self, "
                             f"{qk_cross}/{v_cross} cross) is not mapped")
        if qk_self % latent_heads or qk_cross % cross_heads:
            raise ValueError("attention channels not divisible by head count")
        latent_ff = sd["encoder.self_attends.0.mlp.dense1.weight"].shape[0]
        cross_ff = sd["encoder.cross_attention.mlp.dense1.weight"].shape[0]
        dec_ff = sd["decoder.decoder.decoding_cross_attention.mlp.dense1.weight"].shape[0]
        if latent_ff % latent_dim or cross_ff % latent_dim or dec_ff % token_dim:
            raise ValueError("non-integer FF widening factor is not mapped")
        if dec_ff // token_dim != cross_ff // latent_dim:
            raise ValueError("decoder vs encoder cross-attention widening factors differ")
        flow_channels = sd["decoder.decoder.final_layer.weight"].shape[0]
        kwargs = dict(
            depth=int(cfg.num_self_attends_per_block),
            num_latents=int(num_latents),
            latent_dim=int(latent_dim),
            latent_heads=latent_heads,
            cross_heads=cross_heads,
            latent_dim_heads=int(qk_self) // latent_heads,
            cross_dim_heads=int(qk_cross) // cross_heads,
            dim=int(token_dim),
            queries_dim=int(token_dim),
            qkv_bias=True,
            latent_ff_mult=int(latent_ff) // int(latent_dim),
            cross_ff_mult=int(cross_ff) // int(latent_dim),
            decoder_query_residual=False,  # PerceiverOpticalFlowDecoder's setting
            use_learnable_query=True,
        )
        return sd, kwargs, int(flow_channels)

    def _load_hf_weights(self, state_dict: Dict[str, Any]) -> None:
        """Map the HF transformer core into the freshly made module, its
        data-sized weights first made from a zero batch (as the JAX model
        initialises from one)."""
        from satflow_tpu_torch.interop.torch_weights import load_hf_optical_flow

        s = self.input_size
        x = np.zeros((1, self.history_steps, s, s, self.sat_channels), np.float32)
        self.materialize(({consts.SATELLITE_DATA: x}, x))
        prefix = "core.perceiver" if self.predict_timesteps_together else "core.steps.core"
        load_hf_optical_flow(self.module, self.module.core.core, state_dict, prefix=prefix,
                             strict=True)
        self.restored_from = "hf " + self.model_name
