"""GANBase: the two-network adversarial task model, counterpart of
``satflow_tpu/models/gan_base.py``.

The model holds the generator as ``module`` (the core every BaseModel
holds) and the discriminator as ``disc_module``; :meth:`make_optimizers`
gives each its own Adam. The two losses are the JAX ones with the state
made explicit as the JAX package threads it:

- generator step: the generator in training mode (its own statistics and
  spectral vectors move), the fakes scored by the discriminator in training
  mode (batch statistics) with its state frozen
  (:func:`~satflow_tpu_torch.nn.norm.frozen_state`): JAX throws those
  updates away;
- discriminator step: a generator sample without gradient in eval mode,
  then the discriminator in training mode on the real batch and on the fake
  one, its state moving once per pass, the fake pass seeing the real pass's;
  with ``gan_mode="wgangp"`` the gradient penalty's critic is the
  discriminator in eval mode at the state before both passes (it is taken
  first).

The discriminator scores fakes with the correct labels (the reference
scored them as real). Noise (the gradient penalty's interpolation weights,
the DGMR latent) comes from the ``torch.Generator`` a step passes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.nn.parameter import is_lazy

from satflow_tpu_torch.models.base import BaseModel
from satflow_tpu_torch.nn.losses import GANLoss, gradient_penalty
from satflow_tpu_torch.nn.norm import frozen_state


class GANBase(BaseModel):
    is_gan = True

    def __init__(
        self,
        gen_lr: float = 2e-4,
        disc_lr: float = 2e-4,
        gan_mode: str = "vanilla",
        lambda_l1: float = 100.0,
        beta1: float = 0.5,
        beta2: float = 0.999,
        **kwargs,
    ):
        self.gen_lr = gen_lr
        self.disc_lr = disc_lr
        self.gan_mode = gan_mode
        self.lambda_l1 = lambda_l1
        self.beta1 = beta1
        self.beta2 = beta2
        self.adv_loss = GANLoss(gan_mode)
        kwargs.setdefault("lr", gen_lr)
        super().__init__(**kwargs)
        self.disc_module = self.build_discriminator()

    # -- subclass hooks ------------------------------------------------------

    def build_discriminator(self):
        raise NotImplementedError

    def disc_input(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The discriminator's input from the condition and candidate frames."""
        raise NotImplementedError

    def generate(self, x: torch.Tensor, train: bool = False,
                 generator: Optional[torch.Generator] = None, **kwargs) -> torch.Tensor:
        """The generator on ``x``, in training mode (its state moving) or eval
        mode; ``generator`` is the noise source of a sampling generator,
        ``kwargs`` go to the core."""
        self.module.train(train)
        return self.module(x, **kwargs)

    def discriminate(self, inp: torch.Tensor, train: bool) -> torch.Tensor:
        self.disc_module.train(train)
        return self.disc_module(inp)

    def sample(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """What a session serves: the generator in eval mode, time-major
        (B, forecast_steps, H, W, C)."""
        return self.generate(x, False, generator)

    # -- engine interface ----------------------------------------------------

    def prepare_batch(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ``sat_data`` (x, y) as tensors; each model slices its channels."""
        x, y = super().prepare_batch(batch)
        return torch.as_tensor(x), torch.as_tensor(y)

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        """Compute in ``dtype`` in both networks (the JAX engine rebuilds
        both modules), the f32 weights kept as they are."""
        self.dtype = dtype
        for net in (self.module, self.disc_module):
            net.set_compute_dtype(dtype)

    def materialize(self, batch) -> None:
        """Create both networks' data-shaped parameters from one sample of
        ``batch``: a generator forward in eval mode and the discriminator on
        its output, without grad, nothing moving (the JAX
        ``init_gan_variables``)."""
        if not any(is_lazy(p) for p in self.parameters()):
            return
        x, _ = self.prepare_batch(batch)
        training = self.training
        with torch.no_grad(), frozen_state(self):
            y_hat = self.generate(x[:1], False)
            self.discriminate(self.disc_input(x[:1], y_hat), False)
        self.train(training)

    def generator_loss(self, batch, generator: Optional[torch.Generator] = None,
                       **kwargs) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of the generator step: adversarial loss of the
        fakes, scored by the discriminator in training mode with its state
        frozen, plus ``lambda_l1`` times the reconstruction criterion."""
        x, y = self.prepare_batch(batch)
        y_hat = self.generate(x, True, generator, **kwargs)
        with frozen_state(self.disc_module):
            score = self.discriminate(self.disc_input(x, y_hat), True)
        adv = self.adv_loss(score, True)
        recon = self.criterion(y_hat, y)
        loss = adv + self.lambda_l1 * recon
        return loss, {"loss": loss, "adv_loss": adv, "recon_loss": recon,
                      **self.frame_metrics(y_hat, y)}

    def discriminator_loss(self, batch, generator: Optional[torch.Generator] = None,
                           alpha: Optional[torch.Tensor] = None,
                           **kwargs) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of the discriminator step: the mean of the real
        and fake adversarial losses (plus, for wgangp, the gradient penalty,
        its ``alpha`` drawn from ``generator`` unless given)."""
        x, y = self.prepare_batch(batch)
        with torch.no_grad():
            y_hat = self.generate(x, False, generator, **kwargs)
        penalty = None
        if self.gan_mode == "wgangp":
            penalty = gradient_penalty(
                lambda cand: self.discriminate(self.disc_input(x, cand), False),
                y, y_hat, generator, alpha=alpha)
        loss_real = self.adv_loss(self.discriminate(self.disc_input(x, y), True), True)
        loss_fake = self.adv_loss(self.discriminate(self.disc_input(x, y_hat), True), False)
        loss = 0.5 * (loss_real + loss_fake)
        if penalty is not None:
            loss = loss + penalty
        return loss, {"loss": loss, "real_loss": loss_real, "fake_loss": loss_fake}

    def make_optimizers(self) -> Tuple[torch.optim.Optimizer, torch.optim.Optimizer]:
        """Adam for each network at ``gen_lr`` / ``disc_lr`` with ``(beta1,
        beta2)``. ``scheduler`` "cosine" / "warmup" / "warmup_cosine" makes
        each follow that schedule of its own rate over ``total_steps``
        (default 100 000); "plateau" keeps the rate, which the engine's
        PlateauScheduler rewrites."""
        from satflow_tpu_torch.train.schedules import make_schedule, scheduled

        sched = getattr(self, "scheduler", None)
        total = getattr(self, "total_steps", 100_000)

        def make(net, lr):
            opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(self.beta1, self.beta2),
                                   eps=1e-8)
            if sched in ("cosine", "warmup", "warmup_cosine"):
                name = "warmup_cosine" if sched == "warmup" else sched
                opt = scheduled(opt, make_schedule(name, lr, total_steps=total))
            return opt

        return make(self.module, self.gen_lr), make(self.disc_module, self.disc_lr)

    def make_optimizer(self):
        raise TypeError(f"{type(self).__name__} trains two networks: use make_optimizers()")

    def hparams(self) -> Dict[str, Any]:
        hp = super().hparams()
        hp.update(gen_lr=self.gen_lr, disc_lr=self.disc_lr, gan_mode=self.gan_mode,
                  lambda_l1=self.lambda_l1)
        return hp

    # -- weights ---------------------------------------------------------------

    @staticmethod
    def generator_variables(variables: Dict[str, Any]) -> Dict[str, Any]:
        """The generator's flax variables: a GAN checkpoint's
        ``{'params': {'generator', 'discriminator'}, 'g', 'd'}`` gives its
        generator subtree and the ``g`` collections; anything else is taken
        as the generator's own."""
        params = variables.get("params") or {}
        if "generator" in params:
            return {"params": params["generator"], **(variables.get("g") or {})}
        return variables

    def state_dict_from_flax(self, variables):
        """The generator's state_dict (what a session loads into
        ``module``) from the generator's variables or a GAN checkpoint's."""
        from satflow_tpu_torch.interop.jax_weights import flax_tree_state_dict

        return flax_tree_state_dict(self.generator_variables(variables))
