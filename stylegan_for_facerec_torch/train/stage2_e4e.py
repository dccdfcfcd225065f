"""Stage-2 ReStyle e4e coach, as ``stylegan_for_facerec_tpu/train/
stage2_e4e.py``: the pSp coach's refinement loop and losses on an ``E4e``
model, plus

  * an adversarial term on the encoder: ``softplus(-D(w))`` over the w
    rows the latent discriminator sees (the rows active at the current
    progressive stage, or all rows without progressive training);
  * delta regularisation, the sum over the active deltas w_i - w_0 of
    their mean norm (exactly 0 at stage 0);
  * the latent discriminator's own step: real w's from the frozen mapping
    network (no ``w_avg`` update), fake w's from one raw encoder pass on
    the first iteration's conditioning, both through replay pools, the
    non-saturating loss with a lazy R1 penalty on the real w's every
    ``d_reg_every`` steps, Adam (0.9, 0.999);
  * progressive stages switched by global step.

The encoder step keeps D out of its graph (D's parameters do not require
grad there), so D's ``.grad`` stays None. The D step's encoder pass
normalises with batch statistics and leaves the running statistics as
they were, as the JAX coach throws that pass's new state away. D and its
loss run in float32 whatever ``compute_dtype`` is, as in the JAX coach.

Images at the public methods are NHWC in [-1, 1], as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..models.e4e import E4e, LatentCodesDiscriminator, LatentCodesPool
from ..nn.initializers import init_weights
from .stage2 import Stage2Coach, Stage2Config, cpu_optimizer_state


@dataclasses.dataclass(frozen=True)
class E4eConfig(Stage2Config):
    """``Stage2Config`` plus the e4e knobs."""

    w_discriminator_lambda: float = 0.1
    w_discriminator_lr: float = 2e-5
    r1: float = 10.0
    d_reg_every: int = 16
    delta_norm: int = 2
    delta_norm_lambda: float = 2e-4
    progressive_steps: Sequence[int] = ()
    w_pool_size: int = 50


class E4eCoach(Stage2Coach):
    """Owns the ``E4e`` (seeded random weights, on ``device``), its
    optimizer, the ``LatentCodesDiscriminator`` (weights from seed + 1),
    D's Adam and the two replay pools (real: seed 0, fake: seed 1)."""

    model_class = E4e

    def __init__(self, cfg: E4eConfig, lpips_fn=None, id_loss_fn=None,
                 device: str = "cuda", seed: int = 0):
        super().__init__(cfg, lpips_fn=lpips_fn, id_loss_fn=id_loss_fn,
                         device=device, seed=seed)
        disc = LatentCodesDiscriminator(512, 4)
        init_weights(disc, torch.Generator().manual_seed(seed + 1))
        self.discriminator = disc.to(self.device)
        self.d_optimizer = torch.optim.Adam(disc.parameters(),
                                            lr=cfg.w_discriminator_lr,
                                            betas=(0.9, 0.999))
        self.real_pool = LatentCodesPool(cfg.w_pool_size)
        self.fake_pool = LatentCodesPool(cfg.w_pool_size, seed=1)

    # -- progressive schedule ----------------------------------------------

    def set_stage(self, stage: int) -> None:
        self.model.set_stage(stage)

    def stage_for_step(self, step: int) -> int:
        """The index of the last entry of ``progressive_steps`` that
        ``step`` has reached (0 before the first)."""
        stage = 0
        for i, s in enumerate(self.cfg.progressive_steps):
            if step >= s:
                stage = i
        return stage

    def _dims_to_discriminate(self, n_latent: int) -> int:
        """The leading w rows D sees: rows 0..stage with progressive
        training, all rows without."""
        if self.cfg.progressive_steps:
            return min(self.model.stage + 1, n_latent)
        return n_latent

    # -- encoder side --------------------------------------------------------

    def _calc_loss(self, y_hat, y, x, latent) -> Tuple[torch.Tensor, Dict]:
        loss, logs = super()._calc_loss(y_hat, y, x, latent)
        cfg = self.cfg
        if cfg.w_discriminator_lambda > 0:
            nd = self._dims_to_discriminate(latent.shape[1])
            pred = self.discriminator(
                latent[:, :nd].reshape(-1, latent.shape[-1]))
            loss_disc = F.softplus(-pred).mean()
            logs["encoder_discriminator_loss"] = loss_disc.detach()
            loss = loss + cfg.w_discriminator_lambda * loss_disc
        if cfg.progressive_steps and cfg.delta_norm_lambda > 0:
            # only the deltas active at this stage: the inactive ones are
            # exactly 0, where the norm has no derivative
            n_active = max(0, min(self.model.stage, latent.shape[1] - 1))
            delta_loss = torch.zeros((), dtype=latent.dtype,
                                     device=latent.device)
            if n_active > 0:
                deltas = latent[:, 1:1 + n_active] - latent[:, 0:1]
                delta_loss = torch.linalg.vector_norm(
                    deltas, ord=cfg.delta_norm, dim=2).mean(0).sum()
                loss = loss + cfg.delta_norm_lambda * delta_loss
            logs["total_delta_loss"] = delta_loss.detach()
        logs["loss"] = loss.detach()
        return loss, logs

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   avg_image: torch.Tensor, generator: torch.Generator):
        """``Stage2Coach.train_step`` with the adversarial and delta terms;
        D's parameters take no gradient."""
        self.discriminator.requires_grad_(False)
        try:
            return super().train_step(x, y, avg_image, generator)
        finally:
            self.discriminator.requires_grad_(True)

    # -- discriminator side --------------------------------------------------

    @torch.no_grad()
    def sample_real_w(self, batch: int,
                      generator: Optional[torch.Generator] = None,
                      z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(batch, 512) w's of the frozen mapping network for ``z`` (drawn
        from ``generator`` when not given); ``w_avg`` does not move."""
        if z is None:
            z = torch.randn((batch, 512), generator=generator,
                            device=self.device)
        return self.model.decoder.mapping(z, skip_w_avg_update=True)[:, 0]

    @torch.no_grad()
    def _fake_w(self, x: torch.Tensor, avg_image: torch.Tensor
                ) -> torch.Tensor:
        """Raw encoder codes (B, n_styles, 512) of the first iteration's
        input (x with the average image), without ``latent_avg`` or a
        carry: BatchNorm normalises with the batch's statistics and its
        running statistics stay as they were (the pass updates copies)."""
        enc = self.model.encoder
        x_net = x.permute(0, 3, 1, 2)
        cond = avg_image.permute(2, 0, 1)[None].to(x.dtype).expand_as(x_net)
        copies = {k: v.clone() for k, v in enc.named_buffers()}
        was_training = enc.training
        enc.train()
        try:
            return functional_call(enc, copies,
                                   (torch.cat([x_net, cond], dim=1),))
        finally:
            enc.train(was_training)

    def d_loss(self, real_w: torch.Tensor, fake_w: torch.Tensor,
               do_r1: bool) -> torch.Tensor:
        """softplus(-D(real)) + softplus(D(fake)), batch means; with
        ``do_r1`` plus r1 / 2 * d_reg_every * mean |dD(real)/dreal|^2."""
        real_w = real_w.detach().requires_grad_(do_r1)
        real_pred = self.discriminator(real_w)
        fake_pred = self.discriminator(fake_w.detach())
        loss = F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()
        if do_r1:
            g, = torch.autograd.grad(real_pred.sum(), real_w,
                                     create_graph=True)
            r1 = g.square().sum(dim=1).mean()
            loss = loss + (self.cfg.r1 / 2) * r1 * self.cfg.d_reg_every
        return loss

    def d_step(self, real_w: torch.Tensor, fake_w: torch.Tensor,
               do_r1: bool) -> torch.Tensor:
        """One Adam step of D on these w's; returns the loss."""
        self.d_optimizer.zero_grad(set_to_none=True)
        loss = self.d_loss(real_w, fake_w, do_r1)
        loss.backward()
        self.d_optimizer.step()
        return loss.detach()

    def train_discriminator(self, x: torch.Tensor, avg_image: torch.Tensor,
                            step: int,
                            generator: Optional[torch.Generator] = None,
                            z: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
        """One D update: real w's from ``z`` (or ``generator``), fake w's
        from ``_fake_w`` cut to the discriminated rows, both through their
        pools (a 3-D fake that the disabled pool returns gives its first
        row), R1 when ``step % d_reg_every == 0``. Returns the loss."""
        real_w = self.sample_real_w(x.shape[0], generator, z)
        fake = self._fake_w(x, avg_image)
        if self.cfg.progressive_steps:
            fake = fake[:, :self._dims_to_discriminate(fake.shape[1])]
        real_w = self.real_pool.query(real_w)
        fake_w = self.fake_pool.query(fake)
        if fake_w.ndim == 3:
            fake_w = fake_w[:, 0]
        return self.d_step(real_w, fake_w,
                           step % self.cfg.d_reg_every == 0)

    # -- checkpoints ---------------------------------------------------------

    def state_dict(self) -> Dict:
        """``Stage2Coach.state_dict`` plus ``discriminator`` and
        ``d_optimizer``, on the CPU."""
        out = super().state_dict()
        out["discriminator"] = {k: v.cpu() for k, v in
                                self.discriminator.state_dict().items()}
        out["d_optimizer"] = cpu_optimizer_state(self.d_optimizer)
        return out

    def load_state_dict(self, ckpt: Dict) -> None:
        super().load_state_dict(ckpt)
        self.discriminator.load_state_dict(ckpt["discriminator"],
                                           strict=True)
        if "d_optimizer" in ckpt:
            self.d_optimizer.load_state_dict(ckpt["d_optimizer"])
