"""Stage-1 StyleGAN2-ADA GAN pretraining, as
``stylegan_for_facerec_tpu/train/stage1.py``:

  * non-saturating logistic loss; D on ADA-augmented reals and fakes;
  * lazy R1 on the augmented reals every ``lazy_gradient_penalty_interval``
    steps, ``gamma / 2 * mean_n sum (dD/dx)^2 * interval``, in f32: D
    differentiated with respect to its input, then again, so B1b's
    backward (B1b) runs through every ``fused_leaky_relu``;
  * lazy path length every ``lazy_path_penalty_interval`` steps on the first
    half of the G step's z: the vjp of synthesis at ws (mapped without
    the ``w_avg`` update, still differentiable with respect to the
    mapping) against randn / sqrt(H W), differentiated again, so B1b's and
    B2b's backwards (B1b, B2) run; ``pl_mean`` moves 0.01 of the way to
    the batch's mean length, and the penalty is not detached from it;
  * Adam (0, 0.99), eps 1e-8, for G and D; g_ema ``beta e + (1 - beta) p``
    after each G step, carrying G's buffers (``w_avg``);
  * the ADA controller: every ``ada_interval`` steps p moves by
    sign(E[sign D(real)] - target) * images seen / 500k, clipped to [0, 1].

The D step's G forward leaves ``w_avg`` alone (the JAX trainer discards
that state); the G step's updates it. D's parameters take no gradient in
the G step.

All randomness of a step comes from one ``torch.Generator`` in ``draw``:
z, the layer noise (one (N, 1, res, res) tensor per synthesis layer), the
ADA parameters for reals and fakes, and the path-length noise. The loss
and step methods take those draws, so a test can build them from the JAX
trainer's keys.

``compute_dtype="bfloat16"`` runs G and D under ``torch.autocast``: f32
parameters and optimizer state, bf16 convolutions and matmuls, so kernels
B1, B1b, B2 and B2b see bf16; the losses, ADA and the penalties' norms
run in f32. Reals at the public methods are NHWC in [-1, 1], as in the
JAX package; the mesh path of the JAX trainer is not ported.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.stylegan2 import Discriminator
from ..models.stylegan2_ada import Generator
from ..nn.initializers import init_weights
from ..utils.config import Stage1Config
from ..utils.device import resolve_device
from .ada_aug import apply_ada, sample_ada_params

Draws = Dict[str, object]


class Stage1Trainer:
    """Owns G, D, g_ema (seeded random weights, on ``device``), their Adam
    optimizers, ``ada_p``, the r_t accumulators, ``pl_mean`` and the host
    step counter ``step``; ``rng`` draws each step's randomness."""

    def __init__(self, cfg: Stage1Config, device: str = "cuda",
                 seed: int = 0):
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: "
                             f"float32|bfloat16")
        self.cfg = cfg
        self.device = resolve_device(device)
        G = Generator(z_dim=cfg.z_dim, w_dim=cfg.w_dim,
                      w_num_layers=cfg.num_mapping_layers,
                      img_resolution=cfg.image_size)
        D = Discriminator(size=cfg.image_size)
        init = torch.Generator().manual_seed(seed)
        init_weights(G, init)
        init_weights(D, init)
        self.G = G.to(self.device).train()
        self.D = D.to(self.device).train()
        self.g_ema = copy.deepcopy(self.G).eval().requires_grad_(False)
        self.opt_g = torch.optim.Adam(self.G.parameters(), lr=cfg.lr_g,
                                      betas=(0.0, 0.99), eps=1e-8)
        self.opt_d = torch.optim.Adam(self.D.parameters(), lr=cfg.lr_d,
                                      betas=(0.0, 0.99), eps=1e-8)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.ada_p = torch.tensor(cfg.ada_start_p, **f32)
        self.rt_accum = torch.zeros((), **f32)
        self.rt_count = torch.zeros((), **f32)
        self.pl_mean = torch.zeros((), **f32)
        self.step = 0
        self.rng = torch.Generator(self.device).manual_seed(seed + 1)

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.cfg.compute_dtype == "bfloat16")

    # -- draws -------------------------------------------------------------

    def draw(self, batch: int, do_plp: bool) -> Tuple[Draws, Draws]:
        """One step's randomness: (D step's, G step's). Each has ``z``
        (N, z_dim), ``noises`` (per synthesis layer) and the ADA parameters
        (``ada_real``/``ada_fake`` for D, ``ada_fake`` for G) at the current
        ``ada_p``; with ``do_plp`` the G step's also has ``pl_noises`` and
        ``pl_proj`` (randn / sqrt(H W)) for the first half of the batch."""
        g, dev, s = self.rng, self.device, self.cfg.image_size

        def noises(n):
            return [torch.randn(shape, generator=g, device=dev)
                    for shape in self.G.synthesis.noise_shapes(n)]

        def ada(n):
            return sample_ada_params(g, n, 3, s, s, self.ada_p, dev)

        z_shape = (batch, self.cfg.z_dim)
        d = {"z": torch.randn(z_shape, generator=g, device=dev),
             "noises": noises(batch), "ada_real": ada(batch),
             "ada_fake": ada(batch)}
        gd = {"z": torch.randn(z_shape, generator=g, device=dev),
              "noises": noises(batch), "ada_fake": ada(batch)}
        if do_plp:
            half = max(1, batch // 2)
            gd["pl_noises"] = noises(half)
            gd["pl_proj"] = torch.randn((half, 3, s, s), generator=g,
                                        device=dev) / math.sqrt(s * s)
        return d, gd

    # -- D step ------------------------------------------------------------

    def d_loss(self, reals: torch.Tensor, draws: Draws, do_r1: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, rt) of the D step; ``reals`` NHWC."""
        cfg = self.cfg
        x = reals.to(self.device, torch.float32).permute(0, 3, 1, 2)
        with torch.no_grad(), self._autocast():
            fakes = self.G(draws["z"], noises=draws["noises"],
                           skip_w_avg_update=True)
        reals_aug = apply_ada(x, draws["ada_real"])
        fakes_aug = apply_ada(fakes, draws["ada_fake"])
        if do_r1:
            reals_aug = reals_aug.detach().requires_grad_(True)
        with self._autocast():
            d_real = self.D(reals_aug).float()
            d_fake = self.D(fakes_aug).float()
        loss = F.softplus(d_fake).mean() + F.softplus(-d_real).mean()
        rt = torch.sign(d_real.detach()).mean()
        if do_r1:
            (grad,) = torch.autograd.grad(d_real.sum(), reals_aug,
                                          create_graph=True)
            r1 = grad.float().square().sum(dim=(1, 2, 3)).mean()
            loss = loss + (cfg.lambda_gp / 2) * r1 \
                * cfg.lazy_gradient_penalty_interval
        return loss, rt

    def d_step(self, reals: torch.Tensor, draws: Draws,
               do_r1: bool) -> Dict[str, torch.Tensor]:
        self.opt_d.zero_grad(set_to_none=True)
        loss, rt = self.d_loss(reals, draws, do_r1)
        loss.backward()
        self.opt_d.step()
        self.rt_accum = self.rt_accum + rt
        self.rt_count = self.rt_count + 1
        return {"d_loss": loss.detach(), "rt": rt}

    # -- G step ------------------------------------------------------------

    def g_loss(self, draws: Draws, do_plp: bool
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(loss, plp, pl_new) of the G step; the forward moves G's
        ``w_avg``."""
        cfg = self.cfg
        with self._autocast():
            fakes = self.G(draws["z"], noises=draws["noises"])
        fakes_aug = apply_ada(fakes, draws["ada_fake"])
        with self._autocast():
            d_fake = self.D(fakes_aug).float()
        loss = F.softplus(-d_fake).mean()
        plp = torch.zeros((), device=self.device)
        pl_new = self.pl_mean
        if do_plp:
            zb = draws["z"][: max(1, draws["z"].shape[0] // 2)]
            with self._autocast():
                ws = self.G.mapping(zb, skip_w_avg_update=True)
                img = self.G.synthesis(ws, noises=draws["pl_noises"])
            (pl_grads,) = torch.autograd.grad(
                img, ws, draws["pl_proj"].to(img.dtype), create_graph=True)
            pl_lengths = pl_grads.float().square().sum(2).mean(1).sqrt()
            pl_new = self.pl_mean + 0.01 * (pl_lengths.mean() - self.pl_mean)
            plp = (pl_lengths - pl_new).square().mean()
            loss = loss + cfg.lambda_plp * plp \
                * cfg.lazy_path_penalty_interval
        return loss, plp, pl_new

    def g_step(self, draws: Draws, do_plp: bool) -> Dict[str, torch.Tensor]:
        self.opt_g.zero_grad(set_to_none=True)
        self.D.requires_grad_(False)
        try:
            loss, plp, pl_new = self.g_loss(draws, do_plp)
            loss.backward()
        finally:
            self.D.requires_grad_(True)
        self.opt_g.step()
        self.update_ema()
        self.pl_mean = pl_new.detach()
        return {"g_loss": loss.detach(), "plp": plp.detach()}

    @torch.no_grad()
    def update_ema(self):
        """g_ema = beta g_ema + (1 - beta) G; G's buffers copied."""
        beta = self.cfg.ema_beta
        ema = list(self.g_ema.parameters())
        torch._foreach_mul_(ema, beta)
        torch._foreach_add_(ema, list(self.G.parameters()), alpha=1 - beta)
        for e, b in zip(self.g_ema.buffers(), self.G.buffers()):
            e.copy_(b)

    # -- ADA controller ----------------------------------------------------

    def update_ada(self, n_seen_per_interval: int, ada_kimg: float = 500.0):
        """Move p toward ``ada_target`` by the accumulated r_t's sign; reset
        the accumulators. Runs on the device: no host sync."""
        if self.cfg.ada_fixed:
            return
        rt = self.rt_accum / torch.clamp(self.rt_count, min=1)
        adjust = torch.sign(rt - self.cfg.ada_target) \
            * (n_seen_per_interval / (ada_kimg * 1000.0))
        self.ada_p = torch.clamp(self.ada_p + adjust, 0.0, 1.0)
        self.rt_accum = torch.zeros_like(self.rt_accum)
        self.rt_count = torch.zeros_like(self.rt_count)

    # -- public ------------------------------------------------------------

    def schedule(self, step: int) -> Tuple[bool, bool, bool]:
        """(R1, path length, ADA tick) at ``step``."""
        cfg = self.cfg
        do_r1 = step % cfg.lazy_gradient_penalty_interval == 0
        do_plp = (step >= cfg.lazy_path_penalty_after
                  and step % cfg.lazy_path_penalty_interval == 0)
        return do_r1, do_plp, step > 0 and step % cfg.ada_interval == 0

    def train_step(self, reals: torch.Tensor,
                   step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """One iteration: D step (lazy R1), G step (lazy path length), ADA
        tick. ``step`` defaults to the trainer's host counter, which then
        moves to ``step + 1``. Returns the logs as device tensors."""
        step = self.step if step is None else step
        do_r1, do_plp, tick = self.schedule(step)
        d_draws, g_draws = self.draw(reals.shape[0], do_plp)
        logs = self.d_step(reals, d_draws, do_r1)
        logs.update(self.g_step(g_draws, do_plp))
        if tick:
            self.update_ada(reals.shape[0] * self.cfg.ada_interval)
        self.step = step + 1
        logs["ada_p"] = self.ada_p
        return logs

    # -- checkpoints -------------------------------------------------------

    def state_dict(self) -> Dict:
        cpu = {k: getattr(self, k).cpu()
               for k in ("ada_p", "rt_accum", "rt_count", "pl_mean")}
        return {"g": self.G.state_dict(), "d": self.D.state_dict(),
                "g_ema": self.g_ema.state_dict(),
                "opt_g": self.opt_g.state_dict(),
                "opt_d": self.opt_d.state_dict(), "step": self.step, **cpu}

    def load_state_dict(self, sd: Dict):
        self.G.load_state_dict(sd["g"], strict=True)
        self.D.load_state_dict(sd["d"], strict=True)
        self.g_ema.load_state_dict(sd["g_ema"], strict=True)
        self.opt_g.load_state_dict(sd["opt_g"])
        self.opt_d.load_state_dict(sd["opt_d"])
        for k in ("ada_p", "rt_accum", "rt_count", "pl_mean"):
            setattr(self, k, sd[k].to(self.device, torch.float32))
        self.step = int(sd["step"])
