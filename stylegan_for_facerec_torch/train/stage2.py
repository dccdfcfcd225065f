"""Stage-2 ReStyle pSp coach: GAN-inversion encoder training, as
``stylegan_for_facerec_tpu/train/stage2.py``.

  * ``latent_avg`` is estimated from the frozen generator's mapping
    network, and the average image is synthesised from it, cropped
    [35:223, 30:218] and resized to 112;
  * each batch runs ``n_iters_per_batch`` refinement iterations: the first
    conditions on the average image, later ones on the previous output,
    detached; the latent carry is detached too. Each iteration's loss is
    backpropagated as soon as it is computed, then one optimizer step is
    taken. This is the reference coach's order and holds one iteration's
    graph at a time; the gradient equals the JAX package's gradient of the
    summed loss up to summation order;
  * loss = l2 * lambda + lpips * lambda + w_norm * lambda + id * lambda;
  * Ranger (or Adam) on the encoder's parameters. The decoder is frozen
    (``requires_grad`` off) unless ``train_decoder``; the encoder trains
    with BatchNorm in train mode, so every forward updates its running
    statistics. Random noise draws from an explicit ``torch.Generator``.

``compute_dtype="bfloat16"`` runs the encoder and the generator under
``torch.autocast`` in bfloat16: parameters, optimizer state and BatchNorm
statistics stay float32, convolutions and matmuls run in bf16, so the
activations that reach kernels B1, B1b, B2 and B2b are bf16, and the
losses are computed in float32 after the autocast region.

Images at the public methods are NHWC in [-1, 1], as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from ..losses.identity import w_norm_loss
from ..models.psp import PSp
from ..nn.initializers import init_weights
from ..ops.image import resize_bilinear
from ..utils.device import resolve_device
from ..utils.logging import aggregate_loss_dicts
from .optim import Ranger


@dataclasses.dataclass(frozen=True)
class Stage2Config:
    """The JAX package's ``Stage2Config`` (without ``moco_lambda``, which
    nothing reads): the README stage-2 recipe (l2 1.0, lpips 0.8, others
    0, one refinement iteration)."""

    output_size: int = 128
    input_nc: int = 6
    n_iters_per_batch: int = 1
    l2_lambda: float = 1.0
    lpips_lambda: float = 0.8
    w_norm_lambda: float = 0.0
    id_lambda: float = 0.0
    learning_rate: float = 1e-4
    optim_name: str = "ranger"
    train_decoder: bool = False
    target_size: int = 112
    compute_dtype: str = "bfloat16"


def cpu_optimizer_state(optimizer: torch.optim.Optimizer) -> Dict:
    """``optimizer.state_dict()`` with its tensors copied to the CPU (its
    per-parameter dicts are live: an optimizer loading them would share
    them)."""
    opt = optimizer.state_dict()
    opt["state"] = {i: {k: v.to("cpu", copy=True) if torch.is_tensor(v)
                        else v for k, v in st.items()}
                    for i, st in opt["state"].items()}
    return opt


class Stage2Coach:
    """Owns the ``PSp`` (seeded random weights, on ``device``) and its
    optimizer. ``lpips_fn(y_hat, y)`` and ``id_loss_fn(y_hat, y, x)`` take
    NHWC images; the latter returns (loss, similarity gain, logs).
    ``model_class`` is the model a subclass trains in place of ``PSp``
    (the e4e coach's ``E4e``)."""

    model_class = PSp

    def __init__(self, cfg: Stage2Config,
                 lpips_fn: Optional[Callable] = None,
                 id_loss_fn: Optional[Callable] = None,
                 device: str = "cuda", seed: int = 0):
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: "
                             f"float32|bfloat16")
        self.cfg = cfg
        self.device = resolve_device(device)
        model = self.model_class(output_size=cfg.output_size,
                                 input_nc=cfg.input_nc)
        init_weights(model, torch.Generator().manual_seed(seed))
        model.decoder.requires_grad_(cfg.train_decoder)
        self.model = model.to(self.device).train()
        self.lpips_fn = lpips_fn
        self.id_loss_fn = id_loss_fn
        params = [p for p in model.parameters() if p.requires_grad]
        if cfg.optim_name == "ranger":
            self.optimizer = Ranger(params, lr=cfg.learning_rate)
        elif cfg.optim_name == "adam":
            self.optimizer = torch.optim.Adam(params, lr=cfg.learning_rate)
        else:
            raise ValueError(f"optim_name {cfg.optim_name!r}: ranger|adam")

    # -- setup -------------------------------------------------------------

    @torch.no_grad()
    def estimate_latent_avg(self, generator: torch.Generator,
                            n_latent: int = 100_000) -> torch.Tensor:
        """Fill ``model.latent_avg`` with the mean mapped w over
        ``n_latent`` z drawn from ``generator`` (on the coach's device)."""
        avg = self.model.decoder.mean_latent(n_latent, generator)
        self.model.latent_avg.copy_(avg)
        return self.model.latent_avg

    @torch.no_grad()
    def make_avg_image(self) -> torch.Tensor:
        """Synthesise ``latent_avg`` with const noise, pool to 256, crop
        [35:223, 30:218], resize to ``target_size``: (T, T, 3) in
        [-1, 1]."""
        m = self.model
        img = m.decoder(m.latent_avg[None], noise_mode="const",
                        input_is_latent=True)
        if img.shape[-1] != 256:
            img = m.face_pool(img)
        img = resize_bilinear(img[:, :, 35:223, 30:218], self.cfg.target_size,
                              self.cfg.target_size)
        return img[0].permute(1, 2, 0).clamp(-1, 1)

    # -- losses ------------------------------------------------------------

    def _calc_loss(self, y_hat, y, x, latent) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        loss = torch.zeros((), dtype=torch.float32, device=y_hat.device)
        logs = {}
        if cfg.l2_lambda > 0:
            l2 = torch.mean(torch.square(y_hat - y))
            logs["loss_l2"] = l2
            loss = loss + l2 * cfg.l2_lambda
        if cfg.lpips_lambda > 0 and self.lpips_fn is not None:
            lp = self.lpips_fn(y_hat, y)
            logs["loss_lpips"] = lp
            loss = loss + lp * cfg.lpips_lambda
        if cfg.w_norm_lambda > 0:
            wn = w_norm_loss(latent, self.model.latent_avg)
            logs["loss_w_norm"] = wn
            loss = loss + wn * cfg.w_norm_lambda
        if cfg.id_lambda > 0 and self.id_loss_fn is not None:
            idl, sim, _ = self.id_loss_fn(y_hat, y, x)
            logs["loss_id"] = idl
            logs["id_improve"] = sim
            loss = loss + idl * cfg.id_lambda
        logs["loss"] = loss
        return loss, {k: v.detach() for k, v in logs.items()}

    # -- refinement loop ---------------------------------------------------

    def _refine(self, x, y, avg_image, generator, backward: bool):
        """Runs the refinement iterations; with ``backward`` each
        iteration's loss is backpropagated. Returns (summed loss, last
        iteration's logs, last y_hat NHWC f32)."""
        cfg = self.cfg
        x_net = x.permute(0, 3, 1, 2)
        cond = avg_image.permute(2, 0, 1)[None].to(x.dtype).expand_as(x_net)
        latent, total, logs = None, 0.0, {}
        for _ in range(cfg.n_iters_per_batch):
            with torch.autocast(self.device.type, dtype=torch.bfloat16,
                                enabled=cfg.compute_dtype == "bfloat16"):
                out, latent = self.model(
                    torch.cat([x_net, cond], dim=1),
                    None if latent is None else latent.detach(),
                    resize=True, randomize_noise=True, return_latents=True,
                    generator=generator)
                y_hat = resize_bilinear(out, cfg.target_size, cfg.target_size)
            y_hat = y_hat.float()
            loss, logs = self._calc_loss(y_hat.permute(0, 2, 3, 1), y, x,
                                         latent.float())
            if backward:
                loss.backward()
            total = total + loss.detach()
            cond = y_hat.detach()
        return total, logs, y_hat.detach().permute(0, 2, 3, 1)

    # -- public ------------------------------------------------------------

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   avg_image: torch.Tensor, generator: torch.Generator):
        """x: (B, H, W, 3) source, y: (B, T, T, 3) target, on the coach's
        device. One optimizer step over the refinement iterations; returns
        (summed loss, logs of the last iteration, y_hat (B, T, T, 3))."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, logs, y_hat = self._refine(x, y, avg_image, generator,
                                         backward=True)
        self.optimizer.step()
        return loss, logs, y_hat

    @torch.no_grad()
    def validate_batch(self, x: torch.Tensor, y: torch.Tensor,
                       avg_image: torch.Tensor, generator: torch.Generator):
        """Refinement without gradients, BatchNorm in eval mode; returns
        (summed loss, logs of the last iteration, y_hat)."""
        was_training = self.model.training
        self.model.eval()
        try:
            loss, logs, y_hat = self._refine(x, y, avg_image, generator,
                                             backward=False)
        finally:
            self.model.train(was_training)
        return loss, logs, y_hat

    def validate(self, batches: Iterable, avg_image: torch.Tensor,
                 generator: torch.Generator,
                 max_batches: Optional[int] = None) -> Dict[str, float]:
        """Mean of ``validate_batch``'s logs over (x, y) batches."""
        agg = []
        for bi, (x, y) in enumerate(batches):
            if max_batches is not None and bi >= max_batches:
                break
            _, logs, _ = self.validate_batch(x, y, avg_image, generator)
            agg.append({k: float(v) for k, v in logs.items()})
        return aggregate_loss_dicts(agg) if agg else {}

    # -- checkpoints -------------------------------------------------------

    def state_dict(self) -> Dict:
        """Weights, ``latent_avg`` and optimizer state, as copies on the
        CPU (an optimizer loading live tensors would share them); the keys
        of ``utils.checkpoint.save_checkpoint`` plus ``optimizer``."""
        return {"state_dict": {k: v.cpu() for k, v in
                               self.model.state_dict().items()},
                "latent_avg": self.model.latent_avg.cpu(),
                "optimizer": cpu_optimizer_state(self.optimizer)}

    def load_state_dict(self, ckpt: Dict) -> None:
        self.model.load_state_dict(ckpt["state_dict"], strict=True)
        with torch.no_grad():
            self.model.latent_avg.copy_(ckpt["latent_avg"])
        if "optimizer" in ckpt:
            self.optimizer.load_state_dict(ckpt["optimizer"])
