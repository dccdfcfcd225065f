"""Entry ``inversion``: the port's ``eval/inference.py::run_on_batch`` (ReStyle
iterative inversion, const noise, ``n_iters`` iterations) in a closed
loop over a pool of seeded batches, in the configuration's compute dtype
(float32, as the port's inversion CLI runs it; cuDNN's convolutions in
TF32, PyTorch's default).

Set-up builds ``PSp`` with the benchmark's weights (drawn on the device
from the seed), derives ``latent_avg`` with the port's mapping network
over seeded z (``Generator.mean_latent``) and the average image with the
port's generator, pool and resize (the steps of
``Stage2Coach.make_avg_image``), and warms up. In the window each call of
a batch that the seed picked for the check keeps its outputs and latents
of every iteration. After the window ``check`` frees the model and runs
the plain reference (``reference/restyle.py``), which works
``latent_avg`` and the average image out again: it makes the first
iteration from them, and each later iteration from the program's previous
output and latent, so that the error of one iteration does not compound
through the next (the reference follows the program's trajectory); each
iteration's outputs and latents are compared.
"""

from __future__ import annotations

from typing import Dict

import torch

from port_bench.counts.flops import (inversion_flops, kernel_calls,
                                     kernel_work)
from port_bench.harness import compare, weights
from port_bench.harness.core import PEAK_BYTES_PER_S, PEAK_FP32_FLOPS
from port_bench.reference.ops import Precision, no_tf32
from port_bench.reference.restyle import ReStyle, restyle_weight_table

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def faces(ctx, n: int, tag: str = "inputs") -> torch.Tensor:
    """n (size, size, 3) inputs in [-1, 1], each its own: a 7 x 7 random
    field upsampled bilinearly (the low frequencies that set a face's
    code) plus uniform noise of 0.1, drawn on the device."""
    s = ctx.cfg["input_size"]
    g = weights.generator(ctx.device, ctx.seed, tag)
    low = torch.rand((n, 3, 7, 7), generator=g, device=ctx.device) * 2 - 1
    x = torch.nn.functional.interpolate(low, size=(s, s), mode="bilinear",
                                        align_corners=False)
    x = x + 0.1 * (torch.rand(x.shape, generator=g, device=ctx.device)
                   * 2 - 1)
    return x.clamp(-1, 1).permute(0, 2, 3, 1)


class Inversion:
    def __init__(self, ctx):
        from stylegan_for_facerec_torch.eval.inference import run_on_batch
        from stylegan_for_facerec_torch.models.psp import PSp
        from stylegan_for_facerec_torch.ops.image import resize_bilinear
        c, t = ctx.cfg, ctx.traffic
        self.ctx, self.run_on_batch = ctx, run_on_batch
        b = t["batch"]
        self.items_per_call = b
        self.trace_calls = t["trace_calls"]
        self.flops_per_call = inversion_flops(c, b)
        # the control runs the port's bf16 path: the next precision below
        dtype = torch.bfloat16 if ctx.variant == "control" else \
            DTYPES[c["compute_dtype"]]
        elem = torch.tensor([], dtype=dtype).element_size()
        self.kernel_bound_s_per_call = sum(
            max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS)
            for nbytes, flops in (kernel_work(k, s, elem)
                                  for k, s in kernel_calls(c, b)))
        with torch.device(ctx.device):
            model = PSp(output_size=c["output_size"], input_nc=c["input_nc"],
                        encoder_num_layers=c["encoder_num_layers"],
                        input_size=c["input_size"])
        model.load_state_dict(self._state())
        model.eval()
        s = c["input_size"]
        with torch.no_grad():
            model.latent_avg.copy_(model.decoder.mean_latent(
                c["n_latent"], weights.generator(ctx.device, ctx.seed,
                                                 "latent_avg")))
            img = model.decoder(model.latent_avg[None], noise_mode="const",
                                input_is_latent=True)
            if img.shape[-1] != 256:
                img = model.face_pool(img)
            avg = resize_bilinear(img[:, :, 35:223, 30:218], s, s)[0]
        self.model = model.to(dtype)
        self.avg = avg.permute(1, 2, 0).clamp(-1, 1).to(dtype)
        self.inputs = faces(ctx, t["pool"] * b).view(
            t["pool"], b, s, s, 3).to(dtype)
        pick = torch.randperm(t["pool"], generator=torch.Generator()
                              .manual_seed(weights.derive(ctx.seed,
                                                          "checked")))
        self.checked = sorted(pick[:t["checked_batches"]].tolist())
        self.kept: Dict[int, tuple] = {}
        self.bad = torch.zeros((), dtype=torch.int64, device=ctx.device)
        for i in range(t["warmup_calls"]):
            self.call(i)
        self.first_call = t["warmup_calls"]
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)

    def _state(self):
        return weights.draw(restyle_weight_table(self.ctx.cfg),
                            self.ctx.seed, self.ctx.device)

    def _invert(self, x):
        n, variant = self.ctx.cfg["n_iters"], self.ctx.variant
        if variant == "half_batch":
            h = x.shape[0] // 2
            outs, lats = self.run_on_batch(self.model, x[:h], self.avg, n)
            return torch.cat([outs, outs], 1), torch.cat([lats, lats], 1)
        if variant == "unchanged_state":
            outs, lats = self.run_on_batch(self.model, x, self.avg, 1)
            return (outs.expand(n, *outs.shape[1:]),
                    lats.expand(n, *lats.shape[1:]))
        outs, lats = self.run_on_batch(self.model, x, self.avg, n)
        if variant == "altered_answer":
            outs = outs.clone()
            outs[-1, 0] = outs[-1, 1]
        return outs, lats

    # -- the window --------------------------------------------------------

    def call(self, i: int) -> None:
        p = i % self.ctx.traffic["pool"]
        outs, lats = self._invert(self.inputs[p])
        self.bad += (~torch.isfinite(lats[-1])).any()
        if p in self.checked:
            self.kept[p] = (outs, lats)

    def failed(self) -> int:
        return int(self.bad)

    def release(self) -> None:
        self.model = None

    def check(self) -> Dict[str, float]:
        """The worst relative L2 gap of an output image and of a latent
        over the checked batches and every iteration."""
        ctx, c = self.ctx, self.ctx.cfg
        prec = Precision("fp32")
        s, n = c["input_size"], c["n_iters"]
        gaps = {"image_gap": 0.0, "latent_gap": 0.0}
        with no_tf32():
            with torch.device("meta"):
                ref = ReStyle(c)
            ref = ref.to_empty(device=ctx.device)
            ref.load_state_dict(self._state())
            ref.eval()
            z = torch.randn((c["n_latent"], c["z_dim"]),
                            generator=weights.generator(
                                ctx.device, ctx.seed, "latent_avg"),
                            device=ctx.device)
            latent_avg = ref.mean_latent(z, prec)
            avg = ref.make_avg_image(latent_avg, prec, s)
            for p in self.checked:
                if p not in self.kept:        # never answered
                    gaps["image_gap"] = float("inf")
                    continue
                outs, lats = self.kept[p]
                x = self.inputs[p].float().permute(0, 3, 1, 2)
                cond = avg.permute(2, 0, 1)[None]
                latent = latent_avg[None]
                for k in range(n):
                    y, w = ref.iterate(x, cond, latent, prec)
                    gaps["image_gap"] = max(gaps["image_gap"],
                                            compare.answer_gap(
                                                outs[k], y.permute(0, 2, 3,
                                                                   1)))
                    gaps["latent_gap"] = max(gaps["latent_gap"],
                                             compare.answer_gap(lats[k], w))
                    # the next iteration starts from the program's state
                    cond = ref.condition(outs[k].float().permute(0, 3, 1, 2),
                                         s)
                    latent = lats[k].float()
        return gaps


def setup(ctx) -> Inversion:
    return Inversion(ctx)
