"""Spatially sharded synthesis: the ranks of one mesh axis cooperate on one
high-resolution image, each computing a band of its rows. The port of
``stylegan_for_facerec_tpu/parallel/spatial.py``.

Once the output resolution outgrows what one device holds at a useful
batch size, batch sharding stops helping: a batch-1 synthesis at a high
resolution occupies one device while the rest idle. The JAX package shards
the image's height over the mesh and lets GSPMD partition every
convolution with halo exchanges. PyTorch has no partitioner, so this
module does the partitioner's work by hand, with the JAX package's rule
for which resolutions are sharded:

* ``spatial_shard_fn`` is the policy. A height that divides the axis size
  and leaves at least ``min_rows_per_shard`` rows a rank is sharded: rank
  ``i`` owns rows ``[i H / n, (i + 1) H / n)``. Any other height (the
  pyramid's cheap 4x4/8x8 prefix) stays replicated on every rank.
* ``make_spatial_synthesis`` runs the generator's mapping and its
  replicated prefix as one process does, then each block whose output
  height is sharded on the rank's band only. Weights, state and z are
  replicated; the result is the rank's band, (N, C, H / n, W). It is
  inference only (``torch.no_grad``) and takes the ADA ``Generator`` with
  either layer family or the rosinality ``Generator``.
* ``gather_rows`` assembles the whole image along H on every rank.

Each operation takes from its input what its footprint reaches, derived
from the single-device operation, so that a band equals the same rows of
one process's image up to the convolutions' summation order:

* 3x3 convolutions (the modulated conv, the StyleGAN1 equalized conv):
  one row above and below, zeros only beyond the image's true edges; the
  demodulation depends on weights and styles only.
* Kernel B2 (``smooth_upsample``: nearest x2, edge padding, 4x4 FIR): the
  kernel itself runs on the band plus one input row from each neighbour,
  and the two output rows at each side that its own edge padding touched
  are cropped; only the ranks at the image's edges keep that padding.
* Kernel B1 (``bias_act``) and the 1x1 to-RGB convs are elementwise in H:
  local.
* The rosinality upsampling (a stride-2 transposed convolution, then
  ``Blur`` with pad (1, 1)) and its to-RGB ``Upsample`` (zero insertion,
  pad (2, 1)): one input row from each neighbour; the transposed
  convolution's extra rows are cut so that each band's rows are exactly
  one process's.
* Noise: "random" draws each layer's whole (N, 1, r, r) noise from the
  same seeded ``torch.Generator`` in one process's order and keeps the
  band's rows (so all ranks must pass generators seeded alike); "const",
  ``randomize_noise=False`` and given noises are sliced.
* The StyleGAN1 family's instance norm (AdaIN) uses whole-image
  statistics: band sums reduced over the axis in f32, the mean first,
  then the variance of the centred values, as one process's biased
  variance.

The halo exchange is one all-reduce of zero-filled edge rows per
exchange: each rank writes the rows it owns into the slots of the ranks
that need them, and the sum leaves each slot holding those rows exactly
(bf16 travels as f32). A slot wider than a neighbour's band is filled by
the ranks further on, as GSPMD's exchange would. An all-reduce is the
collective that gloo runs on CUDA tensors (as well as NCCL on CUDA and
gloo on CPU tensors), so the same code serves two ranks sharing one card
through gloo and one rank a card through NCCL.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models import stylegan2, stylegan2_ada
from ..ops.fused_act import bias_act, fused_leaky_relu
from ..ops.modconv import modulated_conv2d
from ..ops.resample import smooth_upsample
from ..ops.upfirdn2d import upfirdn2d
from ..utils.draws import draw_rows
from .mesh import Axis


class SpatialPolicy:
    """Which heights are sharded over ``axis`` and which rows this rank
    owns: the JAX package's ``spatial_shard_fn`` rule. Called on an NCHW
    tensor it returns the rank's rows when the height is sharded, else
    the tensor itself."""

    def __init__(self, axis: Axis, min_rows_per_shard: int = 1):
        if min_rows_per_shard < 1:
            raise ValueError(f"min_rows_per_shard {min_rows_per_shard} < 1")
        self.axis = axis
        self.size, self.index = axis.size, axis.index
        self.min_rows = min_rows_per_shard

    def sharded(self, height: int) -> bool:
        return (height % self.size == 0
                and height // self.size >= self.min_rows)

    def rows(self, height: int) -> Tuple[int, int]:
        """(first, end) of this rank's rows of ``height``: its band when
        sharded, all rows otherwise."""
        if not self.sharded(height):
            return 0, height
        b = height // self.size
        return self.index * b, (self.index + 1) * b

    def __call__(self, x):
        if getattr(x, "ndim", 0) != 4 or not self.sharded(x.shape[2]):
            return x
        lo, hi = self.rows(x.shape[2])
        return x[:, :, lo:hi]


def spatial_shard_fn(mesh, axis: str = "data",
                     min_rows_per_shard: int = 1) -> SpatialPolicy:
    """The policy over ``mesh``'s ``axis`` (an attribute of the mesh
    holding a ``parallel.mesh.Axis``): heights that do not divide the
    axis size, or that would leave fewer than ``min_rows_per_shard`` rows
    a rank, stay replicated."""
    return SpatialPolicy(getattr(mesh, axis), min_rows_per_shard)


# -- bands and the halo exchange -----------------------------------------------

class _Rows:
    """Rows [lo, lo + t.shape[2]) of an NCHW tensor of ``height`` rows;
    ``band`` when they are the policy's band of a sharded height (the
    other ranks hold the rest), else a replicated or locally computed
    range."""

    def __init__(self, t: torch.Tensor, lo: int, height: int,
                 band: bool = False):
        self.t, self.lo, self.height, self.band = t, lo, height, band

    @property
    def hi(self) -> int:
        return self.lo + self.t.shape[2]


def _exchange(band: torch.Tensor, axis: Axis, top: int, bottom: int
              ) -> torch.Tensor:
    """The rank's band with ``top`` rows above and ``bottom`` below from
    the other ranks (zeros beyond the image): one all-reduce of a
    (ranks, N, C, top + bottom, W) buffer into which every rank writes the
    rows it owns of every rank's halo. Every rank calls it with the same
    ``top`` and ``bottom``."""
    n, idx, b = axis.size, axis.index, band.shape[2]
    wire = band.float() if band.dtype in (torch.bfloat16, torch.float16) \
        else band
    buf = wire.new_zeros((n, band.shape[0], band.shape[1], top + bottom,
                          band.shape[3]))
    mine = (idx * b, (idx + 1) * b)
    for j in range(n):
        for start, stop, slot in ((j * b - top, j * b, 0),
                                  ((j + 1) * b, (j + 1) * b + bottom, top)):
            a0, a1 = max(start, mine[0]), min(stop, mine[1])
            if a0 < a1:
                buf[j, :, :, slot + a0 - start: slot + a1 - start] = \
                    wire[:, :, a0 - mine[0]: a1 - mine[0]]
    halo = axis.sum(buf)[idx].to(band.dtype)
    return torch.cat([halo[:, :, :top], band, halo[:, :, top:]], dim=2)


def _fetch(x: _Rows, lo: int, hi: int, axis: Axis) -> torch.Tensor:
    """Rows [lo, hi) of ``x``, zeros outside the image: sliced where this
    rank holds them, else (``x`` a band) exchanged with the neighbours."""
    if not x.band or (x.lo <= lo and hi <= x.hi):
        a, b = max(lo, 0), min(hi, x.height)
        t = x.t[:, :, a - x.lo: b - x.lo]
        return F.pad(t, (0, 0, a - lo, hi - b)) if (a > lo or b < hi) \
            else t
    return _exchange(x.t, axis, x.lo - lo, hi - x.hi)


def _b2(t: torch.Tensor, t_lo: int, h: int, lo: int, hi: int
        ) -> torch.Tensor:
    """Rows [lo, hi) of ``smooth_upsample`` (kernel B2 on a card) of an
    ``h``-row input of which ``t`` holds rows [t_lo, ...) including
    [lo / 2 - 1, hi / 2 + 1) within the image: B2 on those rows, less
    the two output rows at each cut side that its edge padding made."""
    a, b = max(lo // 2 - 1, 0), min(hi // 2 + 1, h)
    y = smooth_upsample(t[:, :, a - t_lo: b - t_lo].contiguous())
    off = lo - 2 * a
    return y[:, :, off: off + hi - lo]


def _noise_rows(x: torch.Tensor, lo: int, hi: int, r: int, mode: str,
                const: Optional[torch.Tensor], generator, given
                ) -> Optional[torch.Tensor]:
    """Rows [lo, hi) of a layer's (N, 1, r, r) noise: drawn whole from
    ``generator`` as one process draws it, given, or the const buffer;
    None in "none" mode."""
    if mode == "random":
        if given is None:
            if generator is None:
                raise ValueError("noise_mode='random' needs a "
                                 "torch.Generator or given noise")
            given = draw_rows(x.shape[0], generator, lambda rows: torch.randn(
                (rows, 1, r, r), generator=generator, device=x.device,
                dtype=x.dtype))
        return given[:, :, lo:hi]
    if mode == "const":
        return const.reshape(1, 1, r, r)[:, :, lo:hi]
    if mode == "none":
        return None
    raise ValueError(f"noise_mode {mode!r}: const|none|random")


def _instance_norm(x: torch.Tensor, eps: float, height: int, axis: Axis
                   ) -> torch.Tensor:
    """Instance norm of a band with the whole image's statistics: sums
    over H and W reduced over the axis in f32, the mean, then the biased
    variance of the centred values."""
    count = height * x.shape[3]
    mean = axis.sum(x.float().sum(dim=(2, 3), keepdim=True)) / count
    mean = mean.to(x.dtype)
    dev = x - mean
    var = axis.sum(dev.float().square().sum(dim=(2, 3), keepdim=True)) \
        / count
    return dev * torch.rsqrt(var.to(x.dtype) + eps)


# -- the StyleGAN2-ADA generator -------------------------------------------

def _check_kernel(kernel_size: int):
    if kernel_size != 3:
        raise ValueError(f"spatial synthesis takes 3x3 synthesis "
                         f"convolutions, got {kernel_size}")


def _ada_layer(layer, x: _Rows, w, lo: int, hi: int, noise_mode: str,
               generator, noise, axis: Axis) -> torch.Tensor:
    """Rows [lo, hi) of an ADA ``SynthesisLayer`` or ``SynthesisLayer1``
    at its resolution from ``x`` (half the resolution when it upsamples).
    """
    _check_kernel(layer.kernel_size)
    r = layer.resolution
    styles = layer.affine(w)
    # the conv's output rows: the band, or what B2 reads for it
    c_lo, c_hi = (lo // 2 - 1, hi // 2 + 1) if layer.up else (lo, hi)
    inp = _fetch(x, c_lo - 1, c_hi + 1, axis)
    if isinstance(layer, stylegan2_ada.SynthesisLayer1):
        y = F.conv2d(inp, layer.weight.to(inp.dtype) * layer.weight_gain,
                     padding=(0, 1))
    else:
        y = modulated_conv2d(inp, layer.weight, styles, padding=(0, 1),
                             demodulate=True)
    if layer.up:
        y = _b2(y, c_lo, r // 2, lo, hi)
    nz = _noise_rows(y, lo, hi, r, noise_mode, layer.noise_const, generator,
                     noise)
    if nz is not None:
        y = y + nz.to(y.dtype) * layer.noise_strength.to(y.dtype)
    y = bias_act(y.contiguous(), layer.bias, act="lrelu", clamp=256.0)
    if isinstance(layer, stylegan2_ada.SynthesisLayer1):
        gamma, beta = styles.to(y.dtype).chunk(2, dim=1)
        y = (gamma[:, :, None, None]
             * _instance_norm(y, layer.ada_in.norm.eps, r, axis)
             + beta[:, :, None, None])
    return y


def _ada_synthesis(net, ws, policy: SpatialPolicy, noise_mode: str,
                   generator, noises, trace: list) -> _Rows:
    axis = policy.axis
    layers = 1 + 2 * len(net.blocks)
    if noises is not None and len(noises) != layers:
        raise ValueError(f"{len(noises)} noises for {layers} layers")
    noises = noises or [None] * layers
    first = net.first_block
    r = first.conv1.resolution
    if not policy.sharded(r):
        x, img = first(ws[:, 0:2], noise_mode, generator, noises[:1])
        x, img = _Rows(x, 0, r), _Rows(img, 0, r)
    else:
        lo, hi = policy.rows(r)
        const = first.const.to(ws.dtype)[None].repeat(ws.shape[0], 1, 1, 1)
        t = _ada_layer(first.conv1, _Rows(const, 0, r), ws[:, 0], lo, hi,
                       noise_mode, generator, noises[0], axis)
        x = _Rows(t, lo, r, band=True)
        img = _Rows(first.torgb(t, ws[:, 1]), lo, r, band=True)
    trace.append((r, x.lo, x.t.shape[2]))
    for n, block in enumerate(net.blocks):
        w = ws[:, 2 * n + 1: 2 * n + 4]
        n0, n1 = noises[1 + 2 * n: 3 + 2 * n]
        r = block.conv1.resolution
        if not policy.sharded(r):
            t, im = block(x.t, img.t, w, noise_mode, generator, [n0, n1])
            x, img = _Rows(t, 0, r), _Rows(im, 0, r)
        else:
            lo, hi = policy.rows(r)
            t = _ada_layer(block.conv0, x, w[:, 0], lo, hi, noise_mode,
                           generator, n0, axis)
            t = _ada_layer(block.conv1, _Rows(t, lo, r, band=True), w[:, 1],
                           lo, hi, noise_mode, generator, n1, axis)
            y = block.torgb(t, w[:, 2])
            up = _b2(_fetch(img, lo // 2 - 1, hi // 2 + 1, axis),
                     lo // 2 - 1, r // 2, lo, hi)
            x = _Rows(t, lo, r, band=True)
            img = _Rows(up + y, lo, r, band=True)
        trace.append((r, x.lo, x.t.shape[2]))
    return img


# -- the rosinality generator ------------------------------------------------

def _rosi_conv(sc, x: _Rows, style, lo: int, hi: int, noise, generator,
               axis: Axis) -> torch.Tensor:
    """Rows [lo, hi) of a rosinality ``StyledConv`` (modulated conv,
    noise, ``FusedLeakyReLU``) at its output resolution."""
    conv = sc.conv
    _check_kernel(conv.kernel_size)
    styles = conv.modulation(style)
    if conv.upsample:
        if tuple(conv.blur.pad) != (1, 1) or conv.blur.kernel.shape != (4, 4):
            raise ValueError("spatial synthesis takes the 4-tap blur with "
                             "pad (1, 1) after the transposed conv")
        # transposed-conv rows [lo - 2, hi + 3) from input rows
        # [lo / 2 - 1, hi / 2 + 1); the blur reads rows [lo - 1, hi + 2)
        inp = _fetch(x, lo // 2 - 1, hi // 2 + 1, axis)
        wt = conv.weight[0].to(inp.dtype) * conv.scale
        y = F.conv_transpose2d(inp * styles.to(inp.dtype)[:, :, None, None],
                               wt.transpose(0, 1), stride=2)
        y = upfirdn2d(conv._demod(y, styles), conv.blur.kernel,
                      pad=(1, 1, -1, -1))
    else:
        inp = _fetch(x, lo - 1, hi + 1, axis)
        wt = conv.weight[0].to(inp.dtype) * conv.scale
        y = conv._demod(F.conv2d(inp * styles.to(inp.dtype)[:, :, None, None],
                                 wt, padding=(0, 1)), styles)
    if noise is None:
        if generator is None:
            raise ValueError("NoiseInjection draws its noise from an "
                             "explicit torch.Generator, or takes it given")
        r = y.shape[3]
        noise = torch.randn((y.shape[0], 1, r, r), generator=generator,
                            device=y.device, dtype=y.dtype)
    y = y + sc.noise.weight.to(y.dtype) * noise[:, :, lo:hi].to(y.dtype)
    return fused_leaky_relu(y.contiguous(), sc.activate.bias)


def _rosi_to_rgb(to_rgb, x: torch.Tensor, style, skip: _Rows, lo: int,
                 hi: int, axis: Axis) -> torch.Tensor:
    """Rows [lo, hi) of a rosinality ``ToRGB`` with its skip image."""
    up = to_rgb.upsample
    if up.factor != 2 or tuple(up.pad) != (2, 1) or up.kernel.shape != (4, 4):
        raise ValueError("spatial synthesis takes the 4-tap x2 Upsample "
                         "with pad (2, 1)")
    y = to_rgb.conv(x, style) + to_rgb.bias.to(x.dtype)
    ext = _fetch(skip, lo // 2 - 1, hi // 2 + 1, axis)
    return y + upfirdn2d(ext, up.kernel, up=2, pad=(2, 1, 0, -1))


def _rosi_synthesis(g, latent, noise, generator, policy: SpatialPolicy,
                    trace: list) -> _Rows:
    axis = policy.axis
    out = g.input(latent.shape[0], latent.dtype)
    r = out.shape[2]
    if not policy.sharded(r):
        out = g.conv1(out, latent[:, 0], noise[0], generator)
        x = _Rows(out, 0, r)
        skip = _Rows(g.to_rgb1(out, latent[:, 1]), 0, r)
    else:
        lo, hi = policy.rows(r)
        t = _rosi_conv(g.conv1, _Rows(out, 0, r), latent[:, 0], lo, hi,
                       noise[0], generator, axis)
        x = _Rows(t, lo, r, band=True)
        skip = _Rows(g.to_rgb1(t, latent[:, 1]), lo, r, band=True)
    trace.append((r, x.lo, x.t.shape[2]))
    i = 1
    for b, to_rgb in enumerate(g.to_rgbs):
        up, conv = g.convs[2 * b], g.convs[2 * b + 1]
        r = 2 * x.height
        if not policy.sharded(r):
            t = up(x.t, latent[:, i], noise[1 + 2 * b], generator)
            t = conv(t, latent[:, i + 1], noise[2 + 2 * b], generator)
            x = _Rows(t, 0, r)
            skip = _Rows(to_rgb(t, latent[:, i + 2], skip.t), 0, r)
        else:
            lo, hi = policy.rows(r)
            t = _rosi_conv(up, x, latent[:, i], lo, hi, noise[1 + 2 * b],
                           generator, axis)
            t = _rosi_conv(conv, _Rows(t, lo, r, band=True),
                           latent[:, i + 1], lo, hi, noise[2 + 2 * b],
                           generator, axis)
            skip = _Rows(_rosi_to_rgb(to_rgb, t, latent[:, i + 2], skip, lo,
                                      hi, axis), lo, r, band=True)
            x = _Rows(t, lo, r, band=True)
        trace.append((r, x.lo, x.t.shape[2]))
        i += 2
    return skip


# -- entry points ------------------------------------------------------------

class SpatialSynthesis:
    """``synth(z, generator=None)``: the rank's band (N, C, H / n, W) of
    the image that ``model`` makes from ``z`` (or w, with
    ``input_is_latent``) with ``apply_kwargs``; ``generator`` is the
    ``torch.Generator`` of random noise (and of a rosinality style-mixing
    crossover), seeded alike on every rank. ``bands`` lists, for the last
    call, (height, first row, rows) of each block's output on this rank.
    """

    def __init__(self, model, policy: SpatialPolicy, apply_kwargs: dict):
        self.model, self.policy = model, policy
        self.apply_kwargs = dict(apply_kwargs)
        self.bands: List[Tuple[int, int, int]] = []
        if isinstance(model, stylegan2_ada.Generator):
            net = model.synthesis
            size = net.first_block.conv1.resolution * 2 ** len(net.blocks)
        elif isinstance(model, stylegan2.Generator):
            size = model.size
        else:
            raise TypeError(f"spatial synthesis takes the ADA or the "
                            f"rosinality Generator, got {type(model)}")
        if not policy.sharded(size):
            raise ValueError(f"output height {size} is not sharded over "
                             f"{policy.size} ranks (min rows "
                             f"{policy.min_rows})")

    @torch.no_grad()
    def __call__(self, z, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        trace: list = []
        kw = self.apply_kwargs
        g = self.model
        if isinstance(g, stylegan2_ada.Generator):
            ws = z if kw.get("input_is_latent", False) else g.mapping(
                z, kw.get("truncation_psi", 1.0),
                kw.get("truncation_cutoff"), skip_w_avg_update=True)
            img = _ada_synthesis(g.synthesis, ws, self.policy,
                                 kw.get("noise_mode", "random"), generator,
                                 kw.get("noises"), trace)
        else:
            latent = g.latents(z, kw.get("inject_index"),
                               kw.get("truncation", 1.0),
                               kw.get("truncation_latent"),
                               kw.get("input_is_latent", False), generator)
            noise = kw.get("noise")
            if noise is None:
                noise = ([None] * g.num_layers
                         if kw.get("randomize_noise", True) else
                         [getattr(g.noises, f"noise_{i}")
                          for i in range(g.num_layers)])
            img = _rosi_synthesis(g, latent, noise, generator, self.policy,
                                  trace)
        self.bands = trace
        return img.t.contiguous()


def make_spatial_synthesis(generator, mesh, axis: str = "data",
                           min_rows_per_shard: int = 1,
                           **apply_kwargs) -> SpatialSynthesis:
    """The synthesis of ``generator`` (an ADA ``Generator`` of either
    layer family, or the rosinality ``Generator``) with its pyramid
    sharded by height over ``mesh``'s ``axis``. ``apply_kwargs`` go to
    the generator as its ``forward`` takes them: ``noise_mode``,
    ``truncation_psi``, ``truncation_cutoff``, ``input_is_latent``,
    ``noises`` (ADA); ``randomize_noise``, ``noise``, ``truncation``,
    ``truncation_latent``, ``inject_index``, ``input_is_latent``
    (rosinality). The mapping network updates no ``w_avg``. Raises when
    the output height is not sharded."""
    return SpatialSynthesis(generator,
                            spatial_shard_fn(mesh, axis, min_rows_per_shard),
                            apply_kwargs)


def gather_rows(band: torch.Tensor, mesh, axis: str = "data"
                ) -> torch.Tensor:
    """The whole image from every rank's band of ``axis`` (bands in rank
    order along H), on every rank."""
    ax = getattr(mesh, axis)
    return ax.gather(band.movedim(2, 0).contiguous()).movedim(0, 2) \
        .contiguous()
