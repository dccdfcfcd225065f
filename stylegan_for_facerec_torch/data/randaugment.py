"""RandAugment on the host, with PIL, as
``stylegan_for_facerec_tpu/data/randaugment.py``: the same 13 operations,
the same magnitude ranges, fill 128, ``num_ops`` operations an image (by
default half the menu) at magnitudes drawn from [0, ``max_magnitude``).

The draws come from a ``random.Random`` that the caller owns (or one
seeded with ``seed``), never from the global generators: for each image
the operations, then the magnitudes, then one sign for each operation.
``apply_op`` computes one operation for given draws, so the same draws
give the JAX package's images.
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple

import numpy as np

OPS: Tuple[str, ...] = (
    "autocontrast", "equalize", "rotate", "solarize", "color", "posterize",
    "contrast", "brightness", "sharpness", "shearX", "shearY",
    "translateX", "translateY")

FILL = 128


def magnitude_ranges() -> dict:
    """The value of each operation's magnitude at the indices 0-9."""
    return {
        "shearX": np.linspace(0, 0.3, 10),
        "shearY": np.linspace(0, 0.3, 10),
        "translateX": np.linspace(0, 0.2, 10),
        "translateY": np.linspace(0, 0.2, 10),
        "rotate": np.linspace(0, 360, 10),
        "color": np.linspace(0.0, 0.9, 10),
        "posterize": np.round(np.linspace(8, 4, 10), 0).astype(int),
        "solarize": np.linspace(256, 231, 10),
        "contrast": np.linspace(0.0, 0.5, 10),
        "sharpness": np.linspace(0.0, 0.9, 10),
        "brightness": np.linspace(0.0, 0.3, 10),
        "autocontrast": [0] * 10,
        "equalize": [0] * 10,
        "invert": [0] * 10,
    }


def apply_op(img, op: str, mag, sign: int):
    """One operation on a PIL image at magnitude value ``mag`` with
    ``sign`` (-1 or 1, used by the signed operations)."""
    from PIL import Image, ImageEnhance, ImageOps
    affine, bicubic = Image.Transform.AFFINE, Image.Resampling.BICUBIC
    if op == "shearX":
        return img.transform(img.size, affine, (1, mag * sign, 0, 0, 1, 0),
                             bicubic, fill=FILL)
    if op == "shearY":
        return img.transform(img.size, affine, (1, 0, 0, mag * sign, 1, 0),
                             bicubic, fill=FILL)
    if op == "translateX":
        return img.transform(img.size, affine,
                             (1, 0, mag * img.size[0] * sign, 0, 1, 0),
                             fill=FILL)
    if op == "translateY":
        return img.transform(img.size, affine,
                             (1, 0, 0, 0, 1, mag * img.size[1] * sign),
                             fill=FILL)
    if op == "rotate":
        rot = img.convert("RGBA").rotate(mag)
        bg = Image.new("RGBA", rot.size, (FILL,) * 4)
        return Image.composite(rot, bg, rot).convert(img.mode)
    if op == "color":
        return ImageEnhance.Color(img).enhance(1 + mag * sign)
    if op == "posterize":
        return ImageOps.posterize(img, int(mag))
    if op == "solarize":
        return ImageOps.solarize(img, mag)
    if op == "contrast":
        return ImageEnhance.Contrast(img).enhance(1 + mag * sign)
    if op == "sharpness":
        return ImageEnhance.Sharpness(img).enhance(1 + mag * sign)
    if op == "brightness":
        return ImageEnhance.Brightness(img).enhance(1 + mag * sign)
    if op == "autocontrast":
        return ImageOps.autocontrast(img)
    if op == "equalize":
        return img          # the reference's 'equalize' is the identity
    if op == "invert":
        return ImageOps.invert(img)
    raise ValueError(op)


class RandAugment:
    """``num_ops`` random operations on each uint8 RGB array."""

    def __init__(self, num_ops: Optional[int] = None,
                 max_magnitude: Optional[int] = None,
                 rng: Optional[random.Random] = None, seed: int = 0):
        self.num_ops = num_ops if num_ops is not None else len(OPS) // 2
        self.max_magnitude = max_magnitude if max_magnitude is not None \
            else 10
        self.ranges = magnitude_ranges()
        self.rng = rng if rng is not None else random.Random(seed)

    def draw(self) -> List[Tuple[str, int, int]]:
        """(operation, magnitude index, sign) for each operation of one
        image."""
        ops = [self.rng.choice(OPS) for _ in range(self.num_ops)]
        mags = [self.rng.randrange(self.max_magnitude)
                for _ in range(self.num_ops)]
        signs = [self.rng.choice((-1, 1)) for _ in range(self.num_ops)]
        return list(zip(ops, mags, signs))

    def apply(self, image: np.ndarray, draws) -> np.ndarray:
        from PIL import Image
        img = Image.fromarray(image)
        for op, m, sign in draws:
            img = apply_op(img, op, self.ranges[op][m], sign)
        return np.asarray(img)

    def __call__(self, image: np.ndarray) -> np.ndarray:
        return self.apply(image, self.draw())
