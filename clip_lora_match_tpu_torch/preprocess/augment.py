"""Train-time image augmentation (port of ``preprocess/augment.py``).

The reference's ``ImageAugmenter`` distribution (ref:src/preprocessing/
augment.py:36-69): horizontal flip p=0.5, rotation p=0.3 uniform ±15° with
expand, and one jitter roll p=0.3 that applies both a brightness and a
contrast factor drawn from [0.8, 1.2]. It draws from a
``numpy.random.Generator`` in the JAX package's order (flip roll, rotate
roll, angle, jitter roll, brightness, contrast), so a seed gives the same
PIL images in both packages. Augmentation runs on the host before the
resize and center crop.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from PIL import Image, ImageEnhance


class ImageAugmenter:
    def __init__(
        self,
        hflip_p: float = 0.5,
        rotate_p: float = 0.3,
        max_rotate_deg: float = 15.0,
        jitter_p: float = 0.3,
        jitter_range: tuple[float, float] = (0.8, 1.2),
        seed: Optional[int] = None,
    ):
        self.hflip_p = hflip_p
        self.rotate_p = rotate_p
        self.max_rotate_deg = max_rotate_deg
        self.jitter_p = jitter_p
        self.jitter_range = jitter_range
        self.rng = np.random.default_rng(seed)

    def reseed(self, seed) -> None:
        """A new stream from ``seed`` (an int or a sequence of ints)."""
        self.rng = np.random.default_rng(seed)

    def augment(self, img: Image.Image) -> Image.Image:
        rng = self.rng
        if rng.random() < self.hflip_p:
            img = img.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
        if rng.random() < self.rotate_p:
            angle = rng.uniform(-self.max_rotate_deg, self.max_rotate_deg)
            img = img.rotate(angle, expand=True, resample=Image.Resampling.BILINEAR)
        if rng.random() < self.jitter_p:
            # one roll gates both enhancements (ref:augment.py:57-67)
            img = ImageEnhance.Brightness(img).enhance(rng.uniform(*self.jitter_range))
            img = ImageEnhance.Contrast(img).enhance(rng.uniform(*self.jitter_range))
        return img

    __call__ = augment


def default_augmenter(seed: Optional[int] = None) -> ImageAugmenter:
    """The reference's default augmenter (ref:src/preprocessing/augment.py:72-76)."""
    return ImageAugmenter(seed=seed)
