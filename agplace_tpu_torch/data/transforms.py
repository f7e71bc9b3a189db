"""Host-side image transforms (``agplace_tpu/data/transforms.py``): PIL
decode and resize plus numpy, with torchvision.transforms' semantics.
Output is float32 [H, W, 3] in [0, 1] before ``normalize``.

The same PIL calls as the JAX package, so a reader of either package gives
bit-equal items from the same files.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from PIL import Image


def load_image_rgb(path: str) -> np.ndarray:
    """Decode to float32 [H, W, 3] in [0, 1]."""
    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def resize(img: np.ndarray, size, interpolation=Image.BILINEAR) -> np.ndarray:
    """torchvision.Resize semantics: int size scales the SHORT side keeping
    aspect; (h, w) resizes exactly."""
    h, w = img.shape[:2]
    if isinstance(size, int):
        if h <= w:
            new_h, new_w = size, max(1, round(w * size / h))
        else:
            new_h, new_w = max(1, round(h * size / w)), size
    else:
        new_h, new_w = size
    if (new_h, new_w) == (h, w):
        return img
    pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    pil = pil.resize((new_w, new_h), interpolation)
    return np.asarray(pil, np.float32) / 255.0


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision.CenterCrop semantics, zero-padding if smaller."""
    h, w = img.shape[:2]
    if h < size or w < size:
        pad_h, pad_w = max(size - h, 0), max(size - w, 0)
        img = np.pad(img, ((pad_h // 2, pad_h - pad_h // 2),
                           (pad_w // 2, pad_w - pad_w // 2), (0, 0)))
        h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return img[top : top + size, left : left + size]


def normalize(img: np.ndarray, mean: Sequence[float],
              std: Sequence[float]) -> np.ndarray:
    return ((img - np.asarray(mean, np.float32))
            / np.asarray(std, np.float32)).astype(np.float32)


def color_jitter(img: np.ndarray, strength: float,
                 rng: np.random.Generator,
                 brightness: "float | None" = None,
                 contrast: "float | None" = None,
                 saturation: "float | None" = None,
                 hue_strength: "float | None" = None) -> np.ndarray:
    """Brightness/contrast/saturation/hue jitter matching
    torchvision.ColorJitter semantics closely enough for augmentation
    purposes (applied in [0,1] space).  ``strength`` is the uniform
    default; the per-component arguments override it (reference
    ``--brightness/--contrast/--saturation/--hue`` flags)."""
    b_s = strength if brightness is None else brightness
    c_s = strength if contrast is None else contrast
    s_s = strength if saturation is None else saturation
    h_s = strength if hue_strength is None else hue_strength
    if max(b_s, c_s, s_s, h_s) <= 0:
        return img
    b = rng.uniform(max(0, 1 - b_s), 1 + b_s)
    img = np.clip(img * b, 0, 1)
    c = rng.uniform(max(0, 1 - c_s), 1 + c_s)
    gray = img.mean(axis=(0, 1, 2), keepdims=True)
    img = np.clip((img - gray) * c + gray, 0, 1)
    s = rng.uniform(max(0, 1 - s_s), 1 + s_s)
    lum = img @ np.array([0.299, 0.587, 0.114], np.float32)
    img = np.clip((img - lum[..., None]) * s + lum[..., None], 0, 1)
    hue = rng.uniform(-min(0.5, h_s), min(0.5, h_s))
    if abs(hue) > 1e-6:
        # cheap hue rotation via channel-mix approximation
        cos_h = np.cos(2 * np.pi * hue)
        sin_h = np.sin(2 * np.pi * hue)
        third = 1.0 / 3.0
        sqrt3 = np.sqrt(1.0 / 3.0)
        mat = (cos_h * np.eye(3)
               + (1 - cos_h) * np.full((3, 3), third)
               + sin_h * sqrt3 * np.array([[0, -1, 1], [1, 0, -1],
                                           [-1, 1, 0]], np.float32))
        img = np.clip(img @ mat.T.astype(np.float32), 0, 1)
    return img.astype(np.float32)


def five_crops(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision FiveCrop: four corners + centre (``test_method
    'five_crops'/'nearest_crop'/'maj_voting'``, ``datasets_ws.py``)."""
    h, w = img.shape[:2]
    tl = img[:size, :size]
    tr = img[:size, w - size:]
    bl = img[h - size:, :size]
    br = img[h - size:, w - size:]
    ct = center_crop(img, size)
    return np.stack([tl, tr, bl, br, ct])


# torchvision-style random query augmentations (the ``horizontal_flip``,
# ``rand_perspective``, ``random_resized_crop`` and ``random_rotation``
# flags), with torchvision's semantics


def random_horizontal_flip(img: np.ndarray, rng: np.random.Generator,
                           p: float = 0.5) -> np.ndarray:
    """T.RandomHorizontalFlip."""
    if rng.random() < p:
        return img[:, ::-1].copy()
    return img


def random_rotation(img: np.ndarray, degrees: float,
                    rng: np.random.Generator) -> np.ndarray:
    """T.RandomRotation(degrees): uniform angle in [-d, d], bilinear,
    constant-zero fill, output size preserved."""
    if degrees <= 0:
        return img
    ang = float(rng.uniform(-degrees, degrees))
    pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    pil = pil.rotate(ang, resample=Image.BILINEAR, expand=False)
    return np.asarray(pil, np.float32) / 255.0


def random_resized_crop(img: np.ndarray, scale_lo: float,
                        rng: np.random.Generator) -> np.ndarray:
    """T.RandomResizedCrop(size=orig, scale=(1-x, 1)) as the reference
    configures it (``datasets_ws.py:518``): area scale in [1-x, 1], aspect
    ratio in [3/4, 4/3], resized back to the input size."""
    if scale_lo >= 1.0:
        return img
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = area * float(rng.uniform(scale_lo, 1.0))
        ratio = float(np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3))))
        cw = int(round(np.sqrt(target * ratio)))
        ch = int(round(np.sqrt(target / ratio)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            crop = img[top : top + ch, left : left + cw]
            return resize(crop, (h, w))
    return img  # torchvision center-crop fallback degenerates to identity


def random_perspective(img: np.ndarray, distortion: float,
                       rng: np.random.Generator,
                       p: float = 0.5) -> np.ndarray:
    """T.RandomPerspective(distortion_scale): displaced corners + 8-dof
    perspective warp (PIL QUAD/PERSPECTIVE semantics)."""
    if distortion <= 0 or rng.random() >= p:
        return img
    h, w = img.shape[:2]
    dx, dy = distortion * w / 2, distortion * h / 2

    def jig(x0, y0, sx, sy):
        return (x0 + sx * float(rng.uniform(0, dx)),
                y0 + sy * float(rng.uniform(0, dy)))

    dst = [jig(0, 0, 1, 1), jig(w - 1, 0, -1, 1),
           jig(w - 1, h - 1, -1, -1), jig(0, h - 1, 1, -1)]
    src = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
    # solve the 8 perspective coefficients mapping dst -> src
    a = []
    b = []
    for (x, y), (u, v) in zip(dst, src):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.extend([u, v])
    coeffs = np.linalg.solve(np.asarray(a, np.float64),
                             np.asarray(b, np.float64))
    pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    pil = pil.transform((w, h), Image.PERSPECTIVE, tuple(coeffs),
                        Image.BILINEAR)
    return np.asarray(pil, np.float32) / 255.0


def random_query_augment(img: np.ndarray, data_cfg,
                         rng: np.random.Generator) -> np.ndarray:
    """The DVGLB query augmentation stack in the reference's intended order
    (``datasets_ws.py:514-522``): perspective -> resized-crop -> rotation
    (+ horizontal flip, flag ``tools/options.py:231``)."""
    if getattr(data_cfg, "rand_perspective", 0.0):
        img = random_perspective(img, data_cfg.rand_perspective, rng)
    if getattr(data_cfg, "random_resized_crop", 0.0):
        img = random_resized_crop(img, 1.0 - data_cfg.random_resized_crop,
                                  rng)
    if getattr(data_cfg, "random_rotation", 0.0):
        img = random_rotation(img, data_cfg.random_rotation, rng)
    if getattr(data_cfg, "horizontal_flip", False):
        img = random_horizontal_flip(img, rng)
    return img
