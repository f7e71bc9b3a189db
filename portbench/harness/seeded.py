"""Everything a run makes from its seed: the towers' weights (on the card,
in a few large calls) and the inputs (images, LiDAR clouds).

Weights: every conv and dense kernel N(0, 1) times He's (convs) or
LeCun's (dense, FCODE) scale for its fan-in; each norm's scale U(0.5, 1.5)
and shift N(0, 0.1); BatchNorm running means N(0, 0.1) and variances
U(0.5, 1.5) (``chip_smoke.seed_bn``'s non-trivial statistics); biases
N(0, 0.1); GeM's p 3.  The same dict is handed to the program and to the
reference.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def generator(seed: int, salt: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) & SEED_MASK)
    return g


def _std(name: str, shape: Tuple[int, ...]) -> float:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel" and len(shape) == 5:  # [k, k, k, cin, cout]
        return math.sqrt(2.0 / math.prod(shape[:4]))
    if leaf == "kernel" and len(shape) == 2:  # FCODE [in, out]
        return 1.0 / math.sqrt(shape[0])
    if leaf == "conv_w":  # ECA [k, 1, 1]
        return 1.0 / math.sqrt(shape[0])
    if len(shape) == 4:  # OIHW conv
        return math.sqrt(2.0 / math.prod(shape[1:]))
    if len(shape) == 2:  # [out, in] dense
        return 1.0 / math.sqrt(shape[1])
    raise ValueError(f"no initialiser for {name} {shape}")


def make_state(shapes: Dict[str, Tuple[int, ...]], seed: int,
               device) -> Dict[str, torch.Tensor]:
    """fp32 tensors for every name of ``shapes`` (parameters and
    buffers), from two draws on ``device``."""
    total = sum(math.prod(s) for s in shapes.values())
    g = generator(seed, 1, device)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        nrm, uni = normal[at:at + n].view(shape), uniform[at:at + n].view(
            shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "p":
            v = torch.full(shape, 3.0, device=device)
        elif leaf in ("running_var",) or (leaf == "weight"
                                          and len(shape) == 1):
            v = 0.5 + uni
        elif leaf in ("running_mean", "bias"):
            v = 0.1 * nrm
        elif leaf == "num_batches_tracked":
            v = torch.zeros(shape, device=device)
        else:
            v = nrm * _std(name, shape)
        out[name] = v.contiguous()
    return out


def lidar(rng: np.random.Generator, batch: int, n_points: int,
          elev_deg: Tuple[float, float], height: float) -> np.ndarray:
    """Spinning-scanner clouds [B, N, 3]: uniform azimuth, uniform elevation
    over the sensor's vertical field, log-uniform range 2-100 m, the ground
    at the sensor's height (``chip_smoke.lidar``'s geometry)."""
    az = rng.uniform(0, 2 * np.pi, (batch, n_points))
    el = np.deg2rad(rng.uniform(elev_deg[0], elev_deg[1],
                                (batch, n_points)))
    r = np.exp(rng.uniform(np.log(2.0), np.log(100.0), (batch, n_points)))
    return np.stack([r * np.cos(el) * np.cos(az),
                     r * np.cos(el) * np.sin(az),
                     np.maximum(r * np.sin(el), -height)],
                    axis=-1).astype(np.float32)


def images(g: torch.Generator, shape, mean, std, device) -> torch.Tensor:
    """Pixels uniform in [0, 1], normalised as the dataset's reader does."""
    x = torch.rand(shape, generator=g, device=device)
    m = torch.tensor(mean, dtype=torch.float32, device=device)
    s = torch.tensor(std, dtype=torch.float32, device=device)
    return (x - m) / s
