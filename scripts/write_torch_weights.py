"""Seeded ``state_dict`` files in the layouts pretrained backbones ship in
(torchvision's ResNet-18 / 34 / 50, the HF ``ViTModel`` of ViT-B/16), for
the pretrained-graft checks of the port's tests and ``chip_smoke.py``:

    python3 scripts/write_torch_weights.py DIR resnet18 resnet50 vit

writes ``DIR/{arch}-seeded.pth`` (``torch.save`` of the dict), the names
``find_pretrained_state_dict`` globs for.  Values are seeded normals at
the layers' fan-in scales; BN statistics are away from the identity, so a
graft that misses them shows.  Nothing here is a trained weight.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Tuple

import torch

_STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
           "resnet50": (3, 4, 6, 3)}


def _shapes_resnet(arch: str) -> Dict[str, Tuple[int, ...]]:
    out: Dict[str, Tuple[int, ...]] = {"conv1.weight": (64, 3, 7, 7)}

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{leaf}"] = (c,)

    bn("bn1", 64)
    bottleneck = arch == "resnet50"
    cin = 64
    for s, n in enumerate(_STAGES[arch]):
        width = 64 * 2 ** s
        cout = width * 4 if bottleneck else width
        for b in range(n):
            p = f"layer{s + 1}.{b}"
            c0 = cin if b == 0 else cout
            if bottleneck:
                convs = [(width, c0, 1), (width, width, 3), (cout, width, 1)]
            else:
                convs = [(cout, c0, 3), (cout, cout, 3)]
            for i, (o, c, k) in enumerate(convs, 1):
                out[f"{p}.conv{i}.weight"] = (o, c, k, k)
                bn(f"{p}.bn{i}", o)
            if b == 0 and (s > 0 or c0 != cout):
                out[f"{p}.downsample.0.weight"] = (cout, c0, 1, 1)
                bn(f"{p}.downsample.1", cout)
        cin = cout
    out["fc.weight"], out["fc.bias"] = (1000, cin), (1000,)
    return out


def _shapes_vit(hidden: int = 768, layers: int = 12, patch: int = 16,
                image: int = 224) -> Dict[str, Tuple[int, ...]]:
    n = (image // patch) ** 2 + 1
    out: Dict[str, Tuple[int, ...]] = {
        "embeddings.cls_token": (1, 1, hidden),
        "embeddings.position_embeddings": (1, n, hidden),
        "embeddings.patch_embeddings.projection.weight":
            (hidden, 3, patch, patch),
        "embeddings.patch_embeddings.projection.bias": (hidden,),
        "layernorm.weight": (hidden,), "layernorm.bias": (hidden,),
    }
    for i in range(layers):
        p = f"encoder.layer.{i}"
        for ln in ("layernorm_before", "layernorm_after"):
            out[f"{p}.{ln}.weight"] = out[f"{p}.{ln}.bias"] = (hidden,)
        for lin, o, c in (("attention.attention.query", hidden, hidden),
                          ("attention.attention.key", hidden, hidden),
                          ("attention.attention.value", hidden, hidden),
                          ("attention.output.dense", hidden, hidden),
                          ("intermediate.dense", 4 * hidden, hidden),
                          ("output.dense", hidden, 4 * hidden)):
            out[f"{p}.{lin}.weight"], out[f"{p}.{lin}.bias"] = (o, c), (o,)
    return out


def randomize(shapes: Dict[str, Tuple[int, ...]], seed: int = 0
              ) -> Dict[str, torch.Tensor]:
    """Seeded fp32 values for a state_dict's names and shapes: norm
    scales and running variances in [0.5, 1.5), other vectors N(0, 0.1),
    kernels N(0, 1 / fan_in), ViT's cls / positional tables N(0, 0.02)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_var" or (len(shape) == 1 and leaf == "weight"):
            t = torch.rand(shape, generator=g) + 0.5
        elif len(shape) <= 1:  # biases, running means, layer scales
            t = torch.randn(shape, generator=g) * 0.1
        elif name.startswith("embeddings.") and len(shape) == 3:
            t = torch.randn(shape, generator=g) * 0.02
        else:
            fan_in = 1
            for d in shape[1:]:
                fan_in *= d
            t = torch.randn(shape, generator=g) * fan_in ** -0.5
        sd[name] = t.float()
    return sd


def seeded_state_dict(arch: str, seed: int = 0, **kw
                      ) -> Dict[str, torch.Tensor]:
    """``arch`` in resnet18 / resnet34 / resnet50 (torchvision's names) or
    vit (HF ViT-B/16's; ``hidden``, ``layers``, ``patch``, ``image``
    shrink it)."""
    return randomize(_shapes_vit(**kw) if arch == "vit"
                     else _shapes_resnet(arch), seed)


def write(out_dir: str, archs, seed: int = 0) -> Dict[str, str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for i, arch in enumerate(archs):
        paths[arch] = os.path.join(out_dir, f"{arch}-seeded.pth")
        torch.save(seeded_state_dict(arch, seed + i), paths[arch])
    return paths


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out_dir")
    p.add_argument("archs", nargs="+",
                   choices=["resnet18", "resnet34", "resnet50", "vit"])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    for arch, path in write(args.out_dir, args.archs, args.seed).items():
        print(arch, path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
