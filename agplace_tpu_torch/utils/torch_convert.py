"""Pretrained backbones: torchvision / HF ``state_dict`` files grafted into
the port's towers (``agplace_tpu/utils/torch_convert.py``).

Each converter maps a checkpoint's tensors onto the flax-layout tree of
the matching module (NHWC / HWIO kernels, ``[in, out]`` dense kernels,
``scale`` / ``mean`` / ``var``), exactly as JAX's converters do: the
port's modules carry the flax scope names, so ``graft`` lands each leaf
through the weight bridge's own rule (``utils/convert.port_entry``) and
the grafted tower equals JAX's grafted tree passed through the bridge.

Sources (``find_pretrained_state_dict``), in JAX's order: the explicit
path (a file, or a directory of ``{arch}*.pth``), ``$AGPLACE_WEIGHTS``,
``~/.cache/agplace_tpu/weights``, ``<repo>/weights``.  A file that fails
to load, or lacks the architecture's probe key, is skipped (and named in
the log).  JAX's last resort, the torchvision / HF model zoo, needs the
network and packages neither machine of the port has: without a file the
port finds no source, as JAX does on such a host.

Architectures: resnet18 / 34 / 50 (by stage count; JAX's table has no
resnet101, so JAX never grafts it and neither does the port), vgg16,
alexnet, convnext_tiny (by ``layers``), squeezenet 1.0 / 1.1 (the trunk:
the 1x1 head stays random), ViT-B/16 (positional embedding resized to the
tower's token count) and CCT-14.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from agplace_tpu_torch.utils.convert import flax_path, port_entry
from agplace_tpu_torch.utils.image_resize import resize_hw

log = logging.getLogger("pretrained")

Tree = Dict[str, Any]

_RESNET_STAGE_BLOCKS = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
}


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _conv(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _bn(sd: Mapping[str, np.ndarray], prefix: str) -> Tuple[Tree, Tree]:
    return ({"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]},
            {"mean": sd[f"{prefix}.running_mean"],
             "var": sd[f"{prefix}.running_var"]})


def _lin(sd, key) -> Tree:
    """torch Linear -> flax Dense: weight [out, in] -> kernel [in, out]."""
    return {"kernel": sd[f"{key}.weight"].T, "bias": sd[f"{key}.bias"]}


def _conv_b(sd, key) -> Tree:
    return {"kernel": _conv(sd[f"{key}.weight"]), "bias": sd[f"{key}.bias"]}


def _ln(sd, key) -> Tree:
    return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}


def convert_resnet(state_dict, arch: str = "resnet18",
                   num_stages: int = 3) -> Tuple[Tree, Tree]:
    """(params, batch_stats) of ``ResNetFeatures`` from a torchvision
    ResNet."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    params: Tree = {"conv1": {"kernel": _conv(sd["conv1.weight"])}}
    stats: Tree = {}
    params["bn1"], stats["bn1"] = _bn(sd, "bn1")
    n_convs = 3 if arch in ("resnet50", "resnet101") else 2
    for stage in range(num_stages):
        for b in range(_RESNET_STAGE_BLOCKS[arch][stage]):
            src, dst = f"layer{stage + 1}.{b}", f"layer{stage + 1}_{b}"
            blk_p: Tree = {}
            blk_s: Tree = {}
            for ci in range(1, n_convs + 1):
                blk_p[f"conv{ci}"] = {
                    "kernel": _conv(sd[f"{src}.conv{ci}.weight"])}
                blk_p[f"bn{ci}"], blk_s[f"bn{ci}"] = _bn(sd, f"{src}.bn{ci}")
            if f"{src}.downsample.0.weight" in sd:
                blk_p["downsample_conv"] = {
                    "kernel": _conv(sd[f"{src}.downsample.0.weight"])}
                blk_p["downsample_bn"], blk_s["downsample_bn"] = _bn(
                    sd, f"{src}.downsample.1")
            params[dst], stats[dst] = blk_p, blk_s
    return params, stats


def convert_vgg16(state_dict) -> Tuple[Tree, Tree]:
    """torchvision vgg16 ``features`` -> ``VGG16Features``."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    conv_idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    return {f"conv{i}": _conv_b(sd, f"features.{idx}")
            for i, idx in enumerate(conv_idx)}, {}


def convert_alexnet(state_dict) -> Tuple[Tree, Tree]:
    """torchvision alexnet ``features`` -> ``AlexNetFeatures``."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    return {f"conv{i}": _conv_b(sd, f"features.{idx}")
            for i, idx in enumerate([0, 3, 6, 8, 10])}, {}


def convert_convnext_tiny(state_dict, layers=(2, 2, 2)) -> Tuple[Tree, Tree]:
    """torchvision convnext_tiny -> ``ConvNeXtTinyFeatures``, each stage
    clipped to ``layers``."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    depths = (3, 3, 9, 3)
    params: Tree = {"stem_conv": _conv_b(sd, "features.0.0"),
                    "stem_norm": _ln(sd, "features.0.1")}
    for s in range(min(len(layers), 4)):
        if s > 0:
            params[f"down_norm{s}"] = _ln(sd, f"features.{2 * s}.0")
            params[f"down_conv{s}"] = _conv_b(sd, f"features.{2 * s}.1")
        for b in range(min(layers[s], depths[s])):
            src = f"features.{2 * s + 1}.{b}"
            params[f"stage{s}_block{b}"] = {
                "dwconv": _conv_b(sd, f"{src}.block.0"),
                "norm": _ln(sd, f"{src}.block.2"),
                "pwconv1": _lin(sd, f"{src}.block.3"),
                "pwconv2": _lin(sd, f"{src}.block.5"),
                "gamma": sd[f"{src}.layer_scale"].reshape(-1),
            }
    return params, {}


_SQUEEZENET_FIRE_IDX = {
    "1_0": [3, 4, 5, 7, 8, 9, 10, 12],
    "1_1": [3, 4, 6, 7, 9, 10, 11, 12],
}


def convert_squeezenet(state_dict, version: str = "1_1"
                       ) -> Tuple[Tree, Tree]:
    """torchvision squeezenet1_0 / 1_1 trunk -> ``SqueezeNetFeatures``
    without ``fc``: the reference's 1x1 512 -> 256 head is fresh there
    too, so it stays as initialised."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    params: Tree = {"conv0": _conv_b(sd, "features.0")}
    for i, idx in enumerate(_SQUEEZENET_FIRE_IDX[version]):
        params[f"fire{i}"] = {
            "squeeze": _conv_b(sd, f"features.{idx}.squeeze"),
            "expand1": _conv_b(sd, f"features.{idx}.expand1x1"),
            "expand3": _conv_b(sd, f"features.{idx}.expand3x3"),
        }
    return params, {}


def _resize_grid(grid: np.ndarray, n_new: int) -> np.ndarray:
    """A square [1, N, D] token grid bilinearly resized to ``n_new``
    tokens with ``jax.image.resize``'s weights (antialiased when it
    shrinks)."""
    side_old = int(round(grid.shape[1] ** 0.5))
    side_new = int(round(n_new ** 0.5))
    g = torch.from_numpy(np.ascontiguousarray(
        grid.reshape(1, side_old, side_old, -1), np.float32))
    out = resize_hw(g, (side_new, side_new), "bilinear").numpy()
    return out.reshape(1, side_new * side_new, -1)


def convert_vit_b16(state_dict, heads: int = 12,
                    n_tokens: Optional[int] = None) -> Tuple[Tree, Tree]:
    """HF ``ViTModel`` (ViT-B/16) -> ``ViTBackbone``; the patch tokens'
    positional embedding is resized to ``n_tokens`` (1 + N) when the
    checkpoint's differs, CLS kept."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    hidden = sd["embeddings.cls_token"].shape[-1]
    hd = hidden // heads
    pos = sd["embeddings.position_embeddings"]
    if n_tokens is not None and pos.shape[1] != n_tokens:
        pos = np.concatenate(
            [pos[:, :1], _resize_grid(pos[:, 1:], n_tokens - 1)], axis=1)
    params: Tree = {
        "cls": sd["embeddings.cls_token"],
        "pos": pos,
        "embed": {"kernel": _conv(sd["embeddings.patch_embeddings."
                                     "projection.weight"]),
                  "bias": sd["embeddings.patch_embeddings.projection.bias"]},
        "ln_f": _ln(sd, "layernorm"),
    }
    i = 0
    while f"encoder.layer.{i}.layernorm_before.weight" in sd:
        src = f"encoder.layer.{i}"

        def qkv(which):
            w = sd[f"{src}.attention.attention.{which}.weight"]
            b = sd[f"{src}.attention.attention.{which}.bias"]
            return {"kernel": w.T.reshape(hidden, heads, hd),
                    "bias": b.reshape(heads, hd)}

        params[f"ln1_{i}"] = _ln(sd, f"{src}.layernorm_before")
        params[f"attn_{i}"] = {
            "query": qkv("query"), "key": qkv("key"), "value": qkv("value"),
            "out": {"kernel": sd[f"{src}.attention.output.dense.weight"]
                    .T.reshape(heads, hd, hidden),
                    "bias": sd[f"{src}.attention.output.dense.bias"]},
        }
        params[f"ln2_{i}"] = _ln(sd, f"{src}.layernorm_after")
        params[f"mlp1_{i}"] = _lin(sd, f"{src}.intermediate.dense")
        params[f"mlp2_{i}"] = _lin(sd, f"{src}.output.dense")
        i += 1
    return params, {}


def convert_cct(state_dict, n_tokens: Optional[int] = None
                ) -> Tuple[Tree, Tree]:
    """SHI-Labs cct_14_7x2_384 -> ``models/cct.CCT``; the learnable
    positional embedding is resized to ``n_tokens`` when it differs."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    params: Tree = {"tokenizer": {}}
    i = 0
    while f"tokenizer.conv_layers.{i}.0.weight" in sd:
        params["tokenizer"][f"conv{i}"] = {
            "kernel": _conv(sd[f"tokenizer.conv_layers.{i}.0.weight"])}
        i += 1
    pos = sd["classifier.positional_emb"]
    if n_tokens is not None and pos.shape[1] != n_tokens:
        pos = _resize_grid(pos, n_tokens)
    params["pos"] = pos
    i = 0
    while f"classifier.blocks.{i}.pre_norm.weight" in sd:
        src = f"classifier.blocks.{i}"
        params[f"pre_norm_{i}"] = _ln(sd, f"{src}.pre_norm")
        params[f"qkv_{i}"] = {"kernel": sd[f"{src}.self_attn.qkv.weight"].T}
        params[f"proj_{i}"] = _lin(sd, f"{src}.self_attn.proj")
        params[f"norm1_{i}"] = _ln(sd, f"{src}.norm1")
        params[f"mlp1_{i}"] = _lin(sd, f"{src}.linear1")
        params[f"mlp2_{i}"] = _lin(sd, f"{src}.linear2")
        i += 1
    params["ln_f"] = _ln(sd, "classifier.norm")
    params["attention_pool"] = _lin(sd, "classifier.attention_pool")
    return params, {}


_CONVERTERS = {
    "vgg16": convert_vgg16,
    "alexnet": convert_alexnet,
    "convnext_tiny": convert_convnext_tiny,
    "squeezenet10": lambda sd, **kw: convert_squeezenet(sd, "1_0"),
    "squeezenet11": lambda sd, **kw: convert_squeezenet(sd, "1_1"),
    "vit": convert_vit_b16,
    "cct384": convert_cct,
}

ARCH_KEY_PROBE = {
    # a key every state_dict of the architecture has
    "vgg16": "features.28.weight",
    "alexnet": "features.10.weight",
    "convnext_tiny": "features.0.0.weight",
    "squeezenet10": "features.12.expand3x3.weight",
    "squeezenet11": "features.12.expand3x3.weight",
    "vit": "embeddings.cls_token",
    "cct384": "classifier.blocks.0.self_attn.qkv.weight",
}


def default_weight_dirs() -> List[str]:
    dirs = []
    env = os.environ.get("AGPLACE_WEIGHTS", "")
    if env:
        dirs.append(env)
    dirs.append(os.path.expanduser("~/.cache/agplace_tpu/weights"))
    dirs.append(os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "weights"))
    return dirs


def find_pretrained_state_dict(arch: str, path: Optional[str] = None,
                               probe: str = "conv1.weight"):
    """The first loadable ``state_dict`` holding ``probe`` among ``path``
    (a file, or a directory's ``{arch}*.pth``) and the default
    directories, a ``"state_dict"`` entry unwrapped; None if there is
    none."""
    candidates = []
    for d in ([path] if path else []) + default_weight_dirs():
        if not os.path.exists(d):
            continue
        if os.path.isfile(d):
            candidates.append(d)
        else:
            candidates.extend(sorted(glob.glob(os.path.join(d,
                                                            f"{arch}*.pth"))))
    for f in candidates:
        try:
            sd = torch.load(f, map_location="cpu", weights_only=True)
        except Exception as err:  # corrupt / another format: keep looking
            log.warning("skipping %s: cannot load it (%s)", f, err)
            continue
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        if isinstance(sd, dict) and probe in sd:
            return sd
        log.warning("skipping %s: no %r, not a %s state_dict", f, probe,
                    arch)
    return None


def load_pretrained_backbone(arch: str, path: Optional[str] = None, **kw
                             ) -> Optional[Tuple[Tree, Tree]]:
    """(params, batch_stats) of ``arch`` in flax layout from the first
    source found, or None.  ResNets take ``num_stages``, convnext_tiny
    ``layers``, vit and cct384 ``n_tokens``."""
    if arch in _RESNET_STAGE_BLOCKS:
        sd = find_pretrained_state_dict(arch, path)
        return None if sd is None else convert_resnet(
            sd, arch, kw.get("num_stages", 3))
    conv = _CONVERTERS.get(arch)
    if conv is None:
        return None
    sd = find_pretrained_state_dict(arch, path, probe=ARCH_KEY_PROBE[arch])
    return None if sd is None else conv(sd, **kw)


def flax_view(module: nn.Module, prefix: str) -> Tuple[Tree, Tree]:
    """The module's entries under ``prefix`` as flax-layout (params,
    batch_stats) trees whose leaves are the entries' flax paths from the
    module's root."""
    trees: Tuple[Tree, Tree] = ({}, {})
    for name, t in module.state_dict().items():
        if not name.startswith(prefix + "."):
            continue
        path = flax_path(name, t)
        node = trees[name.endswith(("running_mean", "running_var"))]
        for k in path[len(prefix.split(".")):-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = path
    return trees


def graft(module: nn.Module, prefix: str, params: Tree, stats: Tree
          ) -> List[str]:
    """Copy a converted (params, batch_stats) pair into ``module``'s
    entries under ``prefix`` (JAX's ``merge_pretrained_subtree``): a leaf
    the source lacks keeps its value, a shape mismatch raises, and the
    source subtrees with no place are returned."""
    target = module.state_dict()
    dropped: List[str] = []
    where = prefix.rsplit(".", 1)[-1]

    def merge(coll, dst, src, at):
        for k, v in dst.items():
            if k not in src:
                continue
            if isinstance(v, dict) != isinstance(src[k], dict):
                raise ValueError(f"pretrained graft structure mismatch at "
                                 f"{at}/{k}")
            if isinstance(v, dict):
                merge(coll, v, src[k], f"{at}/{k}")
                continue
            key, value = port_entry(coll, v, _np(src[k]), target)
            target[key].copy_(value)
        dropped.extend(f"{at}/{k}" for k in src if k not in dst)

    view_p, view_s = flax_view(module, prefix)
    with torch.no_grad():
        merge("params", view_p, params, where)
        if stats:  # BN-less backbones (vgg / convnext / vit ...) have none
            merge("batch_stats", view_s, stats, where)
    return dropped
