"""Weight bridge: JAX/flax variables -> the port's ``state_dict``.

Input is the flax variable tree ``{"params": ..., "batch_stats": ...}`` as
nested dicts of numpy (or array-like) leaves; the port's module tree uses
the flax scope names, so a leaf ``a/b/name`` lands on ``a.b.<torch name>``:

* ``kernel`` of a 2-D conv (HWIO)          -> ``weight`` (OIHW)
* ``kernel`` of a ``Dense`` ([in, out])    -> ``weight`` ([out, in])
  (a depthwise conv's [k,k,1,C] -> [C,1,k,k]; convs with a bias keep it)
* ``kernel`` of a voxel conv (BEV / dense [k,k,k,cin,cout], their
  transposed conv [2,2,2,cin,cout], sparse [K,cin,cout] and 1x1
  [cin,cout], sparse transposed [8,cin,cout]), of an FCODE ([in, out]),
  of a flax ``MultiHeadDotProductAttention``'s ``query`` / ``key`` /
  ``value`` ([in, heads, head_dim]) and ``out`` ([heads, head_dim, out])
  or of a 2-D ``ConvTranspose`` ([2,2,cin,cout]) -> ``kernel``, unchanged
  (folded / used as is at run time); Beltrami's ``fc_kernel`` /
  ``fc_bias`` keep their names
* BN / LayerNorm ``scale``                 -> ``weight``; ``bias`` -> ``bias``
* BN ``batch_stats`` ``mean`` / ``var``    -> ``running_mean`` / ``running_var``
* GeM ``p``, ECA ``conv_w`` [k,1,1], learned scalar weights, NetVLAD's and
  CRN's ``centroids`` / ``assign_w``, ViT's ``cls`` / ``pos``, CCT's
  ``pos`` and ConvNeXt's ``gamma`` -> same name

Scopes carry over as they are, ``GeoDB``'s ``net`` included, and so do
AnyLoc's extractors (their ``q_i`` / ``k_i`` / ``v_i`` / ``proj_i``
denses, ``patch_embed`` conv, ``attn_i`` heads, ``cls`` / ``pos``).
``port_entry`` maps one leaf; ``utils/torch_convert.graft`` lands
converted pretrained weights through it.

Every flax leaf is consumed exactly once and every entry of the target
``state_dict`` is filled; anything else raises.  ``flax_path`` maps a port
name back to its flax path (the optimizer's groups are labelled on it).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}
_FLAX_NAME = {"running_mean": "mean", "running_var": "var"}


def flax_path(name: str, tensor: torch.Tensor) -> Tuple[str, ...]:
    """The flax path of the port's parameter or buffer ``name`` (dotted
    scopes, then the leaf): ``weight`` is ``kernel`` for a conv or dense
    weight and ``scale`` for a norm's, running statistics are ``mean`` /
    ``var``, any other leaf keeps its name."""
    *scope, leaf = name.split(".")
    if leaf == "weight":
        leaf = "scale" if tensor.ndim == 1 else "kernel"
    return (*scope, _FLAX_NAME.get(leaf, leaf))


def _leaves(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, np.asarray(tree)


def port_entry(coll: str, path: Tuple[str, ...], arr: np.ndarray,
               target: Dict[str, torch.Tensor]) -> Tuple[str, torch.Tensor]:
    """(the port's ``state_dict`` key, the value in the port's layout and
    dtype) of the flax leaf ``coll/path``; raises where the leaf has no
    counterpart in ``target`` or another shape."""
    *scope, name = path
    base = ".".join(scope) + ("." if scope else "")
    if name == "kernel" and base + "weight" in target:
        key = base + "weight"
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank "
                             f"{arr.ndim} for a torch weight")
    else:
        key = base + _RENAME.get(name, name)
    if key not in target:
        raise KeyError(f"flax leaf {coll}/{'/'.join(path)} has no "
                       f"counterpart ({key}) in the port")
    want = tuple(target[key].shape)
    if tuple(arr.shape) != want:
        raise ValueError(f"{coll}/{'/'.join(path)}: shape "
                         f"{arr.shape} != {key} {want}")
    return key, torch.from_numpy(np.ascontiguousarray(arr)).to(
        target[key].dtype)


def jax_to_state_dict(variables, module: nn.Module) -> Dict[str, torch.Tensor]:
    target = module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for coll in variables:
        if coll not in ("params", "batch_stats"):
            raise KeyError(f"unexpected variable collection {coll!r}")
        for path, arr in _leaves(variables[coll]):
            key, value = port_entry(coll, path, arr, target)
            if key in out:
                raise KeyError(f"two flax leaves map to {key}")
            out[key] = value
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"port entries with no flax leaf: {missing}")
    return out


def load_jax_variables(module: nn.Module, variables) -> nn.Module:
    """Load flax variables into ``module`` in place (strict)."""
    module.load_state_dict(jax_to_state_dict(variables, module), strict=True)
    return module
