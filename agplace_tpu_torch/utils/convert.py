"""Weight bridge: JAX/flax variables -> the port's ``state_dict``.

Input is the flax variable tree ``{"params": ..., "batch_stats": ...}`` as
nested dicts of numpy (or array-like) leaves; the port's module tree uses
the flax scope names, so a leaf ``a/b/name`` lands on ``a.b.<torch name>``:

* ``kernel`` of a 2-D conv (HWIO)          -> ``weight`` (OIHW)
* ``kernel`` of a ``Dense`` ([in, out])    -> ``weight`` ([out, in])
* ``kernel`` of a BEV 3-D conv ([k,k,k,cin,cout]) or of an FCODE
  ([in, out]) -> ``kernel``, unchanged (folded / used as is at run time)
* BN / LayerNorm ``scale``                 -> ``weight``; ``bias`` -> ``bias``
* BN ``batch_stats`` ``mean`` / ``var``    -> ``running_mean`` / ``running_var``
* GeM ``p``, ECA ``conv_w`` [k,1,1] and learned scalar weights -> same name

Every flax leaf is consumed exactly once and every entry of the target
``state_dict`` is filled; anything else raises.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _leaves(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, np.asarray(tree)


def jax_to_state_dict(variables, module: nn.Module) -> Dict[str, torch.Tensor]:
    target = module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for coll in variables:
        if coll not in ("params", "batch_stats"):
            raise KeyError(f"unexpected variable collection {coll!r}")
        for path, arr in _leaves(variables[coll]):
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
            if key in out:
                raise KeyError(f"two flax leaves map to {key}")
            want = tuple(target[key].shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"{coll}/{'/'.join(path)}: shape "
                                 f"{arr.shape} != {key} {want}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                target[key].dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"port entries with no flax leaf: {missing}")
    return out


def load_jax_variables(module: nn.Module, variables) -> nn.Module:
    """Load flax variables into ``module`` in place (strict)."""
    module.load_state_dict(jax_to_state_dict(variables, module), strict=True)
    return module
