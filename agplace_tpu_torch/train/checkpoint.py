"""Checkpoint and resume (``agplace_tpu/train/checkpoint.py``) on
``torch.save``.

A checkpoint is one file in ``save_dir`` under JAX's names:
``ep@N__r1@R`` (R@1 rounded), ``ep@N`` without recalls, and a copy as
``best_model`` when the epoch is the best.  It holds the epoch, the train
state (both towers' parameters and BN statistics, the optimizer state, the
step), the recalls, the best R@5 and the count of epochs without
improvement.  Files are read with ``weights_only=True``: tensors, numbers,
strings and lists only.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from agplace_tpu_torch.train.state import TrainState


class CheckpointManager:
    def __init__(self, save_dir: str):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.save_dir, name)

    def _restore_path(self, name: str) -> str:
        # an absolute path, or one that exists as given, is read as it is;
        # a bare name resolves inside save_dir.  Saves only use _path.
        if os.path.isabs(name) or os.path.exists(name):
            return os.path.abspath(name)
        return self._path(name)

    def save(self, state: TrainState, epoch_num: int,
             recalls: Optional[np.ndarray], best_r5: float,
             not_improved_num: int, is_best: bool,
             filename: Optional[str] = None) -> str:
        if filename is not None:
            name = filename
        elif recalls is not None:
            name = f"ep@{epoch_num}__r1@{recalls[0]:.0f}"
        else:
            name = f"ep@{epoch_num}"
        payload = {
            "epoch_num": int(epoch_num),
            "state": state.state_dict(),
            "recalls": [float(r) for r in (recalls if recalls is not None
                                           else np.zeros(4))],
            "best_r5": float(best_r5),
            "not_improved_num": int(not_improved_num),
        }
        path = self._path(name)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        if is_best:
            shutil.copyfile(path, self._path("best_model"))
        return path

    def read(self, name: str, device) -> Dict[str, Any]:
        """The payload of checkpoint ``name``, its tensors on ``device``."""
        return torch.load(self._restore_path(name), map_location=device,
                          weights_only=True)

    def restore(self, name: str, state: TrainState
                ) -> Tuple[TrainState, Dict[str, Any]]:
        """Load checkpoint ``name`` into ``state`` (in place, on its
        device); returns (state, the epoch / recalls / best R@5 /
        not-improved meta)."""
        payload = self.read(name, next(state.mm.parameters()).device)
        state.load_state_dict(payload["state"])
        meta = {k: payload[k] for k in
                ("epoch_num", "best_r5", "not_improved_num")}
        meta["recalls"] = np.asarray(payload["recalls"])
        return state, meta

    def latest(self) -> Optional[str]:
        cands = [d for d in os.listdir(self.save_dir)
                 if d.startswith("ep@") and not d.endswith(".tmp")
                 and os.path.isfile(self._path(d))]
        if not cands:
            return None
        return max(cands, key=lambda d: int(d.split("@")[1].split("__")[0]))
