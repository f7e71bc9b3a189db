"""Train state (``agplace_tpu/train/state.py``): both towers (parameters and
BN running statistics), the optimizer over both, and the step count.  The
query tower is ``mm`` whatever its family (JAX's key); ``db`` is None
under ``share_qdb`` (its checkpoint entry is empty, as JAX's subtree).

JAX keeps a pytree that each jitted step replaces; here the towers are
updated in place by the optimizer and by their BN layers, and the step is
a host integer (counting it costs no sync).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import torch
from torch import nn


@dataclass
class TrainState:
    mm: nn.Module
    db: Optional[nn.Module]
    opt: object  # train.optim.GroupAdam | GroupSGD
    step: int = 0

    @property
    def towers(self) -> Tuple[nn.Module, Optional[nn.Module]]:
        return self.mm, self.db

    def named_parameters(self) -> Iterator[Tuple[str, torch.nn.Parameter]]:
        """Both towers' parameters, named ``mm.<path>`` / ``db.<path>``."""
        for tower, module in (("mm", self.mm), ("db", self.db)):
            if module is not None:
                for name, p in module.named_parameters():
                    yield f"{tower}.{name}", p

    def state_dict(self) -> dict:
        return {"step": self.step, "mm": self.mm.state_dict(),
                "db": {} if self.db is None else self.db.state_dict(),
                "opt": self.opt.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        """Load in place (strict); the parameters keep their storage, so a
        load bumps their versions and the folded-weight caches refold."""
        self.mm.load_state_dict(sd["mm"], strict=True)
        if self.db is not None:
            self.db.load_state_dict(sd["db"], strict=True)
        elif sd["db"]:
            raise KeyError("checkpoint holds an aerial tower; this "
                           "configuration shares the query tower")
        self.opt.load_state_dict(sd["opt"])
        self.step = int(sd["step"])
