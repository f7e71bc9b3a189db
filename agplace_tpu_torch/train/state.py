"""Train state (``agplace_tpu/train/state.py``): both towers (parameters and
BN running statistics), the optimizer over both, and the step count.

JAX keeps a pytree that each jitted step replaces; here the towers are
updated in place by the optimizer and by their BN layers, and the step is
a host integer (counting it costs no sync).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import torch

from agplace_tpu_torch.models.dbvanilla2d import DBVanilla2D
from agplace_tpu_torch.models.mm import MM


@dataclass
class TrainState:
    mm: MM
    db: DBVanilla2D
    opt: object  # train.optim.GroupAdam | GroupSGD
    step: int = 0

    @property
    def towers(self) -> Tuple[MM, DBVanilla2D]:
        return self.mm, self.db

    def named_parameters(self) -> Iterator[Tuple[str, torch.nn.Parameter]]:
        """Both towers' parameters, named ``mm.<path>`` / ``db.<path>``."""
        for tower, module in (("mm", self.mm), ("db", self.db)):
            for name, p in module.named_parameters():
                yield f"{tower}.{name}", p

    def state_dict(self) -> dict:
        return {"step": self.step, "mm": self.mm.state_dict(),
                "db": self.db.state_dict(), "opt": self.opt.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        """Load in place (strict); the parameters keep their storage, so a
        load bumps their versions and the folded-weight caches refold."""
        self.mm.load_state_dict(sd["mm"], strict=True)
        self.db.load_state_dict(sd["db"], strict=True)
        self.opt.load_state_dict(sd["opt"])
        self.step = int(sd["step"])
