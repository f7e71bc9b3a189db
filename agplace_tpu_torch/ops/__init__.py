"""Hand-written Hopper kernels of the serving slice, one module each, with
their plain PyTorch versions beside them:

* ``ode_step.fused_euler_ode``       K1 (csrc/ode_step.cu)
* ``bev_down.fused_conv0_down0``     K2 (csrc/bev_down.cu)
* ``bev_block_sm.fused_eca_block_sm`` K3 (csrc/bev_block_sm.cu)

Each wrapper counts its launches in a plain integer attribute
(``wrapper.launches``); only a launch of the CUDA kernel counts.
"""

from __future__ import annotations

from typing import Dict


def kernels():
    from agplace_tpu_torch.ops import bev_block_sm, bev_down, ode_step

    return (ode_step.fused_euler_ode, bev_down.fused_conv0_down0,
            bev_block_sm.fused_eca_block_sm)


def reset_launches() -> None:
    for k in kernels():
        k.launches = 0


def launches() -> Dict[str, int]:
    return {k.__name__: k.launches for k in kernels()}
