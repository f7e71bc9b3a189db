"""Hand-written Hopper kernels of the port, one module each, with their
plain PyTorch versions beside them:

* ``ode_step.fused_euler_ode``                   K1 (csrc/ode_step.cu)
* ``bev_down.fused_conv0_down0``                 K2 (csrc/bev_down.cu)
* ``bev_block_sm.fused_eca_block_sm``            K3 (csrc/bev_block_sm.cu)
* ``bev_head.fused_head``                        K4 (csrc/bev_head.cu)
* ``stem_pool.fused_affine_relu_maxpool``        K5 (csrc/stem_pool.cu)
* ``bev_block.fused_eca_block``                  K6 (csrc/bev_block.cu)
* ``probe_block_sm_v2.fused_eca_block_concat``   P1 (csrc/probe_block_sm_v2.cu)
* ``probe_down_v2.fused_down_concat``            P2 (csrc/probe_down_v2.cu)

Beside them, ``bn_act.fused_bn_act`` (csrc/bn_act.cu) runs every eval
ResNet epilogue on the card (``models/resnet.epilogue``),
``attention.fused_attention`` (csrc/attention_sm90.cu) every bf16
inference attention core of CCT (``models/cct.py``), and
``residual_layer_norm.fused_residual_layer_norm``
(csrc/residual_layer_norm.cu) every seam between CCT's bf16 inference
layers: the residual add, the LayerNorm and the next Dense's bf16 operand
(29 a CCT-14 forward, through ``models/layers.LayerNorm``).  None of the
three ports a TPU kernel, and all stay out of ``kernels()``: the
benchmark's profile reader vouches for a profile by the launches of what
``kernels()`` lists, and has no entry for theirs (the GeoLoc cell vouches
by its LayerNorm calls and span rows instead).

The default serving configuration runs K1-K3; ``bev_pallas_head`` swaps K2
for K4, ``stem_pallas`` / ``db.stem_pallas`` run K5 in the image stems.  No
model path calls K6, P1 or P2; the probe entry points
(``scripts/probe_torch_{block_sm,down}_v2.py``) time P1 against K3 and P2
against K2.

Each wrapper counts its launches in a plain integer attribute
(``wrapper.launches``); only a launch of the CUDA kernel counts.  K1-K4
choose one of their instances by shape before the launch (``ode_instance``,
``down0_instance``, ``conv3x3_instance``, ``head_instance``) and also count
the launches of each in ``wrapper.instances`` (a dict, reset in place).
"""

from __future__ import annotations

from typing import Dict


def kernels():
    from agplace_tpu_torch.ops import (bev_block, bev_block_sm, bev_down,
                                       bev_head, ode_step, probe_block_sm_v2,
                                       probe_down_v2, stem_pool)

    return (ode_step.fused_euler_ode, bev_down.fused_conv0_down0,
            bev_block_sm.fused_eca_block_sm, bev_head.fused_head,
            stem_pool.fused_affine_relu_maxpool, bev_block.fused_eca_block,
            probe_block_sm_v2.fused_eca_block_concat,
            probe_down_v2.fused_down_concat)


def reset_launches() -> None:
    for k in kernels():
        k.launches = 0
        for key in getattr(k, "instances", {}):
            k.instances[key] = 0


def launches() -> Dict[str, int]:
    return {k.__name__: k.launches for k in kernels()}


def instance_launches() -> Dict[str, Dict[str, int]]:
    """The launches of each instance, by kernel (K1-K4)."""
    return {k.__name__: dict(k.instances) for k in kernels()
            if hasattr(k, "instances")}
