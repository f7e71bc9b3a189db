"""The widths of the BEV kernels K2-K4: the names of their instances and
the per-slab channel padding of the z-folded maps.

JAX's Pallas kernels keep their operands whole in VMEM and take any width
the MM's flags give (``--vox_grid_extent``, ``--mm_voxfe_planes``,
``--mm_voxfe_dim``).  So do the port's: each wrapper's rule
(``bev_down.down0_instance``, ``bev_block_sm.conv3x3_instance``,
``bev_head.head_instance``) picks the preset sm90 (TMA + wgmma) instance
where its tiles divide the widths and the z-banded implicit GEMM of
``csrc/zband_sm90.cu`` (ZBAND, ``ops/zband.py``) at every other z, C and
Z*C.  Both read every z-slab of a folded map [..., Z*C] at a multiple of 8
channels: where C is not one, the wrapper pads each slab with zeros at its
end (``pad_slabs``, ``pad_fold``) and slices the output back
(``unpad_slabs``).  Only shapes that no z-fold gives raise
(``check_fold``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

C_STEP = 8  # the channel step of a slab the kernels read
SM90, ZBAND, WINDOW = "sm90", "zband", "window"
# conv_igemm.cuh's A gathers (its enum)
GATHER_SLAB32, GATHER_C8 = 0, 1


def check_fold(name: str, zc: int, z: int, what: str = "Z*C") -> int:
    """The per-slab width of a folded width ``zc`` at ``z`` slabs; raises
    on a shape that no z-fold gives (z < 1, zc < 1, zc not a multiple of
    z)."""
    if not (z >= 1 and zc >= 1 and zc % z == 0):
        raise ValueError(f"{name}: {what} = {zc} at z = {z} is no z-fold's "
                         f"width (z >= 1 slabs of C >= 1 channels each)")
    return zc // z


def c_step(c: int) -> int:
    """A slab's channel count padded to the kernels' step: 8 * ceil(C / 8)."""
    return -(-c // C_STEP) * C_STEP


def pad_slabs(t: torch.Tensor, z: int, c8: int) -> torch.Tensor:
    """[..., Z*C] -> [..., Z*C8]: each of the z slabs padded with zeros at
    its end (``t`` itself where C == C8).  A pad at the end of the Z*C axis
    would misalign every slab past the first."""
    c = t.shape[-1] // z
    if c == c8:
        return t
    return F.pad(t.reshape(*t.shape[:-1], z, c),
                 (0, c8 - c)).reshape(*t.shape[:-1], z * c8)


def unpad_slabs(t: torch.Tensor, z: int, c: int) -> torch.Tensor:
    """[..., Z*C8] -> [..., Z*C]: ``pad_slabs`` undone."""
    c8 = t.shape[-1] // z
    if c == c8:
        return t
    return t.reshape(*t.shape[:-1], z, c8)[..., :c].reshape(
        *t.shape[:-1], z * c)


def pad_fold(w: torch.Tensor, zi: int, ci8: int, zo: int,
             co8: int) -> torch.Tensor:
    """A folded weight [k, k, Zi*Ci, Zo*Co] with every (zi, zo) block
    padded to [Ci8, Co8], zeros at the end of each input and output slab."""
    kh, kw, zci, zco = w.shape
    ci, co = zci // zi, zco // zo
    if (ci, co) == (ci8, co8):
        return w
    return F.pad(w.reshape(kh, kw, zi, ci, zo, co),
                 (0, co8 - co, 0, 0, 0, ci8 - ci)).reshape(kh, kw, zi * ci8,
                                                           zo * co8)


def igemm_gather(cin: int) -> int:
    """conv_igemm.cuh's A gather for Cin input channels (a multiple of 8:
    the wrappers pad every slab): 16-byte copies of 32-channel slices or of
    8-channel chunks."""
    if cin % 8:
        raise ValueError(f"conv_igemm: Cin = {cin} is not a multiple of 8")
    return GATHER_SLAB32 if cin % 32 == 0 else GATHER_C8


# conv_igemm.cuh's tiles: a block computes BM output pixels x BN output
# channels, its K loop runs over BK-deep slices of K = KH*KW*Cin, padded
# with zeros to a multiple of BK
IGEMM_BM, IGEMM_BN, IGEMM_BK = 128, 64, 32


def igemm_grid(m: int, cout: int, k: int):
    """The wmma instance's launch grid over M = B*Ho*Wo output pixels and
    Cout channels, and its K slices: (M tiles, N tiles, slices)."""
    return (-(-m // IGEMM_BM), -(-cout // IGEMM_BN), -(-k // IGEMM_BK))


def igemm_a_source(k: int, cin: int, kw: int):
    """Where the gather takes column ``k`` of an output pixel's A row, as
    conv_igemm.cuh computes it: (tap (dx, dy), input channel); dx, dy
    offset the pixel's window start (ox * stride - pad, oy * stride -
    pad).  Columns at or past K = KH*KW*Cin are zeros (no source)."""
    tap, ci = divmod(k, cin)
    return divmod(tap, kw), ci
