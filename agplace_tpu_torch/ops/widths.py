"""The width grid of the BEV kernels K2-K4, and the names of their
instances.

JAX's Pallas kernels keep their operands whole in VMEM and take any width
the MM's flags give (``--vox_grid_extent``, ``--mm_voxfe_planes``,
``--mm_voxfe_dim``).  The port's kernels take every width of this grid: z
up to MAX_Z, every per-z channel count a multiple of C_STEP (C0 = 1, K4's
occupancy input, excepted), Z*C up to MAX_ZC; each wrapper's rule
(``bev_down.down0_instance``, ``bev_block_sm.conv3x3_instance``,
``bev_head.head_instance``) picks the sm90 (TMA + wgmma) instance where its
tiles divide the widths and the wmma implicit GEMM of
``csrc/conv_igemm.cuh`` (IGEMM) elsewhere.
"""

from __future__ import annotations

MAX_Z, C_STEP, MAX_ZC = 32, 8, 4096
SM90, IGEMM = "sm90", "igemm"
# conv_igemm.cuh's A gathers (its enum; GATHER_C8_BN = 2 is K2's own)
GATHER_SLAB32, GATHER_C8, GATHER_ANY = 0, 1, 3


def on_grid(zc: int, z: int) -> bool:
    """Whether a folded width Z*C lies on the grid: 1 <= z <= MAX_Z, C a
    multiple of C_STEP, Z*C <= MAX_ZC."""
    return (1 <= z <= MAX_Z and 0 < zc <= MAX_ZC and zc % z == 0
            and (zc // z) % C_STEP == 0)


def igemm_gather(cin: int) -> int:
    """conv_igemm.cuh's A gather for Cin input channels: 16-byte copies of
    32-channel slices, of 8-channel chunks, or element by element."""
    return (GATHER_SLAB32 if cin % 32 == 0 else
            GATHER_C8 if cin % 8 == 0 else GATHER_ANY)


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
