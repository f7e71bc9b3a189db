"""Plain PyTorch reference of the two towers of the default MM configuration.

The query tower (ResNet-18 image branch, BEV-FPN voxel branch with ECA
blocks, the FCODE deep-to-shallow fusion, the stage-2 fusion) and the
aerial tower (ResNet-18, GeM, MLP), written from the architecture in NCHW /
NCXYZ with ``torch.nn.functional`` only.  The voxel convs are 3-D convs on
the dense occupancy grid (MinkowskiEngine semantics: every conv output is
masked to the occupied cells, a k2s2 down pads each axis by
``me_down_align`` and its output cell is occupied where any parent is), so
a FLOP count over this code is the model's own arithmetic.

Every conv and matmul goes through one of three ``Products`` modules, one
per precision group, so ``FlopCounterMode`` files its count by group and a
control can lower one group's precision:

* ``img``: the image convs of both towers and of the stage-2 image block
  (the configuration's compute dtype);
* ``vox``: the voxel convs (bf16 in every configuration of the MM);
* ``dense``: the dense layers and the FCODE products (fp32).

A group computes its products on operands rounded to its precision, with
fp32 accumulation, and rounds a bf16 or fp8 product's output to bf16, as a
bf16 conv returns; everything else runs in fp32.  Parameters come as a
dict keyed by the parameter names of the measured towers' ``state_dict``
(``mm.``/``db.`` prefixed).  Nothing here imports the measured program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Params = Dict[str, torch.Tensor]
EPS_BN = 1e-5
GROUPS = ("img", "vox", "dense")
EPS_GEM = 1e-6


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` (fp32) rounded to ``precision``, returned in fp32."""
    if precision == "float32":
        return x
    if precision == "bfloat16":
        return x.to(torch.bfloat16).float()
    if precision == "tf32":  # 10 mantissa bits, round to nearest even
        i = x.float().contiguous().view(torch.int32)
        i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
        return i.view(torch.float32)
    if precision == "fp8":  # e4m3 with one scale per tensor
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {precision!r}")


class _RoundSTE(torch.autograd.Function):
    """Rounding with a straight-through gradient (a rounded product's
    gradient is the product's)."""

    @staticmethod
    def forward(ctx, x, precision):
        return round_to(x, precision)

    @staticmethod
    def backward(ctx, g):
        return g, None


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return x
    return _RoundSTE.apply(x, precision)


class Products(nn.Module):
    """The products of one precision group: ``fn(x, w, *rest)`` on operands
    rounded to ``precision``, the output rounded to bf16 where the
    precision is below fp32's range of mantissas."""

    def __init__(self, precision: str):
        super().__init__()
        self.precision = precision

    def forward(self, fn, x, w, *rest):
        p = self.precision
        y = fn(rounded(x, p), rounded(w, p), *rest)
        return rounded(y, "bfloat16") if p in ("bfloat16", "fp8") else y


def me_down_align(cells: int) -> Tuple[int, int, int]:
    """(low pad, high pad, output cells) of a k2s2 down under
    MinkowskiEngine's pairing: parents (2m - lo, 2m + 1 - lo)."""
    lo = (cells // 2) % 2
    hi = (cells + lo) % 2
    return lo, hi, (cells + lo + hi) // 2


def flops_by_group(counts) -> dict:
    """{group: FLOPs} from ``FlopCounterMode.get_flop_counts()`` of a run
    of the reference."""
    out = {}
    for group in GROUPS:
        out[group] = float(sum(sum(ops.values()) for name, ops in
                               counts.items()
                               if name.split(".")[-1] == f"products_{group}"))
    return out


class Reference(nn.Module):
    """Forward passes of both towers (eval or training mode) over a
    parameter dict.  ``arch`` holds the configuration's numbers this code
    reads (see ``arch_of`` in the harness): the grid, the component
    weights of the final sum, the Euler step."""

    def __init__(self, precisions: Dict[str, str], arch: dict):
        super().__init__()
        for group in GROUPS:  # one class each: FlopCounterMode's names
            setattr(self, group, type(f"products_{group}", (Products,), {})(
                precisions[group]))
        self.arch = arch
        self.training_mode = False
        self.record = None  # {BN name: (mean, var)} of a training-mode pass

    # -- building blocks ----------------------------------------------------
    def linear(self, x, P: Params, name: str):
        y = self.dense(F.linear, x, P[name + ".weight"])
        return y + P[name + ".bias"]

    def bn(self, x, P: Params, name: str, mask=None):
        """BatchNorm over dim 1; training mode takes the batch's biased
        moments (over the occupied cells where ``mask`` [B,1,...] is
        given), eval mode the running statistics."""
        w, b = P[name + ".weight"], P[name + ".bias"]
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training_mode:
            dims = (0,) + tuple(range(2, x.ndim))
            if mask is None:
                mean = x.mean(dim=dims)
                var = x.var(dim=dims, unbiased=False)
            else:
                cnt = mask.sum().clamp(min=1.0)
                mean = (x * mask).sum(dim=dims) / cnt
                var = ((x - mean.reshape(shape)).square() * mask).sum(
                    dim=dims) / cnt
            if self.record is not None:
                self.record[name] = (mean.detach(), var.detach())
        else:
            mean, var = P[name + ".running_mean"], P[name + ".running_var"]
        scale = w / torch.sqrt(var + EPS_BN)
        return x * scale.reshape(shape) + (b - mean * scale).reshape(shape)

    def conv2d(self, x, P: Params, name: str, stride=1, padding=0,
               bias=False):
        y = self.img(F.conv2d, x, P[name + ".weight"], None, stride, padding)
        return y + P[name + ".bias"].reshape(1, -1, 1, 1) if bias else y

    def conv3d(self, x, P: Params, name: str, stride=1, padding=0):
        w = P[name + ".kernel"].permute(4, 3, 0, 1, 2)  # [cout,cin,kx,ky,kz]
        return self.vox(F.conv3d, x, w, None, stride, padding)

    @staticmethod
    def gem(x, p):
        """GeM over H, W of an NCHW map -> [B, C]."""
        return torch.clamp(x, min=EPS_GEM).pow(p).mean(dim=(2, 3)).pow(1 / p)

    @staticmethod
    def masked_mean(x, m):
        """Mean over the occupied cells of each sample -> [B, C]."""
        return (x * m).sum(dim=(2, 3, 4)) / m.sum(dim=(2, 3, 4)).clamp(
            min=1.0)

    def masked_gem(self, x, m, p):
        return self.masked_mean(torch.clamp(x, min=EPS_GEM).pow(p),
                                m).pow(1 / p)

    @staticmethod
    def l2n(x):
        return x / torch.linalg.vector_norm(x, dim=-1,
                                            keepdim=True).clamp(min=1e-12)

    # -- image trunk ----------------------------------------------------------
    def resnet(self, x, P: Params, prefix: str,
               stages: int = 3) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """ResNet-18's stem and first ``stages`` stages on NCHW ``x``."""
        x = self.conv2d(x, P, prefix + "conv1", 2, 3)
        x = F.max_pool2d(torch.relu(self.bn(x, P, prefix + "bn1")), 3, 2, 1)
        maps = []
        for s in range(stages):
            for blk in range(2):
                n = f"{prefix}layer{s + 1}_{blk}."
                stride = 2 if (s > 0 and blk == 0) else 1
                out = torch.relu(self.bn(self.conv2d(x, P, n + "conv1",
                                                     stride, 1), P,
                                         n + "bn1"))
                out = self.bn(self.conv2d(out, P, n + "conv2", 1, 1), P,
                              n + "bn2")
                if n + "downsample_conv.weight" in P:
                    x = self.bn(self.conv2d(x, P, n + "downsample_conv",
                                            stride), P, n + "downsample_bn")
                x = torch.relu(out + x)
            maps.append(x)
        return x, maps

    # -- voxel branch -----------------------------------------------------------
    def down(self, g, m, P: Params, name: str):
        """k2s2 down with the ME alignment padding; (feats, mask)."""
        pads = []
        for d in (4, 3, 2):  # F.pad lists the last axis first
            lo, hi, _ = me_down_align(g.shape[d])
            pads += [lo, hi]
        g = self.conv3d(F.pad(g, pads), P, name, 2)
        m = (F.max_pool3d(F.pad(m, pads), 2, 2) > 0).float()
        return g, m

    def eca_block(self, x, m, P: Params, name: str):
        out = torch.relu(self.bn(self.conv3d(x, P, name + ".conv1",
                                             padding=1), P, name + ".norm1",
                                 m)) * m
        out = self.bn(self.conv3d(out, P, name + ".conv2", padding=1), P,
                      name + ".norm2", m)
        w = P[name + ".eca.conv_w"].reshape(1, 1, -1)
        y = F.conv1d(self.masked_mean(out, m)[:, None, :], w,
                     padding=(w.shape[-1] - 1) // 2)
        out = out * torch.sigmoid(y[:, 0])[:, :, None, None, None]
        res = x
        if name + ".downsample_conv.kernel" in P:
            res = self.bn(self.conv3d(x, P, name + ".downsample_conv"), P,
                          name + ".downsample_bn", m)
        return torch.relu(out + res) * m

    def voxel_fpn(self, occ, P: Params, prefix: str):
        """(final map, its mask, per-stage maps and masks) of the BEV-FPN
        on the occupancy grid ``occ`` [B, X, Y, Z]."""
        m = occ[:, None].float()
        g = self.conv3d(m, P, prefix + "conv0", padding=2)
        g = torch.relu(self.bn(g, P, prefix + "bn0", m)) * m
        maps = []
        for i in range(3):
            g, m = self.down(g, m, P, f"{prefix}down{i}")
            g = torch.relu(self.bn(g, P, f"{prefix}down_bn{i}", m)) * m
            g = self.eca_block(g, m, P, f"{prefix}block{i}_0")
            maps.append((g, m))
        g = self.conv3d(g, P, prefix + "lateral_top")
        maps[-1] = (g, m)
        return g, m, maps

    # -- the towers ----------------------------------------------------------------
    def fcode(self, x, P: Params, name: str):
        w, b = P[name + ".kernel"], P[name + ".bias"]
        dt, steps = self.arch["ode_dt"], self.arch["ode_steps"]
        for _ in range(steps):
            x = x + dt * torch.relu(self.dense(torch.matmul, x, w) + b)
        return x

    def query_tower(self, P: Params, images, occ) -> Dict[str, torch.Tensor]:
        """The MM: images [B, H, W, 3], occupancy [B, X, Y, Z] bool."""
        p = "mm."
        a = self.arch
        imap, imaps = self.resnet(images.permute(0, 3, 1, 2), P,
                                  p + "image_fe.fe.")
        image_vec = self.l2n(self.gem(imap, P[p + "image_pool.p"]))
        vmap, vmask, vmaps = self.voxel_fpn(occ, P, p + "vox_fe.")
        vox_vec = self.l2n(self.masked_gem(vmap, vmask, P[p + "vox_pool.p"]))

        fuse = 0.0
        for i in (2, 1, 0):  # deep to shallow
            iv = imaps[i].mean(dim=(2, 3))
            vv = self.masked_mean(*vmaps[i])
            if i < 2:
                iv = self.linear(iv, P, f"{p}fuseblocktoshallow.updim_img_{i}")
                vv = self.linear(vv, P, f"{p}fuseblocktoshallow.updim_vox_{i}")
            fuse = self.fcode(fuse + iv + vv, P,
                              f"{p}fuseblocktoshallow.diff_{i}.fcode_0")
        shallow_n = self.l2n(fuse)
        shallow = shallow_n * a["shallow_weight"]

        s = p + "stg2fuseblock."
        imap = imap + self.linear(shallow, P, s + "proj_fuse_img_0")[
            :, :, None, None]
        vmap = (vmap + self.linear(shallow, P, s + "proj_fuse_vox_0")[
            :, :, None, None, None]) * vmask
        f = s + "ffn_img_0."
        out = torch.relu(self.bn(self.conv2d(imap, P, f + "conv1", 1, 1,
                                             True), P, f + "bn1"))
        out = self.bn(self.conv2d(out, P, f + "conv2", 1, 1, True), P,
                      f + "bn2")
        imap = torch.relu(out + imap)
        vmap = self.eca_block(vmap, vmask, P, s + "ffn_vox_0")
        stg2image = self.gem(imap, P[s + "pool_img_0.p"])
        stg2vox = self.masked_gem(vmap, vmask, P[s + "pool_vox_0.p"])
        fuse = shallow + self.conv2d(imap, P, s + "proj_img_fuse_0", 1, 0,
                                     True).mean(dim=(2, 3))
        fuse = fuse + self.masked_mean(
            self.conv3d(vmap, P, s + "proj_vox_fuse_0") * vmask, vmask)
        b = s + "ffn_fuse_0.basic_0."
        out = torch.relu(self.layer_norm(self.linear(fuse, P, b + "fc1"), P,
                                         b + "ln1"))
        out = self.layer_norm(self.linear(out, P, b + "fc2"), P, b + "ln2")
        fuse = torch.relu(out + fuse)
        stg2fuse = self.linear(fuse, P, p + "stg2fusefc")

        parts = {"imageorg": image_vec, "voxorg": vox_vec,
                 "shalloworg": shallow_n,
                 "stg2image": stg2image, "stg2vox": stg2vox,
                 "stg2fuse": stg2fuse}
        emb = sum(parts[t] * a["final_weights"][t] for t in a["final_type"])
        return {"embedding": emb, "imagevec_org": image_vec,
                "voxvec_org": vox_vec}

    def layer_norm(self, x, P: Params, name: str):
        return F.layer_norm(x, x.shape[-1:], P[name + ".weight"],
                            P[name + ".bias"], 1e-5)

    def aerial_tower(self, P: Params, maps) -> torch.Tensor:
        """DBVanilla2D with one map type: maps [..., 1, H, W, 3] ->
        [..., C]."""
        lead = maps.shape[:-4]
        x = maps.reshape(-1, *maps.shape[-3:]).permute(0, 3, 1, 2)
        fmap, _ = self.resnet(x, P, "db.fe_0.fe.")
        v = self.gem(fmap, P["db.pool_0.p"])
        v = self.linear(torch.relu(self.layer_norm(
            self.linear(v, P, "db.mlp_0.fc1"), P, "db.mlp_0.ln")), P,
            "db.mlp_0.fc2")
        return self.l2n(v).reshape(*lead, -1)
