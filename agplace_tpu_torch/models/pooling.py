"""Global aggregation heads (``agplace_tpu/models/pooling.py``) on NHWC
maps: GeM, SPoC, MAC, RMAC, ConvAP, CosPlace, MixVPR, RRM, NetVLAD (with
its k-means init) and CRN, and ``GlobalHead``, the ``--aggregation``
registry.  Submodules carry flax's scope names (``Conv_0``, ``Dense_0``,
``LayerNorm_0`` where JAX names none) so the weight bridge maps them one to
one.  NetVLAD's and CRN's products run in fp32 (JAX's
``preferred_element_type``); they are plain ``einsum`` calls, as JAX's run
outside any Pallas kernel.  A NetVLAD built with ``dtype`` bf16 (behind a
bf16 CCT) rounds the operands of its two products, the normalised
descriptors with the assignment weights and the soft assignments with the
descriptors, to bf16 and multiplies them in fp32, exactly (a product of
two bf16 numbers is an fp32 number), with an fp32 result: the residuals
are differences of near-equal sums that a bf16 result would lose.  The
counts subtract the centroids under the same rounded assignments.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from agplace_tpu_torch.models.layers import Conv2d, Dense, LayerNorm, l2n


class GeM(nn.Module):
    """``mean(clamp(x, eps) ** p) ** (1/p)`` over H, W of an NHWC map.
    The clamp runs in the map's dtype and the power in fp32 (jnp promotes
    a bf16 map against the fp32 ``p``)."""

    def __init__(self, p_init: float = 3.0, eps: float = 1e-6):
        super().__init__()
        self.p = nn.Parameter(torch.full((1,), p_init))
        self.eps = eps

    def forward(self, x):  # [B, H, W, C] -> [B, C]
        dt = torch.promote_types(x.dtype, self.p.dtype)
        x = torch.clamp(x, min=self.eps).to(dt) ** self.p.to(dt)
        return x.mean(dim=(1, 2)) ** (1.0 / self.p.to(dt))


class SPoC(nn.Module):
    def forward(self, x):
        return x.mean(dim=(1, 2))


class MAC(nn.Module):
    def forward(self, x):
        return x.amax(dim=(1, 2))


def rmac_regions(h: int, w: int, levels: int = 3):
    """RMAC's square regions (i0, j0, side) of an h x w map: JAX's numpy
    geometry (ovr 0.4, steps 2..7, the overplus on the long side)."""
    ovr = 0.4
    steps = np.array([2, 3, 4, 5, 6, 7], np.float32)
    mn = min(h, w)
    b = (max(h, w) - mn) / (steps - 1)
    idx = int(np.argmin(np.abs((mn * mn - mn * b) / (mn * mn) - ovr)))
    wd = idx + 1 if h < w else 0
    hd = idx + 1 if h > w else 0
    regions = []
    for level in range(1, levels + 1):
        wl = int(np.floor(2 * mn / (level + 1)))
        if wl == 0:
            continue
        wl2 = int(np.floor(wl / 2 - 1))
        bw = 0.0 if level + wd == 1 else (w - wl) / (level + wd - 1)
        bh = 0.0 if level + hd == 1 else (h - wl) / (level + hd - 1)
        cen_w = [int(np.floor(np.float32(wl2 + i * bw))) - wl2
                 for i in range(level + wd)]
        cen_h = [int(np.floor(np.float32(wl2 + i * bh))) - wl2
                 for i in range(level + hd)]
        for i0 in cen_h:
            for j0 in cen_w:
                regions.append((i0, j0, wl))
    return regions


class RMAC(nn.Module):
    """The global max-pool vector plus each region's, each normalised as
    ``v / (||v|| + eps)`` and summed."""

    def __init__(self, levels: int = 3, eps: float = 1e-6):
        super().__init__()
        self.levels, self.eps = levels, eps

    def _norm(self, r):
        return r / (torch.linalg.vector_norm(r, dim=-1, keepdim=True)
                    + self.eps)

    def forward(self, x):
        _, h, w, _ = x.shape
        v = self._norm(x.amax(dim=(1, 2)))
        for i0, j0, wl in rmac_regions(h, w, self.levels):
            v = v + self._norm(x[:, i0:i0 + wl, j0:j0 + wl].amax(dim=(1, 2)))
        return v


class ConvAP(nn.Module):
    """1x1 conv -> (H // s1) x (W // s2) average pool, unpadded, stride =
    window -> channel-major flatten -> L2."""

    def __init__(self, cin: int, out_channels: int = 256, s1: int = 2,
                 s2: int = 2):
        super().__init__()
        self.Conv_0 = Conv2d(cin, out_channels, 1, 1, 0, True, None)
        self.s1, self.s2 = s1, s2

    def forward(self, x):
        x = self.Conv_0(x).permute(0, 3, 1, 2)
        win = (x.shape[2] // self.s1, x.shape[3] // self.s2)
        x = F.avg_pool2d(x, win, win)
        return l2n(x.reshape(x.shape[0], -1))


class CosPlace(nn.Module):
    """channel L2 -> GeM -> linear -> L2."""

    def __init__(self, cin: int, out_dim: int = 256):
        super().__init__()
        self.gem = GeM()
        self.fc = Dense(cin, out_dim)

    def forward(self, x):
        return l2n(self.fc(self.gem(l2n(x))))


class FeatureMixerLayer(nn.Module):
    """Residual MLP over the last axis (the h*w tokens of a channel)."""

    def __init__(self, dim: int, mlp_ratio: float = 1.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.LayerNorm_0 = LayerNorm(dim, eps=1e-5)
        self.Dense_0 = Dense(dim, hidden)
        self.Dense_1 = Dense(hidden, dim)

    def forward(self, x):  # [B, C, hw]
        return x + self.Dense_1(torch.relu(self.Dense_0(
            self.LayerNorm_0(x))))


class MixVPR(nn.Module):
    """[B, C, hw] -> ``mix_depth`` mixers -> channel projection -> row
    projection -> flatten -> L2.  The mixers' width is the map's h * w,
    fixed when the head is built."""

    def __init__(self, in_channels: int, hw: int, out_channels: int = 256,
                 mix_depth: int = 4, mlp_ratio: float = 1.0,
                 out_rows: int = 4):
        super().__init__()
        self.mixers = []
        for i in range(mix_depth):
            setattr(self, f"mix_{i}", FeatureMixerLayer(hw, mlp_ratio))
            self.mixers.append(getattr(self, f"mix_{i}"))
        self.channel_proj = Dense(in_channels, out_channels)
        self.row_proj = Dense(hw, out_rows)

    def forward(self, x):
        b, h, w, c = x.shape
        x = x.reshape(b, h * w, c).transpose(1, 2)  # [B, C, hw]
        for mix in self.mixers:
            x = mix(x)
        x = self.channel_proj(x.transpose(1, 2)).transpose(1, 2)
        return l2n(self.row_proj(x).reshape(b, -1))


class RRM(nn.Module):
    """GAP -> LayerNorm -> residual MLP -> LayerNorm -> L2."""

    def __init__(self, dim: int = 256):
        super().__init__()
        self.ln1 = LayerNorm(dim, eps=1e-5)
        self.fc1 = Dense(dim, dim)
        self.fc2 = Dense(dim, dim)
        self.ln2 = LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        v = self.ln1(x.mean(dim=(1, 2)))
        h = self.fc2(torch.relu(self.fc1(v)))
        return l2n(self.ln2(v + h))


def _operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype``, held in fp32 (the identity at fp32)."""
    return x.to(dtype).float()


def _vlad(x, soft, centroids):
    """Residuals of descriptors ``x`` [B, N, C] against ``centroids``
    [K, C] under soft assignments [B, N, K]; intra-normalised, then
    L2-normalised, [B, K * C]."""
    weighted = torch.einsum("bnk,bnc->bkc", soft, x.float())
    counts = soft.sum(dim=1)
    vlad = l2n(weighted - counts[..., None] * centroids[None].float())
    return l2n(vlad.reshape(vlad.shape[0], -1))


class NetVLAD(nn.Module):
    """Soft assignment by a bias-free 1x1 conv (``assign_w`` [C, K]),
    residual aggregation against ``centroids`` [K, C], intra-norm, L2;
    the products' operands rounded to ``dtype`` (module docstring)."""

    def __init__(self, clusters_num: int = 64, dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.centroids = nn.Parameter(torch.empty(clusters_num, dim))
        self.assign_w = nn.Parameter(torch.empty(dim, clusters_num))
        self.init_std = {"centroids": 1.0, "assign_w": dim ** -0.5}
        self.dtype = dtype

    def forward(self, x):  # [B, H, W, C] or [B, N, C]
        if x.ndim == 4:
            x = x.reshape(x.shape[0], -1, x.shape[-1])
        x = _operand(l2n(x), self.dtype)
        soft = torch.softmax(x @ _operand(self.assign_w, self.dtype), dim=-1)
        return _vlad(x, _operand(soft, self.dtype), self.centroids)

    @staticmethod
    def init_from_kmeans(params: dict, centroids, descriptors=None,
                         alpha: float = None) -> dict:
        """``params`` with ``centroids`` (as given) and ``assign_w`` =
        alpha x the L2-normalised centroids, transposed: the reference's
        ``init_params``.  alpha = -ln(0.01) / mean(top1 - top2) of the
        normalised centroids' dots with the descriptors, in numpy, unless
        given.  Keys are the module's (``centroids``, ``assign_w``)."""
        c = np.asarray(centroids, np.float32)
        c_assign = c / np.linalg.norm(c, axis=1, keepdims=True)
        if alpha is None:
            if descriptors is None:
                raise ValueError("need descriptors (or explicit alpha)")
            dots = np.sort(c_assign @ np.asarray(descriptors, np.float32).T,
                           axis=0)[::-1]
            alpha = float(-np.log(0.01) / np.mean(dots[0] - dots[1]))
        params = dict(params)
        params["centroids"] = torch.from_numpy(c)
        params["assign_w"] = torch.from_numpy(
            np.ascontiguousarray(alpha * c_assign.T))
        return params


class CRN(nn.Module):
    """NetVLAD whose soft assignments are scaled by a context mask: a
    3x3 / 2 ceil-mode average pool (edge windows divided by their in-bounds
    count), 3x3 / 5x5 / 7x7 convs (32 + 32 + 20), relu, the channel sum,
    relu, and a half-pixel bilinear upsample to the map's size."""

    def __init__(self, clusters_num: int = 64, dim: int = 256):
        super().__init__()
        self.filter_3 = Conv2d(dim, 32, 3, 1, 1, True, None)
        self.filter_5 = Conv2d(dim, 32, 5, 1, 2, True, None)
        self.filter_7 = Conv2d(dim, 20, 7, 1, 3, True, None)
        self.centroids = nn.Parameter(torch.empty(clusters_num, dim))
        self.assign_w = nn.Parameter(torch.empty(dim, clusters_num))
        self.init_std = {"centroids": 1.0, "assign_w": dim ** -0.5}

    def forward(self, x):  # [B, H, W, C]
        b, h, w, c = x.shape
        x = l2n(x)
        # count_include_pad=False: the reference's AvgPool2d divides the
        # ceil-mode windows by their in-bounds count; JAX sums and divides
        xd = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 2, ceil_mode=True,
                          count_include_pad=False).permute(0, 2, 3, 1)
        g = torch.relu(torch.cat([self.filter_3(xd), self.filter_5(xd),
                                  self.filter_7(xd)], dim=-1))
        wmask = torch.relu(g.sum(dim=-1, keepdim=True))
        mask = F.interpolate(wmask.permute(0, 3, 1, 2).float(), (h, w),
                             mode="bilinear", align_corners=False)
        flat = x.reshape(b, h * w, c)
        soft = torch.softmax(flat.float() @ self.assign_w.float(), dim=-1)
        soft = soft * mask.reshape(b, h * w, 1)
        return _vlad(flat, soft, self.centroids)


# aggregations that take no parameters beyond the map
POOLS = ("gem", "spoc", "mac", "rmac")


class GlobalHead(nn.Module):
    """``--aggregation``: gem, spoc, mac, rmac, convap, cosplace, mixvpr,
    rrm, netvlad or crn over a [B, h, w, ``dim``] map (``hw`` = h * w,
    MixVPR's width); ``dtype`` reaches NetVLAD, the others are fp32."""

    def __init__(self, aggregation: str = "gem", dim: int = 256,
                 netvlad_clusters: int = 64, hw: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.aggregation = agg = aggregation
        if agg == "gem":
            self.gem = GeM()
        elif agg in ("spoc", "mac", "rmac"):
            setattr(self, agg, {"spoc": SPoC, "mac": MAC, "rmac": RMAC}[agg]())
        elif agg == "convap":
            self.convap = ConvAP(dim, dim)
        elif agg == "cosplace":
            self.cosplace = CosPlace(dim, dim)
        elif agg == "mixvpr":
            self.mixvpr = MixVPR(dim, hw, out_channels=dim)
        elif agg == "rrm":
            self.rrm = RRM(dim)
        elif agg == "netvlad":
            self.netvlad = NetVLAD(netvlad_clusters, dim, dtype)
        elif agg == "crn":
            self.crn = CRN(netvlad_clusters, dim)
        else:
            raise NotImplementedError(f"aggregation={agg}")

    def forward(self, x):
        return getattr(self, self.aggregation)(x)
