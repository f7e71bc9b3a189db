"""The model factory (``agplace_tpu/models/factory.py``): ``--modelq`` /
``--modeldb`` to towers, and the calls that make them interchangeable.

* query towers: mm | minkloc | minkloc_multimodal | geoloc;
* aerial towers: vanilla2d | geoloc (``GeoDB``, its network under ``net``);
* ``--share_qdb``: no aerial tower; ``shared_db_apply`` embeds the aerial
  maps with the query tower (geoloc only, as in JAX and the reference).

The 5-D cache entry [B, NMAP, H, W, 3] and the 6-D training entry [B, NDB,
NMAP, H, W, 3] fold every map into one image batch (``db_map_batched``),
so a training forward's BN statistics cover all of them, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from agplace_tpu_torch.config import Config
from agplace_tpu_torch.models.geoloc import GeoLocalizationNet
from agplace_tpu_torch.models.layers import l2n
from agplace_tpu_torch.models.minkloc import MinkLoc, MinkLocMultimodal


def geoloc_net(cfg: Config, image_hw: Tuple[int, int],
               dtype: torch.dtype = torch.float32) -> GeoLocalizationNet:
    m = cfg.model
    return GeoLocalizationNet(
        backbone=m.backbone, aggregation=m.aggregation,
        netvlad_clusters=m.netvlad_clusters, fc_output_dim=m.fc_output_dim,
        l2=m.l2, trunc_te=m.trunc_te, image_hw=image_hw, dtype=dtype)


def make_query_model(cfg: Config, dtype: torch.dtype = torch.float32
                     ) -> nn.Module:
    """``--modelq``, for query images of ``q_resize`` squared where a
    geoloc tower fixes a size; ``dtype`` reaches the MM and a geoloc
    tower, where CCT and NetVLAD take it (JAX's factory gives the towers
    other than the MM none; MinkLoc stays fp32)."""
    name, fd = cfg.model.modelq, cfg.model.features_dim
    if name == "mm":
        from agplace_tpu_torch.models.mm import MM

        return MM(cfg.model.mm, dtype=dtype)
    if name == "minkloc":
        return MinkLoc(feature_size=fd, output_dim=fd)
    if name == "minkloc_multimodal":
        return MinkLocMultimodal(fd, fd, 2 * fd)
    if name == "geoloc":
        return geoloc_net(cfg, (cfg.data.q_resize,) * 2, dtype)
    raise NotImplementedError(f"modelq={name}")


def make_db_model(cfg: Config, dtype: torch.dtype = torch.float32
                  ) -> nn.Module:
    """``--modeldb``, for tiles of ``db_resize`` squared; ``dtype`` as
    ``make_query_model``'s."""
    name = cfg.model.db.modeldb
    if name == "vanilla2d":
        from agplace_tpu_torch.models.dbvanilla2d import DBVanilla2D

        return DBVanilla2D(cfg.model.db, dim=cfg.model.features_dim,
                           nmap=cfg.data.nmap,
                           output_l2=cfg.model.mm.output_l2,
                           final_l2=cfg.model.mm.final_l2, dtype=dtype)
    if name == "geoloc":
        return GeoDB(geoloc_net(cfg, (cfg.data.db_resize,) * 2, dtype))
    raise NotImplementedError(f"modeldb={name}")


def db_map_batched(db_map: torch.Tensor,
                   embed_flat: Callable[[torch.Tensor], torch.Tensor]
                   ) -> torch.Tensor:
    """[B, NMAP, H, W, C] -> [B, D] or [B, NDB, NMAP, H, W, C] -> [B, NDB,
    D]: every map through ``embed_flat`` ([N, H, W, C] -> [N, D]) in one
    batch, per-map L2, the mean over map types."""
    nd = db_map.ndim
    if nd not in (5, 6):
        raise ValueError(f"db_map must be 5-D or 6-D, got "
                         f"{tuple(db_map.shape)}")
    if nd == 5:
        db_map = db_map[:, None]
    b, ndb, nmap, h, w, c = db_map.shape
    emb = embed_flat(db_map.reshape(b * ndb * nmap, h, w, c))
    emb = l2n(emb.reshape(b * ndb, nmap, -1)).mean(dim=1).reshape(b, ndb, -1)
    return emb[:, 0] if nd == 5 else emb


class GeoDB(nn.Module):
    """GeoLocalizationNet as the aerial tower, under the scope ``net``."""

    def __init__(self, net: GeoLocalizationNet):
        super().__init__()
        self.net = net

    def forward(self, db_map: torch.Tensor) -> torch.Tensor:
        return db_map_batched(db_map, self.net)


def shared_db_apply(model: nn.Module, db_map: torch.Tensor) -> torch.Tensor:
    """``--share_qdb``: the aerial maps through the query tower."""
    if not isinstance(model, GeoLocalizationNet):
        raise NotImplementedError(
            "share_qdb needs an image-only query tower (modelq='geoloc'); "
            "the reference MM raises NotImplementedError identically")
    return db_map_batched(db_map, model)


def query_args(model: nn.Module, image, vox) -> tuple:
    """mm(image, vox) | minkloc(vox) | minkloc_multimodal(vox, image) |
    geoloc(image)."""
    if isinstance(model, GeoLocalizationNet):
        return (image,)
    if isinstance(model, MinkLoc):
        return (vox,)
    if isinstance(model, MinkLocMultimodal):
        return (vox, image)
    return (image, vox)


def query_apply(model: nn.Module, image, vox) -> dict:
    """The query tower's output as a dict with ``embedding`` (a tower that
    returns a bare tensor is wrapped)."""
    out = model(*query_args(model, image, vox))
    return out if isinstance(out, dict) else {"embedding": out}


def tower_width(model: Optional[nn.Module]) -> Optional[int]:
    """The descriptor width of a tower, where the tower knows it."""
    if isinstance(model, GeoDB):
        model = model.net
    return getattr(model, "out_dim", None)
