"""MM ground/query tower (``agplace_tpu/models/mm.py``) with every option
JAX's ``MM`` builds, in eval mode (the kernels' gates open) or training
mode (batch statistics; K2-K5 gated off, K1 through its autograd Function).

Voxel backends (``voxfe_backend``), one parameter tree for ``bev`` and
``dense`` and its [K, Cin, Cout] reshape for ``sparse``:

* ``bev``: a folded ``BEVGrid`` (host-rasterized, the serving path) or
  ``SparseVoxels`` (folded on the device); K2 / K4 at stage 0, K3 in the
  ECA blocks;
* ``dense``: ``SparseVoxels`` scattered into the [X, Y, Z] grid;
* ``sparse``: ``SparseVoxels`` as they are, the only backend that keeps a
  cloud beyond ``vox_grid_extent`` (the grids crop it).

Options: ``drop`` (image / pc), ``output_type`` with ``shallow`` or
``addorg``, ``final_fusetype`` (add / cat / catadd), and through the
submodules ``voxfe_ntd``, ``voxfe_block``, the integrators and
``stg2_useproj``.  Output: the reference's dict — imagevec_org,
voxvec_org, shallowvec_org, stg2fusevec, stg2imagevec, stg2voxvec,
embedding.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from agplace_tpu_torch.config import MMConfig
from agplace_tpu_torch.models.fusion import (
    FuseBlockToShallow,
    Stage2FuseBlockAdd,
)
from agplace_tpu_torch.models.image_fe import ImageFE
from agplace_tpu_torch.models.layers import Dense, l2n
from agplace_tpu_torch.models.pooling import GeM
from agplace_tpu_torch.sparse import dense_grid, minkfpn, modules, voxels
from agplace_tpu_torch.sparse.bev_grid import (
    BEVGrid,
    BEVMinkFPN,
    BEVMinkGeM,
    bev_densify,
    bev_global_avg,
)
from agplace_tpu_torch.utils.spans import span

# final_type component -> (MMConfig weight field, learn flag, flax name)
_FINAL = {
    "imageorg": ("imagevoxorg_weight", "imagevoxorg_learnweight",
                 "imageorg_weight"),
    "voxorg": ("imagevoxorg_weight", "imagevoxorg_learnweight",
               "voxorg_weight"),
    "shalloworg": ("shalloworg_weight", "shalloworg_learnweight",
                   "shalloworg_weight"),
    "stg2image": ("stg2imagevox_weight", "stg2imagevox_learnweight",
                  "stg2image_weight"),
    "stg2vox": ("stg2imagevox_weight", "stg2imagevox_learnweight",
                "stg2vox_weight"),
    "stg2fuse": ("stg2fuse_weight", "stg2fuse_learnweight",
                 "stg2fuse_weight"),
}


class MM(nn.Module):
    def __init__(self, config: MMConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        if "image" not in cfg.output_type:
            raise NotImplementedError(
                f"output_type={cfg.output_type}: the stage-2 fusion needs "
                f"the image branch (JAX fails there too)")
        if cfg.final_fusetype not in ("add", "cat", "catadd"):
            raise NotImplementedError(cfg.final_fusetype)
        backend = cfg.voxfe_backend
        if backend not in ("bev", "dense", "sparse"):
            raise NotImplementedError(f"voxfe_backend={backend!r}")
        self.dtype = dtype
        self.use_vox = "vox" in cfg.output_type
        self.use_shallow = "shallow" in cfg.output_type
        self.use_addorg = "addorg" in cfg.output_type
        img_dims = ImageFE.map_dims(cfg.imgfe, cfg.imgfe_layers)
        if img_dims[-1] != cfg.stg2fuse_dim and (
                "shallow" in cfg.output_type
                or ("imageorg" in cfg.final_type
                    and cfg.final_fusetype != "cat")):
            raise NotImplementedError(
                f"mm.imgfe={cfg.imgfe!r} ends at {img_dims[-1]} channels: "
                f"JAX's MM adds the last image vector to the "
                f"{cfg.stg2fuse_dim}-wide fusion sum with no projection "
                f"(agplace_tpu/models/fusion.py:136-146, and the final "
                f"sum) and fails with a TypeError")
        self.image_fe = ImageFE(cfg.imgfe, cfg.imgfe_layers, dtype,
                                use_pallas_stem=cfg.stem_pallas)
        self.image_pool = GeM()
        if self.use_vox:
            kw = dict(in_channels=1, out_channels=cfg.voxfe_planes[-1],
                      planes=cfg.voxfe_planes, layers=cfg.voxfe_layers,
                      num_top_down=cfg.voxfe_ntd, conv0_kernel_size=5,
                      block=cfg.voxfe_block)
            if backend == "bev":
                self.vox_fe = BEVMinkFPN(
                    **kw, use_pallas=cfg.bev_pallas,
                    use_pallas_head=cfg.bev_pallas_head,
                    use_fused_down=cfg.bev_fused_down)
                self.vox_pool = BEVMinkGeM()
            elif backend == "dense":
                self.vox_fe = dense_grid.DenseMinkFPN(**kw)
                self.vox_pool = dense_grid.GridMinkGeM()
            else:
                self.vox_fe = minkfpn.MinkFPN(**kw)
                self.vox_pool = modules.MinkGeM()
        if self.use_shallow:
            n = len(cfg.imgfe_planes)
            if len(img_dims) != n or (self.use_vox
                                      and len(cfg.voxfe_planes) != n):
                raise NotImplementedError(
                    f"the stage-1 fusion walks {n} scales (imgfe_planes) "
                    f"over {len(img_dims)} image maps and "
                    f"{len(cfg.voxfe_planes)} voxel maps: JAX's "
                    f"FuseBlockToShallow fails unless all agree")
            # the FPN's maps from n - 1 - ntd on carry its out_channels
            vp, ntd = cfg.voxfe_planes, cfg.voxfe_ntd
            vox_dims = tuple(vp[-1] if i >= len(vp) - 1 - ntd else c
                             for i, c in enumerate(vp))
            self.fuseblocktoshallow = FuseBlockToShallow(
                dims=tuple(cfg.stg2fuse_dim for _ in range(n)),
                img_dims=img_dims,
                vox_dims=vox_dims if self.use_vox else None,
                ode=cfg.ode)
        self.stg2fuseblock = Stage2FuseBlockAdd(
            fusedim=cfg.stg2fuse_dim, imgdim=cfg.imgfe_dim,
            voxdim=cfg.voxfe_dim, vox_backend=backend if self.use_vox
            else None, nlayers=cfg.stg2nlayers,
            stg2fuse_type=cfg.stg2fuse_type, use_proj=cfg.stg2_useproj,
            dtype=dtype, bev_pallas=cfg.bev_pallas)
        self.stg2fusefc = Dense(cfg.stg2fuse_dim, cfg.stg2fuse_dim)
        # component weights: a parameter when learned (flax name), else a
        # constant, as ``MM._weight``
        self._weights = {}
        for field, learn, name in (
                ("image_weight", "image_learnweight", "image_weight"),
                ("vox_weight", "vox_learnweight", "vox_weight"),
                ("shallow_weight", "shallow_learnweight", "shallow_weight"),
                *_FINAL.values()):
            if getattr(cfg, learn):
                if not hasattr(self, name):
                    setattr(self, name, nn.Parameter(
                        torch.tensor(float(getattr(cfg, field)))))
            else:
                self._weights[name] = float(getattr(cfg, field))

    def _w(self, name: str):
        return self._weights[name] if name in self._weights \
            else getattr(self, name)

    def _drop(self, query_image, vox):
        """The modality-drop ablation (``mm.py:67-86``): a zero image, or
        the cloud reduced to one voxel (the grid's centre cell, or one row
        at the origin: ME requantises zeroed coordinates into one voxel)."""
        drop = self.config.drop
        if drop == "image":
            query_image = query_image * 0
        elif drop == "pc" and vox is not None:
            if isinstance(vox, BEVGrid):
                b, gx, gy, gz = vox.mask.shape
                m0 = torch.zeros_like(vox.mask)
                m0[:, gx // 2, gy // 2, gz // 2] = True
                vox = BEVGrid(feats=m0.to(vox.feats.dtype), mask=m0,
                              z=vox.z, stride=vox.stride)
            else:
                keep = torch.zeros_like(vox.mask)
                keep[:, 0] = True
                vox = vox.replace(coords=vox.coords * 0, mask=keep)
        return query_image, vox

    def _voxel_branch(self, vox):
        """(final map, per-stage maps, keys or None, pooled vector)."""
        cfg, backend = self.config, self.config.voxfe_backend
        keys = None
        if backend == "bev":
            if isinstance(vox, BEVGrid):
                g = vox.replace(feats=vox.feats.to(self.dtype))
            else:
                g = bev_densify(vox, cfg.vox_grid_extent, self.dtype,
                                ones_feats=True)
            fmap, maps = self.vox_fe(g)
        elif isinstance(vox, BEVGrid):
            raise TypeError("a host-rasterized BEVGrid needs "
                            "voxfe_backend='bev'")
        elif backend == "dense":
            g = dense_grid.densify(vox, extent=cfg.vox_grid_extent)
            fmap, maps = self.vox_fe(g.replace(feats=g.feats.to(self.dtype)))
        else:
            fmap, keys, maps = self.vox_fe(vox)
            maps = [m for m, _ in maps]
        return fmap, maps, keys, self.vox_pool(fmap)

    def forward(self, query_image: torch.Tensor, vox=None
                ) -> Dict[str, torch.Tensor]:
        cfg = self.config
        outputs: Dict[str, torch.Tensor] = {}
        components = []
        query_image, vox = self._drop(query_image, vox)
        use_vox = self.use_vox and vox is not None

        with span("mm.image"):
            imagefeatmap, imagemaplist = self.image_fe(query_image)
            v = self.image_pool(imagefeatmap)
            if cfg.output_l2:
                v = l2n(v)
            outputs["imagevec_org"] = v
            components.append(v * self._w("image_weight"))

        voxfeatmap = voxmaplist = vox_keys = None
        if use_vox:
            with span("mm.voxel"):
                voxfeatmap, voxmaplist, vox_keys, v = self._voxel_branch(vox)
                if cfg.output_l2:
                    v = l2n(v)
                outputs["voxvec_org"] = v
                components.append(v * self._w("vox_weight"))

        with span("mm.fusion"):
            shallow = None
            if self.use_shallow:
                imageveclist = [m.mean(dim=(1, 2)) for m in imagemaplist]
                voxveclist = None
                if use_vox:
                    avg = {"bev": bev_global_avg,
                           "dense": dense_grid.grid_global_avg,
                           "sparse": voxels.masked_global_avg
                           }[cfg.voxfe_backend]
                    voxveclist = [avg(g) for g in voxmaplist]
                shallow = self.fuseblocktoshallow(imageveclist, voxveclist)
                outputs["shallowvec_org"] = shallow
                if cfg.output_l2:
                    shallow = l2n(shallow)
                components.append(shallow * self._w("shallow_weight"))
            elif self.use_addorg:
                addorg = outputs["imagevec_org"]
                if use_vox:
                    addorg = addorg + outputs["voxvec_org"]
                if cfg.output_l2:
                    addorg = l2n(addorg)
                outputs["shallowvec_org"] = addorg
                components.append(addorg * self._w("shallow_weight"))

            fuse, stg2image, stg2vox = self.stg2fuseblock(
                imagefeatmap, voxfeatmap if use_vox else None, components[-1],
                vox_keys)
            outputs["stg2fusevec"] = self.stg2fusefc(fuse)
            outputs["stg2imagevec"] = stg2image
            if stg2vox is not None:
                outputs["stg2voxvec"] = stg2vox

            present = {"imageorg": outputs["imagevec_org"],
                       "voxorg": outputs.get("voxvec_org"),
                       "shalloworg": shallow,
                       "stg2image": stg2image, "stg2vox": stg2vox,
                       "stg2fuse": outputs["stg2fusevec"]}
            final = [present[t] * self._w(_FINAL[t][2])
                     for t in _FINAL if t in cfg.final_type
                     and present[t] is not None]
            if cfg.final_fusetype == "add":
                x = sum(final)
            elif cfg.final_fusetype == "cat":
                x = torch.cat(final, dim=-1)
            else:  # catadd
                x = torch.cat(final[:-1], dim=-1) + final[-1]
            outputs["embedding"] = l2n(x) if cfg.final_l2 else x
        return outputs
