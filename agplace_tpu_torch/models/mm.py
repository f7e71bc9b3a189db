"""MM ground/query tower (``agplace_tpu/models/mm.py``), eval mode, with the
``bev`` voxel backend.

Input: ``query_image`` [B, H, W, 3] (NHWC) and a host-rasterized
``BEVGrid``.  Output: the reference's 7-key dict — imagevec_org,
voxvec_org, shallowvec_org, stg2fusevec, stg2imagevec, stg2voxvec,
embedding — with the weighted final sum of ``mm.py:250-288``.
"""

from __future__ import annotations

from typing import Dict, Optional

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
from agplace_tpu_torch.sparse.bev_grid import (
    BEVGrid,
    BEVMinkFPN,
    BEVMinkGeM,
    bev_global_avg,
)

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
        if cfg.voxfe_backend != "bev":
            raise NotImplementedError(
                f"voxfe_backend={cfg.voxfe_backend!r} (port: 'bev' only)")
        if cfg.drop is not None or cfg.final_fusetype != "add":
            raise NotImplementedError("drop / non-'add' final fusion")
        if "image" not in cfg.output_type or "addorg" in cfg.output_type:
            raise NotImplementedError(f"output_type={cfg.output_type}")
        self.dtype = dtype
        self.use_vox = "vox" in cfg.output_type
        self.use_shallow = "shallow" in cfg.output_type
        self.image_fe = ImageFE(cfg.imgfe, cfg.imgfe_layers, dtype,
                                use_pallas_stem=cfg.stem_pallas)
        self.image_pool = GeM()
        if self.use_vox:
            self.vox_fe = BEVMinkFPN(
                in_channels=1, out_channels=cfg.voxfe_planes[-1],
                planes=cfg.voxfe_planes, layers=cfg.voxfe_layers,
                num_top_down=cfg.voxfe_ntd, conv0_kernel_size=5,
                block=cfg.voxfe_block, use_pallas=cfg.bev_pallas,
                use_pallas_head=cfg.bev_pallas_head,
                use_fused_down=cfg.bev_fused_down)
            self.vox_pool = BEVMinkGeM()
        if self.use_shallow:
            n = len(cfg.imgfe_planes)
            self.fuseblocktoshallow = FuseBlockToShallow(
                dims=tuple(cfg.stg2fuse_dim for _ in range(n)),
                img_dims=cfg.imgfe_planes,
                vox_dims=cfg.voxfe_planes if self.use_vox else None,
                ode=cfg.ode)
        self.stg2fuseblock = Stage2FuseBlockAdd(
            fusedim=cfg.stg2fuse_dim, imgdim=cfg.imgfe_dim,
            voxdim=cfg.voxfe_dim, with_vox=self.use_vox,
            nlayers=cfg.stg2nlayers, stg2fuse_type=cfg.stg2fuse_type,
            use_proj=cfg.stg2_useproj, dtype=dtype,
            bev_pallas=cfg.bev_pallas)
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

    def forward(self, query_image: torch.Tensor,
                vox: Optional[BEVGrid] = None) -> Dict[str, torch.Tensor]:
        cfg = self.config
        outputs: Dict[str, torch.Tensor] = {}
        components = []
        use_vox = self.use_vox and vox is not None

        imagefeatmap, imagemaplist = self.image_fe(query_image)
        v = self.image_pool(imagefeatmap)
        if cfg.output_l2:
            v = l2n(v)
        outputs["imagevec_org"] = v
        components.append(v * self._w("image_weight"))

        voxfeatmap = voxmaplist = None
        if use_vox:
            bev = vox.replace(feats=vox.feats.to(self.dtype))
            voxfeatmap, voxmaplist = self.vox_fe(bev)
            v = self.vox_pool(voxfeatmap)
            if cfg.output_l2:
                v = l2n(v)
            outputs["voxvec_org"] = v
            components.append(v * self._w("vox_weight"))

        shallow = None
        if self.use_shallow:
            imageveclist = [m.mean(dim=(1, 2)) for m in imagemaplist]
            voxveclist = ([bev_global_avg(g) for g in voxmaplist]
                          if use_vox else None)
            shallow = self.fuseblocktoshallow(imageveclist, voxveclist)
            outputs["shallowvec_org"] = shallow
            if cfg.output_l2:
                shallow = l2n(shallow)
            components.append(shallow * self._w("shallow_weight"))

        fuse, stg2image, stg2vox = self.stg2fuseblock(
            imagefeatmap, voxfeatmap if use_vox else None, components[-1])
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
        outputs["embedding"] = sum(final)
        if cfg.final_l2:
            outputs["embedding"] = l2n(outputs["embedding"])
        return outputs
