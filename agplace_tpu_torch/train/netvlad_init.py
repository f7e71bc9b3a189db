"""NetVLAD / CRN cluster init from dataset descriptors
(``agplace_tpu/train/netvlad_init.py``): sample images, run the tower's own
backbone, L2-normalise each descriptor and keep up to 100 per image,
k-means them (``retrieval/kmeans.py``, on the tower's device) and set the
head's ``centroids`` and ``assign_w`` (``NetVLAD.init_from_kmeans``).

The image and descriptor draws use ``np.random.default_rng(seed)``, as
JAX's do, so they are the same; k-means' initial rows come from a torch
generator of ``seed`` (or ``init_idx``: see ``retrieval/kmeans.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from agplace_tpu_torch.models.pooling import NetVLAD
from agplace_tpu_torch.retrieval.kmeans import kmeans


def initialize_netvlad(head: nn.Module,
                       backbone_apply: Callable[[np.ndarray], torch.Tensor],
                       sample_images: np.ndarray, clusters_num: int = 64,
                       descriptors_per_image: int = 100, seed: int = 0,
                       alpha: Optional[float] = None,
                       init_idx: Optional[np.ndarray] = None) -> np.ndarray:
    """Set ``head``'s (a NetVLAD or CRN) cluster parameters in place from
    ``backbone_apply(images [b, H, W, 3]) -> [b, h, w, C]`` maps of
    ``sample_images``, 8 at a time; returns the k-means centroids."""
    rng = np.random.default_rng(seed)
    descs = []
    for s in range(0, len(sample_images), 8):
        with torch.inference_mode():
            fm = backbone_apply(sample_images[s:s + 8]).float().cpu().numpy()
        b, h, w, c = fm.shape
        flat = fm.reshape(b, h * w, c)
        flat = flat / np.maximum(
            np.linalg.norm(flat, axis=-1, keepdims=True), 1e-12)
        for i in range(b):
            take = rng.choice(h * w, size=min(descriptors_per_image, h * w),
                              replace=False)
            descs.append(flat[i, take])
    descs = np.concatenate(descs).astype(np.float32)
    dev = head.centroids.device
    centroids, _ = kmeans(
        torch.from_numpy(descs).to(dev), clusters_num,
        generator=torch.Generator().manual_seed(seed),
        init_idx=None if init_idx is None else torch.as_tensor(
            np.array(init_idx)))
    centroids = centroids.cpu().numpy()
    new = NetVLAD.init_from_kmeans({}, centroids, descriptors=descs,
                                   alpha=alpha)
    with torch.no_grad():
        for name in ("centroids", "assign_w"):
            getattr(head, name).copy_(new[name])
    return centroids


def initialize_netvlad_from_dataset(cfg, tower: nn.Module, ds,
                                    seed: int = 0, n_images: int = 32,
                                    which: str = "query",
                                    init_idx: Optional[np.ndarray] = None
                                    ) -> np.ndarray:
    """The dataset init of a GeoLocalizationNet tower (``which``:
    "query", its query images; "db", a ``GeoDB``'s aerial tiles), called
    by ``init_state`` when the aggregation is netvlad or crn.  ResNet,
    VGG16 and AlexNet backbones only, as in JAX."""
    from agplace_tpu_torch.data.base import collate_cache_db
    from agplace_tpu_torch.embed import to_device
    from agplace_tpu_torch.models.geoloc import RESNET_BACKBONES

    rng = np.random.default_rng(seed)
    if which == "db":
        n = min(n_images, ds.database_num)
        idx = rng.choice(ds.database_num, size=n, replace=False)
        maps = collate_cache_db(ds, list(idx))  # [n, NMAP, H, W, 3]
        images = maps.reshape(-1, *maps.shape[2:])
        net = tower.net
    else:
        n = min(n_images, ds.queries_num)
        idx = rng.choice(ds.queries_num, size=n, replace=False)
        images = np.stack([ds.load_query_image(int(i)) for i in idx])
        net = tower
    backbone = cfg.model.backbone
    if backbone not in RESNET_BACKBONES and backbone not in ("vgg16",
                                                             "alexnet"):
        raise NotImplementedError(
            f"dataset netvlad init for backbone={backbone} (JAX raises "
            f"here too)")
    dev = next(net.parameters()).device
    was_training = net.training
    net.backbone.eval()

    def apply_fn(im):
        out = net.backbone(to_device(im, dev))
        return out[0] if backbone in RESNET_BACKBONES else out

    try:
        return initialize_netvlad(
            getattr(net.aggregation, cfg.model.aggregation), apply_fn,
            np.asarray(images), clusters_num=cfg.model.netvlad_clusters,
            seed=seed, init_idx=init_idx)
    finally:
        net.backbone.train(was_training)
