"""K-means by Lloyd's iterations (``agplace_tpu/retrieval/kmeans.py``), the
solver of NetVLAD's and CRN's cluster init (faiss in the reference).

Each iteration is one [N, K] distance product (``knn.pairwise_sq_l2``), a
first-index argmin (``torch.argmin``'s tie rule, JAX's too) and the mean of
each cluster's points; an empty cluster keeps its centroid.  The initial
centroids are distinct points drawn with ``generator``, or the rows
``init_idx`` when given: JAX draws them with ``jax.random.choice``, which
the port does not reproduce, so a comparison passes JAX's draw here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from agplace_tpu_torch.retrieval.knn import pairwise_sq_l2


def kmeans(points: torch.Tensor, n_clusters: int, n_iter: int = 25,
           generator: Optional[torch.Generator] = None,
           init_idx: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points [N, D] fp32 -> (centroids [K, D], assignments [N])."""
    n = points.shape[0]
    if init_idx is None:
        init_idx = torch.randperm(n, generator=generator)[:n_clusters]
    centroids = points[torch.as_tensor(init_idx, device=points.device)]
    for _ in range(n_iter):
        assign = torch.argmin(pairwise_sq_l2(points, centroids), dim=-1)
        one_hot = torch.nn.functional.one_hot(assign, n_clusters).to(
            points.dtype)
        counts = one_hot.sum(dim=0)
        new = (one_hot.T @ points) / torch.clamp(counts[:, None], min=1.0)
        centroids = torch.where(counts[:, None] > 0, new, centroids)
    return centroids, torch.argmin(pairwise_sq_l2(points, centroids), dim=-1)
