"""LiDAR / retrieval figures (``agplace_tpu/utils/viz.py``): the port's own
copy, matplotlib with the Agg backend, the same figures as JAX's
(3-D scatter of point clouds; a query beside its top-k tiles with
green / red borders), written to PNG."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def viz_lidar(pc_list: Sequence[np.ndarray],
              colors: Optional[Sequence] = None,
              out_path: str = "lidar.png", elev: float = 35.0,
              azim: float = -60.0) -> str:
    """Render one or more point clouds to a PNG (matplotlib 3D scatter).
    NaN-padded rows are dropped.  Returns the output path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    default_colors = ["tab:blue", "tab:orange", "tab:green", "tab:red"]
    for i, pc in enumerate(pc_list):
        pc = np.asarray(pc)
        pc = pc[np.all(np.isfinite(pc), axis=-1)]
        c = (colors[i] if colors is not None
             else default_colors[i % len(default_colors)])
        ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], s=0.5, c=c)
    ax.view_init(elev=elev, azim=azim)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def viz_retrievals(query_img: np.ndarray, retrieved: Sequence[np.ndarray],
                   correct: Sequence[bool], out_path: str = "retrievals.png"
                   ) -> str:
    """Query + top-k retrieved tiles side by side, green/red borders."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = 1 + len(retrieved)
    fig, axes = plt.subplots(1, n, figsize=(2.2 * n, 2.6), squeeze=False)
    axes = axes[0]  # n == 1 (no retrievals) still indexes fine
    def show(ax, img, title, color=None):
        img = np.asarray(img)
        lo, hi = img.min(), img.max()
        ax.imshow((img - lo) / max(hi - lo, 1e-6))
        ax.set_title(title, fontsize=9)
        ax.set_xticks([]); ax.set_yticks([])
        if color:
            for s in ax.spines.values():
                s.set_edgecolor(color); s.set_linewidth(3)
    show(axes[0], query_img, "query")
    for i, (img, ok) in enumerate(zip(retrieved, correct)):
        show(axes[i + 1], img, f"top-{i + 1}",
             "green" if ok else "red")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
