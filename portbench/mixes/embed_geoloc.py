"""The GeoLoc embed mix: batches of ground images through a camera-only
GeoLoc tower, closed loop, ``depth`` batches in flight.

The tower is DVGLB's GeoLocalizationNet with the CCT backbone and a NetVLAD
head (``modelq`` geoloc, ``share_qdb``: it embeds queries and tiles alike),
built by ``infer.build_towers`` for square images of the traffic's
``image_hw`` (``q_resize`` = ``db_resize`` = its side) and driven through
``infer.make_infer_fns(...)[0]``, as ``embed``'s query cells drive theirs.

Parameters (``traffic/<name>.json``): ``tower`` ("query"), ``batch``,
``pool``, ``depth``, ``image_hw``, ``check_rows``, ``profile_units``.

Weights come from the seed: ``seeded.make_state``'s initialisers (its
non-trivial LayerNorm affines and biases among them), CCT's own where it
has them (dense kernels N(0, 0.02^2), the positional embedding N(0,
0.2^2)), the tokenizer's filters centred, and NetVLAD's clusters as DVGLB
initialises them from its training images: k-means of the L2-normalised
descriptors of the pool's first images (the reference's fp32 tokens), the
assignment weights alpha times the normalised centroids, alpha = -ln(0.01)
over the mean gap between each descriptor's two nearest centroids.

Why not ``make_state`` alone: random filters pass the ReLU / max-pool
map's positive mean on as a vector every token shares (mean cosine 0.96
between tokens), and dense kernels at LeCun's scale let each layer's
attention average it in, until after 14 layers the tokens' mean cosine is
0.9999; NetVLAD's residuals then measure rounding alone (alpha ~3e5, bf16
against itself 54 % apart).  Centred filters and CCT's dense scale leave
the tokens as diverse as a trained tower's (mean cosine 0.46, alpha ~150),
and the program agrees with the reference to ~1 % where the fp8 control
reads ~75 % (CPU runs of the reference at the cell's widths, 8 images).

The configuration serves the tower in its ``compute_dtype``.  Set-up
runs the first batch through the entry and counts the dtypes of the products
it computes; a program none of whose products takes that dtype (one
whose GeoLoc tower ignores ``compute_dtype`` and runs fp32) cannot run
the configuration, and set-up raises before any window.

A batch is complete when its descriptors are in the pinned host buffer;
the harness then keeps each row's finiteness (a row sum: the rows are
L2-normalised) and two rows drawn from the seed, the check's candidates,
where ``embed`` copies the whole batch into fresh host memory: at
24,576-d that copy (7.5 GB over a window) took 6.6-7.6 ms a batch with a
tail to 40 ms from page faults, and set the cell's p95 (a quartile
spread of 2.6 % over four fresh runs, 1.0 % without it, on an H100).

In a traced run the program's spans are on while the profiler records
(``dispatch`` turns them on and off); ``layer_record`` takes their device
rows out of the trace and reads from them the device time under
``geoloc.encoder`` and ``geoloc.attn``.  A profile is whole when it holds
one LayerNorm kernel per call of a LayerNorm module of the tower (hooks
count them: two a layer and the final one) and, where the program opened
spans, one device row per span opened.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict

import numpy as np
import torch

from portbench.harness import geoloc, seeded
from portbench.harness.window import closed_loop
from portbench.mixes import embed
from portbench.reference.geoloc import BACKBONE, VLAD, GeoLocReference, l2n
from portbench.reference.geoloc import flops as reference_flops

CCT_HEADS = 6  # cct_14_7x2_384's heads of 64 at width 384
POS_STD = 0.2  # CCT's positional embedding initialiser
DENSE_STD = 0.02  # CCT's dense kernels' initialiser
VLAD_IMAGES = 8  # pool images whose descriptors place the clusters
KMEANS_ITERS = 20
VLAD_BLOCK = 8  # clusters a block in the reference's NetVLAD
KEEP_ROWS = 2  # rows of each batch kept as the check's candidates
# PyTorch's LayerNorm kernel at the tower's widths (one per module call;
# the card's profiles: 29 vectorized_layer_norm_kernel a 14-layer forward)
LAYER_NORM = r"layer_norm_kernel"


def arch_of(cfg) -> dict:
    """The numbers of the configuration the reference reads.  Raises for a
    tower the reference does not implement."""
    m = cfg.model
    want = dict(modelq="geoloc", backbone="cct384", aggregation="netvlad",
                fc_output_dim=None, share_qdb=True)
    for key, value in want.items():
        if getattr(m, key) != value:
            raise NotImplementedError(f"the GeoLoc reference implements "
                                      f"model.{key}={value!r}, not "
                                      f"{getattr(m, key)!r}")
    return {"layers": m.trunc_te or 14, "heads": CCT_HEADS,
            "vlad_block": VLAD_BLOCK}


def make_state(shapes: Dict[str, tuple], seed: int, device
               ) -> Dict[str, torch.Tensor]:
    """``seeded.make_state``, then CCT's own initialisers where it has
    them (SHI-Labs' ``_init_weight``): every dense kernel N(0, 0.02^2), the
    positional embedding N(0, 0.2^2); and each tokenizer filter centred
    (its taps sum to zero)."""
    state = seeded.make_state({k: s for k, s in shapes.items()
                               if k != BACKBONE + "pos"}, seed, device)
    g = seeded.generator(seed, 4, device)
    for k, s in shapes.items():
        if k == BACKBONE + "pos":
            state[k] = POS_STD * torch.randn(s, generator=g, device=device)
        elif k.startswith(BACKBONE) and k.endswith(".weight"):
            if len(s) == 2:
                state[k] = DENSE_STD * torch.randn(s, generator=g,
                                                   device=device)
            elif len(s) == 4:
                state[k] = state[k] - state[k].mean(dim=(1, 2, 3),
                                                    keepdim=True)
    return state


def kmeans(x: torch.Tensor, k: int, iters: int,
           g: torch.Generator) -> torch.Tensor:
    """Lloyd's k-means of the rows of ``x`` from ``k`` distinct rows drawn
    by ``g``; sums by one-hot products, so a run repeats exactly."""
    if x.shape[0] < k:
        raise ValueError(f"{x.shape[0]} descriptors for {k} clusters")
    c = x[torch.randperm(x.shape[0], generator=g, device=x.device)[:k]]
    for _ in range(iters):
        near = (x @ c.T - 0.5 * (c * c).sum(dim=1)).argmax(dim=1)
        onehot = torch.nn.functional.one_hot(near, k).float()
        n = onehot.sum(dim=0)
        c = torch.where(n[:, None] > 0, (onehot.T @ x) / n.clamp(
            min=1.0)[:, None], c)
    return c


def place_clusters(state: Dict[str, torch.Tensor], arch: dict, images,
                   seed: int) -> None:
    """NetVLAD's centroids and assignment weights in ``state``, from
    k-means of the reference's fp32 descriptors of ``images``."""
    ref = GeoLocReference("float32", arch)
    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=True, deterministic=True, allow_tf32=False):
        x = l2n(ref.encode(state, images))
    x = x.reshape(-1, x.shape[-1])
    c = kmeans(x, state[VLAD + "centroids"].shape[0], KMEANS_ITERS,
               seeded.generator(seed, 5, x.device))
    c_assign = l2n(c)
    dots = torch.sort(c_assign @ x.T, dim=0, descending=True).values
    alpha = -math.log(0.01) / float((dots[0] - dots[1]).mean())
    state[VLAD + "centroids"] = c.contiguous()
    state[VLAD + "assign_w"] = (alpha * c_assign).T.contiguous()


class _Rows:
    """What the harness keeps of a batch: each row's finiteness, and the
    rows ``rows`` ({index: descriptor}) that the check may sample."""

    def __init__(self, rows: Dict[int, np.ndarray], finite: np.ndarray):
        self.rows, self.finite = rows, finite

    def __getitem__(self, r: int) -> np.ndarray:
        return self.rows[r]


class _Kept:
    def __init__(self, pending, keep):
        self.pending, self.keep = pending, keep

    def done(self) -> _Rows:
        if self.pending.event is not None:
            self.pending.event.synchronize()
        host = self.pending.buf.numpy()
        return _Rows({int(r): host[r].copy() for r in self.keep},
                     np.isfinite(host.sum(axis=-1)))


class Session(embed.Session):
    def __init__(self, cell, seed: int, device, extra: Dict = None):
        h, w = cell.params["image_hw"]
        if h != w:
            raise ValueError(f"image_hw {h} x {w}: the GeoLoc tower is "
                             f"built for square images")
        if cell.params["tower"] != "query":
            raise ValueError("the GeoLoc mix drives the query entry")
        super().__init__(cell, seed, device, {
            **(extra or {}), "data.q_resize": h, "data.db_resize": h})
        self.arch = arch_of(self.cfg)
        self.precision = self.cfg.model.compute_dtype
        self.layer_norms = 0
        self.span_calls: Counter = Counter()

    # -- set-up --------------------------------------------------------------
    def setup(self) -> None:
        from agplace_tpu_torch.infer import build_towers, make_infer_fns
        from agplace_tpu_torch.models.layers import LayerNorm
        from agplace_tpu_torch.utils import spans

        self.spans = spans
        cfg, dev, p = self.cfg, self.device, self.p
        mm, _ = build_towers(cfg, dev, None)
        self.state = make_state({"mm." + k: tuple(v.shape)
                                 for k, v in mm.state_dict().items()},
                                self.seed, dev)
        g = seeded.generator(self.seed, 2, dev)
        h, w = p["image_hw"]
        self.images = [seeded.images(g, (self.batch, h, w, 3),
                                     cfg.data.norm_mean, cfg.data.norm_std,
                                     dev) for _ in range(int(p["pool"]))]
        place_clusters(self.state, self.arch, self.images[0][:VLAD_IMAGES],
                       self.seed)
        mm.load_state_dict({k[3:]: v for k, v in self.state.items()})
        for m in mm.modules():
            if isinstance(m, LayerNorm):
                m.register_forward_hook(self._count_layer_norm)
        self.towers = (mm, None)
        embed_q, _ = make_infer_fns(mm, None)
        geoloc.require_precision(geoloc.product_dtypes(
            lambda: embed_q(self.images[0], None)), self.precision)
        self.entry = lambda k: embed_q(self.images[k], None)
        out = self.entry(0)
        self._sync()
        self.bufs = [torch.empty(out.shape, dtype=out.dtype,
                                 pin_memory=dev.type == "cuda")
                     for _ in range(int(p["depth"]))]
        closed_loop(self.dispatch, int(p["depth"]), 0.0,
                    max_units=2 * int(p["pool"]))

    def _count_layer_norm(self, *_):
        self.layer_norms += 1

    # -- the window ------------------------------------------------------------
    def dispatch(self, i: int):
        self.spans.enable(torch.autograd._profiler_enabled())
        rng = np.random.default_rng([self.seed & seeded.SEED_MASK, 11, i])
        keep = rng.choice(self.batch, min(KEEP_ROWS, self.batch),
                          replace=False)
        return _Kept(super().dispatch(i), keep)

    # -- traced-run records ----------------------------------------------------
    def counters(self) -> Dict[str, int]:
        self.span_calls.update(self.spans.drain().calls)
        return dict(self.span_calls, layer_norms=self.layer_norms)

    def expect(self, delta: Dict[str, int]):
        if not delta.get("layer_norms"):
            return None
        return [(LAYER_NORM, delta["layer_norms"])] + [
            (f"^{re.escape(name)}$", n) for name, n in sorted(delta.items())
            if name != "layer_norms" and n]

    def flops(self) -> Dict[str, float]:
        """FLOPs of one batch at the configuration's precision, counted over
        the reference on the meta device."""
        from torch.utils.flop_counter import FlopCounterMode

        ref = GeoLocReference(self.precision, self.arch)
        P = {k: torch.empty(v.shape, device="meta")
             for k, v in self.state.items()}
        h, w = self.p["image_hw"]
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            ref(P, torch.empty(self.batch, h, w, 3, device="meta"))
        peak = "bfloat16" if self.precision == "bfloat16" else "float32"
        return {peak: reference_flops(fc.get_flop_counts())}

    def hand_work(self) -> Dict[str, list]:
        return {}

    def layer_record(self, w, trace) -> dict:
        self.spans.enable(False)
        rows = [] if trace is None else geoloc.split_rows(trace,
                                                          self.spans.NAMES)
        rec = super().layer_record(w, trace)
        pos = self.state[BACKBONE + "pos"]
        tokens, width = pos.shape[1], pos.shape[2]
        heads = self.arch["heads"]
        work = geoloc.attention_core_work(self.batch, heads, tokens,
                                          width // heads, self.precision)
        rec["span_device_s"] = ({} if trace is None else
                                geoloc.device_s_under(trace, rows))
        rec["attn_bound_s"] = self.arch["layers"] * work.bound_s
        return rec

    # -- the check ---------------------------------------------------------------
    def sample(self, w):
        """(unit, row) pairs among the rows the window kept, drawn from the
        seed."""
        kept = [(u, r) for u, unit in enumerate(w.units)
                for r in sorted(unit.payload.rows)]
        rng = np.random.default_rng([self.seed & seeded.SEED_MASK, 7])
        pick = rng.choice(len(kept), size=min(int(self.p["check_rows"]),
                                              len(kept)), replace=False)
        return sorted(kept[int(j)] for j in pick)

    def attempted_failed(self, w):
        return (len(w.units) * self.batch,
                sum(int((~u.payload.finite).sum()) for u in w.units))

    def reference_rows(self, k: int, rows: np.ndarray,
                       precision_of=None) -> torch.Tensor:
        prec = (self.precision if precision_of is None
                else precision_of(self.precision))
        ref = GeoLocReference(prec, self.arch)
        idx = torch.as_tensor(rows, device=self.device)
        with torch.no_grad():
            return ref(self.state, self.images[k][idx]).float()
