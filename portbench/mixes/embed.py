"""The embed mix: batches of queries (or aerial tiles) through one tower,
closed loop, ``depth`` batches in flight.

Parameters (``traffic/<name>.json``): ``tower`` ("query" or "aerial"),
``batch``, ``pool`` (distinct batches made in set-up and cycled, so
consecutive inputs always differ), ``depth``, ``image_hw`` (the query
image or the tile as the reader feeds it), and for queries ``points``,
``elev_deg`` and ``height`` (the LiDAR's clouds), ``check_rows`` (rows of
the window's descriptors the reference recomputes).

The entry driven is ``infer.make_infer_fns(...)[0]`` (``embed_queries``)
or ``[1]`` (``embed_db``); each batch's descriptors are copied to pinned
host memory, as ``embed.drain`` fetches them, and a unit is complete when
that copy is.
"""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import cell as cells
from portbench.harness import roofline, seeded
from portbench.harness.roofline import by_precision
from portbench.harness.window import closed_loop, percentile

# pool inputs whose moments set the BatchNorms' running statistics
BN_ROWS = 8
# sampled rows the reference recomputes at a time
CHECK_BLOCK = 16


class _Pending:
    def __init__(self, event, buf):
        self.event, self.buf = event, buf

    def done(self):
        if self.event is not None:
            self.event.synchronize()
        return self.buf.numpy().copy()


class Session:
    kind = "embed"

    def __init__(self, cell, seed: int, device, extra: Dict = None):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.p = cell.params
        self.cfg = cells.port_config(cell.config, self.kind, extra)
        self.query = self.p["tower"] == "query"
        self.batch = int(self.p["batch"])
        self.enqueue_s: List[float] = []
        self.conv_calls = 0

    # -- set-up --------------------------------------------------------------
    def setup(self) -> None:
        from agplace_tpu_torch.data.voxels import prepare_query_vox
        from agplace_tpu_torch.infer import build_towers, make_infer_fns

        cfg, dev, p = self.cfg, self.device, self.p
        mm, db = build_towers(cfg, dev, None)
        shapes = {f"{t}.{k}": tuple(v.shape)
                  for t, mod in (("mm", mm), ("db", db))
                  for k, v in mod.state_dict().items()}
        self.state = seeded.make_state(shapes, self.seed, dev)
        g = seeded.generator(self.seed, 2, dev)
        h, w = p["image_hw"]
        mean, std = cfg.data.norm_mean, cfg.data.norm_std
        n = int(p["pool"])
        if self.query:
            rng = np.random.default_rng([self.seed & seeded.SEED_MASK, 3])
            self.images = [seeded.images(g, (self.batch, h, w, 3), mean, std,
                                         dev) for _ in range(n)]
            self.clouds = [seeded.lidar(rng, self.batch, int(p["points"]),
                                        p["elev_deg"], p["height"])
                           for _ in range(n)]
        else:
            self.images = [seeded.images(g, (self.batch, 1, h, w, 3), mean,
                                         std, dev) for _ in range(n)]
        self._running_stats(BN_ROWS)
        for t, mod in (("mm", mm), ("db", db)):
            mod.load_state_dict({k[len(t) + 1:]: v for k, v in
                                 self.state.items() if k.startswith(t + ".")})
        self.towers = (mm, db)
        embed_q, embed_db = make_infer_fns(mm, db)
        if self.query:
            self.vox = [prepare_query_vox(cfg, c, dev) for c in self.clouds]
            self.entry = lambda k: embed_q(self.images[k], self.vox[k])
        else:
            self.entry = lambda k: embed_db(self.images[k])
            self._count_convs(db)
        out = self.entry(0)
        self._sync()
        self.bufs = [torch.empty(out.shape, dtype=out.dtype,
                                 pin_memory=dev.type == "cuda")
                     for _ in range(int(p["depth"]))]
        closed_loop(self.dispatch, int(p["depth"]), 0.0,
                    max_units=2 * n)  # every pool batch through the loop

    def _running_stats(self, rows: int) -> None:
        """Every BatchNorm's running statistics set to the moments of its
        input over the first ``rows`` inputs of the pool, from a
        training-mode pass of the reference (as a trained tower's
        statistics match its data): each branch then reaches the
        descriptor at its trained scale, none drowned by another's."""
        from portbench.reference.model import Reference
        from portbench.reference.voxels import occupancy

        arch = cells.arch_of(self.cfg)
        ref = Reference(cells.precisions(self.cfg), arch)
        ref.training_mode, ref.record = True, {}
        tower = "mm." if self.query else "db."
        with torch.no_grad():
            if self.query:
                occ = torch.from_numpy(occupancy(
                    self.clouds[0][:rows], arch["quant"], arch["capacity"],
                    arch["extent"])).to(self.device)
                ref.query_tower(self.state, self.images[0][:rows], occ)
            else:
                ref.aerial_tower(self.state, self.images[0][:rows])
        for name, (m, v) in ref.record.items():
            if name.startswith(tower):
                self.state[name + ".running_mean"] = m.contiguous()
                self.state[name + ".running_var"] = v.contiguous()

    def _count_convs(self, tower) -> None:
        from agplace_tpu_torch.models.layers import Conv2d

        def hook(*_):
            self.conv_calls += 1

        for m in tower.modules():
            if isinstance(m, Conv2d):
                m.register_forward_hook(hook)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window ------------------------------------------------------------
    def dispatch(self, i: int):
        import time

        k = i % int(self.p["pool"])
        t = time.perf_counter()
        out = self.entry(k)
        self.enqueue_s.append(time.perf_counter() - t)
        buf = self.bufs[i % len(self.bufs)]
        buf.copy_(out, non_blocking=self.device.type == "cuda")
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return _Pending(event, buf)

    def window(self, seconds: float):
        self.enqueue_s = []
        w = closed_loop(self.dispatch, int(self.p["depth"]), seconds)
        self.enqueued = list(self.enqueue_s)
        return w

    def units(self, w) -> int:
        return len(w.units)

    def end_to_end(self, w) -> Dict[str, float]:
        return {"desc_per_s": self.batch * len(w.units) / w.seconds,
                "embed_p95_ms": 1e3 * percentile(w.latencies_s(), 95)}

    # -- traced-run records ----------------------------------------------------
    def counters(self) -> Dict[str, int]:
        from portbench.harness import profiling

        return dict(profiling.hand_counters(), conv_calls=self.conv_calls)

    def expect(self, delta: Dict[str, int]):
        from portbench.harness import profiling

        if self.query:
            return profiling.expected_from_launches(
                {k: n for k, n in delta.items() if k != "conv_calls"})
        return [(CONV_KERNELS, delta["conv_calls"])]

    def flops(self) -> Dict[str, float]:
        """FLOPs of one batch by the precision the configuration computes
        them in, counted over the reference on the meta device."""
        from torch.utils.flop_counter import FlopCounterMode

        from portbench.reference.model import Reference

        cfg, b = self.cfg, self.batch
        prec = cells.precisions(cfg)
        ref = Reference(prec, cells.arch_of(cfg))
        P = {k: torch.empty(v.shape, device="meta") for k, v in
             self.state.items()}
        h, w = self.p["image_hw"]
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            if self.query:
                ref.query_tower(P, torch.empty(b, h, w, 3, device="meta"),
                                torch.empty(b, *cells.arch_of(cfg)["extent"],
                                            dtype=torch.bool, device="meta"))
            else:
                ref.aerial_tower(P, torch.empty(b, 1, h, w, 3,
                                                device="meta"))
        return by_precision(fc.get_flop_counts(), prec)

    def hand_work(self) -> Dict[str, list]:
        if not self.query:
            return {}
        m = self.cfg.model.mm
        return roofline.mm_hand_work(self.batch, m.vox_grid_extent,
                                     m.voxfe_planes, m.stg2fuse_dim,
                                     round(1.0 / m.ode.step_size))

    def layer_record(self, w, trace) -> dict:
        return {"kind": self.kind, "units": len(w.units),
                "window_s": w.seconds,
                "enqueue_s": self.enqueued, "trace": trace,
                "flops": self.flops(), "hand_work": self.hand_work()}

    # -- the check ---------------------------------------------------------------
    def free(self) -> None:
        for name in ("towers", "vox", "entry", "bufs"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_rows(self, k: int, rows: np.ndarray,
                       precision_of=None) -> torch.Tensor:
        from portbench.reference.model import Reference
        from portbench.reference.voxels import occupancy

        cfg = self.cfg
        prec = cells.precisions(cfg)
        if precision_of is not None:
            prec = {g: precision_of(v) for g, v in prec.items()}
        arch = cells.arch_of(cfg)
        ref = Reference(prec, arch)
        idx = torch.as_tensor(rows, device=self.device)
        with torch.no_grad():
            if self.query:
                occ = torch.from_numpy(occupancy(
                    self.clouds[k][rows], arch["quant"], arch["capacity"],
                    arch["extent"])).to(self.device)
                return ref.query_tower(self.state, self.images[k][idx],
                                       occ)["embedding"].float()
            return ref.aerial_tower(self.state, self.images[k][idx]).float()

    def sample(self, w):
        """(unit, row) pairs of the window's descriptors, drawn from the
        seed."""
        n = len(w.units) * self.batch
        rng = np.random.default_rng([self.seed & seeded.SEED_MASK, 7])
        pick = rng.choice(n, size=min(int(self.p["check_rows"]), n),
                          replace=False)
        return sorted((int(r) // self.batch, int(r) % self.batch)
                      for r in pick)

    def compare(self, w, control=None) -> Dict[str, float]:
        """The widest relative L2 gap, over the sampled rows, between the
        window's descriptors and the reference's.  With ``control`` (a map
        of the stated precisions to lower ones) the reference computed so
        takes the program's place: the control."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        by_pool: Dict[int, list] = {}
        for u, r in self.sample(w):
            by_pool.setdefault(w.units[u].index % int(self.p["pool"]),
                               []).append((u, r))
        worst = 0.0
        for k, picks in sorted(by_pool.items()):
            for s in range(0, len(picks), CHECK_BLOCK):
                part = picks[s:s + CHECK_BLOCK]
                rows = np.array([r for _, r in part])
                want = self.reference_rows(k, rows).cpu()
                if control is None:
                    got = torch.from_numpy(np.stack(
                        [w.units[u].payload[r] for u, r in part])).float()
                else:
                    got = self.reference_rows(k, rows, control).cpu()
                if not torch.isfinite(got).all():
                    return {"desc_rel_err": float("inf")}
                gap = (torch.linalg.vector_norm(got - want, dim=-1)
                       / torch.linalg.vector_norm(want, dim=-1))
                worst = max(worst, float(gap.max()))
        return {"desc_rel_err": worst}

    def check(self, w) -> Dict[str, float]:
        self.free()
        return self.compare(w)

    def attempted_failed(self, w):
        rows = len(w.units) * self.batch
        bad = sum(int((~np.isfinite(u.payload)).any(axis=-1).sum())
                  for u in w.units)
        return rows, bad


# cuDNN's forward-convolution kernels: one per conv module call (the card's
# profiles of the aerial tower: 15 calls, 15 kernels named *fprop*, beside
# cuDNN's padding helpers and cuBLAS's GEMMs of the dense layers)
CONV_KERNELS = r"fprop"
