"""The train mix: optimizer steps of both towers back to back, closed loop,
``depth`` steps in flight.

Parameters (``traffic/<name>.json``): ``pool`` (distinct batches, collated
in set-up by the program's ``data.base.collate_train`` from a seeded
synthetic set of the dataset's shapes and staged on the card), ``depth``,
``image_hw`` (the query image), ``tile_hw`` (an aerial tile), ``points``,
``elev_deg``, ``height`` (the LiDAR's clouds), ``area_m`` (the side of the
square the places lie in) and ``positive_m`` (how far a query lies from
its positive tile).  The batch and the negatives are the configuration's
(``train_batch_size``, ``negs_num_per_query``).

Set-up builds the state (``train.step.init_state``) and the step
(``make_train_step``), loads the seeded weights, warms up with one step per
pool batch through the window's own call, and loads the seeded state back
into the same objects (weights, BatchNorm statistics, Adam's moments and
count, the step).  The window then cycles the pool from that state: its
first ``pool`` steps are what the reference follows (their losses, Adam's
first moment after the first step, the parameters after the last of
them), and every window step's loss is read once the window has closed,
a non-finite one counted as failed.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import cell as cells
from portbench.harness import seeded
from portbench.harness.roofline import by_precision
from portbench.harness.window import closed_loop

ADAM_B1 = 0.9


class _Pending:
    def __init__(self, event, loss):
        self.event, self.loss = event, loss

    def done(self):
        """The step's loss, a 0-d tensor on the device (read after the
        window: reading it here would wait for the step behind it)."""
        if self.event is not None:
            self.event.synchronize()
        return self.loss


def voxel_branch(name: str) -> bool:
    """The query tower's voxel branch: its FPN and pooling, and the
    stage-2 fusion's voxel half."""
    return name.startswith(("mm.vox_fe.", "mm.vox_pool.")) or any(
        k in name for k in ("ffn_vox_", "pool_vox_", "proj_vox_fuse_",
                            "proj_fuse_vox_"))


class Places:
    """A synthetic set of the dataset's shapes (``data.base.PlaceDataset``):
    query i and the tiles of its triplet; images and clouds drawn from the
    seed, UTM positions in a square of ``area_m``."""

    def __init__(self, rng: np.random.Generator, n_q: int, n_db: int,
                 p: dict, mean, std):
        h, w = p["image_hw"]
        th, tw = p["tile_hw"]

        def pixels(*shape):
            x = rng.random(shape, dtype=np.float32)
            return ((x - np.float32(mean)) / np.float32(std)).astype(
                np.float32)

        self.q_images = pixels(n_q, h, w, 3)
        self.db_maps = pixels(n_db, 1, th, tw, 3)
        self.clouds = seeded.lidar(rng, n_q, int(p["points"]), p["elev_deg"],
                                   p["height"])
        area = float(p["area_m"])
        self.db_eastnorth = 500000.0 + rng.uniform(0, area, (n_db, 2))
        self.q_eastnorth = np.zeros((n_q, 2))
        self.database_num, self.queries_num = n_db, n_q

    def load_query_image(self, i):
        return self.q_images[i]

    def load_query_points(self, i):
        return self.clouds[i]

    def load_db_maps(self, i):
        return self.db_maps[i]


class Session:
    kind = "train"

    def __init__(self, cell, seed: int, device, extra: Dict = None):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.p = cell.params
        self.cfg = cells.port_config(cell.config, self.kind, extra)
        self.batch = self.cfg.train.train_batch_size
        self.negs = self.cfg.train.negs_num_per_query
        self.enqueued: List[float] = []

    # -- set-up --------------------------------------------------------------
    def _places(self):
        """The places and the pool's triplets [B, 2 + nneg] of global ids:
        query j, its positive (placed ``positive_m`` from it), then
        negatives drawn from the whole set."""
        p, b, nneg = self.p, self.batch, self.negs
        n = int(p["pool"])
        rng = np.random.default_rng([self.seed & seeded.SEED_MASK, 5])
        n_q, n_db = n * b, n * b * (1 + nneg)
        ds = Places(rng, n_q, n_db, p, self.cfg.data.norm_mean,
                    self.cfg.data.norm_std)
        triplets = []
        for k in range(n):
            rows = []
            for j in range(b):
                q = k * b + j
                pos = q * (1 + nneg)
                ang = rng.uniform(0, 2 * np.pi)
                ds.q_eastnorth[q] = ds.db_eastnorth[pos] + float(
                    p["positive_m"]) * np.array([np.cos(ang), np.sin(ang)])
                negs = rng.choice(n_db, size=nneg, replace=False)
                rows.append([q, pos, *negs])
            triplets.append(np.array(rows, np.int64))
        return ds, triplets

    def setup(self) -> None:
        from agplace_tpu_torch.data.base import collate_train
        from agplace_tpu_torch.data.pipeline import map_tensors
        from agplace_tpu_torch.train.step import init_state, make_train_step

        cfg, dev = self.cfg, self.device
        state = init_state(cfg, dev, seed=0)
        shapes = {f"{t}.{k}": tuple(v.shape)
                  for t, mod in (("mm", state.mm), ("db", state.db))
                  for k, v in mod.state_dict().items()}
        self.init = seeded.make_state(shapes, self.seed, dev)
        for t, mod in (("mm", state.mm), ("db", state.db)):
            mod.load_state_dict({k[len(t) + 1:]: v for k, v in
                                 self.init.items() if k.startswith(t + ".")})
        self.param_names = [n for n, _ in state.named_parameters()]
        self.ds, self.triplets = self._places()
        self.angles, batches = [], []
        for k, tri in enumerate(self.triplets):
            seed_k = [self.seed & seeded.SEED_MASK, 11, k]
            deg = cfg.data.pc_rot_aug_deg
            self.angles.append(float(np.random.default_rng(seed_k).uniform(
                -deg, deg)) if deg > 0 else 0.0)
            host = collate_train(self.ds, tri, cfg,
                                 np.random.default_rng(seed_k))
            batches.append(map_tensors(host, lambda t: t.to(dev)))
        self.pool = batches
        self.step_fn = make_train_step(cfg)
        self.state = state
        for k in range(len(self.pool)):  # warm-up: every batch's shapes
            self.step_fn(self.state, self.pool[k])
        self._sync()
        self._reset()

    def _reset(self) -> None:
        """The seeded state loaded back into the same objects: weights,
        BatchNorm statistics, Adam's moments and count, the step."""
        zeros = torch.zeros_like(self.state.opt.lr)
        self.state.load_state_dict({
            "step": 0,
            **{t: {k[len(t) + 1:]: v for k, v in self.init.items()
                   if k.startswith(t + ".")} for t in ("mm", "db")},
            "opt": {"count": 0, "mu": zeros, "nu": zeros}})
        self.taken = 0
        self.losses, self.first_grad = [], None
        self.first_mu = self.after = None
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window ------------------------------------------------------------
    def dispatch(self, i: int):
        """Step ``taken`` from the seeded state (the window's unit i, or a
        profiled sub-window's), on pool batch ``taken`` mod pool.  Before
        the second step it copies Adam's first moment, before step
        ``pool`` the parameters: what the reference is compared with."""
        n = len(self.pool)
        if self.taken == 1:
            self.first_mu = self.state.opt.mu.clone()
        elif self.taken == n:
            self.after = {k: p.detach().clone()
                          for k, p in self.state.named_parameters()}
        t = time.perf_counter()
        metrics = self.step_fn(self.state, self.pool[self.taken % n])
        self.enqueued.append(time.perf_counter() - t)
        self.taken += 1
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return _Pending(event, metrics["loss"])

    def window(self, seconds: float):
        self.enqueued = []
        return closed_loop(self.dispatch, int(self.p["depth"]), seconds,
                           min_units=len(self.pool) + 1)

    def end_to_end(self, w) -> Dict[str, float]:
        return {"triplets_per_s": self.batch * len(w.units) / w.seconds}

    # -- traced-run records ----------------------------------------------------
    def counters(self) -> Dict[str, int]:
        from portbench.harness import profiling

        return profiling.hand_counters()

    def expect(self, delta: Dict[str, int]):
        from portbench.harness import profiling

        return profiling.expected_from_launches(delta)

    def ref_batches(self, device) -> list:
        """The pool's batches as the reference takes them: raw images,
        tiles and positions, and the occupancy grids worked out from the
        raw clouds (turned by the collation's drawn angle)."""
        from portbench.reference.voxels import occupancy, rotate_z

        arch = cells.arch_of(self.cfg)
        out = []
        for tri, ang in zip(self.triplets, self.angles):
            q, dbi = tri[:, 0], tri[:, 1:]
            pts = rotate_z(self.ds.clouds[q], ang) if ang else self.ds.clouds[q]
            occ = occupancy(pts, arch["quant"], arch["capacity"],
                            arch["extent"])
            f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            out.append({
                "query_image": f(self.ds.q_images[q]), "occ": f(occ),
                "query_eastnorth": f(self.ds.q_eastnorth[q].astype(
                    np.float32)),
                "db_map": f(self.ds.db_maps[dbi]),
                "db_eastnorth": f(self.ds.db_eastnorth[dbi].astype(
                    np.float32))})
        return out

    def flops(self) -> Dict[str, float]:
        """FLOPs of one step's forward and backward by the precision the
        configuration computes them in, over the reference on meta."""
        from torch.utils.flop_counter import FlopCounterMode

        from portbench.reference import train as ref_train
        from portbench.reference.model import Reference

        cfg = self.cfg
        prec = cells.precisions(cfg)
        arch = cells.arch_of(cfg)
        ref = Reference(prec, arch)
        ref.training_mode = True
        P = {k: torch.empty(v.shape, device="meta",
                            requires_grad=k in self.param_names)
             for k, v in self.init.items()}
        b, n = self.batch, 1 + self.negs
        h, w = self.p["image_hw"]
        th, tw = self.p["tile_hw"]
        meta = dict(device="meta")
        batch = {"query_image": torch.empty(b, h, w, 3, **meta),
                 "occ": torch.empty(b, *arch["extent"], dtype=torch.bool,
                                    **meta),
                 "query_eastnorth": torch.empty(b, 2, **meta),
                 "db_map": torch.empty(b, n, 1, th, tw, 3, **meta),
                 "db_eastnorth": torch.empty(b, n, 2, **meta)}
        with FlopCounterMode(display=False) as fc:
            ref_train.loss_of(ref, P, batch, self.hyper()).backward()
        return by_precision(fc.get_flop_counts(), prec)

    def layer_record(self, w, trace) -> dict:
        return {"kind": self.kind, "units": len(w.units),
                "window_s": w.seconds, "enqueue_s": self.enqueued,
                "trace": trace, "flops": self.flops(), "hand_work": {}}

    # -- the check ---------------------------------------------------------------
    def hyper(self) -> dict:
        c = self.cfg
        return {"margin": c.train.loss.margin,
                "otherloss_weight": c.train.loss.otherloss_weight,
                "triplet_weight": c.train.loss.tripletloss_weight,
                "pos_thd": c.data.train_positives_dist_threshold,
                "neg_thd": c.data.val_positive_dist_threshold}

    def lrs(self) -> dict:
        t = self.cfg.train
        return {"base": t.lr, "pc": t.lrpc, "db": t.lrdb}

    def free(self) -> None:
        for name in ("state", "step_fn", "pool", "first_mu"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision_of=None, half_batch: bool = False):
        """The reference's (losses, first gradients' norms, leaves after
        the steps), from the seeded weights over the pool's batches."""
        from portbench.reference import train as ref_train
        from portbench.reference.model import Reference

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        prec = cells.precisions(self.cfg)
        if precision_of is not None:
            prec = {g: precision_of(v) for g, v in prec.items()}
        ref = Reference(prec, cells.arch_of(self.cfg))
        params = {n: self.init[n] for n in self.param_names}
        buffers = {n: v for n, v in self.init.items() if n not in params}
        batches = self.ref_batches(self.device)
        hp = self.hyper()
        if half_batch:  # a fault: the loss over the first half only
            half = self.batch // 2
            batches = [{k: v[:half] for k, v in b.items()} for b in batches]
        losses, first, last = ref_train.steps(ref, params, buffers, batches,
                                              hp, self.lrs())
        return losses, {n: float(g.norm()) for n, g in first.items()}, last

    def compare(self, ref_out, prog=None) -> Dict[str, float]:
        """The gaps of the program's numbers (or ``prog``'s) to the
        reference's ``ref_out``: each step's loss (the widest), the first
        gradient's norm by the worst leaf, over every leaf and over the
        leaves outside the voxel branch (whose bf16 convs' rounding,
        amplified by the training-mode BatchNorms over the occupied cells,
        sets the gap of the voxel branch's leaves), and the change after
        the steps by the median leaf.  A leaf's gap is measured against
        the reference's norm of that leaf or of the median leaf, whichever
        is larger; leaves whose reference gradient is under a thousandth
        of the median leaf's move by round-off alone and are left out of
        the change."""
        losses, g_norm, last = prog or (self.losses, self.first_grad,
                                        self.after)
        r_losses, r_g, r_last = ref_out
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
        med_g = float(np.median(list(r_g.values())))
        grad = {n: abs(g_norm[n] - r_g[n]) / max(r_g[n], med_g)
                for n in r_g}
        live = [n for n in r_g if r_g[n] >= 1e-3 * med_g]
        d_prog = {n: float((last[n].to(self.init[n].device)
                            - self.init[n]).norm()) for n in live}
        d_ref = {n: float((r_last[n] - self.init[n]).norm()) for n in live}
        med_d = float(np.median(list(d_ref.values())))
        step = [abs(d_prog[n] - d_ref[n]) / max(d_ref[n], med_d)
                for n in live]
        return {"loss_gap": loss_gap, "grad_gap": max(grad.values()),
                "grad_gap_nonvox": max(v for n, v in grad.items()
                                       if not voxel_branch(n)),
                "step_gap_median": float(np.median(step))}

    def check(self, w) -> Dict[str, float]:
        """The window's first ``pool`` steps against the reference's."""
        self.losses = [float(u.payload) for u in w.units[:len(self.pool)]]
        mu = self.state.opt.per_param(self.first_mu)
        self.first_grad = {n: (mu[n] / (1 - ADAM_B1)).norm().item()
                           for n in self.param_names}
        self.free()
        return self.compare(self.reference())

    def attempted_failed(self, w):
        """The window's steps, and those whose loss is not finite."""
        losses = torch.stack([u.payload for u in w.units]).float().cpu()
        return len(w.units), int((~torch.isfinite(losses)).sum())
