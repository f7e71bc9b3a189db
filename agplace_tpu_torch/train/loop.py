"""The training loop (``agplace_tpu/train/loop.py``).

Per epoch: ``ceil(queries_per_epoch / cache_refresh_rate)`` mining rounds,
each mining triplets with the current towers and then running the train
step over the mined batches (collated by ``Prefetcher`` threads, two
batches in flight to the device); the losses stay on the device and are
fetched once per round.  After each epoch: ``evaluate`` (Recall@N), the
best epoch by R@1 + R@5 + R@10, and a checkpoint when the epoch is past
``checkpoint_after_epoch`` or the best.

When it builds the initial state, the port needs no sample batch, so
unlike JAX's loop it mines and collates no warm-up batch first: such a run
draws from its numpy generator in another order than a JAX run of the same
seed (given a state, both draw alike).
"""

from __future__ import annotations

import logging
import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from agplace_tpu_torch.config import Config
from agplace_tpu_torch.data.base import PlaceDataset, collate_train
from agplace_tpu_torch.data.pipeline import Prefetcher, prefetch_to_device
from agplace_tpu_torch.device import resolve_device
from agplace_tpu_torch.evaluate import evaluate
from agplace_tpu_torch.infer import make_infer_fns
from agplace_tpu_torch.train.checkpoint import CheckpointManager
from agplace_tpu_torch.train.mining import TripletMiner
from agplace_tpu_torch.train.state import TrainState
from agplace_tpu_torch.train.step import (check_supported, init_state,
                                          make_train_step)
from agplace_tpu_torch.utils.common import (MetricsWriter, PhaseTimer,
                                            ProfilerTrace, count_params)


def train(cfg: Config, train_ds: PlaceDataset, test_ds: PlaceDataset,
          state: Optional[TrainState] = None,
          max_steps: Optional[int] = None, results_logger=None,
          device="cuda") -> Dict:
    """Run the training loop on ``device`` (the card unless the caller
    passes ``"cpu"``); returns the final state, the per-epoch history, the
    best [R@1, R@5, R@10, epoch] and the phase times."""
    log = logging.getLogger("train")
    device = resolve_device(device)
    check_supported(cfg)
    t = cfg.train
    rng = np.random.default_rng(t.seed)
    metrics_out = MetricsWriter(f"{t.save_dir}/metrics.jsonl")
    timer = PhaseTimer()
    miner = TripletMiner(cfg, train_ds, device)
    train_step = make_train_step(cfg)
    if state is None:
        state = init_state(cfg, device)
    log.info("params: %d", count_params(state.named_parameters()))

    ckpt = CheckpointManager(t.save_dir)
    start_epoch = 0
    best = [0.0, 0.0, 0.0, 0]  # R@1, R@5, R@10, epoch
    best_r5 = 0.0
    not_improved_num = 0
    if t.resume:
        state, meta = ckpt.restore(t.resume, state)
        start_epoch = int(meta["epoch_num"]) + 1
        best_r5 = float(meta["best_r5"])
        not_improved_num = int(meta["not_improved_num"])
        log.info("resumed from %s at epoch %d", t.resume, start_epoch)

    history = []
    steps_done = 0
    trace = None
    bs = t.train_batch_size
    for epoch in range(start_epoch, t.epochs_num):
        t0 = time.time()
        epoch_losses = []
        for _ in range(math.ceil(t.queries_per_epoch / t.cache_refresh_rate)):
            with timer("mining"):
                triplets = miner.mine(rng, t.cache_refresh_rate,
                                      state.towers)
            n_batches = len(triplets) // bs
            seeds = rng.integers(0, 2 ** 31, size=n_batches)
            loader = Prefetcher(
                [(triplets[b * bs:(b + 1) * bs], seeds[b])
                 for b in range(n_batches)],
                lambda it: collate_train(train_ds, it[0], cfg,
                                         np.random.default_rng(it[1])),
                num_workers=cfg.data.num_workers)
            round_losses = []
            with timer("train"):
                for batch in prefetch_to_device(loader, device):
                    if (t.profile_steps > 0 and steps_done == 0
                            and epoch == start_epoch):
                        trace = ProfilerTrace(f"{t.save_dir}/profile")
                    round_losses.append(train_step(state, batch)["loss"])
                    steps_done += 1
                    if trace is not None and steps_done >= t.profile_steps:
                        log.info("profiler trace written to %s",
                                 trace.stop())
                        trace = None
                    if max_steps is not None and steps_done >= max_steps:
                        break
            # one host sync per mining round, outside the step loop
            if round_losses:
                epoch_losses += torch.stack(round_losses).cpu().tolist()
            if max_steps is not None and steps_done >= max_steps:
                break

        with timer("eval"):
            for tower in state.towers:
                tower.eval()
            recalls, recalls_str = evaluate(
                cfg, test_ds, *make_infer_fns(*state.towers), device=device)
        mean_loss = float(np.mean(epoch_losses)) if epoch_losses else 0.0
        is_best = sum(recalls[:3]) > sum(best[:3])
        if is_best:
            best = [recalls[0], recalls[1], recalls[2], epoch]
            not_improved_num = 0
        else:
            not_improved_num += 1
        best_r5 = max(best_r5, float(recalls[1]))
        log.info("epoch %d: loss=%.4f %s (best ep %d) [%.1fs]", epoch,
                 mean_loss, recalls_str, best[3], time.time() - t0)
        if results_logger is not None:
            results_logger.info(
                f"epoch {epoch}: loss={mean_loss:.4f} {recalls_str}")
        metrics_out.write({
            "epoch": epoch, "loss": mean_loss, "losses": epoch_losses,
            "recalls": recalls.tolist(), "is_best": is_best,
            "steps": state.step, "phase_times": dict(timer.totals),
        })
        history.append({"epoch": epoch, "loss": mean_loss,
                        "losses": epoch_losses, "recalls": recalls})
        if epoch > t.checkpoint_after_epoch or is_best:
            ckpt.save(state, epoch, recalls, best_r5=best_r5,
                      not_improved_num=not_improved_num, is_best=is_best)
        if max_steps is not None and steps_done >= max_steps:
            break

    if trace is not None:  # training ended before profile_steps
        log.info("profiler trace written to %s", trace.stop())
    return {"state": state, "history": history, "best": best,
            "phase_times": dict(timer.totals)}
