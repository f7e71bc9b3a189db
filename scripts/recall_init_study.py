"""Loss and recall curves of the training recipe of
``tests/test_train.py::test_end_to_end_training_improves_recall`` (tiny
synthetic world, 7 epochs of 16 queries, learning rates 1e-3) from several
initial weights, on the CPU, in both packages:

* the port from JAX's ``init_state`` at key 0 (converted), as its slow
  test ``tests/test_torch_port_train_loop.py`` starts;
* the port from its own ``init_state`` at seeds ``--port-seeds``;
* JAX from the port's weights at ``--jax-from-port-seed`` (converted the
  other way), to tell the recipe's noise from a fault of the port.

Each run prints one JSON line: its name, the untrained R@5, and per epoch
the mined loss and R@5.

    JAX_PLATFORMS=cpu python scripts/recall_init_study.py \\
        --port-seeds 0 1 2 3 --jax-from-port-seed 0
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RECIPE = dict(epochs_num=7, queries_per_epoch=16, cache_refresh_rate=8,
              lr=1e-3, lrpc=1e-3, lrdb=1e-3)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(save_dir):
    from agplace_tpu import config as jax_config
    from agplace_tpu_torch import config

    kw = dict(batch_size=2, image_size=32, vox_max_points=128)
    out = []
    for mod in (jax_config, config):
        cfg = mod.synthetic_config(**kw)
        out.append(cfg.replace(
            model=dataclasses.replace(cfg.model, pretrained=False),
            data=dataclasses.replace(cfg.data, num_workers=2),
            train=dataclasses.replace(cfg.train, save_dir=save_dir,
                                      **RECIPE)))
    return out


def _worlds():
    from agplace_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
    from agplace_tpu_torch.data.synthetic import SyntheticDataset

    return ((JaxSynthetic(n_db=24, n_q=16, image_size=32, seed=0),
             JaxSynthetic(n_db=24, n_q=12, image_size=32, seed=1)),
            (SyntheticDataset(n_db=24, n_q=16, image_size=32, seed=0),
             SyntheticDataset(n_db=24, n_q=12, image_size=32, seed=1)))


def _jax_state(cfg_j, ds_j):
    """JAX's ``init_state`` at key 0, on the batch its test builds."""
    import jax

    from agplace_tpu.data.base import collate_train
    from agplace_tpu.train.mining import TripletMiner
    from agplace_tpu.train.step import init_state

    rng = np.random.default_rng(0)
    rows = TripletMiner(cfg_j, ds_j).mine_random(rng, 2)
    batch = collate_train(ds_j, rows, cfg_j, rng)
    return init_state(cfg_j, jax.random.PRNGKey(0), batch)


def _to_flax(template, module):
    """The port module's weights as a flax tree shaped like ``template``
    (the inverse of ``utils/convert.jax_to_state_dict``)."""
    sd = {k: v.detach().numpy() for k, v in module.state_dict().items()}
    rename = {"scale": "weight", "mean": "running_mean",
              "var": "running_var"}

    def walk(tree, scope):
        out = {}
        for name, leaf in tree.items():
            if hasattr(leaf, "items"):
                out[name] = walk(leaf, scope + (name,))
                continue
            base = ".".join(scope) + ("." if scope else "")
            if name == "kernel" and base + "weight" in sd:
                arr = sd[base + "weight"]
                arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            else:
                arr = sd[base + rename.get(name, name)]
            assert arr.shape == np.shape(leaf), (scope, name)
            out[name] = np.ascontiguousarray(arr)
        return out
    return {coll: walk(template[coll], ()) for coll in template}


def _record(name, r0, history):
    print(json.dumps({
        "run": name, "r5_untrained": float(r0[1]),
        "loss": [float(h["loss"]) for h in history],
        "r5": [float(h["recalls"][1]) for h in history]}), flush=True)


def _own_dir(cfg, name):
    """``cfg`` checkpointing under its own directory of the git-ignored
    ``_runs/`` (the two packages' checkpoints share names)."""
    d = os.path.join(ROOT, "_runs", "recall_init_study",
                     "".join(c if c.isalnum() else "_" for c in name))
    return cfg.replace(train=dataclasses.replace(cfg.train, save_dir=d))


def run_port(name, cfg, worlds, state):
    from agplace_tpu_torch.evaluate import evaluate
    from agplace_tpu_torch.infer import make_infer_fns
    from agplace_tpu_torch.train.loop import train

    train_ds, test_ds = worlds
    cfg = _own_dir(cfg, name)
    r0, _ = evaluate(cfg, test_ds, *make_infer_fns(*state.towers),
                     device="cpu")
    out = train(cfg, train_ds, test_ds, state=state, device="cpu")
    shutil.rmtree(cfg.train.save_dir)  # the checkpoints serve no reader
    _record(name, r0, out["history"])


def run_jax(name, cfg_j, worlds_j, state_j):
    from agplace_tpu.evaluate import evaluate
    from agplace_tpu.train.loop import train
    from agplace_tpu.train.step import make_infer_fns

    train_ds, test_ds = worlds_j
    cfg_j = _own_dir(cfg_j, name)
    r0, _ = evaluate(cfg_j, test_ds, state_j.params, state_j.batch_stats,
                     *make_infer_fns(cfg_j))
    out = train(cfg_j, train_ds, test_ds, state=state_j)
    shutil.rmtree(cfg_j.train.save_dir)
    _record(name, r0, out["history"])


def main(argv=None):
    import jax
    import torch

    from agplace_tpu_torch.train.step import init_state
    from agplace_tpu_torch.utils.convert import load_jax_variables

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port-seeds", type=int, nargs="*", default=[0])
    ap.add_argument("--jax-from-port-seed", type=int, default=None)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    torch.set_num_threads(4)
    cfg_j, cfg = _cfgs(os.path.join(ROOT, "_runs", "recall_init_study"))
    worlds_j, worlds = _worlds()
    tree = jax.tree_util.tree_map(np.array, _jax_state(cfg_j, worlds_j[0]))

    state = init_state(cfg, "cpu")
    for tower, mod in (("mm", state.mm), ("db", state.db)):
        load_jax_variables(mod, {"params": tree.params[tower],
                                 "batch_stats": tree.batch_stats[tower]})
    run_port("port from JAX's init (key 0)", cfg, worlds, state)
    for seed in args.port_seeds:
        run_port(f"port from its init (seed {seed})", cfg, worlds,
                 init_state(cfg, "cpu", seed=seed))
    if args.jax_from_port_seed is not None:
        seed = args.jax_from_port_seed
        port = init_state(cfg, "cpu", seed=seed)
        params, stats = {}, {}
        for tower, mod in (("mm", port.mm), ("db", port.db)):
            both = _to_flax({"params": tree.params[tower],
                             "batch_stats": tree.batch_stats[tower]}, mod)
            params[tower], stats[tower] = both["params"], both["batch_stats"]
        state_j = _jax_state(cfg_j, worlds_j[0])
        state_j = state_j.replace(
            params=jax.tree_util.tree_map(jax.numpy.asarray, params),
            batch_stats=jax.tree_util.tree_map(jax.numpy.asarray, stats))
        run_jax(f"JAX from the port's init (seed {seed})", cfg_j, worlds_j,
                state_j)
        state_j = _jax_state(cfg_j, worlds_j[0])
        run_jax("JAX from its init (key 0)", cfg_j, worlds_j, state_j)


if __name__ == "__main__":
    main()
