"""Worker of the port's multi-process tests (``tests/test_torch_port_
parallel*.py``), the counterpart of ``_multihost_worker.py``: one rank of
a gloo process group on the CPU, joined through a file rendezvous.

    python tests/_torch_parallel_worker.py CASE RANK WORLD RDV OUT

``CASE`` names a function below.  It makes its inputs from seeds (the
``*_data`` functions, which the tests call too) or reads them from
``OUT/inputs.pt``, and writes its results to ``OUT/CASE_rankRANK.pt``.
The worker imports the port and never JAX.
"""

import dataclasses
import datetime
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

# ---- inputs made from seeds (the tests hold JAX to the same) -------------


def retrieval_data():
    """Galleries and queries of the retrieval cases."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((32, 64)).astype(np.float32)
    db = rng.standard_normal((1000, 64)).astype(np.float32)  # W ∤ 1000
    rng = np.random.default_rng(3)
    db8 = rng.standard_normal((1000, 64)).astype(np.float32)
    db8 /= np.linalg.norm(db8, axis=1, keepdims=True)
    q8 = rng.standard_normal((16, 64)).astype(np.float32)
    q8 /= np.linalg.norm(q8, axis=1, keepdims=True)
    rng = np.random.default_rng(7)
    small_db = rng.standard_normal((10, 16)).astype(np.float32)
    small_q = rng.standard_normal((3, 16)).astype(np.float32)
    # small integers: exact arithmetic, so rows j, j + 4, j + 8 tie
    # exactly, on both sides of every shard boundary at 2 and 3 ranks
    rng = np.random.default_rng(11)
    base = rng.integers(-2, 3, (4, 8)).astype(np.float32)
    tie_db = np.concatenate([base, base, base])
    tie_q = rng.integers(-2, 3, (5, 8)).astype(np.float32)
    # a search-only index's gallery
    rng = np.random.default_rng(9)
    idx_db = rng.standard_normal((40, 32)).astype(np.float32)
    idx_db /= np.linalg.norm(idx_db, axis=1, keepdims=True)
    idx_q = rng.standard_normal((6, 32)).astype(np.float32)
    idx_q /= np.linalg.norm(idx_q, axis=1, keepdims=True)
    return dict(q=q, db=db, q8=q8, db8=db8, small_q=small_q,
                small_db=small_db, tie_q=tie_q, tie_db=tie_db, idx_q=idx_q,
                idx_db=idx_db)


MASKED_COUNTS = (2, 9, 16)  # valid points of each rank's sample


def bn_data(world: int):
    """Plain BN input [2W, 4, 4, 3], rank i's block centred at 5 i; masked
    BN feats [W, 16, 3] centred at 3 i with MASKED_COUNTS valid rows; the
    cotangents; the BNs' affine."""
    rng = np.random.default_rng(0)
    x = np.concatenate([5.0 * i + rng.standard_normal((2, 4, 4, 3))
                        for i in range(world)]).astype(np.float32)
    feats = np.concatenate([3.0 * i + rng.standard_normal((1, 16, 3))
                            for i in range(world)]).astype(np.float32)
    mask = np.zeros((world, 16), bool)
    for i in range(world):
        mask[i, :MASKED_COUNTS[i]] = True
    return dict(x=x, feats=feats, mask=mask,
                gx=rng.standard_normal(x.shape).astype(np.float32),
                gf=rng.standard_normal(feats.shape).astype(np.float32),
                weight=rng.uniform(0.5, 1.5, 3).astype(np.float32),
                bias=rng.standard_normal(3).astype(np.float32))


def bn_run(data, ax=None):
    """(plain out, masked out, input grads, affine grads, running stats)
    of the plain and masked BN over this rank's blocks (the whole batch
    when ``ax`` is None), moments over ``ax``."""
    from agplace_tpu_torch.models.norm import BatchNorm2D, moments_over
    from agplace_tpu_torch.sparse.modules import MaskedBatchNorm

    def block(a, per):
        if ax is None:
            return torch.from_numpy(a)
        return torch.from_numpy(a[ax.index * per:(ax.index + 1) * per])

    out = {}
    for name, bn, args, g, per in (
            ("plain", BatchNorm2D(3), (data["x"],), data["gx"], 2),
            ("masked", MaskedBatchNorm(3), (data["feats"], data["mask"]),
             data["gf"], 1)):
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(data["weight"]))
            bn.bias.copy_(torch.from_numpy(data["bias"]))
        bn.train()
        inp = block(args[0], per).requires_grad_()
        with moments_over([bn], ax):
            y = bn(inp, *(block(a, per) for a in args[1:]))
        (y * block(g, per)).sum().backward()
        out[name] = dict(y=y.detach().numpy(), gx=inp.grad.numpy(),
                         gw=bn.weight.grad.numpy(),
                         gb=bn.bias.grad.numpy(),
                         mean=bn.running_mean.numpy(),
                         var=bn.running_var.numpy())
    return out


def world_cfg(batch_size=4, **train_kw):
    """The tiny synthetic world's configuration (the sizes of JAX's mesh
    tests of its loop)."""
    from agplace_tpu_torch.config import synthetic_config

    cfg = synthetic_config(batch_size=batch_size, image_size=32,
                           vox_max_points=64, negs=2)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, pretrained=False),
        data=dataclasses.replace(cfg.data, num_workers=1),
        train=dataclasses.replace(cfg.train, **train_kw))


def world_data(seed=0):
    from agplace_tpu_torch.data.synthetic import SyntheticDataset

    return (SyntheticDataset(n_db=24, n_q=16, image_size=32, n_points=64,
                             seed=seed),
            SyntheticDataset(n_db=24, n_q=8, image_size=32, n_points=64,
                             seed=seed + 1))


def fp32_twin(state) -> None:
    """The model's BEV convs in fp32 (the tests' twin of the configured
    model, which JAX's fp32-patched step is held to)."""
    for tower in state.towers:
        for mod in tower.modules():
            if hasattr(mod, "compute_dtype"):
                mod.compute_dtype = torch.float32


def applied_grads(state) -> dict:
    """{name: the gradient Adam applied in the first step} (its first
    moment over 1 - b1), reduced over the ranks where the step reduces."""
    opt = state.opt
    return {n: g.clone() for n, g in
            opt.per_param(opt.mu / (1 - opt.b1)).items()}


# ---- the cases ------------------------------------------------------------


def case_bootstrap(rank, world, rdv, out):
    """Idempotent: a second call returns True and keeps the group."""
    from agplace_tpu_torch.parallel import bootstrap, mesh

    again = bootstrap.initialize_distributed(device="cpu")
    hybrid = bootstrap.make_hybrid_mesh(gallery_parallel=world)
    ax = hybrid.axis("gallery")
    total = mesh.all_reduce_sum(torch.tensor([float(rank + 1)]), ax)
    return dict(again=again, world=mesh.world_size(),
                hybrid=hybrid.devices, total=float(total))


def case_retrieval(rank, world, rdv, out):
    from agplace_tpu_torch.config import MeshConfig
    from agplace_tpu_torch.parallel.mesh import make_mesh, mesh_axis
    from agplace_tpu_torch.retrieval import sharded
    from agplace_tpu_torch.serving import PlaceIndex

    d = retrieval_data()
    g = make_mesh(MeshConfig(data_parallel=1, gallery_parallel=world))
    res = {}
    sh = sharded.shard_gallery(g, d["db"], device="cpu")
    res["shard_rows"] = sh.shape[0]
    res["topk"] = [t.numpy() for t in sharded.sharded_l2_topk(
        g, torch.from_numpy(d["q"]), sh, 10)]
    res["topk_blocks"] = [t.numpy() for t in sharded.sharded_l2_topk(
        g, torch.from_numpy(d["q"]), sh, 10, block=7)]
    _, cand = sharded.sharded_l2_candidates_int8(
        g, torch.from_numpy(d["q8"]),
        sharded.shard_quant_gallery(g, d["db8"], device="cpu"), 20)
    res["int8"] = cand.numpy()
    small = sharded.shard_gallery(g, d["small_db"], device="cpu")
    res["window"] = {k: [t.numpy() for t in sharded.sharded_l2_topk(
        g, torch.from_numpy(d["small_q"]), small, k, n_rows=10)]
        for k in (12, 16, 20)}
    ties = sharded.shard_gallery(g, d["tie_db"], device="cpu")
    res["ties"] = {k: [t.numpy() for t in sharded.sharded_l2_topk(
        g, torch.from_numpy(d["tie_q"]), ties, k, n_rows=12)]
        for k in (5, 12)}
    data = bn_data(world)
    res["bn"] = bn_run(data, mesh_axis(make_mesh(MeshConfig(
        data_parallel=world, gallery_parallel=1)), "data"))
    for quant in (None, "int8"):
        idx = PlaceIndex(None, device="cpu", quant=quant, gallery_mesh=g)
        idx.add_descriptors(d["idx_db"])
        res[f"index_{quant}"] = [idx.search_descriptors(d["idx_q"], k)
                                 for k in (4, 50)]
        for _ in range(2):
            idx.search_descriptors(d["idx_q"], 4)
        res[f"uploads_{quant}"] = idx.upload_count
    return res


def case_paths(rank, world, rdv, out):
    """The eval passes, ``evaluate`` and ``full_gallery`` mining with a
    data mesh and a gallery mesh, each beside its single-device run; the
    sharded ``PlaceIndex`` over embedded tiles."""
    from agplace_tpu_torch.config import MeshConfig
    from agplace_tpu_torch.embed import batched_embed_db, batched_embed_q
    from agplace_tpu_torch.evaluate import evaluate
    from agplace_tpu_torch.infer import build_towers, make_infer_fns
    from agplace_tpu_torch.parallel.mesh import make_mesh
    from agplace_tpu_torch.serving import PlaceIndex
    from agplace_tpu_torch.train.mining import TripletMiner

    cfg = world_cfg(mining="full_gallery")
    train_ds, test_ds = world_data()
    towers = build_towers(cfg, "cpu", torch.Generator().manual_seed(0))
    eq, edb = make_infer_fns(*towers)
    dmesh = make_mesh(MeshConfig(data_parallel=world, gallery_parallel=1))
    gmesh = make_mesh(MeshConfig(data_parallel=1, gallery_parallel=world))
    res = {}
    ids = list(range(test_ds.database_num))
    qs = list(range(test_ds.queries_num))
    for tag, mesh in (("single", None), ("mesh", dmesh)):
        res[f"db_{tag}"] = batched_embed_db(test_ds, ids, edb, 4, "cpu",
                                            mesh)
        res[f"q_{tag}"] = batched_embed_q(test_ds, qs, eq, 4, cfg, "cpu",
                                          mesh)
    res["recalls_single"] = evaluate(cfg, test_ds, eq, edb,
                                     device="cpu")[0]
    res["recalls_mesh"] = evaluate(cfg, test_ds, eq, edb, device="cpu",
                                   mesh=dmesh, gallery_mesh=gmesh)[0]
    for tag, meshes in (("single", {}), ("mesh", dict(mesh=dmesh,
                                                       gallery_mesh=gmesh))):
        miner = TripletMiner(cfg, train_ds, "cpu")
        res[f"mine_{tag}"] = miner.mine(np.random.default_rng(5), 8, towers,
                                        **meshes)
    for quant in (None, "int8"):
        for tag, mesh in (("single", None), ("mesh", gmesh)):
            idx = PlaceIndex(cfg, towers, "cpu", quant=quant,
                             gallery_mesh=mesh)
            idx.add_tiles(test_ds)
            res[f"index_{quant}_{tag}"] = idx.search_descriptors(
                res["q_single"], 4)
    return res


def case_train_step(rank, world, rdv, out):
    """One data-parallel step of the state and batch in ``inputs.pt``
    (every rank resolves the data mesh from ``data_parallel=-1``: at 3
    ranks and batch 8 it holds ranks 0 and 1, and rank 2 runs the
    single-device step)."""
    from agplace_tpu_torch.data.pipeline import prefetch_to_device
    from agplace_tpu_torch.parallel.mesh import (batch_sharding,
                                                 resolve_data_mesh)
    from agplace_tpu_torch.train.step import (TOWER_INPUTS, init_state,
                                              make_train_step)

    inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    cfg = world_cfg(batch_size=8)
    state = init_state(cfg, "cpu")
    state.load_state_dict(inp["state"])
    fp32_twin(state)
    mesh = resolve_data_mesh(cfg.mesh, (8, 8))
    batch = next(prefetch_to_device([inp["batch"]], "cpu", sharding=(
        batch_sharding(mesh, keys=TOWER_INPUTS))))
    m = make_train_step(cfg, mesh)(state, batch)
    return dict(dp=mesh.shape["data"], loss=float(m["loss"]),
                state=state.state_dict(), grads=applied_grads(state))


def case_train_loop(rank, world, rdv, out):
    """``train()`` of 4 steps at data_parallel = gallery_parallel = 2."""
    from agplace_tpu_torch.config import MeshConfig
    from agplace_tpu_torch.train.loop import train

    cfg = world_cfg(save_dir=os.path.join(out, "run"), epochs_num=1,
                    queries_per_epoch=16, cache_refresh_rate=16)
    cfg = cfg.replace(mesh=MeshConfig(data_parallel=2, gallery_parallel=2))
    got = train(cfg, *world_data(), max_steps=4, device="cpu")
    return dict(history=got["history"], steps=got["state"].step,
                files=sorted(os.listdir(cfg.train.save_dir)))


class Ranks:
    """``world`` worker processes of ``case``, started at once (from a
    test; they rendezvous in ``out``)."""

    def __init__(self, case: str, world: int, out: str):
        self.case, self.world, self.out = case, world, str(out)
        os.makedirs(self.out, exist_ok=True)
        rdv = os.path.join(self.out, f"{case}.rdv")
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(r),
             str(world), rdv, self.out], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def results(self, timeout: float = 300) -> list:
        """Each rank's results; raises with the ranks' output when one
        failed or the time ran out (all are stopped)."""
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in self.procs):
            raise RuntimeError(f"{self.case} workers failed:\n"
                               + "\n".join(outs)[-6000:])
        return [torch.load(os.path.join(self.out,
                                        f"{self.case}_rank{r}.pt"),
                           weights_only=False) for r in range(self.world)]


def main():
    case, rank, world, rdv, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    from agplace_tpu_torch.parallel.bootstrap import initialize_distributed

    assert initialize_distributed(f"file://{rdv}", world, rank,
                                  device="cpu",
                                  timeout=datetime.timedelta(seconds=120))
    res = globals()[f"case_{case}"](rank, world, rdv, out)
    torch.save(res, os.path.join(out, f"{case}_rank{rank}.pt"))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
