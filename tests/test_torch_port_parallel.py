"""The port's multi-GPU layer held against JAX's (``agplace_tpu/parallel``,
``agplace_tpu/retrieval/sharded.py``) on the CPU: the mesh rules on rank
lists of 1-8 against JAX's on as many virtual devices; the bootstrap (a
no-op without a coordinator, idempotent, raising on a coordinator that
fails); ``make_hybrid_mesh``'s shapes; and, in 2 and 3 gloo processes
(``tests/_torch_parallel_worker.py``), the sharded fp32 top-k against
JAX's sharded and single-device search (indices exact, distances 1e-4 as
``tests/test_parallel.py``), the sharded int8 candidates against the exact
top-k, faiss's padding for k in the padding window, ties across shard
boundaries lowest global index first, the global BN moments (plain and
masked, shard means 5 i apart, valid counts 2 / 9 / 16) against JAX's
single-device BN on the whole batch (1e-4, JAX's tolerance), and a
sharded ``PlaceIndex`` (fp32, int8) against the single-device one."""

import datetime
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_parallel_worker as worker
from agplace_tpu.config import MeshConfig as JaxMeshConfig
from agplace_tpu.parallel import bootstrap as jax_bootstrap
from agplace_tpu.parallel import mesh as jax_mesh
from agplace_tpu.retrieval.knn import l2_topk as jax_l2_topk
from agplace_tpu.retrieval.sharded import (shard_gallery as jax_shard,
                                           sharded_l2_topk as jax_sharded)
from agplace_tpu_torch.config import MeshConfig
from agplace_tpu_torch.parallel import bootstrap, mesh
from agplace_tpu_torch.serving import PlaceIndex

WORLDS = (2, 3)
D_TOL = 1e-4  # distances and BN, as tests/test_parallel.py


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each world's workers, started together; their results by world."""
    out = tmp_path_factory.mktemp("parallel")
    started = {w: worker.Ranks("retrieval", w, out / f"w{w}")
               for w in WORLDS}
    started["boot"] = worker.Ranks("bootstrap", 2, out / "boot")
    return {w: r.results() for w, r in started.items()}


# ---- the mesh rules ----------------------------------------------------


def _shape(m):
    return None if m is None else (dict(m.shape), np.asarray(
        m.devices).tolist())


def _jax_shape(m):
    return None if m is None else (dict(m.shape), [
        [d.id for d in row] for row in m.devices])


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_rules_match_jax_on_rank_lists(n):
    """resolve_data_mesh / resolve_gallery_mesh / make_mesh on n ranks
    against JAX's on n devices: caps, divisibility, -1, None at width
    1."""
    devs = jax.devices()[:n]
    checked = 0
    for dp in (-1, 1, 2, 3, 4, 8):
        for bss in ((), (8, 8), (8, 6), (4, 12), (3,)):
            want = jax_mesh.resolve_data_mesh(
                JaxMeshConfig(data_parallel=dp), bss, devices=devs)
            got = mesh.resolve_data_mesh(MeshConfig(data_parallel=dp), bss,
                                         devices=list(range(n)))
            assert _shape(got) == _jax_shape(want), (dp, bss)
            checked += 1
    for gp in (-1, 0, 1, 2, 3, 8):
        want = jax_mesh.resolve_gallery_mesh(
            JaxMeshConfig(gallery_parallel=gp), devices=devs)
        got = mesh.resolve_gallery_mesh(MeshConfig(gallery_parallel=gp),
                                        devices=list(range(n)))
        assert _shape(got) == _jax_shape(want), gp
    for dp in (-1, 1, 2, 4):
        for gp in (1, 2, 3):
            cfg = dict(data_parallel=dp, gallery_parallel=gp)
            try:
                want = _jax_shape(jax_mesh.make_mesh(JaxMeshConfig(**cfg),
                                                     devices=devs))
            except AssertionError:
                with pytest.raises(ValueError):
                    mesh.make_mesh(MeshConfig(**cfg), devices=range(n))
                continue
            assert _shape(mesh.make_mesh(MeshConfig(**cfg),
                                         devices=range(n))) == want, cfg
    assert checked == 30
    # the defaults: every rank of the group, [0] with none
    assert not dist.is_initialized()
    assert mesh.resolve_data_mesh(MeshConfig(data_parallel=-1)) is None
    assert mesh.resolve_gallery_mesh(MeshConfig(gallery_parallel=-1)) \
        is None


def test_mesh_axes_and_batch_blocks():
    """A rank's place on each axis, and its block of a batch: the tower
    inputs split in rank order (BEVGrid-like dataclasses too), 0-d and
    unlisted entries whole, the whole batch outside the mesh."""
    import dataclasses

    from agplace_tpu_torch.sparse.bev_grid import BEVGrid

    m = mesh.Mesh(np.array([[0]]), ("data", "gallery"))  # this process: 0
    assert m.axis("data") == mesh.MeshAxis(None, 0, 1)
    assert mesh.mesh_axis(m, "data") is None  # width 1: single-device
    outside = mesh.Mesh(np.array([[1], [2]]), ("data", "gallery"))
    assert outside.axis("data") is None
    batch = {"x": np.arange(8), "vox": BEVGrid(torch.arange(8)[:, None],
                                               torch.ones(8, 1, dtype=bool)),
             "t": np.arange(3), "s": np.float32(1)}
    assert mesh.shard_batch(outside, batch) is batch
    two = mesh.Mesh(np.array([[0], [1]]), ("data", "gallery"))
    assert two.axis("data") == mesh.MeshAxis(None, 0, 2)
    got = mesh.batch_sharding(two, keys=("x", "vox"))(batch)
    assert got["x"].tolist() == [0, 1, 2, 3] and got["t"] is batch["t"]
    assert dataclasses.is_dataclass(got["vox"])
    assert got["vox"].feats[:, 0].tolist() == [0, 1, 2, 3]
    assert mesh.replicated(two)(batch) is batch
    with pytest.raises(ValueError, match="split"):
        mesh.shard_batch(two, {"t": np.arange(3)})
    # a mesh of two ranks with no process group cannot reduce
    with pytest.raises(RuntimeError, match="process group"):
        mesh.all_reduce_sum(torch.ones(1), two.axis("data"))


# ---- the bootstrap -----------------------------------------------------


def _no_coordinator(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
                "MASTER_ADDR", "TPU_WORKER_HOSTNAMES"):
        monkeypatch.delenv(var, raising=False)


def test_bootstrap_single_process_noop(monkeypatch):
    _no_coordinator(monkeypatch)
    assert jax_bootstrap.initialize_distributed() is False
    assert bootstrap.initialize_distributed(device="cpu") is False
    assert not dist.is_initialized() and mesh.world_size() == 1
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert bootstrap.rank_device("cuda") == torch.device("cuda", 3)
    assert bootstrap.rank_device("cuda:1") == torch.device("cuda", 1)
    assert bootstrap.rank_device("cpu") == torch.device("cpu")


def test_bootstrap_raises_on_a_coordinator_that_fails(monkeypatch):
    """A deliberate departure: JAX warns and runs as one process; the
    port raises (N silent independent copies otherwise)."""
    _no_coordinator(monkeypatch)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]  # closed once the block ends
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(RuntimeError):
        bootstrap.initialize_distributed(
            device="cpu", timeout=datetime.timedelta(seconds=1))
    assert not dist.is_initialized()


def test_bootstrap_is_idempotent(ranks):
    """Two ranks joined by the file rendezvous: a second call returns
    True, the group holds both, and an all-reduce over a hybrid mesh's
    gallery row sums both ranks."""
    for r in ranks["boot"]:
        assert r["again"] is True and r["world"] == 2
        assert r["hybrid"].tolist() == [[0, 1]] and r["total"] == 3.0


def test_hybrid_mesh_shapes(monkeypatch):
    monkeypatch.delenv("TPU_WORKER_HOSTNAMES", raising=False)
    for gp in (1, 2, 4, 8):
        want = jax_bootstrap.make_hybrid_mesh(gallery_parallel=gp)
        got = bootstrap.make_hybrid_mesh(gallery_parallel=gp,
                                         devices=range(8))
        assert _shape(got) == _jax_shape(want)
    assert _shape(bootstrap.make_hybrid_mesh(
        gallery_parallel=2, devices=[5, 4, 7, 6])) == (
        {"data": 2, "gallery": 2}, [[4, 5], [6, 7]])
    with pytest.raises(ValueError):
        bootstrap.make_hybrid_mesh(gallery_parallel=3, devices=range(8))


# ---- sharded retrieval -------------------------------------------------


def _jax_mesh(w):
    return jax_mesh.make_mesh(JaxMeshConfig(data_parallel=1,
                                            gallery_parallel=w),
                              devices=jax.devices()[:w])


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_topk_matches_jax(ranks, w):
    """1000 rows over w ranks (not divisible): indices equal to JAX's
    sharded and single-device search, on every rank."""
    d = worker.retrieval_data()
    jm = _jax_mesh(w)
    d_sh, i_sh = jax_sharded(jm, jnp.asarray(d["q"]), jax_shard(jm, d["db"]),
                             10)
    d_ref, i_ref = jax_l2_topk(jnp.asarray(d["q"]), jnp.asarray(d["db"]), 10)
    for r in ranks[w]:
        assert r["shard_rows"] == -(-1000 // w)
        dist_, idx = r["topk"]
        np.testing.assert_array_equal(idx, np.asarray(i_sh))
        np.testing.assert_array_equal(idx, np.asarray(i_ref))
        np.testing.assert_allclose(dist_, np.asarray(d_ref), rtol=D_TOL,
                                   atol=D_TOL)


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_topk_in_query_blocks(ranks, w):
    """The 32 queries in blocks of 7 (the last one short), each block
    gathered and merged on its own: the same answer as one block, and
    JAX's single-device indices."""
    d = worker.retrieval_data()
    _, i_ref = jax_l2_topk(jnp.asarray(d["q"]), jnp.asarray(d["db"]), 10)
    for r in ranks[w]:
        (dist_, idx), (d_whole, i_whole) = r["topk_blocks"], r["topk"]
        np.testing.assert_array_equal(idx, i_whole)
        np.testing.assert_array_equal(idx, np.asarray(i_ref))
        np.testing.assert_allclose(dist_, d_whole, rtol=D_TOL, atol=D_TOL)


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_int8_candidates_contain_true_topk(ranks, w):
    d = worker.retrieval_data()
    _, i_ref = jax_l2_topk(jnp.asarray(d["q8"]), jnp.asarray(d["db8"]), 5)
    i_ref = np.asarray(i_ref)
    for r in ranks[w]:
        cand = r["int8"]
        assert cand.shape == (16, 20) and (cand < 1000).all()  # no padding
        for q in range(16):
            assert set(i_ref[q]) <= set(cand[q].tolist()), q


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_topk_padding_window_gives_faiss_padding(ranks, w):
    """10 real rows padded to 10 + (-10 % w): k = 12, 16, 20 past the real
    rows give +inf / -1, as JAX's sharded search with ``n_rows``."""
    d = worker.retrieval_data()
    jm = _jax_mesh(w)
    for k in (12, 16, 20):
        d_j, i_j = jax_sharded(jm, jnp.asarray(d["small_q"]),
                               jax_shard(jm, d["small_db"]), k, n_rows=10)
        for r in ranks[w]:
            dist_, idx = r["window"][k]
            np.testing.assert_array_equal(idx, np.asarray(i_j))
            assert (idx[:, 10:] == -1).all() and np.isinf(
                dist_[:, 10:]).all()
            np.testing.assert_allclose(dist_[:, :10], np.asarray(d_j)[:, :10],
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_ties_lowest_global_index_first(ranks, w):
    """Rows j, j + 4, j + 8 are equal (exact small integers), across
    shard boundaries: equal distances come out lowest global index first
    (JAX's single-device order), at k = 5 (a tie straddling the k-th
    place) and k = 12 (every row)."""
    d = worker.retrieval_data()
    for k in (5, 12):
        d_ref, i_ref = jax_l2_topk(jnp.asarray(d["tie_q"]),
                                   jnp.asarray(d["tie_db"]), k)
        d2 = ((d["tie_q"][:, None] - d["tie_db"][None]) ** 2).sum(-1)
        lex = np.lexsort((np.broadcast_to(np.arange(12), d2.shape), d2))
        for r in ranks[w]:
            dist_, idx = r["ties"][k]
            np.testing.assert_array_equal(idx, np.asarray(i_ref))
            np.testing.assert_array_equal(idx, lex[:, :k])
            np.testing.assert_array_equal(dist_, np.asarray(d_ref))


def _jax_bn(data):
    """JAX's single-device BatchNorm2D and MaskedBatchNorm on the whole
    batch: (outputs, new running statistics, gradients of sum(y * g) by
    the input, scale and bias)."""
    from agplace_tpu.models.norm import BatchNorm2D as JaxBN
    from agplace_tpu.sparse.modules import MaskedBatchNorm as JaxMaskedBN

    out = {}
    for name, mod, args, g in (
            ("plain", JaxBN(), (data["x"],), data["gx"]),
            ("masked", JaxMaskedBN(), (data["feats"], data["mask"]),
             data["gf"])):
        args = [jnp.asarray(a) for a in args]
        stats = {"mean": jnp.zeros(3), "var": jnp.ones(3)}

        def loss(x, params):
            y, mut = mod.apply({"params": params, "batch_stats": stats}, x,
                               *args[1:], mutable=["batch_stats"])
            return (y * g).sum(), (y, mut["batch_stats"])

        params = {"scale": jnp.asarray(data["weight"]),
                  "bias": jnp.asarray(data["bias"])}
        (_, (y, st)), (gx, gp) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(args[0], params)
        out[name] = dict(y=np.asarray(y), gx=np.asarray(gx),
                         gw=np.asarray(gp["scale"]),
                         gb=np.asarray(gp["bias"]),
                         mean=np.asarray(st["mean"]),
                         var=np.asarray(st["var"]))
    return out


@pytest.mark.parametrize("w", WORLDS)
def test_global_bn_moments_match_jax(ranks, w):
    """Each rank's block of the outputs and of the input gradients, the
    running statistics on every rank and the sum of the ranks' affine
    gradients equal JAX's single-device BN on the concatenated batch
    (rtol = atol = 1e-4, JAX's tolerance); also the port's own
    single-device BN."""
    data = worker.bn_data(w)
    want = _jax_bn(data)
    mine = worker.bn_run(data)
    for name, per in (("plain", 2), ("masked", 1)):
        for ref in (want[name], mine[name]):
            got = [r["bn"][name] for r in ranks[w]]
            for key in ("y", "gx"):
                np.testing.assert_allclose(
                    np.concatenate([g[key] for g in got]), ref[key],
                    rtol=D_TOL, atol=D_TOL, err_msg=f"{name} {key}")
            for key in ("gw", "gb"):
                np.testing.assert_allclose(sum(g[key] for g in got),
                                           ref[key], rtol=D_TOL, atol=D_TOL,
                                           err_msg=f"{name} {key}")
            for g in got:
                for key in ("mean", "var"):
                    np.testing.assert_allclose(g[key], ref[key], rtol=D_TOL,
                                               atol=D_TOL,
                                               err_msg=f"{name} {key}")


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_index_matches_single_device(ranks, w):
    """A search-only ``PlaceIndex(gallery_mesh=)``, fp32 and int8: k = 4
    equal to the single-device fp32 index (indices exact, distances
    1e-4 / 1e-5 as JAX's ``tests/test_serving.py``); k = 50 past the 40
    rows gives faiss's padding; repeated searches upload once."""
    d = worker.retrieval_data()
    idx = PlaceIndex(None, device="cpu")
    idx.add_descriptors(d["idx_db"])
    want = [idx.search_descriptors(d["idx_q"], k) for k in (4, 50)]
    for r in ranks[w]:
        for quant, atol in ((None, 1e-4), ("int8", 1e-5)):
            for (d_got, i_got), (d_want, i_want) in zip(
                    r[f"index_{quant}"], want):
                np.testing.assert_array_equal(i_got, i_want)
                np.testing.assert_allclose(d_got, d_want, rtol=1e-4,
                                           atol=atol)
            assert r[f"uploads_{quant}"] == 1
        assert (r["index_None"][1][1][:, 40:] == -1).all()
