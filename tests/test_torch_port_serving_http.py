"""The port's HTTP front end (``agplace_tpu_torch/serving_http.py``) against
the JAX package's: a port node and a JAX node on ephemeral ports over the
same gallery give the same ``/healthz``, ``/add``, ``/remove`` and error
replies (status and body) and the same ``/search`` answers, fp32 and int8;
the port's ``ShardedSearchClient`` over port nodes equals the flat index;
and the wire format crosses packages both ways (a port client over JAX
nodes, a JAX client over port nodes)."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch

from agplace_tpu.serving import PlaceIndex as JaxIndex
from agplace_tpu.serving_http import ShardedSearchClient as JaxClient
from agplace_tpu.serving_http import make_http_server as jax_server
from agplace_tpu_torch.serving import PlaceIndex
from agplace_tpu_torch.serving_http import (ShardedSearchClient,
                                            make_http_server)

torch.set_num_threads(1)

N, C = 120, 256


def _world(seed=0, n=N):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, C)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    return feats, rng.uniform(0, 1000, (n, 2)), rng


def _req(base, path, payload=None, raw=None):
    """(status, parsed body) of a GET (no payload) or POST."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _Nodes:
    """HTTP servers over indexes, each on its own thread and port."""

    def __init__(self):
        self.servers = []

    def start(self, make, index):
        srv = make(index)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        self.servers.append(srv)
        return "http://%s:%d" % srv.server_address

    def close(self):
        for srv in self.servers:
            srv.shutdown()
            srv.server_close()


@pytest.fixture()
def nodes():
    n = _Nodes()
    try:
        yield n
    finally:
        n.close()


def _pair(nodes, quant, feats, pos):
    ours = PlaceIndex(None, device="cpu", quant=quant)
    ref = JaxIndex(None, None, None, quant=quant)
    for idx in (ours, ref):
        idx.add_descriptors(feats, positions=pos)
    return (nodes.start(make_http_server, ours),
            nodes.start(jax_server, ref))


BAD = [
    ("/search", {"descriptors": "nope"}),
    ("/search", {"descriptors": [[1.0, float("nan")]]}),
    ("/search", {"k": 3}),
    ("/search", {"descriptors": [[1.0, 2.0]], "k": 1}),
    ("/search", {"descriptors": [[1.0] * C], "k": "five"}),
    ("/search", {"descriptors": [[1.0] * C], "k": 10 ** 12}),
    ("/add", {"descriptors": [[1.0] * C], "positions": [[1.0]]}),
    ("/add", {"descriptors": [[1.0, 2.0]]}),
    ("/add", {"descriptors": [[1.0] * C],
              "positions": [[1.0], [2.0, 3.0]]}),
    ("/remove", {"indices": [1000]}),
    ("/remove", {"nope": [1]}),
    ("/nope", {}),
]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_replies_equal_the_jax_nodes(nodes, quant):
    feats, pos, rng = _world()
    port, jax_url = _pair(nodes, quant, feats, pos)
    assert _req(port, "/healthz") == _req(jax_url, "/healthz") == (
        200, {"ok": True, "rows": N, "quant": quant, "positions": True})
    assert _req(port, "/nope") == _req(jax_url, "/nope")
    for path, payload in BAD:
        got, want = _req(port, path, payload), _req(jax_url, path, payload)
        assert got == want and got[0] in (400, 404), (path, got)
    assert _req(port, "/search", raw=b"{not json") == _req(
        jax_url, "/search", raw=b"{not json")

    q = feats[rng.choice(N, 6)] + 1e-2 * rng.standard_normal(
        (6, C)).astype(np.float32)
    for k in (1, 5, N + 3):
        s1, got = _req(port, "/search", {"descriptors": q.tolist(), "k": k})
        s2, want = _req(jax_url, "/search", {"descriptors": q.tolist(),
                                             "k": k})
        assert s1 == s2 == 200
        assert got["indices"] == want["indices"]
        assert got["east_north"] == want["east_north"]
        if quant == "int8":  # the same host re-rank: bit-equal
            assert got["sq_distances"] == want["sq_distances"]
        else:
            d1, d2 = (np.array([[np.inf if v is None else v for v in r]
                                for r in x["sq_distances"]])
                      for x in (got, want))
            np.testing.assert_allclose(d1, d2, rtol=0, atol=1e-5)

    new = (feats[7:9] * 0.999).tolist()
    for payload in ({"descriptors": new, "positions": [[1.0, 2.0],
                                                       [3.0, 4.0]]},):
        assert _req(port, "/add", payload) == _req(jax_url, "/add", payload)
    assert _req(port, "/remove", {"indices": [0, 5]}) == _req(
        jax_url, "/remove", {"indices": [0, 5]}) == (200, {"rows": N})
    s1, got = _req(port, "/search", {"descriptors": new, "k": 3})
    s2, want = _req(jax_url, "/search", {"descriptors": new, "k": 3})
    assert got["indices"] == want["indices"]
    assert [r[0] for r in got["indices"]] == [N - 2, N - 1]


def test_empty_node_replies_equal_the_jax_node(nodes):
    port = nodes.start(make_http_server, PlaceIndex(None, device="cpu"))
    jax_url = nodes.start(jax_server, JaxIndex(None, None, None))
    assert _req(port, "/healthz") == _req(jax_url, "/healthz")
    q = {"descriptors": [[1.0] * C], "k": 2}
    assert _req(port, "/search", q) == _req(jax_url, "/search", q) == (
        409, {"error": "empty index"})
    assert _req(port, "/remove", {"indices": [0]}) == _req(
        jax_url, "/remove", {"indices": [0]})


def _shards(nodes, make, index_of, feats, pos, cuts=((0, 50), (50, N))):
    urls = []
    for lo, hi in cuts:
        idx = index_of()
        idx.add_descriptors(feats[lo:hi], positions=pos[lo:hi])
        urls.append(nodes.start(make, idx))
    return urls


def test_fan_out_equals_the_flat_index(nodes):
    feats, pos, rng = _world(1)
    flat = PlaceIndex(None, device="cpu")
    flat.add_descriptors(feats, positions=pos)
    urls = _shards(nodes, make_http_server,
                   lambda: PlaceIndex(None, device="cpu"), feats, pos)
    urls.append(nodes.start(make_http_server,
                            PlaceIndex(None, device="cpu")))  # empty node
    client = ShardedSearchClient(urls)
    assert len(client) == N
    q = feats[rng.choice(N, 5)] + 1e-2 * rng.standard_normal(
        (5, C)).astype(np.float32)
    for k in (7, 60, N + 3):
        d, i, p = client.search(q, k)
        d_ref, i_ref, p_ref = flat.locate_descriptors(q, k)
        np.testing.assert_array_equal(i, i_ref)
        np.testing.assert_allclose(d, d_ref, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(p, p_ref)


def test_clients_cross_packages(nodes):
    feats, pos, rng = _world(2)
    q = feats[rng.choice(N, 4)] + 1e-2 * rng.standard_normal(
        (4, C)).astype(np.float32)
    jax_nodes = _shards(nodes, jax_server,
                        lambda: JaxIndex(None, None, None), feats, pos)
    port_nodes = _shards(nodes, make_http_server,
                         lambda: PlaceIndex(None, device="cpu"), feats, pos)
    ours = ShardedSearchClient(jax_nodes).search(q, 9)
    theirs = JaxClient(port_nodes).search(q, 9)
    same = JaxClient(jax_nodes).search(q, 9)
    np.testing.assert_array_equal(ours[1], theirs[1])
    np.testing.assert_array_equal(ours[1], same[1])
    np.testing.assert_array_equal(ours[0], same[0])
    np.testing.assert_allclose(ours[0], theirs[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ours[2], theirs[2])
