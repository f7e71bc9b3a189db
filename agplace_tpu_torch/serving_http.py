"""HTTP front end for :class:`agplace_tpu_torch.serving.PlaceIndex`
(``agplace_tpu/serving_http.py``): a stdlib-only (``http.server``) JSON
API with the JAX package's routes, keys, status codes and error strings,
so a client of either package talks to nodes of either.

    GET  /healthz            -> {"ok": true, "rows": N, "quant": ...,
                                 "positions": bool}
    POST /search             <- {"descriptors": [[...]], "k": 5}
                             -> {"sq_distances": [[...]], "indices": [[...]],
                                 "east_north": [[[e,n], ...], ...]?}
    POST /add                <- {"descriptors": [[...]],
                                 "positions": [[e,n], ...]?}
                             -> {"rows": N}
    POST /remove             <- {"indices": [...]}
                             -> {"rows": N}   (remaining rows shift down)

Descriptors travel as JSON float lists: embedder nodes hold the model
(``PlaceIndex.embed``), searcher nodes run model-free over a saved gallery
(``PlaceIndex.from_gallery``).  One lock serialises every access to the
index, so the handler threads take turns on its device (a search stays on
the index's device; it never moves to the host copy).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np


def make_http_server(index, host: str = "127.0.0.1", port: int = 0
                     ) -> ThreadingHTTPServer:
    """Wrap a :class:`PlaceIndex` in a ready-to-``serve_forever`` HTTP
    server.  ``port=0`` binds an ephemeral port (``server.server_address``
    has the real one)."""
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; callers own logging
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        MAX_BODY = 256 << 20  # network input: bound allocations

        def _body(self) -> Optional[dict]:
            try:
                n = int(self.headers.get("Content-Length", 0))
                if not 0 <= n <= self.MAX_BODY:
                    return None
                return json.loads(self.rfile.read(n))
            except (ValueError, json.JSONDecodeError):
                return None

        def do_GET(self):
            if self.path != "/healthz":
                return self._reply(404, {"error": "not found"})
            with lock:
                self._reply(200, {
                    "ok": True, "rows": len(index),
                    "quant": index.quant,
                    "positions": index.positions is not None})

        def do_POST(self):
            try:
                if self.path == "/search":
                    return self._search()
                if self.path == "/add":
                    return self._add()
                if self.path == "/remove":
                    return self._remove()
                self._reply(404, {"error": "not found"})
            except Exception as e:  # backend failure: 500, not a dropped
                # connection (device OOM, a failed launch, ...)
                try:
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                except Exception:
                    pass

        def _parse_desc(self, req: dict) -> Tuple[Optional[np.ndarray], str]:
            try:
                q = np.asarray(req["descriptors"], np.float32)
            except (KeyError, TypeError, ValueError):
                return None, "descriptors must be a [n][C] float list"
            if q.ndim != 2 or not np.isfinite(q).all():
                return None, "descriptors must be a finite [n][C] matrix"
            return q, ""

        def _search(self):
            req = self._body()
            if req is None:
                return self._reply(400, {"error": "invalid JSON body"})
            q, err = self._parse_desc(req)
            if q is None:
                return self._reply(400, {"error": err})
            try:
                k = int(req.get("k", 5))
            except (TypeError, ValueError):
                return self._reply(400, {"error": "k must be an integer"})
            if not 1 <= k <= 65536:
                return self._reply(400, {
                    "error": "k must be in [1, 65536]"})
            with lock:
                if len(index) == 0:
                    return self._reply(409, {"error": "empty index"})
                if q.shape[1] != index.dim:
                    return self._reply(400, {
                        "error": f"descriptor dim {q.shape[1]} != "
                                 f"gallery dim {index.dim}"})
                out = {}
                if index.positions is not None:
                    d, i, pos = index.locate_descriptors(q, k=k)
                    out["east_north"] = [
                        [[None, None] if np.isnan(e) else
                         [float(e), float(n)] for e, n in row]
                        for row in pos]
                else:
                    d, i = index.search_descriptors(q, k=k)
            out["sq_distances"] = [
                [None if not np.isfinite(v) else float(v) for v in row]
                for row in d]
            out["indices"] = i.astype(int).tolist()
            self._reply(200, out)

        def _add(self):
            req = self._body()
            if req is None:
                return self._reply(400, {"error": "invalid JSON body"})
            feats, err = self._parse_desc(req)
            if feats is None:
                return self._reply(400, {"error": err})
            pos = req.get("positions")
            try:
                if pos is not None:
                    pos = np.asarray(pos, np.float64)
                with lock:
                    n = index.add_descriptors(feats, positions=pos)
            except (ValueError, TypeError) as e:
                return self._reply(400, {"error": str(e)})
            self._reply(200, {"rows": n})

        def _remove(self):
            req = self._body()
            if req is None:
                return self._reply(400, {"error": "invalid JSON body"})
            try:
                idx = np.asarray(req["indices"], np.int64)
                with lock:
                    n = index.remove_rows(idx)
            except (KeyError, ValueError, TypeError, IndexError) as e:
                return self._reply(400, {"error": str(e)})
            self._reply(200, {"rows": n})

    return ThreadingHTTPServer((host, port), Handler)


def serve_forever(index, host: str = "127.0.0.1", port: int = 8080) -> None:
    """Blocking entry of ``python -m agplace_tpu_torch.serve http``."""
    srv = make_http_server(index, host, port)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


class ShardedSearchClient:
    """Scatter-gather over N searcher nodes, each serving one row range of
    the global gallery through the HTTP API above: each node loads its own
    ``save_gallery`` file, and the client fans a query out to every node
    and merges the local top-k.  Global index = the node's row offset +
    local index, with offsets taken from the node order given here
    (``/healthz`` row counts)."""

    def __init__(self, urls, timeout: float = 30.0):
        self.urls = list(urls)
        self.timeout = timeout
        self.refresh()

    def refresh(self) -> None:
        """Re-read every node's row count; global index = offset in node
        order + local index.  Called at construction and before every
        search — an /add on a non-terminal node between searches would
        otherwise silently shift every later node's global indices."""
        import urllib.request

        self._rows = []
        for u in self.urls:
            with urllib.request.urlopen(u.rstrip("/") + "/healthz",
                                        timeout=self.timeout) as r:
                self._rows.append(int(json.loads(r.read())["rows"]))
        self.offsets = np.concatenate(
            [[0], np.cumsum(self._rows[:-1])]).astype(np.int64)

    def __len__(self) -> int:
        return int(sum(self._rows))

    def _post(self, url: str, payload: dict) -> dict:
        import urllib.request

        req = urllib.request.Request(
            url.rstrip("/") + "/search",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def search(self, descriptors: np.ndarray, k: int = 5):
        """[Q, C] descriptors -> (sq_distances [Q, k], global indices
        [Q, k], east_north [Q, k, 2] or None).  faiss semantics: +inf/-1
        (NaN positions) padding when k exceeds the global row count."""
        q = np.asarray(descriptors, np.float32)
        payload = {"descriptors": q.tolist(), "k": k}
        import concurrent.futures as cf
        import urllib.error

        self.refresh()  # /adds since the last search move row offsets

        def ask(u_rows):
            u, rows = u_rows
            if rows == 0:  # a node awaiting its gallery contributes
                return None  # nothing (its /search would 409)
            try:
                return self._post(u, payload)
            except urllib.error.HTTPError as e:
                if e.code == 409:
                    return None
                raise

        with cf.ThreadPoolExecutor(len(self.urls)) as ex:
            replies = list(ex.map(ask, zip(self.urls, self._rows)))
        offsets = [o for o, rep in zip(self.offsets, replies)
                   if rep is not None]
        replies = [rep for rep in replies if rep is not None]
        if not replies:  # every node empty: pure faiss padding
            return (np.full((len(q), k), np.inf, np.float32),
                    np.full((len(q), k), -1, np.int64),
                    None)

        def col(rep, key, fill):
            rows = rep[key]
            return np.asarray([[fill if v is None else v for v in r]
                               for r in rows])

        d = np.concatenate(
            [col(rep, "sq_distances", np.inf) for rep in replies], axis=1)
        i = np.concatenate(
            [np.where(np.asarray(rep["indices"]) >= 0,
                      np.asarray(rep["indices"], np.int64) + off, -1)
             for rep, off in zip(replies, offsets)], axis=1)
        has_pos = all("east_north" in rep for rep in replies)
        if has_pos:
            pos = np.concatenate(
                [np.asarray([[[np.nan, np.nan] if e is None or e[0] is None
                              else e for e in r] for r in rep["east_north"]])
                 for rep in replies], axis=1)
        # each node already pads its local result to k with inf/-1, so the
        # concatenated width is n_nodes*k >= k and the global merge keeps
        # faiss semantics (k > global rows -> trailing inf/-1 rows)
        order = np.argsort(d.astype(np.float32), axis=1,
                           kind="stable")[:, :k]
        d_out = np.take_along_axis(d, order, axis=1).astype(np.float32)
        i_out = np.where(np.isinf(d_out), -1,
                         np.take_along_axis(i, order, axis=1))
        if not has_pos:
            return d_out, i_out, None
        p_out = np.take_along_axis(pos, order[..., None], axis=1)
        p_out = np.where((i_out >= 0)[..., None], p_out, np.nan)
        return d_out, i_out, p_out
