"""Serving entry point (the JAX package's ``serve.py``): build, persist and
query a place index.

    # embed the test split's aerial tiles once and persist the gallery
    python -m agplace_tpu_torch.serve build --dataset kitti360 --dataroot D \\
        --resume best_model --gallery_out g.npz

    # answer pre-computed descriptors (.npy [Q, C]) against a saved gallery,
    # model-free; or embed the dataset's query split with --resume
    python -m agplace_tpu_torch.serve search --gallery g.npz --queries q.npy \\
        --k 5 [--quant int8]
    python -m agplace_tpu_torch.serve search --gallery g.npz \\
        --dataset kitti360 --dataroot D --resume best_model

    # a model-free JSON search node, and a fan-out over several of them
    python -m agplace_tpu_torch.serve http --gallery g.npz --port 8080 \\
        [--quant int8]
    python -m agplace_tpu_torch.serve search \\
        --gallery http://a:8080,http://b:8080 --queries q.npy

``search`` prints one strict-JSON line per query (distances, gallery
indices, and UTM east/north when the gallery carries positions; ``null``
for non-finite values).  The flags after the subcommand's own are the
training entry point's (every flag of ``config.FLAG_TABLE``).  ``--device``
picks the index's device: the card by default, which raises "no CUDA
device" without one; the fan-out client holds no index and needs no
device.  ``--data_parallel`` and ``--gallery_parallel`` are taken and
ignored, as JAX's ``serve.py`` does: it builds no mesh (a sharded index is
``serving.PlaceIndex(gallery_mesh=)`` in a program of one process per
card).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np


def _split_argv(argv):
    """The subcommand and its own flags; the rest goes to
    ``config.parse_arguments``."""
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("command", choices=["build", "search", "http"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--gallery_out", default="gallery.npz",
                   help="build: output .npz path")
    p.add_argument("--gallery", default=None,
                   help="search: saved gallery .npz (repeatable via comma)")
    p.add_argument("--queries", default=None,
                   help="search: .npy of [Q, C] query descriptors; omit to "
                        "embed the dataset's query split (needs --resume)")
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--quant", default=None, choices=["int8"],
                   help="int8 device gallery with exact fp32 re-rank")
    p.add_argument("--device", default="cuda",
                   help="the index's device: cuda (default) or cpu")
    return p.parse_known_args(argv)


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(msg)


def _config(rest):
    from agplace_tpu_torch.config import parse_arguments

    return parse_arguments(rest)[0]


def _build(own, rest) -> None:
    from agplace_tpu_torch.serving import PlaceIndex
    from agplace_tpu_torch.train.cli import build_datasets
    from agplace_tpu_torch.utils.common import setup_logging

    cfg = _config(rest)
    setup_logging(cfg.train.save_dir)
    log = logging.getLogger("serve")
    _, test_ds = build_datasets(cfg)
    _require(bool(cfg.train.resume),
             "build needs --resume <checkpoint-name>")
    idx = PlaceIndex.from_checkpoint(cfg, cfg.train.save_dir,
                                     cfg.train.resume, own.device)
    n = idx.add_tiles(test_ds)
    idx.save_gallery(own.gallery_out)
    log.info("gallery: %d tiles -> %s", n, own.gallery_out)
    print(json.dumps({"gallery": own.gallery_out, "rows": n,
                      "positions": idx.positions is not None}))


def _print_rows(d, i, pos) -> None:
    """One JSON line per query; non-finite values (k > rows padding)
    become null so the output stays strict JSON."""
    for r in range(d.shape[0]):
        row = {"query": r,
               "indices": [int(v) for v in i[r]],
               "sq_distances": [None if not np.isfinite(v)
                                else round(float(v), 6) for v in d[r]]}
        if pos is not None:
            row["east_north"] = [
                [None, None] if not np.isfinite(e)
                else [round(float(e), 3), round(float(n), 3)]
                for e, n in pos[r]]
        print(json.dumps(row))


def _answer(idx, q, k):
    if idx.positions is not None:
        return idx.locate_descriptors(q, k=k)
    return (*idx.search_descriptors(q, k=k), None)


def _search(own, rest) -> None:
    from agplace_tpu_torch.serving import PlaceIndex

    _require(bool(own.gallery),
             "search needs --gallery <file.npz or http://node,..>")
    if own.gallery.startswith(("http://", "https://")):
        # scatter-gather across searcher nodes (`serve http` instances)
        from agplace_tpu_torch.serving_http import ShardedSearchClient

        _require(own.queries is not None,
                 "node search takes pre-computed --queries descriptors")
        _require(own.quant is None,
                 "--quant applies node-side (serve http), not to the "
                 "client")
        client = ShardedSearchClient(own.gallery.split(","))
        q = np.load(own.queries).astype(np.float32)
        _print_rows(*client.search(q, k=own.k))
        return
    if own.queries is not None:
        # model-free: pre-computed descriptors against the saved gallery
        idx = PlaceIndex.from_gallery(own.gallery.split(",")[0],
                                      device=own.device, quant=own.quant)
        for extra in own.gallery.split(",")[1:]:
            idx.load_gallery(extra)
        q = np.load(own.queries).astype(np.float32)
    else:
        from agplace_tpu_torch.embed import batched_embed_q
        from agplace_tpu_torch.train.cli import build_datasets

        cfg = _config(rest)
        _require(bool(cfg.train.resume),
                 "search without --queries needs --resume to embed the "
                 "query split")
        idx = PlaceIndex.from_checkpoint(cfg, cfg.train.save_dir,
                                         cfg.train.resume, own.device,
                                         quant=own.quant)
        for g in own.gallery.split(","):
            idx.load_gallery(g)
        _, test_ds = build_datasets(cfg)
        q = batched_embed_q(test_ds, list(range(test_ds.queries_num)),
                            idx._embed_q, cfg.train.infer_batch_size, cfg,
                            idx.device)
    _print_rows(*_answer(idx, q, own.k))


def _http(own, rest) -> None:
    """Model-free JSON search node over a saved gallery
    (``serving_http``)."""
    from agplace_tpu_torch.serving import PlaceIndex
    from agplace_tpu_torch.serving_http import serve_forever

    _require(bool(own.gallery), "http needs --gallery <file.npz>")
    paths = own.gallery.split(",")
    idx = PlaceIndex.from_gallery(paths[0], device=own.device,
                                  quant=own.quant)
    for extra in paths[1:]:
        idx.load_gallery(extra)
    print(json.dumps({"serving": f"http://{own.host}:{own.port}",
                      "rows": len(idx)}), flush=True)
    serve_forever(idx, own.host, own.port)


def main(argv=None) -> None:
    from agplace_tpu_torch.device import resolve_device

    own, rest = _split_argv(sys.argv[1:] if argv is None else argv)
    if not (own.command == "search" and own.gallery
            and own.gallery.startswith(("http://", "https://"))):
        own.device = resolve_device(own.device)  # before any other work
    {"build": _build, "http": _http, "search": _search}[own.command](
        own, rest)


if __name__ == "__main__":
    main()
