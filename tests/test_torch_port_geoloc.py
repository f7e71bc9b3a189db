"""The port's GeoLocalizationNet and CCT held against the JAX package on the
CPU, and the weight bridge over their trees.

Each backbone of JAX's ``tests/test_geoloc.py`` parametrisation (64 px,
``trunc_te=2``, 4 clusters), plus resnet50conv4 / resnet101conv4,
``fc_output_dim`` and the ``l2`` placements, with the same random weights
in both packages (BN statistics away from identity).  Both run in fp32
(JAX's factory gives the tower no dtype).  Tolerance: max |diff| <= 1e-4
of max |JAX| (measured <= 1.2e-6; CCT <= 1e-6).  The bridge consumes every flax leaf and
``flax_path`` maps each port entry back onto one.
"""

import jax
import numpy as np
import pytest
import torch

from agplace_tpu.models.cct import CCT as JaxCCT
from agplace_tpu.models.geoloc import GeoLocalizationNet as JaxNet
from agplace_tpu.models.geoloc import backbone_output_dim as jax_dim
from agplace_tpu_torch.models.cct import CCT
from agplace_tpu_torch.models.geoloc import (GeoLocalizationNet,
                                             backbone_output_dim)
from agplace_tpu_torch.utils.convert import (flax_path, jax_to_state_dict,
                                             load_jax_variables)
from test_torch_port_mm_options import random_variables
from test_torch_port_pooling import close

torch.set_num_threads(1)

IMG = 64
CASES = [  # JAX's test_geoloc parametrisation, then the wider ResNets
    ("resnet18conv4", "gem", {}),
    ("resnet18conv5", "netvlad", {}),
    ("vgg16", "gem", {}),
    ("alexnet", "spoc", {}),
    ("vit", "cls", {}),
    ("vit", "gem", {}),
    ("cct384", "seqpool", {}),
    ("cct384", "gem", {}),
    ("resnet50conv4", "netvlad", {}),
    ("resnet101conv4", "gem", {}),
    ("resnet18conv4", "gem", {"fc_output_dim": 128}),
    ("resnet18conv4", "mixvpr", {"fc_output_dim": 32}),
    ("resnet18conv4", "convap", {"fc_output_dim": 32}),
    ("alexnet", "crn", {}),
    ("resnet18conv4", "rmac", {"l2": "after_pool"}),
    ("resnet18conv4", "mac", {"l2": "none"}),
]


def pair(backbone, agg, kw, seed=0, size=IMG):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    net = JaxNet(backbone=backbone, aggregation=agg, netvlad_clusters=4,
                 trunc_te=2, **kw)
    v = random_variables(net, rng, x)
    port = GeoLocalizationNet(backbone, agg, 4, trunc_te=2,
                              image_hw=(size, size), **kw)
    return x, net, v, load_jax_variables(port, v).eval()


@pytest.mark.parametrize("backbone,agg,kw", CASES, ids=[
    "-".join([b, a, *map(str, k.values())]) for b, a, k in CASES])
def test_geoloc_matches_jax(backbone, agg, kw):
    x, net, v, port = pair(backbone, agg, kw)
    want = np.asarray(net.apply(v, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape[1] == port.out_dim
    close(got, want, what=f"{backbone}/{agg}")
    if kw.get("fc_output_dim") or agg in ("cls", "seqpool"):
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   rtol=1e-5)


@pytest.mark.parametrize("backbone", ["resnet18conv4", "vit", "cct384"])
def test_bridge_consumes_every_leaf_and_inverts(backbone):
    _, _, v, port = pair(backbone, "netvlad", {})
    sd = jax_to_state_dict(v, port)  # raises on any unconsumed leaf
    jax_paths = {tuple(p.key for p in path) for c in v for path, _ in
                 jax.tree_util.tree_flatten_with_path(v[c])[0]}
    mine = {flax_path(n, t) for n, t in sd.items()}
    assert mine == jax_paths
    assert len(sd) == len(jax_paths)


def test_backbone_output_dims():
    for b in ("resnet18conv4", "resnet18conv5", "resnet50conv4",
              "resnet50conv5", "resnet101conv4", "resnet101conv5", "vgg16",
              "alexnet", "vit", "cct384"):
        assert backbone_output_dim(b) == jax_dim(b)


@pytest.mark.parametrize("positional", ["learnable", "sine"])
def test_cct_matches_jax(positional):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    m = JaxCCT(embed_dim=64, num_layers=2, num_heads=4,
               positional_embedding=positional)
    v = random_variables(m, rng, x)
    want_t, want_p = m.apply(v, x)
    port = load_jax_variables(
        CCT((IMG, IMG), embed_dim=64, num_layers=2, num_heads=4,
            positional_embedding=positional), v).eval()
    with torch.no_grad():
        got_t, got_p = port(torch.from_numpy(x))
    close(got_t.numpy(), want_t, what="tokens")
    close(got_p.numpy(), want_p, what="pooled")


def test_cct_training_refused_where_jax_fails():
    """JAX's stochastic depth needs a 'dropout' rng its train step never
    passes: two layers fail there, one layer (rate 0) trains."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    for layers, fails in ((2, True), (1, False)):
        m = JaxNet(backbone="cct384", aggregation="seqpool",
                   trunc_te=layers, train=True)
        v = random_variables(JaxNet(backbone="cct384", aggregation="seqpool",
                                    trunc_te=layers), rng, x)
        port = load_jax_variables(GeoLocalizationNet(
            "cct384", "seqpool", trunc_te=layers, image_hw=(32, 32)), v)
        port.train()
        if fails:
            with pytest.raises(Exception, match="dropout"):
                m.apply(v, x)
            with pytest.raises(NotImplementedError, match="dropout"):
                port(torch.from_numpy(x))
        else:
            want = m.apply(v, x)
            got = port(torch.from_numpy(x))
            close(got.detach().numpy(), want)


def test_token_geometry_is_fixed_at_build():
    _, _, _, port = pair("vit", "cls", {})
    with pytest.raises(ValueError, match="positional"):
        port(torch.zeros(1, 2 * IMG, IMG, 3))
    # JAX's ViT reshapes its patch tokens to a square map: a non-square
    # token grid fails there and here
    port = GeoLocalizationNet("vit", "gem", trunc_te=1, image_hw=(32, 64))
    with pytest.raises(ValueError, match="square"):
        port(torch.zeros(1, 32, 64, 3))
