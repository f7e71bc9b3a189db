"""The port's camera-only GeoLoc tower, CCT + NetVLAD, held against the
benchmark's plain reference (``portbench/reference/geoloc.py``) on the CPU
at a small size: 64 px images (16 tokens), two encoder layers (and the
full 14 where depth matters), 8 clusters, the benchmark's seeded weights
and clusters (``portbench/mixes/embed_geoloc.py``).

* fp32 (JAX's precision, the default): the tower matches the reference to
  fp32's rounding, and is bit-identical to the parent commit's tower (its
  forward kept here verbatim);
* bf16 (the serving precision): every product rounds where the
  reference's does, so the tokens sit far closer to the bf16 reference
  than to the fp32 one, the head on given tokens matches the bf16
  reference's to fp32's rounding, and the fp8 control fails each
  tolerance;
* the spans: one ``geoloc.attn`` a layer under ``geoloc.encoder``;
* the compute dtype reaches CCT and the NetVLAD head behind it, no other
  backbone or head.
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from agplace_tpu_torch import config
from agplace_tpu_torch.infer import build_towers, make_infer_fns
from agplace_tpu_torch.models.layers import (Conv2d, Dense, conv2d_nhwc, l2n,
                                             max_pool_nhwc)
from agplace_tpu_torch.models.pooling import POOLS
from agplace_tpu_torch.utils import spans
from portbench.harness import seeded
from portbench.mixes.embed_geoloc import arch_of, make_state, place_clusters
from portbench.reference.geoloc import GeoLocReference

torch.set_num_threads(2)

IMG, B, CLUSTERS = 64, 4, 8
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CASES = [(2, 3), (2, 4), (14, 3)]  # (encoder layers, seed)
# Tolerances, as the widest relative L2 gap over the rows (measured over
# these cases and seeds 5-7):
# fp32 against fp32: the same arithmetic summed in other orders.  The
# tokens agree to the bit (measured 0); NetVLAD's sharp softmax (alpha
# ~20-200) magnifies the last bits of its sums (measured <= 1.3e-5).
FP32_TOKENS_TOL = 1e-6
FP32_TOL = 1e-4
# bf16 against the reference rounding at the same points: a product's fp32
# sum in another order now and then rounds to the neighbouring bf16 value
# (2^-8 of it), and that travels through the layers.  Tokens: measured
# <= 6.5e-4 at 2 layers, 3.6e-3 at 14, where the fp32 reference reads
# >= 1.2e-2 and the fp8 control >= 0.16.  The head on the same tokens:
# measured <= 1.1e-5 (fp32 head >= 3e-3, fp8 >= 0.05).  The descriptors,
# through NetVLAD's softmax: measured <= 0.029 (fp8 >= 0.25).
BF16_TOKENS_TOL = 8e-3
BF16_HEAD_TOL = 1e-4
BF16_TOL = 0.06


def geoloc_cfg(dtype="float32", layers=2, backbone="cct384",
               aggregation="netvlad"):
    cfg = config.kitti360_config()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, modelq="geoloc", backbone=backbone,
            aggregation=aggregation, netvlad_clusters=CLUSTERS,
            share_qdb=True, trunc_te=layers, compute_dtype=dtype,
            pretrained=False),
        data=dataclasses.replace(cfg.data, q_resize=IMG, db_resize=IMG))


def tower(dtype="float32", layers=2, seed=3, aggregation="netvlad"):
    """(the query tower with the benchmark's seeded weights, the weights as
    the reference reads them, B seeded images)."""
    cfg = geoloc_cfg(dtype, layers, aggregation=aggregation)
    mm, db = build_towers(cfg, "cpu", None)
    assert db is None
    state = make_state({"mm." + k: tuple(v.shape)
                        for k, v in mm.state_dict().items()}, seed, "cpu")
    images = seeded.images(seeded.generator(seed, 2, "cpu"),
                           (B, IMG, IMG, 3), cfg.data.norm_mean,
                           cfg.data.norm_std, "cpu")
    if aggregation == "netvlad":
        place_clusters(state, arch_of(cfg), images, seed)
    mm.load_state_dict({k[3:]: v for k, v in state.items()})
    return mm, state, images


def ref(precision, layers=2):
    return GeoLocReference(precision, {"layers": layers, "heads": 6,
                                       "vlad_block": 3})


def gap(got, want):
    """The widest relative L2 gap over the rows (the benchmark's
    ``desc_rel_err``; tokens are rows too)."""
    got = got.float().reshape(-1, got.shape[-1])
    want = want.reshape(-1, want.shape[-1])
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


def embed(mm, images):
    embed_q, _ = make_infer_fns(mm, None)
    return embed_q(images, None)


@pytest.mark.parametrize("layers,seed", CASES)
def test_fp32_tower_matches_the_reference(layers, seed):
    mm, state, images = tower("float32", layers, seed)
    got = embed(mm, images)
    assert got.dtype == torch.float32 and got.shape == (B, CLUSTERS * 384)
    with torch.no_grad():
        tokens = mm.backbone(images)[0]
        assert gap(tokens, ref("float32", layers).encode(state, images)) \
            <= FP32_TOKENS_TOL
        assert gap(got, ref("float32", layers)(state, images)) <= FP32_TOL


@pytest.mark.parametrize("layers,seed", CASES)
def test_bf16_tower_matches_the_reference_at_its_rounding_points(layers,
                                                                   seed):
    """Tokens, the head on the same tokens and the descriptors, each
    within its tolerance of the bf16 reference; the tokens farther than
    it from the fp32 reference, and the fp8 control outside it."""
    mm, state, images = tower("bfloat16", layers, seed)
    got = embed(mm, images)
    assert got.dtype == torch.float32
    with torch.no_grad():
        tokens = mm.backbone(images)[0]
        want = {p: ref(p, layers).encode(state, images)
                for p in ("bfloat16", "float32", "fp8")}
        assert gap(tokens, want["bfloat16"]) <= BF16_TOKENS_TOL
        assert gap(tokens, want["float32"]) > BF16_TOKENS_TOL
        assert gap(want["fp8"], want["bfloat16"]) > BF16_TOKENS_TOL
        t = want["float32"]  # one set of tokens into both heads
        head = mm.aggregation(mm._square(t))
        assert gap(head, ref("bfloat16").netvlad(t, state)) <= BF16_HEAD_TOL
        assert gap(head, ref("float32").netvlad(t, state)) > BF16_HEAD_TOL
        desc = ref("bfloat16", layers)(state, images)
        assert gap(got, desc) <= BF16_TOL
        assert gap(ref("fp8", layers)(state, images), desc) > BF16_TOL


# ---------------------------------------------------------- the parent's tower
def parent_dense(d, x):
    dt = torch.promote_types(x.dtype, d.weight.dtype)
    return F.linear(x.to(dt), d.weight.to(dt),
                    None if d.bias is None else d.bias.to(dt))


def parent_cct(m, x):
    """CCT.forward at the parent commit, on ``m``'s parameters."""
    for conv in m.tokenizer.convs:
        dt = torch.promote_types(x.dtype, conv.weight.dtype)
        x = max_pool_nhwc(torch.relu(conv2d_nhwc(
            x, conv.weight, None, conv.stride, conv.padding, dt)), 3, 2, 1)
    b, h, w, c = x.shape
    tokens = x.reshape(b, h * w, c)
    b, n, c = tokens.shape
    tokens = tokens + m.pos.to(tokens.dtype)
    h = m.heads
    hd = c // h
    scale = hd ** -0.5
    for i in range(m.num_layers):
        y = getattr(m, f"pre_norm_{i}")(tokens)
        qkv = parent_dense(getattr(m, f"qkv_{i}"), y).reshape(b, n, 3, h, hd)
        q, k, v = qkv.unbind(dim=2)
        attn = torch.softmax(torch.einsum(
            "bnhd,bmhd->bhnm", q.float(), k.float()) * scale, dim=-1)
        y = torch.einsum("bhnm,bmhd->bnhd", attn, v.float())
        y = parent_dense(getattr(m, f"proj_{i}"), y.reshape(b, n, c).to(
            tokens.dtype))
        tokens = getattr(m, f"norm1_{i}")(tokens + y)
        y = parent_dense(getattr(m, f"mlp2_{i}"), F.gelu(parent_dense(
            getattr(m, f"mlp1_{i}"), tokens), approximate="tanh"))
        tokens = tokens + y
    tokens = m.ln_f(tokens)
    attn = torch.softmax(parent_dense(m.attention_pool, tokens), dim=1)
    return tokens, (attn * tokens).sum(dim=1)


def parent_vlad(x, soft, centroids):
    weighted = torch.einsum("bnk,bnc->bkc", soft, x.float())
    counts = soft.sum(dim=1)
    vlad = l2n(weighted - counts[..., None] * centroids[None].float())
    return l2n(vlad.reshape(vlad.shape[0], -1))


def parent_tower(net, x):
    """GeoLocalizationNet.forward at the parent commit for a CCT tower."""
    tokens, pooled = parent_cct(net.backbone, x)
    if net.tokens_out:
        return l2n(pooled)
    feat = net._square(tokens)
    if net.aggregation_name in POOLS:
        return net.aggregation(l2n(feat))
    nv = net.aggregation.netvlad
    x = l2n(feat.reshape(feat.shape[0], -1, feat.shape[-1]))
    soft = torch.softmax(x.float() @ nv.assign_w.float(), dim=-1)
    return parent_vlad(x, soft, nv.centroids)


@pytest.mark.parametrize("aggregation", ["netvlad", "seqpool", "gem"])
def test_fp32_tower_is_the_parents_bit_for_bit(aggregation):
    mm, _, images = tower("float32", aggregation=aggregation)
    with torch.no_grad():
        assert torch.equal(mm(images), parent_tower(mm, images))


# ----------------------------------------------------------------- the spans
@pytest.fixture
def spans_on():
    spans.enable(True)
    spans.drain()
    yield
    spans.enable(False)
    spans.drain()


@pytest.mark.parametrize("layers", [2, 14])
def test_spans_count_one_attn_a_layer(spans_on, layers):
    mm, _, images = tower("bfloat16", layers)
    spans.drain()
    embed(mm, images)
    d = spans.drain()
    assert d.calls == {"entry.embed_queries": 1, "geoloc.tokenizer": 1,
                       "geoloc.encoder": 1, "geoloc.attn": layers,
                       "geoloc.aggregation": 1}
    parent = {r.name: r.parent for r in d.records}
    assert parent["geoloc.attn"] == "geoloc.encoder"
    for name in ("geoloc.tokenizer", "geoloc.encoder", "geoloc.aggregation"):
        assert parent[name] == "entry.embed_queries"
    enc = next(r for r in d.records if r.name == "geoloc.encoder")
    for r in d.records:
        if r.name == "geoloc.attn":
            assert enc.t0_ns <= r.t0_ns <= r.t1_ns <= enc.t1_ns


def test_spans_change_no_number(spans_on):
    mm, _, images = tower("bfloat16")
    on = embed(mm, images)
    spans.enable(False)
    assert torch.equal(on, embed(mm, images))


# ------------------------------------------------ where the compute dtype goes
def _dtypes(mm):
    return ({m.dtype for m in mm.modules() if isinstance(m, (Conv2d, Dense))
             and m is not getattr(mm.backbone, "attention_pool", None)},
            getattr(getattr(mm, "aggregation", None), "netvlad", None))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_compute_dtype_reaches_cct_and_its_netvlad(dtype):
    mm, _ = build_towers(geoloc_cfg(dtype), "cpu", None)
    layers, netvlad = _dtypes(mm)
    assert layers == {DTYPES[dtype]}
    assert netvlad.dtype == DTYPES[dtype]
    assert mm.backbone.attention_pool.dtype is None  # the seqpool head: fp32


@pytest.mark.parametrize("backbone,aggregation", [
    ("resnet18conv4", "netvlad"), ("resnet18conv4", "gem"),
    ("vit", "netvlad")])
def test_other_backbones_and_their_heads_stay_fp32(backbone, aggregation):
    cfg = geoloc_cfg("bfloat16", backbone=backbone, aggregation=aggregation)
    mm, _ = build_towers(cfg, "cpu", None)
    layers, netvlad = _dtypes(mm)
    assert layers <= {torch.float32, None}
    assert netvlad is None or netvlad.dtype == torch.float32
    x = torch.randn(2, IMG, IMG, 3)
    with torch.no_grad():
        assert mm(x).dtype == torch.float32
