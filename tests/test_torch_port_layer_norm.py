"""CCT's residual LayerNorm kernel: its plain version, launch geometry, gate
and the encoder's routing, on the CPU (``ops/residual_layer_norm.py``,
``models/layers.py``, ``models/cct.py``); and, on the card, the kernel
against the eager chain.

What runs here:

* ``residual_layer_norm_plain`` (what the CPU runs) is the eager chain bit
  for bit (the fp32 add of the bf16 branch, ``F.layer_norm``, the cast
  ``Dense.forward`` makes) for each output the wrapper writes, at C 384
  and 256 and at 1, 7 and 1,728 rows;
* ``ln_grid`` gives every row one warp; the kernel is compiled for the module's constants and is named so that
  the GeoLoc benchmark counts it as a LayerNorm and no hand kernel;
* the wrapper raises before any launch on what the kernel does not take;
* ``CCT._encode`` sends bf16 inference's 29 seams to the wrapper (1 with
  no residual, 27 with one, and ``ln_f``), through 2 x layers + 1
  ``LayerNorm`` calls as before; fp32, training and autograd send none;
  on the CPU the bf16 tower through the wrapper is the eager tower bit
  for bit; the MM's fusion and the aerial tower never reach it.

The card's tests (marked ``cuda``, skipped without a card) hold the kernel
to the eager chain at the GeoLoc cell's [128 x 576, 384] and at odd row
counts: t exact, LN(t) within ``LN_ATOL``, the bf16 operand equal on
``OPERAND_EQUAL`` of the elements and elsewhere one ulp off, or within
``LN_ATOL`` where the norm is near zero.
"""

import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from agplace_tpu_torch.models import cct
from agplace_tpu_torch.models.layers import LayerNorm
from agplace_tpu_torch.ops import _build
from agplace_tpu_torch.ops import residual_layer_norm as rln
from portbench.harness import profiling
from portbench.mixes.embed_geoloc import LAYER_NORM

torch.set_num_threads(2)

_BF16 = torch.bfloat16
EPS = 1e-5
# the rows of the outputs table: (stream, operand, with a residual), as
# CCT asks at pre_norm_{i+1}, norm1_i, ln_f and pre_norm_0
MODES = {"sum+operand": ("sum", True, True),
         "normed+operand": ("normed", True, True),
         "normed": ("normed", False, True),
         "operand, no residual": (None, True, False)}


def _operands(rows, c, seed=0, residual=True, dev="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, c, generator=g) * 3.0 + 0.5
    r = (torch.randn(rows, c, generator=g) * 2.0).to(_BF16) if residual \
        else None
    w = torch.rand(c, generator=g) * 2.0 - 0.5
    b = torch.randn(c, generator=g) * 0.3
    return tuple(t if t is None else t.to(dev) for t in (x, r, w, b))


def _parent_chain(x, r, w, b, stream, operand):
    """The parent's seam in ``CCT._encode`` and ``Dense.forward``: the
    stream's ``tokens + y``, ``LayerNorm.forward``, ``x.to(dt)``."""
    t = x if r is None else x + r
    n = F.layer_norm(t, t.shape[-1:], w.to(t.dtype), b.to(t.dtype), EPS)
    return ({"sum": t, "normed": n, None: None}[stream],
            n.to(_BF16) if operand else None)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _same_bits(got, want):
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(_bits(a), _bits(b))


# ---- the plain version is the eager chain -------------------------------------

@pytest.mark.parametrize("rows", [1, 7, 576 * 3])
@pytest.mark.parametrize("c", [384, 256])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_is_the_eager_chain_bit_for_bit(mode, c, rows):
    stream, operand, res = MODES[mode]
    x, r, w, b = _operands(rows, c, seed=rows + c, residual=res)
    want = _parent_chain(x, r, w, b, stream, operand)
    for fn in (rln.residual_layer_norm_plain,
               rln.fused_residual_layer_norm):  # the CPU: the plain one
        _same_bits(fn(x, w, b, EPS, r, stream, operand), want)


def test_layer_norm_alone_is_f_layer_norm():
    x, _, w, b = _operands(9, 384, seed=3, residual=False)
    m = LayerNorm(384)
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(b)
    assert torch.equal(m(x), F.layer_norm(x, (384,), w, b, 1e-5))


def test_the_check_tells_a_rounding_gap_from_a_far_operand():
    """Two ulps apart near zero (within LN_ATOL) is a rounding gap; two
    ulps apart at 1 is far; the record of an exact copy passes."""
    x = torch.tensor([1.0, 3e-6, -2.0])
    exact = (x, x.to(_BF16))
    assert rln.close_to_chain(rln.chain_gap(exact, exact), "normed", True)
    near = x.to(_BF16).clone()
    near[1] = torch.tensor(3.2e-6).to(_BF16)
    rec = rln.chain_gap((x, near), exact)
    assert rec["operand_max_ulps"] > 1 and rec["operand_far"] == 0
    far = x.to(_BF16).clone()
    far[0] = 1.0 + 2 * torch.finfo(_BF16).eps
    rec = rln.chain_gap((x, far), exact)
    assert rec["operand_far"] == 1
    assert not rln.close_to_chain(rec, None, True)
    off = (x + torch.tensor([0.0, 0.0, 2e-5]), exact[1])
    assert not rln.close_to_chain(rln.chain_gap(off, exact), "normed", True)


def test_ulps_apart_counts_bf16_steps_across_zero():
    one = torch.tensor([1.0], dtype=_BF16)
    up = torch.nextafter(one.float(), torch.tensor([2.0])).to(_BF16)
    assert int(rln.ulps_apart(one, one)) == 0
    assert int(rln.ulps_apart(one, one + torch.finfo(_BF16).eps)) == 1
    assert int(rln.ulps_apart(one, up)) == 0  # fp32's next rounds back
    zeros = torch.tensor([0.0, -0.0], dtype=_BF16)
    assert int(rln.ulps_apart(zeros[:1], zeros[1:])) == 0
    tiny = torch.tensor([0x0001, 0x8001 - 0x10000],
                        dtype=torch.int16).view(_BF16)
    assert int(rln.ulps_apart(tiny[:1], tiny[1:])) == 2


# ---- the launch geometry and the kernel's name --------------------------------

def _cu():
    src = (Path(_build.SRC_DIR) / "residual_layer_norm.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    return src, consts


def test_the_kernel_is_compiled_for_the_modules_constants():
    src, c = _cu()
    assert c["kThreads"] == rln.BLOCK
    assert c["kChunk"] == rln.CHUNK
    assert c["kChunk"] * c["kMaxChunks"] == rln.MAX_C
    assert f"{rln.KERNEL_NAME}(" in src
    # one entry, its arguments as the wrapper passes them
    assert len(_build._SIGNATURES["agp_residual_layer_norm"]) == 6 + 6 + 1


@pytest.mark.parametrize("rows", list(range(1, 50)) + [576, 1731, 73728,
                                                        100003])
def test_ln_grid_gives_every_row_one_warp(rows):
    """Warp w of block b takes row b x WARPS + w: every row once, and no
    block without one."""
    grid = rln.ln_grid(rows)
    taken = [b * rln.WARPS + w for b in range(grid)
             for w in range(rln.WARPS) if b * rln.WARPS + w < rows]
    assert taken == list(range(rows))
    assert (grid - 1) * rln.WARPS < rows <= grid * rln.WARPS


# the name as the profiler reports a launch of the C = 384 instance
PROFILED = ("void (anonymous namespace)::residual_layer_norm_kernel<3>("
            "(anonymous namespace)::LnParams)")


@pytest.mark.parametrize("name", [rln.KERNEL_NAME, PROFILED])
def test_the_kernels_name_is_a_layer_norm_to_the_benchmark(name):
    """The GeoLoc cell counts a profile whole when it holds one kernel
    matching ``layer_norm_kernel`` a LayerNorm call; the name lands under
    ``other``, as PyTorch's LayerNorm kernel did, and no hand kernel's
    pattern claims it."""
    assert re.search(LAYER_NORM, name)
    assert not profiling.HAND.search(name)
    assert not any(re.search(p, name) for p in profiling.KERNEL.values())
    assert profiling.classify(name) == "other"
    assert profiling.k_of(name) is None


# ---- the wrapper's gate -------------------------------------------------------

def _misaligned(t):
    flat = torch.cat([t.new_zeros(1), t.flatten()])
    return flat[1:].view(t.shape)


def _case(x=None, r=None, **kw):
    base = dict(zip("xrwb", _operands(6, 384, seed=5)))
    if x is not None:
        base["x"] = x(base["x"])
    if r is not None:
        base["r"] = r(base["r"])
    return base, {"stream": "sum", "operand": True, **kw}


# (case, operands) the kernel does not take on the card
REFUSED = {
    "bf16 x": lambda: _case(x=lambda x: x.to(_BF16)),
    "fp16 x": lambda: _case(x=lambda x: x.half()),
    "fp32 residual": lambda: _case(r=lambda r: r.float()),
    "fp16 residual": lambda: _case(r=lambda r: r.half()),
    "not dense": lambda: _case(x=lambda x: x.t().contiguous().t(),
                               r=lambda r: r.t().contiguous().t()),
    "misaligned x": lambda: _case(x=_misaligned),
    "misaligned residual": lambda: _case(r=_misaligned),
    "C = 320": lambda: ({k: v if v.dim() == 1 else v[:, :320].contiguous()
                         for k, v in _case()[0].items()} | {
                             "w": torch.ones(320), "b": torch.zeros(320)},
                        _case()[1]),
    "C = 768": lambda: ({k: torch.cat([v, v], dim=-1)
                         for k, v in _case()[0].items()},
                        _case()[1]),
}
# requests no device takes
MISSHAPEN = {
    "weight [383]": (lambda: ({**_case()[0], "w": torch.ones(383)},
                              _case()[1]), "weight and bias must be"),
    "residual of another shape": (lambda: _case(r=lambda r: r[:5]),
                                  "of x's shape"),
    "sum without a residual": (lambda: ({**_case()[0], "r": None},
                                        _case()[1]), "without a residual"),
    "nothing asked for": (lambda: _case(stream=None, operand=False),
                          "neither stream nor operand"),
    "unknown stream": (lambda: _case(stream="normal"), "is none of"),
}


def _call(ops, kw):
    return rln.fused_residual_layer_norm(ops["x"], ops["w"], ops["b"], EPS,
                                         ops["r"], **kw)


@pytest.fixture
def card(monkeypatch):
    """The wrapper sees its operands as on the card; a launch fails the
    test."""
    def no_launch(*a):
        raise AssertionError("launched")
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "call", no_launch)


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_wrapper_raises_on_the_card_before_any_launch(case, card):
    ops, kw = REFUSED[case]()
    before = rln.fused_residual_layer_norm.launches
    with pytest.raises(ValueError, match="must be fp32 and the residual "
                                         "bf16, dense, 16-byte aligned"):
        _call(ops, kw)
    assert rln.fused_residual_layer_norm.launches == before


@pytest.mark.parametrize("on_card", [False, True])
@pytest.mark.parametrize("case", list(MISSHAPEN))
def test_the_wrapper_refuses_a_misshapen_request_everywhere(case, on_card,
                                                            monkeypatch):
    monkeypatch.setattr(_build, "on_cuda", lambda *t: on_card)
    make, msg = MISSHAPEN[case]
    with pytest.raises(ValueError, match=msg):
        _call(*make())


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_cpu_runs_the_plain_version_for_any_operands(case):
    ops, kw = REFUSED[case]()
    want = _parent_chain(ops["x"], ops["r"], ops["w"], ops["b"],
                         kw["stream"], kw["operand"])
    _same_bits(_call(ops, kw), want)


# ---- CCT's routing ----------------------------------------------------------------

class _Spy:
    """``fused_residual_layer_norm`` behind a recorder: (with a residual,
    stream, operand) of each call."""

    def __init__(self, real):
        self.real, self.calls = real, []

    def __call__(self, x, weight, bias, eps, residual=None,
                 stream="normed", operand=False):
        self.calls.append((residual is not None, stream, operand))
        return self.real(x, weight, bias, eps, residual, stream, operand)


@pytest.fixture
def spy(monkeypatch):
    s = _Spy(rln.fused_residual_layer_norm)
    monkeypatch.setattr(rln, "fused_residual_layer_norm", s)
    return s


IMG = 64  # 16 tokens


def _cct(dtype, seed=0, stochastic_depth=0.1, layers=14):
    m = cct.CCT((IMG, IMG), num_layers=layers, dtype=dtype,
                stochastic_depth=stochastic_depth)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name == "pos":
                p.copy_(torch.randn(p.shape, generator=g) * 0.2)
            elif p.dim() == 4:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
                p.sub_(p.mean(dim=(1, 2, 3), keepdim=True))
            elif p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
            else:  # LayerNorm affines and biases away from 1 and 0
                p.copy_(torch.randn(p.shape, generator=g) * 0.3
                        + (1.0 if name.endswith(".weight") else 0.0))
    return m.eval()


def _images(seed=1, b=2):
    return torch.randn(b, IMG, IMG, 3,
                       generator=torch.Generator().manual_seed(seed))


def _seams(layers):
    """The calls a bf16 inference forward makes, in order."""
    return ([(False, None, True), (True, "normed", True)]
            + [(True, "sum", True), (True, "normed", True)] * (layers - 1)
            + [(True, "normed", False)])


@pytest.mark.parametrize("grad_mode", ["inference_mode", "no_grad"])
@pytest.mark.parametrize("layers", [14, 2, 1])
def test_bf16_inference_sends_every_seam_to_the_wrapper(spy, grad_mode,
                                                        layers):
    m, x = _cct(_BF16, layers=layers), _images()
    with getattr(torch, grad_mode)():
        m(x)
    assert spy.calls == _seams(layers)
    if layers == 14:
        assert len(spy.calls) == 29
        assert sum(not c[0] for c in spy.calls) == 1
        assert sum(c[0] and c[2] for c in spy.calls) == 27


def test_fp32_keeps_the_eager_chain(spy):
    m, x = _cct(torch.float32), _images()
    with torch.no_grad():
        m(x)
    assert spy.calls == []


@pytest.mark.parametrize("dtype", [_BF16, torch.float32])
def test_training_keeps_the_eager_chain(spy, dtype):
    m, x = _cct(dtype, stochastic_depth=0.0), _images()
    m.train()
    tokens, pooled = m(x)
    pooled.float().sum().backward()
    assert spy.calls == []
    assert m.norm1_3.weight.grad is not None


@pytest.mark.parametrize("dtype", [_BF16, torch.float32])
def test_an_input_that_needs_a_gradient_keeps_the_eager_chain(spy, dtype):
    """Eval mode, but autograd follows: the weights need a gradient, or
    only the images do, or only one LayerNorm's weight does."""
    m, x = _cct(dtype), _images()
    m(x)
    assert spy.calls == []
    for p in m.parameters():
        p.requires_grad_(False)
    m(x.requires_grad_(True))[1].float().sum().backward()
    assert spy.calls == [] and x.grad is not None
    m.ln_f.weight.requires_grad_(True)
    m(x.detach())[1].float().sum().backward()
    assert spy.calls == [] and m.ln_f.weight.grad is not None
    m.ln_f.weight.requires_grad_(False)
    with torch.no_grad():  # nothing needs one: the gate opens at bf16
        m(x)
    assert len(spy.calls) == (29 if dtype == _BF16 else 0)


@pytest.mark.parametrize("dtype", [_BF16, torch.float32])
@pytest.mark.parametrize("layers", [14, 3])
def test_layer_norm_modules_are_called_2_layers_plus_1_times(dtype, layers):
    """The GeoLoc benchmark counts LayerNorm module calls with forward
    hooks and wants one LayerNorm kernel each."""
    m, x = _cct(dtype, layers=layers), _images()
    calls = []
    for mod in m.modules():
        if isinstance(mod, LayerNorm):
            mod.register_forward_hook(lambda *a: calls.append(1))
    with torch.inference_mode():
        m(x)
    assert len(calls) == 2 * layers + 1


@pytest.mark.parametrize("layers", [14, 2])
def test_the_bf16_tower_through_the_wrapper_is_the_eager_tower(
        spy, monkeypatch, layers):
    """On the CPU the wrapper's plain version is the chain, so the tower's
    tokens and pooled vector keep the eager tower's bits."""
    m, x = _cct(_BF16, seed=3, layers=layers), _images(4)
    with torch.inference_mode():
        got = m(x)
    assert len(spy.calls) == 2 * layers + 1
    monkeypatch.setattr(cct.CCT, "_fused_seams", lambda self, t: False)
    with torch.inference_mode():
        want = m(x)
    assert len(spy.calls) == 2 * layers + 1
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert torch.equal(_bits(a), _bits(b))


def test_the_mm_fusion_and_the_aerial_tower_never_reach_the_wrapper(spy):
    """The MM's stage-2 fusion and the aerial tower's MLP call their
    LayerNorms on x alone, in bf16 inference too: ``F.layer_norm``."""
    import dataclasses

    import numpy as np

    from agplace_tpu_torch import synthetic_config
    from agplace_tpu_torch.data.voxels import prepare_query_vox
    from agplace_tpu_torch.infer import build_towers, make_infer_fns

    cfg = synthetic_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="bfloat16"))
    mm, db = build_towers(cfg, "cpu", torch.Generator().manual_seed(0))
    calls = {"mm": 0, "db": 0}
    for name, tower in (("mm", mm), ("db", db)):
        for mod in tower.modules():
            if isinstance(mod, LayerNorm):
                mod.register_forward_hook(
                    lambda *a, n=name: calls.__setitem__(n, calls[n] + 1))
    embed_q, embed_db = make_infer_fns(mm, db)
    rng = np.random.default_rng(0)
    side = cfg.data.q_resize
    images = torch.from_numpy(
        rng.standard_normal((2, side, side, 3)).astype(np.float32))
    vox = prepare_query_vox(cfg, rng.uniform(
        -30, 30, (2, 500, 3)).astype(np.float32), "cpu")
    embed_q(images, vox)
    side = cfg.data.db_resize
    embed_db(torch.from_numpy(rng.standard_normal(
        (2, db.nmap, side, side, 3)).astype(np.float32)))
    assert calls["mm"] > 0 and calls["db"] > 0
    assert spy.calls == []


# ---- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [128 * 576, 1, 7, 1731, 100003])
@pytest.mark.parametrize("mode", list(MODES))
def test_the_kernel_is_the_eager_chain_to_rounding(cuda, mode, rows):
    stream, operand, res = MODES[mode]
    x, r, w, b = _operands(rows, 384, seed=rows, residual=res, dev=cuda)
    with torch.inference_mode():
        before = rln.fused_residual_layer_norm.launches
        got = rln.fused_residual_layer_norm(x, w, b, EPS, r, stream,
                                            operand)
        assert rln.fused_residual_layer_norm.launches == before + 1
        want = _parent_chain(x, r, w, b, stream, operand)
    torch.cuda.synchronize()
    gap = rln.chain_gap(got, want)
    if stream == "sum":
        assert torch.equal(_bits(got[0]), _bits(want[0]))
    elif stream == "normed":
        assert gap["stream_max_abs"] <= rln.LN_ATOL, gap
    if operand:
        assert got[1].dtype == _BF16
        assert gap["operand_equal"] >= rln.OPERAND_EQUAL, gap
        assert gap["operand_far"] == 0, gap
    assert rln.close_to_chain(gap, stream, operand)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [128, 256, 512])
def test_the_kernel_takes_every_width_to_its_limit(cuda, c):
    x, r, w, b = _operands(333, c, seed=c, dev=cuda)
    with torch.inference_mode():
        got = rln.fused_residual_layer_norm(x, w, b, EPS, r, "normed",
                                            True)
        want = _parent_chain(x, r, w, b, "normed", True)
    gap = rln.chain_gap(got, want)
    assert gap["stream_max_abs"] <= rln.LN_ATOL, gap
    assert gap["operand_far"] == 0, gap


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16 x", "fp32 residual", "not dense",
                                  "misaligned x", "C = 768"])
def test_the_wrapper_raises_on_the_card(cuda, case):
    ops, kw = REFUSED[case]()
    ops = {k: v if v is None else v.to(cuda) for k, v in ops.items()}
    if case == "misaligned x":  # .to() copies: misalign on the card
        ops["x"] = _misaligned(ops["x"])
    before = rln.fused_residual_layer_norm.launches
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="must be fp32"):
        _call(ops, kw)
    assert rln.fused_residual_layer_norm.launches == before


@pytest.mark.cuda
def test_cct_bf16_inference_launches_the_kernel_once_a_seam(cuda):
    m = _cct(_BF16).to(cuda)
    x = _images().to(cuda)
    before = rln.fused_residual_layer_norm.launches
    with torch.inference_mode():
        tokens, pooled = m(x)
    torch.cuda.synchronize()
    assert rln.fused_residual_layer_norm.launches == before + 29
    assert bool(torch.isfinite(pooled).all())
    m2 = _cct(torch.float32).to(cuda)  # fp32: the eager chain
    with torch.inference_mode():
        m2(x)
    assert rln.fused_residual_layer_norm.launches == before + 29
