"""The ResNet epilogue kernel's plain version, gate and launch geometry, on
the CPU (``ops/bn_act.py``, ``models/resnet.epilogue``).

The kernel runs only on the card (``test_torch_port_cuda.py`` holds it to
the eager chain bit for bit there).  What surrounds it runs here:

* ``bn_act_plain`` (what the CPU runs) equals the blocks' eager chain
  (``BatchNorm2D``'s eval forward, ``+ idn``, ``torch.relu``) bit for bit in
  all three instances, bf16 and fp32, with negative scales, NaN and -0.0 in
  the maps; whole eval trunks equal their eager forward, every epilogue
  through the wrapper (its plain version here);
* the gate: training mode and anything that needs a gradient take the
  eager chain; every other epilogue takes the wrapper, which on the card
  raises for maps the kernel cannot take (not dense, misaligned, C % 8,
  fp16, a residual unlike the map) and on the CPU runs the plain version;
* ``resnet18_epilogues`` is what a real trunk launches, and the cells' maps
  it gives are those of their image sizes;
* ``bn_act_grid`` replayed thread by thread with the kernel's arithmetic;
* the kernel's name lands in no class of the benchmark's profile reader,
  and ``ops.launches()`` stays the wrappers the reader vouches for.
"""

import copy
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from agplace_tpu_torch import ops
from agplace_tpu_torch.models import resnet
from agplace_tpu_torch.models.layers import max_pool_nhwc
from agplace_tpu_torch.models.norm import BatchNorm2D
from agplace_tpu_torch.ops import _build, bn_act
from portbench.harness import cell as cells

_BF16 = torch.bfloat16
DTYPES = [_BF16, torch.float32]
INSTANCES = ["bn", "bn+idn", "bn+bn_ds"]
# the benchmark's embed cells: batch, image [H, W] (the image branch's or
# the aerial tower's ResNet-18 input)
EMBED_CELLS = {c.name: (c.params["batch"], tuple(c.params["image_hw"]))
               for c in map(cells.load, (w["name"] for w in
                                         cells.benchmark()["workloads"]))
               if c.mix == "embed"}
H100_SMS = 132


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _equal_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a), _bits(b))


def _equal_but_nan_bits(a, b):
    """Bit-equal but for the bits of NaNs, which must be in the same
    places: the CPU's bf16 kernels give a NaN's sign by code path
    (vectorised or not), so the same chain over another memory layout may
    flip it."""
    assert a.dtype == b.dtype and a.shape == b.shape
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    assert torch.equal(_bits(a)[~nan], _bits(b)[~nan])


def _bn(c, g):
    """An eval BatchNorm2D with drawn statistics, a third of its scales
    negative."""
    bn = BatchNorm2D(c)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g) * 2 - 0.7)
        bn.bias.copy_(torch.randn(c, generator=g))
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.1)
    return bn.eval()


def _map(shape, dtype, g, specials=True):
    """A map with NaN, -0.0 and +0.0 planted where ``specials``."""
    x = (torch.randn(shape, generator=g) * 3).to(dtype)
    if specials:
        flat = x.view(-1)
        idx = torch.randperm(flat.numel(), generator=g)[:30]
        flat[idx[:10]] = float("nan")
        flat[idx[10:20]] = -0.0
        flat[idx[20:]] = 0.0
    return x


def _instance(inst, shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x, bn = _map(shape, dtype, g), _bn(c, g)
    r = _map(shape, dtype, g) if inst != "bn" else None
    rbn = _bn(c, g) if inst == "bn+bn_ds" else None
    return x, bn, r, rbn


def _eager(x, bn, r=None, rbn=None):
    """The blocks' chain as it was written before the epilogue gate."""
    out = bn(x)
    if r is None:
        return torch.relu(out)
    idn = rbn(r) if rbn is not None else r
    return torch.relu(out + idn)


# ---- the plain version is the eager chain ---------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("inst", INSTANCES)
def test_plain_is_bit_equal_to_the_eager_chain(inst, dtype):
    x, bn, r, rbn = _instance(inst, (2, 5, 7, 24), dtype)
    want = _eager(x, bn, r, rbn)
    raff = rbn.affine() if rbn is not None else None
    _equal_bits(bn_act.bn_act_plain(x, *bn.affine(), r, raff), want)
    _equal_bits(bn_act.fused_bn_act(x, *bn.affine(), r, raff), want)
    # written into a given output, as the blocks hand over the conv's
    y = x.clone()
    _equal_bits(bn_act.fused_bn_act(y, *bn.affine(), r, raff, out=y), want)
    _equal_bits(y, want)
    # the specials reached the output: NaN passes the relu, -0.0 stays
    assert bool(torch.isnan(want).any())


def test_wrapper_refuses_affines_not_of_width_c():
    x, bn, r, rbn = _instance("bn+bn_ds", (1, 2, 2, 16), _BF16)
    s, b = bn.affine()
    with pytest.raises(ValueError, match=r"must be \[16\]"):
        bn_act.fused_bn_act(x, s[:8], b)
    with pytest.raises(ValueError, match="without a residual"):
        bn_act.fused_bn_act(x, s, b, None, rbn.affine())


@pytest.mark.parametrize("on_card", [False, True])
def test_wrapper_refuses_a_residual_or_out_unlike_the_map(on_card,
                                                          monkeypatch):
    """On every device: the eager chain would promote a residual of
    another dtype, the kernel cannot."""
    monkeypatch.setattr(_build, "on_cuda", lambda *t: on_card)
    x, bn, r, _ = _instance("bn+idn", (1, 2, 2, 16), _BF16)
    s, b = bn.affine()
    for kw in (dict(residual=r.float()), dict(residual=r[:, :1]),
               dict(out=x.float()), dict(out=x[:, :1])):
        with pytest.raises(ValueError, match="must be of x's shape"):
            bn_act.fused_bn_act(x, s, b, **kw)


def _eager_block(blk, x):
    if isinstance(blk, resnet.BasicBlock):
        out = torch.relu(blk.bn1(blk.conv1(x)))
        out = blk.bn2(blk.conv2(out))
    else:
        out = torch.relu(blk.bn1(blk.conv1(x)))
        out = torch.relu(blk.bn2(blk.conv2(out)))
        out = blk.bn3(blk.conv3(out))
    idn = (blk.downsample_bn(blk.downsample_conv(x)) if blk.downsample
           else x)
    return torch.relu(out + idn)


def _eager_trunk(m, x):
    x = max_pool_nhwc(torch.relu(m.bn1(m.conv1(x))), 3, 2, 1)
    maps = []
    for stage in m.blocks:
        for blk in stage:
            x = _eager_block(blk, x)
        maps.append(x)
    return x, maps


def _trunk(arch, stages, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    m = resnet.ResNetFeatures(arch, stages, dtype)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("conv1.weight") and p.shape[1] == 3:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
            elif p.dim() == 4:
                p.copy_(torch.randn(p.shape, generator=g)
                        * (2.0 / p[0].numel()) ** 0.5)
    for mod in m.modules():
        if isinstance(mod, BatchNorm2D):
            fresh = _bn(mod.weight.numel(), g)
            mod.load_state_dict(fresh.state_dict())
    return m.eval()


class _Spy:
    """``fused_bn_act`` behind a recorder: the calls the gate lets
    through."""

    def __init__(self, real):
        self.real, self.calls = real, []

    def __call__(self, x, *a, **k):
        r, ra = (a + (None, None, None))[2:4]
        self.calls.append((tuple(x.shape), r is not None, ra is not None,
                           k.get("out") is x))
        return self.real(x, *a, **k)


@pytest.fixture
def spy(monkeypatch):
    s = _Spy(bn_act.fused_bn_act)
    monkeypatch.setattr(bn_act, "fused_bn_act", s)
    return s


@pytest.fixture
def card(monkeypatch):
    """The wrapper sees every map as on the card: it checks the maps as it
    does there, and fails at its first call of the card after that."""
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)


# resnet18 / resnet50, 3 stages: (blocks, epilogues a block, blocks with a
# downsample); the stem adds one epilogue
TRUNK_BLOCKS = {"resnet18": (6, 2, 2), "resnet50": (13, 3, 3)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_trunk_on_the_cpu_takes_the_eager_chain(arch, dtype, spy):
    """Under no_grad, every epilogue through the wrapper, whose plain
    version the CPU runs: the eager chain's bits."""
    m = _trunk(arch, 3, dtype)
    x = torch.randn(2, 40, 36, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got, maps = m(x)
        want, wmaps = _eager_trunk(m, x)
    _equal_bits(got, want)
    for a, b in zip(maps, wmaps):
        _equal_bits(a, b)
    blocks, per_block, _ = TRUNK_BLOCKS[arch]
    assert len(spy.calls) == 1 + blocks * per_block


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_trunk_through_the_open_gate_equals_the_eager_chain(arch, dtype, spy):
    m = _trunk(arch, 3, dtype)
    x = torch.randn(2, 40, 36, 3, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        got, maps = m(x)
    with torch.no_grad():
        want, wmaps = _eager_trunk(m, x)
    _equal_bits(got, want)
    for a, b in zip(maps, wmaps):
        _equal_bits(a, b)
    blocks, per_block, ds = TRUNK_BLOCKS[arch]
    assert len(spy.calls) == 1 + blocks * per_block
    assert all(written for *_, written in spy.calls)  # over the conv's map
    # the three instances, each where the blocks put it
    kinds = [(r, ra) for _, r, ra, _ in spy.calls]
    assert kinds.count((True, True)) == ds
    assert kinds.count((True, False)) == blocks - ds
    assert kinds.count((False, False)) == 1 + blocks * (per_block - 1)


@pytest.mark.parametrize(
    "hw", [(40, 36), (33, 17), (7, 9), (64, 239)]
    + [hw for _, hw in EMBED_CELLS.values()],
    ids=lambda hw: "x".join(map(str, hw)))
def test_resnet18_epilogues_are_what_a_trunk_launches(hw, spy):
    """At odd and even sizes, and at the benchmark's embed cells' image
    sizes: the maps and instances of every epilogue, in order."""
    m = _trunk("resnet18", 3, torch.float32)
    x = torch.randn(1, *hw, 3, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        m(x)
    inst = {(False, False): 0, (True, False): 1, (True, True): 2}
    got = [(shape[1:], inst[r, ra]) for shape, r, ra, _ in spy.calls]
    assert got == bn_act.resnet18_epilogues(*hw)


def test_the_gate_opens_for_a_dense_eval_map(spy):
    x, bn, r, rbn = _instance("bn+bn_ds", (2, 6, 5, 32), _BF16)
    with torch.no_grad():
        want = _eager(x, bn, r, rbn)
        got = resnet.epilogue(False, x.clone(), bn, r, rbn)
    _equal_bits(got, want)
    assert len(spy.calls) == 1


def test_training_mode_takes_the_eager_chain(spy):
    x, bn, r, _ = _instance("bn+idn", (2, 6, 6, 16), _BF16)
    twin = copy.deepcopy(bn).train()  # training mode moves the statistics
    bn.train()
    with torch.no_grad():
        got = resnet.epilogue(True, x, bn, r)
        want = _eager(x, twin, r)
    assert spy.calls == []
    _equal_bits(got, want)
    _equal_bits(bn.running_mean, twin.running_mean)  # moved alike


def _misaligned(x):
    """A dense view of x one element past 16-byte alignment."""
    flat = torch.cat([x.new_zeros(1), x.flatten()])
    return flat[1:].view(x.shape)


# (case, the conv's map, the residual): maps the kernel does not take
REFUSED = {
    "not dense": lambda x, r: (x.transpose(1, 2), r.transpose(1, 2)),
    "misaligned": lambda x, r: (_misaligned(x), r),
    "misaligned residual": lambda x, r: (x, _misaligned(r)),
    "C % 8": lambda x, r: (x[..., :12].contiguous(),
                           r[..., :12].contiguous()),
    "fp16": lambda x, r: (x.half(), r.half()),
}


def _refused(case):
    x, bn, r, _ = _instance("bn+idn", (2, 6, 6, 16), _BF16)
    x, r = REFUSED[case](x, r)
    if x.shape[-1] != bn.weight.numel():
        bn = _bn(x.shape[-1], torch.Generator().manual_seed(5))
    return x, bn, r


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_wrapper_raises_on_the_card_for_maps_it_cannot_take(case, spy,
                                                                card):
    """No eager chain on the card behind the gate's back: the epilogue, and
    the wrapper called alone, raise before anything runs."""
    x, bn, r = _refused(case)
    with torch.no_grad():  # x as it is: a copy would be dense and aligned
        with pytest.raises(ValueError, match="must be dense, 16-byte"):
            resnet.epilogue(False, x, bn, r)
        with pytest.raises(ValueError, match="must be dense, 16-byte"):
            bn_act.fused_bn_act(x, *bn.affine(), r)
    assert len(spy.calls) == 2


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_cpu_runs_the_plain_version_for_any_map(case, spy):
    x, bn, r = _refused(case)
    with torch.no_grad():
        want = _eager(x, bn, r)
        got = resnet.epilogue(False, x, bn, r)
    assert len(spy.calls) == 1
    _equal_but_nan_bits(got, want)


def test_the_gate_refuses_a_map_that_needs_a_gradient(spy):
    x, bn, r, _ = _instance("bn", (1, 4, 4, 16), torch.float32)
    x.requires_grad_(True)
    got = resnet.epilogue(False, x, bn)
    assert spy.calls == [] and got.requires_grad
    with torch.no_grad():  # no gradient needed: the gate opens
        resnet.epilogue(False, x.detach().clone(), bn)
    assert len(spy.calls) == 1


def test_the_gate_refuses_a_bn_that_needs_a_gradient(spy):
    """A map that needs none beside a BN (or a downsample's BN) whose
    affine does: the eager chain, which autograd follows."""
    x, bn, r, rbn = _instance("bn+bn_ds", (1, 4, 4, 16), torch.float32)
    for p in (*bn.parameters(), *rbn.parameters()):
        p.requires_grad_(False)
    for p in (bn.weight, rbn.bias):
        p.requires_grad_(True)
        got = resnet.epilogue(False, x.clone(), bn, r, rbn)
        assert got.requires_grad
        p.requires_grad_(False)
    assert spy.calls == []
    resnet.epilogue(False, x.clone(), bn, r, rbn)  # nothing needs one
    assert len(spy.calls) == 1


# ---- the launch geometry --------------------------------------------------

def _rbf(v):
    return v.to(_BF16).float()


def _replay(x, s, b, r, raff, sms):
    """The kernel thread by thread: thread t of the grid takes vectors t,
    t + stride, ... with the rounded affine of channel group t % cv, as
    the kernel computes it (every product and sum in fp32, rounded to the
    activation dtype)."""
    vw = 16 // x.element_size()
    n_vec, cv = x.numel() // vw, x.shape[-1] // vw
    stride = bn_act.bn_act_grid(n_vec, cv, sms) * bn_act.BLOCK
    assert stride % cv == 0
    rnd = _rbf if x.dtype == _BF16 else (lambda v: v)
    # every (thread, step) pair of the grid-stride loop, in thread order
    t = np.repeat(np.arange(stride), -(-n_vec // stride))
    m = np.tile(np.arange(-(-n_vec // stride)), stride)
    vec = t + m * stride
    t, vec = t[vec < n_vec], vec[vec < n_vec]
    assert np.array_equal(np.bincount(vec, minlength=n_vec),
                          np.ones(n_vec))  # each vector once
    grp = torch.from_numpy(t % cv)
    ch = grp[:, None] * vw + torch.arange(vw)  # the thread's channels
    idx = torch.from_numpy(vec)
    f = x.reshape(n_vec, vw)[idx].float()

    def affine(v, sc, bi):
        return rnd(rnd(v * rnd(sc)[ch]) + rnd(bi)[ch])

    v = affine(f, s, b)
    if r is not None:
        q = r.reshape(n_vec, vw)[idx].float()
        v = rnd(v + (q if raff is None else affine(q, *raff)))
    v = torch.relu(v)  # torch.relu's clamp_min: NaN passes, as the kernel's
    out = torch.empty(n_vec, vw)
    out[idx] = v
    return out.to(x.dtype).reshape(x.shape)


@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("inst", INSTANCES)
@pytest.mark.parametrize("shape", [(2, 9, 7, 64), (1, 5, 3, 24),
                                   (3, 4, 4, 8), (1, 2, 3, 264)])
def test_grid_replay_matches_plain(shape, inst, dtype, sms):
    x, bn, r, rbn = _instance(inst, shape, dtype, seed=sum(shape))
    raff = rbn.affine() if rbn is not None else None
    want = bn_act.bn_act_plain(x, *bn.affine(), r, raff)
    _equal_but_nan_bits(_replay(x, *bn.affine(), r, raff, sms), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cell", list(EMBED_CELLS))
def test_grid_at_the_cells_shapes(cell, dtype):
    """A persistent grid of BLOCKS_PER_SM blocks an SM, or the blocks that
    give each thread UNROLL vectors where fewer do, its stride a multiple
    of the vectors per pixel (a power of two here: no rounding)."""
    batch, hw = EMBED_CELLS[cell]
    vw = 16 // torch.empty((), dtype=dtype).element_size()
    for (h, w, c), _ in bn_act.resnet18_epilogues(*hw):
        n_vec, cv = batch * h * w * c // vw, c // vw
        grid = bn_act.bn_act_grid(n_vec, cv, H100_SMS)
        assert grid * bn_act.BLOCK % cv == 0
        assert grid == min(-(-n_vec // (bn_act.BLOCK * bn_act.UNROLL)),
                           bn_act.BLOCKS_PER_SM * H100_SMS)


def test_grid_rounds_up_to_a_whole_channel_stride():
    # 3 vectors a pixel (C = 24 bf16): the stride must be a multiple of 3
    assert bn_act.bn_act_grid(10 ** 6, 3, 132) == 978  # 977 rounded up
    assert bn_act.bn_act_grid(10 ** 6, 3, 7) == 57  # 56 rounded up
    assert bn_act.bn_act_grid(3, 3, 132) == 3  # one block, rounded


# ---- what the benchmark's profile reader sees -----------------------------

def _device_names():
    """The kernel's instances as the profiler names them (demangled)."""
    src = (Path(bn_act.__file__).parents[1] / "csrc" / "bn_act.cu").read_text()
    assert re.search(r"__global__ void __launch_bounds__\(kThreads\)\s+"
                     + bn_act.KERNEL_NAME + r"\(", src)
    return [f"void (anonymous namespace)::{bn_act.KERNEL_NAME}<{t}, {r}>("
            f"(anonymous namespace)::EpiParams<{t}>)"
            for t in ("__nv_bfloat16", "float") for r in (0, 1, 2)]


@pytest.mark.parametrize("name", _device_names())
def test_kernel_name_matches_no_pattern_of_the_profile_reader(name):
    from portbench.harness import profiling
    from portbench.mixes.embed import CONV_KERNELS

    assert not profiling.HAND.search(name)
    assert not any(re.search(p, name) for p in profiling.KERNEL.values())
    assert not re.search(CONV_KERNELS, name)
    assert profiling.k_of(name) is None
    assert profiling.classify(name) == "other"


def test_launch_counters_stay_the_vouched_wrappers():
    from portbench.harness import profiling

    unvouched = {"fused_eca_block", "fused_eca_block_concat",
                 "fused_down_concat"}  # K6, P1, P2: no model path
    assert set(ops.launches()) == set(profiling.PER_CALL) | unvouched
    assert bn_act.fused_bn_act not in ops.kernels()
