"""CCT's attention kernel: its plain version, launch geometry, gate and the
encoder's routing, on the CPU (``ops/attention.py``, ``models/cct.py``).

The kernel runs only on the card (``test_torch_port_cuda.py`` and
``chip_smoke.py`` [attention] hold it to an fp32 attention and to the
eager chain there).  What surrounds it runs here:

* ``attention_plain`` (what the CPU runs) is the parent's eager einsum /
  softmax chain bit for bit, in bf16 and fp32, at N from 1 to CCT's 576;
* ``attention_tiling`` for every N from 1 to 1024: the query tiles and KV
  blocks cover N, the tail is masked, the items map onto (batch row, head,
  query tile) once each, a head's tiles adjacent, shared memory fits, and
  the grid is one block per SM up to the items; the kernel is compiled for
  the module's tiles;
* the kernel's arithmetic replayed KV block by KV block (the online
  softmax, the masks, its rounding points) is no farther from an fp32
  attention than the eager bf16 chain;
* the wrapper raises before any launch on what the kernel does not take;
* ``CCT._encode`` sends bf16 inference to the wrapper, 14 calls a forward,
  and keeps fp32, training and autograd on the eager einsums; on the CPU
  the bf16 tower through the wrapper is the eager tower bit for bit.
"""

import math
import re
from pathlib import Path

import pytest
import torch

from agplace_tpu_torch.models import cct
from agplace_tpu_torch.ops import _build, attention
from portbench.harness import profiling

torch.set_num_threads(2)

_BF16 = torch.bfloat16
DTYPES = [_BF16, torch.float32]
H100_SMS = 132


def _qkv(b, n, dtype=_BF16, h=6, d=64, seed=0, scale=1.5):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, n, 3, h, d, generator=g) * scale).to(dtype)


def _parent_chain(qkv):
    """The parent's attention core in ``CCT._encode``, verbatim."""
    b, n, _, h, hd = qkv.shape
    scale = hd ** -0.5
    q, k, v = qkv.unbind(dim=2)
    attn = torch.softmax(torch.einsum(
        "bnhd,bmhd->bhnm", q, k) * scale, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


# ---- the plain version is the parent's chain -------------------------------

@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [1, 7, 196, 576])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_is_the_parents_chain_bit_for_bit(dtype, n, b):
    qkv = _qkv(b, n, dtype, seed=n + b)
    want = _parent_chain(qkv)
    for got in (attention.attention_plain(qkv),
                attention.fused_attention(qkv)):  # the CPU: the plain one
        assert got.dtype == dtype and got.shape == (b, n, 6, 64)
        assert torch.equal(_bits(got), _bits(want))


# ---- the launch geometry ------------------------------------------------

def _cu_constants():
    src = (Path(_build.SRC_DIR) / "attention_sm90.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    return src, consts


def test_the_kernel_is_compiled_for_the_modules_tiles():
    src, c = _cu_constants()
    assert c["kD"] == attention.HEAD_DIM
    assert 64 * c["kWGs"] == attention.Q_ROWS
    assert c["kKV"] == attention.KV_ROWS
    assert c["kStages"] == attention.STAGES
    assert 128 * c["kWGs"] + 32 == attention.THREADS
    assert f"{attention.KERNEL_NAME}(" in src
    # one entry, its arguments as the wrapper passes them
    assert len(_build._SIGNATURES["agp_attention"]) == \
        2 + 3 + len(attention.AttentionTiling._fields) + 1


@pytest.mark.parametrize("batch,heads", [(1, 1), (3, 6), (128, 6)])
def test_tiling_covers_every_n_to_1024(batch, heads):
    assert attention.SMEM_BYTES <= attention.SMEM_LIMIT
    for n in range(1, 1025):
        t = attention.attention_tiling(batch, heads, n, H100_SMS)
        # query tiles and KV blocks cover n, none of them past it
        assert (t.q_tiles - 1) * attention.Q_ROWS < n <= \
            t.q_tiles * attention.Q_ROWS
        assert (t.kv_steps - 1) * attention.KV_ROWS < n <= \
            t.kv_steps * attention.KV_ROWS
        keys = [attention.live_keys(n, s) for s in range(t.kv_steps)]
        assert sum(keys) == n and min(keys) >= 1
        assert all(k == attention.KV_ROWS for k in keys[:-1])
        # the masked tail: the last block's keys past n, fewer than a block
        assert 0 <= attention.KV_ROWS - keys[-1] < attention.KV_ROWS
        rows = [attention.stored_rows(n, q) for q in range(t.q_tiles)]
        assert sum(rows) == n and min(rows) >= 1
        assert t.items == batch * heads * t.q_tiles
        assert t.grid == min(t.items, H100_SMS)


@pytest.mark.parametrize("batch,heads,n,sms", [(128, 6, 576, H100_SMS),
                                               (3, 6, 196, H100_SMS),
                                               (2, 5, 333, 7), (1, 1, 1, 4)])
def test_items_map_onto_each_tile_once_a_heads_tiles_adjacent(batch, heads,
                                                              n, sms):
    t = attention.attention_tiling(batch, heads, n, sms)
    coords = [attention.item_coords(t, heads, i) for i in range(t.items)]
    assert sorted(coords) == [(b, h, q) for b in range(batch)
                              for h in range(heads)
                              for q in range(t.q_tiles)]
    for i in range(0, t.items, t.q_tiles):  # a head's tiles in a row
        assert len({c[:2] for c in coords[i:i + t.q_tiles]}) == 1
    # the persistent blocks walk blockIdx, + grid, ...: every item once
    walked = sorted(i for blk in range(t.grid)
                    for i in range(blk, t.items, t.grid))
    assert walked == list(range(t.items))


def test_the_kernels_name_is_no_hand_kernel_of_the_profile_reader():
    """Its device rows land under ``other`` (where softmax and the nvjet
    GEMMs of the eager chain were), and no K-number claims them."""
    assert profiling.classify(attention.KERNEL_NAME) == "other"
    assert profiling.k_of(attention.KERNEL_NAME) is None


# ---- the kernel's arithmetic, replayed ------------------------------------

def _replay(qkv):
    """The kernel's arithmetic on the CPU, KV block by KV block as a
    warpgroup walks ``attention_tiling``'s steps: K and V zero-filled past
    n (TMA), each score's fp32 sum rounded to bf16, keys past n at -inf,
    the running max in bf16 score units and exp2 of the scores times
    d^-1/2 log2(e) less that max times it, the running sum of the fp32
    probabilities, their bf16 rounding as AV's operand, AV in fp32, then
    O times l's fp32 reciprocal, rounded to bf16.  Rows past n are not computed (the kernel
    computes and drops them)."""
    b, n, _, h, d = qkv.shape
    kv_rows = attention.KV_ROWS
    q, k, v = (x.float().permute(0, 2, 1, 3) for x in qkv.unbind(dim=2))
    t = attention.attention_tiling(b, h, n, H100_SMS)
    c = torch.tensor(0.125 * math.log2(math.e), dtype=torch.float32)
    m = torch.full((b, h, n), -math.inf)
    l = torch.zeros(b, h, n)
    o = torch.zeros(b, h, n, d)
    for s in range(t.kv_steps):
        live = attention.live_keys(n, s)
        kb, vb = torch.zeros(b, h, kv_rows, d), torch.zeros(b, h, kv_rows, d)
        kb[:, :, :live] = k[:, :, s * kv_rows:s * kv_rows + live]
        vb[:, :, :live] = v[:, :, s * kv_rows:s * kv_rows + live]
        x = (q @ kb.transpose(-1, -2)).to(_BF16).float()
        x[..., live:] = -math.inf
        mn = torch.maximum(m, x.amax(dim=-1))
        alpha = torch.exp2(m * c - mn * c)
        p = torch.exp2(x * c - (mn * c)[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + p.to(_BF16).float() @ vb
        m = mn
    return (o * torch.reciprocal(l)[..., None]).to(_BF16).permute(
        0, 2, 1, 3)


@pytest.mark.parametrize("b,n", [(2, 1), (2, 7), (1, 64), (1, 65), (2, 196),
                                 (1, 576)])
def test_the_replayed_kernel_is_as_near_fp32_as_the_eager_chain(b, n):
    qkv = _qkv(b, n, seed=100 + n)
    exact = _parent_chain(qkv.float())
    got, chain = _replay(qkv), _parent_chain(qkv)
    assert bool(torch.isfinite(got.float()).all())
    k_err, c_err = (attention.row_err(got, exact),
                    attention.row_err(chain, exact))
    assert k_err[0] <= attention.ERR_MARGIN * c_err[0], (k_err, c_err)
    assert k_err[1] <= attention.ERR_MARGIN * c_err[1], (k_err, c_err)
    # near the chain too: bf16's rounding apart, not another function
    assert attention.row_err(got, chain.float())[0] < attention.ERR_APART


# ---- the wrapper's gate ----------------------------------------------------

def _misaligned(x):
    flat = torch.cat([x.new_zeros(1), x.flatten()])
    return flat[1:].view(x.shape)


# (case, qkv) the kernel does not take
REFUSED = {
    "fp32": lambda: _qkv(2, 9, torch.float32),
    "fp16": lambda: _qkv(2, 9, torch.float16),
    "d = 32": lambda: _qkv(2, 9, d=32),
    "d = 128": lambda: _qkv(2, 9, d=128),
    "not dense": lambda: _qkv(9, 2).transpose(0, 1),
    "misaligned": lambda: _misaligned(_qkv(2, 9)),
}
MISSHAPEN = {
    "4-D": lambda: _qkv(2, 9).flatten(3),
    "two slots": lambda: _qkv(2, 9)[:, :, :2],
    "6-D": lambda: _qkv(2, 9)[None],
}


@pytest.fixture
def card(monkeypatch):
    """The wrapper sees qkv as on the card; a launch fails the test."""
    def no_launch(*a):
        raise AssertionError("launched")
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "call", no_launch)


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_wrapper_raises_on_the_card_before_any_launch(case, card):
    qkv = REFUSED[case]()
    before = attention.fused_attention.launches
    with pytest.raises(ValueError, match="must be bf16, d = 64, dense"):
        attention.fused_attention(qkv)
    assert attention.fused_attention.launches == before


@pytest.mark.parametrize("on_card", [False, True])
@pytest.mark.parametrize("case", list(MISSHAPEN))
def test_the_wrapper_refuses_a_misshapen_qkv_everywhere(case, on_card,
                                                        monkeypatch):
    monkeypatch.setattr(_build, "on_cuda", lambda *t: on_card)
    with pytest.raises(ValueError, match=r"must be \[B, N, 3, H, d\]"):
        attention.fused_attention(MISSHAPEN[case]())


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_cpu_runs_the_plain_version_for_any_qkv(case):
    qkv = REFUSED[case]()
    assert torch.equal(_bits(attention.fused_attention(qkv)),
                       _bits(_parent_chain(qkv)))


# ---- CCT's routing ---------------------------------------------------------

class _Spy:
    """``fused_attention`` behind a recorder: the layers the gate sends."""

    def __init__(self, real):
        self.real, self.calls = real, []

    def __call__(self, qkv):
        self.calls.append((tuple(qkv.shape), qkv.dtype))
        return self.real(qkv)


@pytest.fixture
def spy(monkeypatch):
    s = _Spy(attention.fused_attention)
    monkeypatch.setattr(attention, "fused_attention", s)
    return s


IMG = 64  # 16 tokens


def _cct(dtype, seed=0, stochastic_depth=0.1):
    m = cct.CCT((IMG, IMG), dtype=dtype, stochastic_depth=stochastic_depth)
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
    return m.eval()


def _images(seed=1, b=2):
    return torch.randn(b, IMG, IMG, 3,
                       generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("grad_mode", ["inference_mode", "no_grad"])
def test_bf16_inference_sends_every_layer_to_the_wrapper(spy, grad_mode):
    m, x = _cct(_BF16), _images()
    with getattr(torch, grad_mode)():
        m(x)
    assert spy.calls == [((2, 16, 3, 6, 64), _BF16)] * 14


def test_fp32_keeps_the_eager_einsums(spy):
    m, x = _cct(torch.float32), _images()
    with torch.no_grad():
        m(x)
    assert spy.calls == []


@pytest.mark.parametrize("dtype", DTYPES)
def test_training_keeps_the_eager_einsums(spy, dtype):
    m, x = _cct(dtype, stochastic_depth=0.0), _images()
    m.train()
    tokens, pooled = m(x)
    pooled.float().sum().backward()
    assert spy.calls == []
    assert m.qkv_0.weight.grad is not None


@pytest.mark.parametrize("dtype", DTYPES)
def test_an_input_that_needs_a_gradient_keeps_the_eager_einsums(spy, dtype):
    """Eval mode, but autograd follows: the weights need a gradient, or
    only the images do."""
    m, x = _cct(dtype), _images()
    m(x)
    assert spy.calls == []
    for p in m.parameters():
        p.requires_grad_(False)
    m(x.requires_grad_(True))[1].float().sum().backward()
    assert spy.calls == [] and x.grad is not None
    with torch.no_grad():  # nothing needs one: the gate opens at bf16
        m(x)
    assert len(spy.calls) == (14 if dtype == _BF16 else 0)


def test_the_bf16_tower_through_the_wrapper_is_the_eager_tower(spy,
                                                               monkeypatch):
    """On the CPU the wrapper's plain version is the chain, so the tower's
    tokens and pooled vector keep the parent's bits."""
    m, x = _cct(_BF16, seed=3), _images(4)
    with torch.inference_mode():
        got = m(x)
    assert len(spy.calls) == 14
    monkeypatch.setattr(cct.CCT, "_fused", lambda self, qkv: False)
    with torch.inference_mode():
        want = m(x)
    assert len(spy.calls) == 14
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
