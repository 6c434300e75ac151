"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (they build ``csrc/`` first) and
skip elsewhere. Run them on the card with
``python -m pytest --noconftest tests/test_torch_kernels.py -q`` (the
shared ``tests/conftest.py`` imports jax, which that machine may lack).
Tolerances: K1 1e-5 abs/rel at f32 (summation order; 3xTF32 products keep
float32 accuracy), 2e-2 at bf16; K2 1e-5 relative norm per gradient at f32,
2e-2 at bf16 (the plain version's autograd does not round dO and dS to
bf16, K2 does, as the TPU kernel did);
K3, K4 and the rerank score on the tensor cores with one routine
(csrc/scoring.cuh), the plain versions in index order: values within
SCORE_ORDER_TOL (1e-5) of sum_j |q_j e_rj| (two summation orders of the
same products), ids equal but for near-ties within that bound; between the
kernels bit-equality: K4's maxima = the rerank's group maxima, the
tournament (K4, the rerank and the select kernel) = the stream (K3), ids
and values, and K3 = a full sort of the routine's own scores. The select
kernel equals its plain version bit for bit (lax.top_k's order). With weight dropout the plain version is
fed the kernels' own Philox keep mask.
"""

import copy

import numpy as np
import pytest
import torch

from carca_tpu_torch.models.attention import MHA, masked_attention
from carca_tpu_torch.ops import _build
from carca_tpu_torch.ops.flash_attention import (SEED_LIMIT, attention_bwd,
                                                 attention_grads_plain, attention_keep_mask,
                                                 bwd_branch, fused_attention, fwd_branch)
from carca_tpu_torch.ops.retrieval_topk import (GROUP, GROUPMAX_BRANCHES, MAX_K,
                                                SCORE_ORDER_TOL, TOURNAMENT_MAX_K, QuantizedIndex,
                                                catalog_topk, catalog_topk_plain,
                                                compare_within_order_tol, groupmax,
                                                groupmax_branch, groupmax_plain, quantize_index,
                                                resolve_method, select_plan, select_topk,
                                                select_topk_plain,
                                                stream_plan, tournament_rerank,
                                                tournament_rerank_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def attn_inputs(dev, b, lq, lk, d, seed=0):
    """q/k/v [b, L, d] and masks: random padded query rows, batch row 0
    with every key masked."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(b, n, d, generator=g) for n in (lq, lk, lk))
    qm = (torch.rand(b, lq, generator=g) > 0.2).float()
    km = (torch.rand(b, lk, generator=g) > 0.2).float()
    km[0] = 0.0  # every key masked: the row must come out exactly 0
    return [t.to(dev) for t in (q, k, v, qm, km)]


# K1 past one 64-key tile (the whole-row kernel, csrc/attention_fwd.cu): the
# men encoder and decoder, the eval cross [101] x [200], one query row, a
# ragged query tile and key chunk, one key past a tile; and key rows past
# the whole-row kernel's longest, 200 keys (rows_kernel takes them)
LONG_KEYS = [(0, 200, 200, 3), (-1, 200, 200, 3), (None, 101, 200, 3), (0, 1, 200, 3),
             (0, 201, 257, 3), (0, 65, 65, 3), (0, 70, 300, 3)]


@pytest.mark.parametrize("causal,lq,lk,b", [(0, 50, 50, 8), (None, 512, 50, 8),
                                            (-1, 50, 50, 8), (0, 33, 70, 3),
                                            (None, 1, 1, 1)] + LONG_KEYS)
@pytest.mark.parametrize("cd,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_attention_kernel_matches_plain(dev, causal, lq, lk, b, cd, tol):
    q, k, v, qm, km = attn_inputs(dev, b, lq, lk, 64)
    kw = dict(causal=causal, scale=32 ** 0.5, n_heads=2, compute_dtype=cd)
    got = fused_attention(q, k, v, qm, km, **kw)
    want = masked_attention(q, k, v, qm, km, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert torch.count_nonzero(got[0]) == 0
    assert torch.count_nonzero(got[qm == 0]) == 0


def seed_of(i):
    """The Philox seed fused_attention draws from Generator().manual_seed(i)."""
    return int(torch.randint(SEED_LIMIT, (), generator=torch.Generator().manual_seed(i)))


@pytest.mark.parametrize("causal,lq,lk,b", [(0, 50, 50, 8), (None, 40, 50, 8),
                                            (-1, 50, 50, 8), (0, 33, 70, 3)] + LONG_KEYS)
@pytest.mark.parametrize("cd,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_attention_kernel_dropout_matches_plain_fed_its_bits(dev, causal, lq, lk, b, cd, tol):
    q, k, v, qm, km = attn_inputs(dev, b, lq, lk, 64)
    kw = dict(causal=causal, scale=32 ** 0.5, n_heads=2, compute_dtype=cd, dropout_rate=0.5)
    got = fused_attention(q, k, v, qm, km, seed_generator=torch.Generator().manual_seed(3), **kw)
    keep = attention_keep_mask(seed_of(3), (b, 2, lq, lk), 0.5, dev)
    want = masked_attention(q, k, v, qm, km, keep_mask=keep, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert torch.count_nonzero(got[0]) == 0
    assert torch.count_nonzero(got[qm == 0]) == 0


@pytest.mark.parametrize("dh", [32, 64, 128, 256])
@pytest.mark.parametrize("causal,lq,lk", [(0, 200, 200), (-1, 200, 200), (None, 101, 200),
                                          (0, 40, 300)])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("cd,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_attention_kernel_long_keys_every_head_width(dev, dh, causal, lq, lk, rate, cd, tol):
    """K1 at Lk = 200 and past the whole-row kernel's longest key row, at
    32-, 64- and 128-dim heads and 256-dim ones (128-column chunks), with
    and without weight dropout (the plain version fed the kernel's bits):
    within the tolerance, fully masked rows exactly 0."""
    b, heads = 3, 2
    q, k, v, qm, km = attn_inputs(dev, b, lq, lk, dh * heads, seed=dh + lk)
    kw = dict(causal=causal, scale=dh ** 0.5, n_heads=heads, compute_dtype=cd,
              dropout_rate=rate)
    got = fused_attention(q, k, v, qm, km, seed_generator=torch.Generator().manual_seed(5), **kw)
    keep = attention_keep_mask(seed_of(5), (b, heads, lq, lk), rate, dev) if rate else None
    want = masked_attention(q, k, v, qm, km, keep_mask=keep, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert torch.count_nonzero(got[0]) == 0
    assert torch.count_nonzero(got[qm == 0]) == 0


def test_attention_fwd_branch_rule_is_the_kernels(dev):
    """flash_attention.fwd_branch, the rule the CPU tests hold, is the one
    csrc/attention_fwd.cu dispatches by (its C query)."""
    lib = _build.library()
    for dh in (1, 8, 31, 32, 33, 64, 65, 128, 129, 256):
        for lk in (1, 64, 65, 120, 200, 201, 240, 280, 281, 4000):
            c = lib.carca_attention_fwd_branch(lk, dh)
            assert ("whole_row" if c else "rows") == fwd_branch(lk, dh), (dh, lk)


def test_attention_kernel_long_keys_deterministic_and_graphed(dev):
    """K1 at the men encoder [256,200,64] (the whole-row kernel, no atomics,
    no split over keys): two calls bit-equal, with and without dropout;
    a CUDA graph of the call replays bit-equal to the eager call."""
    b, lq = 256, 200
    q, k, v, qm, km = attn_inputs(dev, b, lq, lq, 64, seed=11)
    kw = dict(causal=0, scale=32 ** 0.5, n_heads=2)
    for rate in (0.0, 0.5):
        f1, f2 = (fused_attention(q, k, v, qm, km, dropout_rate=rate, seed=77, **kw)
                  for _ in range(2))
        assert torch.equal(f1, f2)
    eager = fused_attention(q, k, v, qm, km, dropout_rate=0.5, seed=78, **kw)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm up outside the capture
        fused_attention(q, k, v, qm, km, dropout_rate=0.5, seed=78, **kw)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused_attention(q, k, v, qm, km, dropout_rate=0.5, seed=78, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    q.mul_(-1.0)  # a replay reads its inputs anew
    graph.replay()
    want = fused_attention(q, k, v, qm, km, dropout_rate=0.5, seed=78, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_attention_bwd_branch_rule_is_the_kernels(dev):
    """flash_attention.bwd_branch, the rule the CPU tests hold, is the one
    csrc/attention_bwd.cu dispatches K2 by (its C query)."""
    lib = _build.library()
    for dh in (1, 8, 31, 32, 33, 64, 65, 128, 129, 256):
        for lk in (1, 50, 64, 65, 101, 120, 199, 200, 201, 257, 4000):
            c = lib.carca_attention_bwd_branch(lk, dh)
            assert ("whole_row" if c else "rows") == bwd_branch(lk, dh), (dh, lk)


def test_keep_mask_on_the_card_equals_the_numpy_generator(dev):
    shape = (3, 2, 50, 70)
    for seed in (0, 2**40 + 17, SEED_LIMIT - 1):
        assert torch.equal(attention_keep_mask(seed, shape, 0.3, dev).cpu(),
                           attention_keep_mask(seed, shape, 0.3))


def rel(a, b):
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


# (causal, Lq, Lk, batch, d) with 2 heads: 32-dim heads (d = 64) as the
# flagship, 64-dim heads (d = 128) as games and fashion at L = 50, men's
# decoder at L = 200; then K2's edges: Lk = 64 and 65 (one key tile and a
# second one), Lk = 1, Lq != Lk (several query tiles over one key tile; a
# causal query tile that reaches only the first of three key tiles, so the
# others' dK/dV are written as zeros), and B·H = 4 and 1,200 (far below and
# above one wave of blocks); then the whole-row kernel's edges (bwd_branch
# "whole_row": 64 < Lk <= 200 at 32-dim heads): Lk = 65 (two key chunks, one
# a warpgroup), 199 and 200 at causal 0 and -1 (Lq = 200: an 8-row last
# query tile), Lq != Lk (20 x 150, 130 x 200), B·H = 4 and 4,096 (the remat
# batch)
BWD_CASES = [(0, 50, 50, 8, 64), (-1, 50, 50, 16, 64), (0, 200, 200, 4, 64),
             (None, 33, 70, 3, 64), (0, 1, 1, 1, 64),
             (0, 50, 50, 8, 128), (-1, 50, 50, 16, 128), (-1, 200, 200, 4, 64),
             (0, 64, 64, 4, 128), (-1, 65, 65, 4, 64), (None, 30, 65, 3, 128),
             (None, 40, 1, 3, 128), (0, 130, 50, 3, 128), (-1, 20, 150, 3, 64),
             (0, 50, 50, 2, 128), (-1, 50, 50, 600, 128),
             (0, 65, 65, 2, 64), (0, 199, 199, 3, 64), (-1, 199, 199, 3, 64),
             (None, 130, 200, 3, 64), (0, 20, 150, 3, 64), (-1, 200, 200, 2048, 64),
             (3, 200, 200, 2, 64), (-70, 200, 200, 2, 64), (0, 200, 200, 2, 48),
             (0, 200, 200, 2, 44)]


@pytest.mark.parametrize("causal,lq,lk,b,d", BWD_CASES)
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("cd,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_attention_bwd_kernel_matches_plain_autograd(dev, causal, lq, lk, b, d, rate, cd, tol):
    q, k, v, qm, km = attn_inputs(dev, b, lq, lk, d)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(9)).to(dev)
    kw = dict(causal=causal, scale=(d / 2) ** 0.5, n_heads=2, compute_dtype=cd,
              dropout_rate=rate)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    before = attention_bwd.launches
    at_shape = (fused_attention.launches_by_shape[lq, lk, causal],
                attention_bwd.launches_by_shape[lq, lk, causal])
    out = fused_attention(qq, kk, vv, qm, km, seed_generator=torch.Generator().manual_seed(4),
                          **kw)
    out.backward(g)
    keep = attention_keep_mask(seed_of(4), (b, 2, lq, lk), rate, dev) if rate else None
    want = attention_grads_plain(q, k, v, qm, km, g, keep_mask=keep, **kw)
    torch.cuda.synchronize()
    assert attention_bwd.launches == before + 1
    assert (fused_attention.launches_by_shape[lq, lk, causal],
            attention_bwd.launches_by_shape[lq, lk, causal]) == (at_shape[0] + 1, at_shape[1] + 1)
    for got, w in zip((qq.grad, kk.grad, vv.grad), want):
        assert rel(got, w) <= tol
    assert torch.count_nonzero(qq.grad[0]) == 0  # every key of batch row 0 is masked
    assert torch.count_nonzero(qq.grad[qm == 0]) == 0
    assert torch.count_nonzero(kk.grad[0]) == 0 and torch.count_nonzero(vv.grad[0]) == 0


@pytest.mark.parametrize("lq,lk,d,batch,causal", [
    (50, 50, 64, 32, -1), (200, 320, 64, 32, -1), (50, 50, 128, 32, -1), (200, 200, 64, 32, -1),
    (64, 64, 128, 4, -1), (65, 65, 64, 4, -1), (8, 1, 128, 8, -1), (130, 50, 128, 3, -1),
    (20, 150, 64, 3, -1), (50, 50, 128, 2, -1), (50, 50, 128, 600, -1), (65, 65, 64, 2, -1),
    (199, 199, 64, 3, -1), (130, 200, 64, 3, -1), (200, 200, 64, 2048, -1),
    (200, 200, 64, 2, -1), (200, 200, 64, 2, 3), (200, 200, 64, 2, -70), (200, 200, 48, 2, 0),
    (200, 200, 44, 2, 0)])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_attention_bwd_kernel_is_deterministic(dev, lq, lk, d, batch, causal, cd):
    """No atomics: two runs of K2 (and of K1) are bit-equal, with one key
    tile and with several, 22- to 64-dim heads, causal offsets that skip
    key chunks, at K2's edges (as in
    test_attention_bwd_kernel_matches_plain_autograd, the whole-row
    kernel's too), in float32 and bf16; another seed changes the result."""
    q, k, v, qm, km = attn_inputs(dev, batch, lq, lk, d)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(dev)
    kw = dict(causal=causal, scale=(d / 2) ** 0.5, n_heads=2, compute_dtype=cd,
              dropout_rate=0.5, seed=123)
    a = attention_bwd(q, k, v, qm, km, g, **kw)
    b = attention_bwd(q, k, v, qm, km, g, **kw)
    c = attention_bwd(q, k, v, qm, km, g, **dict(kw, seed=124))
    fkw = dict(causal=causal, scale=(d / 2) ** 0.5, n_heads=2, compute_dtype=cd,
               dropout_rate=0.5)
    f1, f2 = (fused_attention(q, k, v, qm, km, seed_generator=torch.Generator().manual_seed(7),
                              **fkw) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[2], c[2])
    assert torch.equal(f1, f2)


RAGGED = [(1, 1), (17, 63), (50, 50), (63, 65), (65, 17), (200, 200), (1, 200), (200, 1)]


@pytest.mark.parametrize("lq,lk", RAGGED)
@pytest.mark.parametrize("causal", [None, 0, -1])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("cd,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_attention_kernels_ragged_tiles(dev, lq, lk, causal, rate, cd, tol):
    """K1 and K2 at lengths that are not multiples of the 16-row fragments
    or the 64-row tiles (one tile, a ragged second tile, several key
    tiles), against the plain version fed the kernels' keep mask: fully
    masked query rows and a batch row with every key masked come out
    exactly 0 in both directions."""
    b = 3
    q, k, v, qm, km = attn_inputs(dev, b, lq, lk, 64, seed=lq * 1000 + lk)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(lk)).to(dev)
    kw = dict(causal=causal, scale=32 ** 0.5, n_heads=2, compute_dtype=cd, dropout_rate=rate)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    out = fused_attention(qq, kk, vv, qm, km, seed_generator=torch.Generator().manual_seed(6),
                          **kw)
    out.backward(g)
    keep = attention_keep_mask(seed_of(6), (b, 2, lq, lk), rate, dev) if rate else None
    want = masked_attention(q, k, v, qm, km, keep_mask=keep, **kw)
    want_grads = attention_grads_plain(q, k, v, qm, km, g, keep_mask=keep, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.detach(), want, rtol=tol, atol=tol)
    for got, w in zip((qq.grad, kk.grad, vv.grad), want_grads):
        assert rel(got, w) <= tol
    dead = (qm == 0) | (km.sum(1, keepdim=True) == 0)
    assert torch.count_nonzero(out.detach()[dead]) == 0
    assert torch.count_nonzero(qq.grad[dead]) == 0
    assert torch.count_nonzero(kk.grad[0]) == 0 and torch.count_nonzero(vv.grad[0]) == 0


@pytest.mark.parametrize("b,lq,lk,d,heads", [
    (4, 200, 200, 128, 2),  # dh = 64 at Lk = 200: K2 needed 170.6 KB of shared memory
    (4, 100, 320, 64, 2),   # dh = 32 at Lk = 320
    (2, 8, 4000, 64, 1),    # K1 staged all of K/V: 2 MB at Lk = 4000
])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_attention_kernels_take_the_shapes_that_used_to_raise(dev, b, lq, lk, d, heads, rate):
    """Key lengths whose K/V tiles overflowed shared memory in the earlier
    kernels: shared memory is now a fixed number of 64-row tiles."""
    q, k, v, qm, km = attn_inputs(dev, b, lq, lk, d, seed=lk)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)).to(dev)
    kw = dict(causal=0, scale=(d / heads) ** 0.5, n_heads=heads, dropout_rate=rate)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    out = fused_attention(qq, kk, vv, qm, km, seed_generator=torch.Generator().manual_seed(8),
                          **kw)
    out.backward(g)
    keep = attention_keep_mask(seed_of(8), (b, heads, lq, lk), rate, dev) if rate else None
    want_grads = attention_grads_plain(q, k, v, qm, km, g, keep_mask=keep, **kw)
    torch.testing.assert_close(out.detach(), masked_attention(q, k, v, qm, km, keep_mask=keep,
                                                              **kw), rtol=1e-5, atol=1e-5)
    for got, w in zip((qq.grad, kk.grad, vv.grad), want_grads):
        assert rel(got, w) <= 1e-5


@pytest.mark.parametrize("dh,heads,lk", [(6, 1, 70), (8, 2, 70), (16, 2, 70), (24, 2, 70),
                                         (40, 1, 70), (64, 1, 70), (100, 1, 70), (128, 2, 70),
                                         (131, 1, 50), (136, 1, 70), (256, 2, 50),
                                         (300, 1, 130)])
@pytest.mark.parametrize("cd,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_attention_kernels_every_head_tile(dev, dh, heads, lk, cd, tol):
    """Each head tile the kernels are built for (32/64/128), with
    zero-padded columns, and row strides that rule out 16-byte loads (dh =
    6, 131) or allow them; heads wider than 128 dims in 128-column chunks,
    with one key tile (Lk = 50) and with several."""
    d = dh * heads
    q, k, v, qm, km = attn_inputs(dev, 5, 37, lk, d, seed=dh)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(3)).to(dev)
    kw = dict(causal=0, scale=dh ** 0.5, n_heads=heads, compute_dtype=cd)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    out = fused_attention(qq, kk, vv, qm, km, **kw)
    out.backward(g)
    want_grads = attention_grads_plain(q, k, v, qm, km, g, **kw)
    torch.testing.assert_close(out.detach(), masked_attention(q, k, v, qm, km, **kw),
                               rtol=tol, atol=tol)
    for got, w in zip((qq.grad, kk.grad, vv.grad), want_grads):
        assert rel(got, w) <= tol


def test_attention_kernel_raises_on_what_it_lacks(dev):
    """Dropout and autograd run the kernels at every key length and head
    width; what they cannot take still raises: a non-contiguous or
    non-float32 input, and dropout without a CPU seed generator."""
    q, k, v, qm, km = attn_inputs(dev, 2, 8, 8, 16)
    kw = dict(causal=0, scale=1.0, n_heads=2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention(q.transpose(0, 1), k, v, qm, km, **kw)
    with pytest.raises(TypeError, match="float32"):
        fused_attention(q.double(), k, v, qm, km, **kw)
    with pytest.raises(ValueError, match="seed_generator"):
        fused_attention(q, k, v, qm, km, dropout_rate=0.1, **kw)
    with pytest.raises(ValueError, match="seed_generator"):
        fused_attention(q, k, v, qm, km, dropout_rate=0.1,
                        seed_generator=torch.Generator(device=dev), **kw)


def test_mha_auto_on_cuda_raises_instead_of_falling_back(dev):
    """use_kernel="auto" on CUDA tensors never runs the plain version: in
    training it launches K1 forward and K2 backward, with the plain path's
    gradients at dropout 0; weight dropout without a seed generator raises;
    use_kernel=False is the way to the plain version on the card."""
    mha = MHA(16, torch.Generator().manual_seed(0)).to(dev)
    x = torch.randn(2, 6, 16, generator=torch.Generator().manual_seed(1)).to(dev)
    m = torch.ones(2, 6, device=dev)
    kw = dict(n_heads=2, causal=0)
    g = torch.Generator(device=dev).manual_seed(2)
    with pytest.raises(ValueError, match="seed_generator"):
        mha(x, x, x, m, m, train=True, generator=g, dropout_rate=0.5, use_kernel="auto", **kw)
    before = (fused_attention.launches, attention_bwd.launches)
    mha(x, x, x, m, m, train=True, dropout_rate=0.0, use_kernel="auto", **kw).sum().backward()
    assert (fused_attention.launches, attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    kernel_grads = [p.grad.clone() for p in mha.parameters()]
    mha.zero_grad()
    mha(x, x, x, m, m, train=True, dropout_rate=0.0, use_kernel=False, **kw).sum().backward()
    for a, b in zip(kernel_grads, (p.grad for p in mha.parameters())):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    out = mha(x, x, x, m, m, train=True, generator=g, dropout_rate=0.5, use_kernel="auto",
              seed_generator=torch.Generator().manual_seed(5), **kw)
    out.sum().backward()
    assert fused_attention.launches == before[0] + 2 and attention_bwd.launches == before[1] + 2
    assert mha(x, x, x, m, m, train=True, generator=g, dropout_rate=0.5, use_kernel=False,
               **kw).shape == x.shape


@pytest.mark.parametrize("b,r,k,offset,n_items", [
    (33, 19_156, 562, 0, None), (33, 5_000, 10, 0, None), (33, 3_000, 40, 7, 2_500),
    (33, 300, 600, 0, 250), (9, 2_048, 1_024, 0, None), (5, 10_000, 1_500, 0, None),
    (1, 2_049, 1, 0, None), (1, 5, 3, 0, None)])
def test_topk_kernel_matches_plain(dev, b, r, k, offset, n_items):
    """K3 over an f32 index against its plain version, within the
    summation-order tolerance (values; ids equal but for near-ties)."""
    g = torch.Generator(device="cpu").manual_seed(r)
    q = torch.randn(b, 64, generator=g)
    e = torch.randn(r, 64, generator=g)
    e[100:120] = e[min(5, r - 1)]  # exact ties
    q[b // 2] = 0.0  # a zero query: lowest ids in order
    q, e = q.to(dev), e.to(dev)
    kw = dict(n_items=n_items, id_offset=offset)
    v, i = catalog_topk(q, e, k, **kw)
    pv, pi = catalog_topk_plain(q, e, k, **kw)
    torch.cuda.synchronize()
    compare_within_order_tol(v, i, pv, pi, q, e, offset)
    assert torch.equal(i[b // 2], pi[b // 2])


def as_index(e, kind):
    if kind == "f32":
        return e
    if kind == "bf16":
        return e.to(torch.bfloat16)
    return quantize_index(e)


def rows_of(index):
    return (index.qvals, index.scales) if isinstance(index, QuantizedIndex) else (index, None)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("b,r,k,offset,n_items", [
    (33, 19_156, 562, 0, None), (33, 3_000, 40, 7, 2_500), (33, 300, 600, 0, 250),
    (1, 2_049, 1, 0, None), (4, 5_000, 10, 0, None)])
def test_topk_kernel_variants_match_plain(dev, kind, b, r, k, offset, n_items):
    """K3 over a bf16 or int8 index: the query rounded to bf16, the int8
    scale after the sum; within the summation-order tolerance of the plain
    version."""
    g = torch.Generator(device="cpu").manual_seed(r + 1)
    q = torch.randn(b, 64, generator=g)
    e = torch.randn(r, 64, generator=g)
    e[100:120] = e[min(5, r - 1)]
    q[b // 2] = 0.0
    index = as_index(e.to(dev), kind)
    kw = dict(n_items=n_items, id_offset=offset)
    before = catalog_topk.launches[kind]
    v, i = catalog_topk(q.to(dev), index, k, method="stream", **kw)
    pv, pi = catalog_topk_plain(q.to(dev), index, k, **kw)
    torch.cuda.synchronize()
    assert catalog_topk.launches[kind] == before + 1
    compare_within_order_tol(v, i, pv, pi, q.to(dev), index, offset)


def group_magnitudes(q, rows, scales, layout):
    """The largest sum_j |q_j e_rj| of each group: what bounds |K4 - plain|."""
    return groupmax_plain(q.abs(), rows.abs(), scales, rows.shape[0], False, layout)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("layout", [0, 1])
@pytest.mark.parametrize("b,r,lim0,mask_row0,d", [
    (256, 20_000, 20_000, True, 64), (33, 19_156, 15_000, False, 64), (17, 1_000, 1_000, True, 64),
    (9, 300, 250, True, 64), (1, 2_049, 2_049, True, 64), (5, 129, 129, False, 64),
    (300, 3_000, 3_000, True, 64),
    # the warpgroup kernel's edges: one, two or four products of 64
    # queries a query set of 256 (B = 64, 65, 128, 129, 255, 257, 520), rows
    # one either side of a 64-row tile and a 128-row slot, lim0 inside a
    # tile, more groups than a block's ring holds (300,000 rows), 128
    # columns, a ragged width
    (64, 63, 63, True, 64), (65, 65, 65, False, 64), (128, 127, 100, True, 64),
    (129, 129, 129, True, 64), (255, 255, 230, True, 64), (257, 257, 257, False, 64),
    (520, 20_000, 19_999, True, 64), (33, 300_000, 299_990, True, 64),
    (1, 65, 60, True, 128), (65, 1_025, 1_000, True, 128), (129, 4_000, 3_999, True, 128),
    (257, 383, 300, True, 128), (17, 1_000, 990, True, 50)])
def test_groupmax_kernel_within_order_tol_of_plain(dev, kind, layout, b, r, lim0, mask_row0, d):
    """K4 against groupmax_plain: -inf groups alike, maxima within
    SCORE_ORDER_TOL of each group's largest sum_j |q_j e_rj| (B = 300 walks
    two query chunks of the f32 kernel, B > 256 two query sets of the
    warpgroup kernel)."""
    g = torch.Generator(device="cpu").manual_seed(b * r if d == 64 else b * r + d)
    q = torch.randn(b, d, generator=g)
    e = torch.randn(r, d, generator=g)
    e[120:140] = e[min(3, r - 1)]  # exact ties across a group boundary
    q[0] = 0.0
    q, e = q.to(dev), e.to(dev)
    rows, scales = rows_of(as_index(e, kind))
    before = groupmax.launches[layout]
    got = groupmax(q, rows, scales, lim0, mask_row0, layout)
    want = groupmax_plain(q, rows, scales, lim0, mask_row0, layout)
    torch.cuda.synchronize()
    assert groupmax.launches[layout] == before + 1
    assert got.shape == want.shape
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    bound = SCORE_ORDER_TOL * group_magnitudes(q, rows, scales, layout)
    assert bool(((got - want).abs()[fin] <= bound[fin]).all())


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("layout", [0, 1])
@pytest.mark.parametrize("b", [1, 8, 16, 17, 32, 64, 65, 128, 129, 255, 256, 257])
@pytest.mark.parametrize("d", [64, 128])
def test_groupmax_equals_the_rerank_group_maxima(dev, kind, layout, b, d):
    """The one scoring routine: K4's maxima equal, bit for bit, the maxima
    over each group of the rerank kernel's scores of every group (the
    warpgroup products against score_tile's mma.sync at bf16 and int8); the
    rerank is within the summation-order tolerance of its plain version."""
    r, lim0 = 5_000, 4_900
    g = torch.Generator(device="cpu").manual_seed(b + layout if d == 64 else b + layout + d)
    q = torch.randn(b, d, generator=g).to(dev)
    e = torch.randn(r, d, generator=g).to(dev)
    rows, scales = rows_of(as_index(e, kind))
    n_g = -(-r // GROUP)
    gi = torch.arange(n_g, device=dev).expand(b, n_g).contiguous()
    before = tournament_rerank.launches
    s = tournament_rerank(q, rows, scales, gi, lim0, True)
    gm = groupmax(q, rows, scales, lim0, True, layout)
    plain = tournament_rerank_plain(q, rows, scales, gi, lim0, True)
    torch.cuda.synchronize()
    assert tournament_rerank.launches == before + 1
    got = gm.t() if layout == 0 else gm[:, :n_g]
    assert torch.equal(s.view(b, n_g, GROUP).amax(dim=2), got)
    fin = torch.isfinite(plain)
    assert torch.equal(torch.isfinite(s), fin)
    bound = SCORE_ORDER_TOL * tournament_rerank_plain(q.abs(), rows.abs(), scales, gi, r, False)
    assert bool(((s - plain).abs()[fin] <= bound[fin]).all())


def probe_inputs(kind, case, b, d, seed):
    """q [b, d] f32 and 64 rows [64, d] (bf16, or int8 widened in the
    kernel) for the scoring probe: N(0,1) values; cancelling sums (powers
    of two over 2^-12..2^12 with random signs, each row's second half the
    negation of its first, so exact sums are 0 or tiny against their
    terms); exact ties (one row repeated, one query repeated); a zero
    query."""
    rng = np.random.default_rng(seed)
    if case == "normal":
        q = rng.standard_normal((b, d))
        e = rng.standard_normal((64, d))
    elif case == "cancelling":
        q = np.sign(rng.standard_normal((b, d))) * 2.0 ** rng.integers(-12, 13, (b, d))
        e = np.sign(rng.standard_normal((64, d))) * 2.0 ** rng.integers(-6, 7, (64, d))
        h = d // 2
        q[:, h:2 * h] = q[:, :h]
        e[:, h:2 * h] = -e[:, :h]
        e[1::2] = rng.standard_normal((32, d))
    else:  # ties
        q = rng.standard_normal((b, d))
        e = rng.standard_normal((64, d))
        e[8:40] = e[3]
        q[b // 2:] = q[0]
    q[b - 1] = 0.0
    q = torch.from_numpy(q.astype(np.float32))
    if kind == "int8":
        e = np.clip(np.round(e / np.abs(e).max() * 127), -127, 127)
        return q, torch.from_numpy(e.astype(np.int8))
    return q, torch.from_numpy(e.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("case", ["normal", "cancelling", "ties"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("zero_acc", [0, 1])
def test_wgmma_scores_equal_score_tile(dev, kind, case, d, zero_acc):
    """The probe (csrc/groupmax.cu, probe_kernel): one 64-row tile against
    256 queries by score_tile (mma.sync m16n8k16, k-steps ascending from a
    zero accumulator) and by K4's warpgroup products (wgmma m64n128k16, A the
    rows from load_a, B the queries staged in score_tile's column map,
    k-steps ascending; zero_acc 0: from the first product, 1: from a zeroed
    accumulator). The raw sums must be equal bit for bit (sign of zero
    included): K4 may run on wgmma only if its group maxima stay bit-equal
    to the rerank's and K3's scores."""
    b = 256
    q, e = probe_inputs(kind, case, b, d, seed=d + len(case))
    q, e = q.to(dev), e.to(dev)
    out = [torch.full((b, 64), float("nan"), device=dev) for _ in range(2)]
    lib = _build.library()
    err = lib.carca_groupmax_probe(q.data_ptr(), e.data_ptr(), out[0].data_ptr(),
                                   out[1].data_ptr(), b, d, 1 if kind == "bf16" else 2, zero_acc,
                                   torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "carca_groupmax_probe")
    torch.cuda.synchronize()
    mma, wg = (x.cpu() for x in out)
    assert torch.isfinite(mma).all()
    differ = (mma.view(torch.int32) != wg.view(torch.int32))
    assert not differ.any(), (int(differ.sum()), (mma - wg).abs().max().item())


def test_groupmax_branch_rule_is_the_kernels(dev):
    """retrieval_topk.groupmax_branch, the rule the CPU tests hold, is the
    one csrc/groupmax.cu launches by."""
    lib = _build.library()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1), (torch.int8, 2)):
        for d in (1, 8, 50, 63, 64, 65, 100, 128, 129, 256, 300):
            assert GROUPMAX_BRANCHES[lib.carca_groupmax_branch(code, d)] == \
                groupmax_branch(dtype, d), (dtype, d)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("layout", [0, 1])
@pytest.mark.parametrize("b", [1, 256, 300])
def test_groupmax_kernel_is_deterministic(dev, kind, layout, b):
    """Two launches of K4 over the same inputs give the same bits."""
    g = torch.Generator(device="cpu").manual_seed(b)
    q = torch.randn(b, 64, generator=g).to(dev)
    rows, scales = rows_of(as_index(torch.randn(200_000, 64, generator=g).to(dev), kind))
    first = groupmax(q, rows, scales, 199_000, True, layout)
    second = groupmax(q, rows, scales, 199_000, True, layout)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("layout", [0, 1])
def test_groupmax_kernel_takes_unaligned_rows_and_scales(dev, kind, layout):
    """Rows that start 8 bytes past a 16-byte boundary (the producer's plain
    copies instead of bulk copies) and int8 scales 4 bytes past one (4-byte
    cp.async): the same bits as over aligned copies of the same index."""
    b, r, d = 65, 3_000, 64
    g = torch.Generator(device="cpu").manual_seed(7)
    q = torch.randn(b, d, generator=g).to(dev)
    rows, scales = rows_of(as_index(torch.randn(r, d, generator=g).to(dev), kind))
    off = 8 // rows.element_size()
    flat = torch.empty(r * d + off, dtype=rows.dtype, device=dev)
    flat[off:] = rows.reshape(-1)
    odd_rows = flat[off:].view(r, d)
    odd_scales = None
    if scales is not None:
        sflat = torch.empty(r + 1, device=dev)
        sflat[1:] = scales.reshape(-1)
        odd_scales = sflat[1:].view(1, r)
    assert odd_rows.data_ptr() % 16 == 8
    want = groupmax(q, rows, scales, r - 5, True, layout)
    got = groupmax(q, odd_rows, odd_scales, r - 5, True, layout)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("k,b,r", [(1, 9, 3_000), (10, 9, 3_000), (562, 33, 19_156),
                                   (1_024, 5, 10_000), (16_384, 3, 40_000)])
def test_topk_kernel_selection_is_exact(dev, kind, k, b, r):
    """K3's selection against a full stable sort of the card's own scores
    (the rerank kernel runs the same routine over every group): ids and
    values equal, with many equal scores (rows drawn from 0/1/2 integers)."""
    g = torch.Generator(device="cpu").manual_seed(k)
    q = torch.randint(0, 3, (b, 64), generator=g).float().to(dev)
    e = torch.randint(0, 3, (r, 64), generator=g).float().to(dev)
    e[r // 2:] = torch.randn(r - r // 2, 64, generator=g).to(dev)
    index = as_index(e, kind)
    rows, scales = rows_of(index)
    n_g = -(-r // GROUP)
    s = tournament_rerank(q, rows, scales, torch.arange(n_g, device=dev).expand(b, n_g)
                          .contiguous(), r, True)
    order = torch.sort(s, dim=1, descending=True, stable=True)
    v, i = catalog_topk(q, index, k, method="stream")
    torch.cuda.synchronize()
    want_v = order.values[:, :k]
    assert torch.equal(v, want_v)
    assert torch.equal(i, torch.where(torch.isfinite(want_v), order.indices[:, :k], 0))


def test_topk_scratch_is_independent_of_rows(dev):
    """K3's scratch (B * splits * k * 8 bytes) is bounded by the same amount
    at 2M and 20M rows, and the call's peak memory beyond its outputs stays
    within the plan's scratch."""
    b, k = 64, 562
    q = torch.randn(b, 64, generator=torch.Generator().manual_seed(0)).to(dev)
    for r in (2_000_000, 20_000_000):
        e = torch.randint(-127, 128, (r, 64), dtype=torch.int8, device=dev)
        index = QuantizedIndex(e, torch.rand(1, r, device=dev))
        plan = stream_plan(k, b, r, 64, 1)
        assert plan.scratch_bytes <= (b + 4 * 132 * 8) * k * 8
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        catalog_topk(q, index, k, method="stream")
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - base <= plan.scratch_bytes + b * k * 12 + (4 << 20)
        del e, index
    assert stream_plan(k, b, 2_000_000, 64, 1) == stream_plan(k, b, 20_000_000, 64, 1)._replace(
        rows_per_split=stream_plan(k, b, 2_000_000, 64, 1).rows_per_split)


def check_stream(dev, kind, b, r, k, seed, zero=True):
    """K3 against its plain version (values within SCORE_ORDER_TOL of
    sum_j |q_j e_rj|, ids equal but for near-ties), bit-equal to the
    tournament, and a zero query's top-k the lowest valid ids in order."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, 64, generator=g)
    e = torch.randn(r, 64, generator=g)
    e[100:300] = e[7]  # 200 exact ties
    if zero:
        q[b // 2] = 0.0
    q = q.to(dev)
    index = as_index(e.to(dev), kind)
    before = catalog_topk.launches[kind]
    v, i = catalog_topk(q, index, k, method="stream", n_items=r - 3)
    tv, ti = catalog_topk(q, index, k, method="tournament", n_items=r - 3)
    pv, pi = catalog_topk_plain(q, index, k, n_items=r - 3)
    torch.cuda.synchronize()
    assert catalog_topk.launches[kind] == before + 1
    compare_within_order_tol(v, i, pv, pi, q, index)
    assert torch.equal(i, ti) and torch.equal(v, tv)
    if zero:
        n = min(k, r - 4)
        assert torch.equal(i[b // 2, :n].cpu(), torch.arange(1, n + 1))


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_topk_kernel_at_the_retrieval_monitor_shape(dev, kind):
    """The 10M fit's retrieval monitor: B = 256 queries, k = 60 (k + L),
    over 50,000 rows (the 468,273 seen rows, reduced): the plan's 8 query
    groups of 8 queries."""
    assert stream_plan(60, 256, 50_000, 64, 2 if kind == "bf16" else 1).qb == 64
    check_stream(dev, kind, 256, 50_000, 60, seed=60)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b", [1, 7, 8, 9, 15, 16, 17, 63, 64, 65, 256])
def test_topk_kernel_ragged_query_blocks(dev, kind, b):
    """B around the query groups (8 queries a warp) and the query blocks
    (64): padding columns, padding warps and row parts, k = 60."""
    check_stream(dev, kind, b, 20_000, 60, seed=b)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("k", [1, 16_384])
def test_topk_kernel_smallest_and_largest_k(dev, kind, k):
    """k = 1 and k = MAX_K (one query a warp, one warp a block)."""
    check_stream(dev, kind, 9, 40_000, k, seed=k)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("recursive", [False, True])
@pytest.mark.parametrize("b,r,k,offset,n_items", [
    (33, 19_156, 562, 0, None), (64, 5_000, 10, 0, None), (33, 3_000, 40, 7, 2_500),
    (9, 300, 600, 0, 250), (1, 2_049, 1, 0, None)])
def test_tournament_equals_stream_on_the_card(dev, monkeypatch, kind, recursive,
                                              b, r, k, offset, n_items):
    import carca_tpu_torch.ops.retrieval_topk as rt

    if recursive:
        monkeypatch.setattr(rt, "_RECURSIVE_MIN_GROUPS", 1)
    g = torch.Generator(device="cpu").manual_seed(r + 2)
    q = torch.randn(b, 64, generator=g)
    e = torch.randn(r, 64, generator=g)
    e[100:300] = e[min(7, r - 1)]  # 200 exact ties over two group boundaries
    q[b // 2] = 0.0
    index = as_index(e.to(dev), kind)
    kw = dict(n_items=n_items, id_offset=offset)
    before = (sum(groupmax.launches.values()), tournament_rerank.launches,
              select_topk.launches["positions"], select_topk.launches["values"])
    tv, ti = catalog_topk(q.to(dev), index, k, method="tournament", **kw)
    sv, si = catalog_topk(q.to(dev), index, k, method="stream", **kw)
    torch.cuda.synchronize()
    assert (sum(groupmax.launches.values()), tournament_rerank.launches,
            select_topk.launches["positions"], select_topk.launches["values"]) == \
        (before[0] + 1, before[1] + 1, before[2] + 1 + recursive, before[3] + 1)
    assert torch.equal(ti, si) and torch.equal(tv, sv)


# The select kernel (csrc/select_topk.cu) against its plain version, bit for
# bit (values as int32 bits: the sign of zero counts) and ids / positions.
SELECT_KINDS = ("signed_zeros", "all_equal", "half_neg_inf", "normal")
SELECT_B = (1, 8, 64, 256, 257)
SELECT_N = (1, 127, 128, 8_704, 72_960, 78_126, 1_000_000)


def select_rows(dev, kind, b, n, seed=0):
    """[b, n] float32 on the card, of one kind (the CPU tests' kinds)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "signed_zeros":
        pick = torch.tensor([0.0, -0.0, 0.0, -0.0, 1.0, -1.0, 2.0, float("-inf")], device=dev)
        return pick[torch.randint(0, 8, (b, n), generator=g, device=dev)]
    if kind == "all_equal":
        x = torch.full((b, n), 0.5, device=dev)
        x[1::3] = -0.0
        x[2::3] = float("-inf")
        return x
    x = torch.randn(b, n, generator=g, device=dev)
    if kind == "half_neg_inf":
        x[:, ::2] = float("-inf")
    else:
        x[:, 10:40] = x[:, 7:8]  # 30 exact ties
    return x


def check_select(v, k, gi=None, id_offset=0):
    """Both modes of the kernel against the plain version on the same
    values (its sorts run on the card too)."""
    before = dict(select_topk.launches)
    vals, ids = select_topk(v, k, gi=gi, id_offset=id_offset)
    pos = select_topk(v, k, positions_sorted=True) if k <= v.shape[1] else None
    torch.cuda.synchronize()
    assert select_topk.launches == {"values": before["values"] + 1,
                                    "positions": before["positions"] + (pos is not None)}
    pv, pids = select_topk_plain(v, k, gi=gi, id_offset=id_offset)
    assert torch.equal(vals.view(torch.int32), pv.view(torch.int32))
    assert torch.equal(ids, pids)
    if pos is not None:
        assert torch.equal(pos, select_topk_plain(v, k, positions_sorted=True))


def select_cases():
    """(B, N, k) of the matrix: k in 1, 10, 60, 68, 562, 570, N, N + 5 up
    to MAX_K; at most ~80M values a case."""
    for n in SELECT_N:
        for b in SELECT_B:
            if b * n > 80_000_000:
                continue
            for k in sorted({1, 10, 60, 68, 562, 570, n, n + 5}):
                if k <= MAX_K:
                    yield b, n, k


@pytest.mark.parametrize("b,n,k", list(select_cases()))
def test_select_kernel_is_bit_equal_to_plain(dev, b, n, k):
    check_select(select_rows(dev, "normal", b, n, seed=b + n + k), k, id_offset=5)


@pytest.mark.parametrize("kind", SELECT_KINDS)
@pytest.mark.parametrize("b,n,k", [(8, 8_704, 68), (257, 72_960, 570), (1, 78_126, 562),
                                   (64, 127, 132), (3, 1_000_000, MAX_K), (256, 9_000, 600)])
@pytest.mark.parametrize("column_major", [False, True])
def test_select_kernel_every_kind_of_row(dev, kind, b, n, k, column_major):
    v = select_rows(dev, kind, b, n, seed=k)
    check_select(v.t().contiguous().t() if column_major else v, k)


@pytest.mark.parametrize("b,kg,k", [(256, 570, 562), (256, 68, 60), (1, 570, 562), (9, 3, 400)])
def test_select_kernel_ids_from_winner_groups(dev, b, kg, k):
    """Value mode with the winner groups (the tournament's final top-k)."""
    g = torch.Generator(device="cpu").manual_seed(kg)
    gi = torch.sort(torch.rand(b, 80_000, generator=g).argsort(dim=1)[:, :kg], dim=1).values
    v = select_rows(dev, "normal", b, kg * GROUP, seed=k)
    v[:, -GROUP:] = float("-inf")  # masked rows past the index
    check_select(v, k, gi=gi.to(dev).contiguous(), id_offset=11)


@pytest.mark.parametrize("b,g,k", [(256, 78_126, 570), (256, 78_126, 68), (8, 78_126, 570),
                                   (257, 1_000, 100), (1, 78_126, 570), (129, 5_000, 1),
                                   (128, 20_000, 640), (200, 3_000, 641), (135, 70_000, 10)])
def test_select_kernel_reads_the_group_major_layout_through_strides(dev, b, g, k):
    """K4's layout 0 [G, B] read in place as [B, G] (gm.t()): both modes."""
    gm = select_rows(dev, "normal", g, b, seed=b)  # [G, B]
    assert gm.t().stride() == (1, b)
    check_select(gm.t(), k)


def test_select_kernel_raises_on_what_it_lacks(dev):
    v = torch.randn(4, 300, device=dev)
    for bad, err, match in (
            (lambda: select_topk(v.double(), 5), TypeError, "float32"),
            (lambda: select_topk(v[None], 5), TypeError, "float32"),
            (lambda: select_topk(v, 0), ValueError, "outside"),
            (lambda: select_topk(v, MAX_K + 1), ValueError, "outside"),
            (lambda: select_topk(v, 301, positions_sorted=True), ValueError, "positions"),
            (lambda: select_topk(v[:, :256], 5, gi=torch.zeros(4, 2, dtype=torch.int32,
                                                                 device=dev)),
             TypeError, "int64"),
            (lambda: select_topk(v[:, :256], 5, gi=torch.zeros(4, 2, dtype=torch.int64)),
             TypeError, "int64"),
            (lambda: select_topk(v[:, :256], 5, gi=torch.zeros(4, 3, dtype=torch.int64,
                                                                 device=dev)),
             ValueError, "group ids")):
        with pytest.raises(err, match=match):
            bad()


def select_reads_by_tma(v, k):
    """Whether the select kernel reads v by tensor copies (else its
    producer's plain loads), at the plan's queries a block."""
    b, n = v.shape
    plan = select_plan(b, n, k, column=n > 1 and v.stride(1) != 1)
    return bool(_build.library().carca_select_topk_tma(v.data_ptr(), v.stride(0), v.stride(1), b,
                                                      n, plan.queries))


def test_select_plan_shared_memory_is_the_kernels(dev):
    """select_plan sizes a block by retrieval_topk._select_smem, the C
    side's smem_bytes formula: the two agree at every k, queries a block
    and ring slots."""
    import carca_tpu_torch.ops.retrieval_topk as rt

    lib = _build.library()
    for k in (1, 60, 68, 562, 570, 1_000, 4_096, MAX_K):
        for qb in (1, 2, 4, 8):
            for slots in (2, 8, 24):
                assert lib.carca_select_topk_smem_bytes(k, qb, slots) == rt._select_smem(k, qb, slots)


@pytest.mark.parametrize("g,k", [(78_126, 570), (5_000, 68), (300, 300)])
@pytest.mark.parametrize("b", [1, 3, 9, 257])
def test_select_kernel_group_major_rows_past_a_box(dev, b, g, k):
    """K4's [G, B] read in place with B not a multiple of 8: the tensor
    copies' boxes of 8 queries run past B (and the plain loads take the
    strides a tensor map cannot), and no value past B or past a split is
    offered."""
    gm = select_rows(dev, "normal", g, b, seed=b + g)
    check_select(gm.t(), k)


@pytest.mark.parametrize("make,tma", [
    (lambda x: x.t().contiguous().t(), True),             # [G, 256] read as [256, G]
    (lambda x: x, True),                                  # rows of 80,000 bytes
    (lambda x: x[:3].t().contiguous().t(), False),        # [G, 3]: a 12-byte stride
    (lambda x: x[:, 1:], False),                          # rows from an unaligned pointer
    (lambda x: x[:, ::3], False),                         # every third value
    (lambda x: torch.cat([x, x[:, :1]], 1)[:, :-1], False),  # rows 80,004 bytes apart
])
@pytest.mark.parametrize("k", [1, 570])
def test_select_kernel_strides_a_tensor_map_cannot_take(dev, make, tma, k):
    """Views a 2-D tensor map cannot describe go through the producer's
    plain loads, a path of the same kernel, bit-equal like the copies."""
    v = make(select_rows(dev, "normal", 256, 20_000, seed=k))
    assert select_reads_by_tma(v, k) == tma
    check_select(v, k)


@pytest.mark.parametrize("column_major", [False, True])
@pytest.mark.parametrize("b,n,k", [(8, 5_000, 1), (8, 5_000, 5_000), (3, 100_000, MAX_K),
                                   (2, MAX_K, MAX_K), (256, 40_000, 1), (1, 78_126, 78_126 // 5)])
def test_select_kernel_smallest_and_largest_k(dev, b, n, k, column_major):
    """k = 1, k = N and k = 16,384 (one query a block, the sort in shared
    memory past 2,048 slots)."""
    v = select_rows(dev, "normal", b, n, seed=n + k)
    check_select(v.t().contiguous().t() if column_major else v, k)


@pytest.mark.parametrize("b,n,k,splits", [(256, 1_000, 60, 1), (256, 2_000, 570, 1),
                                          (1, 78_126, 570, 8), (8, 78_126, 570, 8),
                                          (16, 78_126, 570, 8)])
@pytest.mark.parametrize("column_major", [False, True])
def test_select_kernel_one_split_and_a_cluster_of_8(dev, b, n, k, splits, column_major):
    """One block a query group (no merge across blocks) and clusters of 8
    blocks (rank r merges the queries r, r + 8, ...): both modes
    bit-equal."""
    v = select_rows(dev, "half_neg_inf" if splits == 1 else "normal", b, n, seed=b * splits)
    v = v.t().contiguous().t() if column_major else v
    assert select_plan(b, n, k, column=column_major).splits == splits
    check_select(v, k)


@pytest.mark.parametrize("b,n,k,column_major", [(1, 78_126, 570, True), (8, 72_960, 562, False),
                                                (256, 78_126, 570, True)])
def test_select_kernel_back_to_back_and_graphed(dev, b, n, k, column_major):
    """100 calls in a row and 10 replays of one captured CUDA graph, each
    bit-equal to the plain version: the clusters' merge leaves nothing
    behind for the next call."""
    v = select_rows(dev, "normal", b, n, seed=7)
    v = v.t().contiguous().t() if column_major else v
    pv, pids = select_topk_plain(v, k, id_offset=3)
    ppos = select_topk_plain(v, k, positions_sorted=True)
    outs = [(select_topk(v, k, id_offset=3), select_topk(v, k, positions_sorted=True))
            for _ in range(100)]
    torch.cuda.synchronize()
    for (vals, ids), pos in outs:
        assert torch.equal(vals.view(torch.int32), pv.view(torch.int32))
        assert torch.equal(ids, pids) and torch.equal(pos, ppos)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        select_topk(v, k, id_offset=3)  # warm on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        (vals, ids), pos = select_topk(v, k, id_offset=3), select_topk(v, k, positions_sorted=True)
    for _ in range(10):
        vals.zero_(), ids.zero_(), pos.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(vals.view(torch.int32), pv.view(torch.int32))
        assert torch.equal(ids, pids) and torch.equal(pos, ppos)


@pytest.mark.parametrize("k", [TOURNAMENT_MAX_K, TOURNAMENT_MAX_K + 1])
def test_tournament_largest_k_on_the_card(dev, k):
    """The tournament takes k up to TOURNAMENT_MAX_K = MAX_K - 8 on the card
    (stage 2 selects k + 8 groups, the select kernel at most MAX_K): at the
    limit, over more than MAX_K groups, it equals the stream; one past it
    the tournament raises and "auto" gives that k the stream."""
    assert TOURNAMENT_MAX_K == MAX_K - 8
    r = (MAX_K + 8) * GROUP
    g = torch.Generator(device="cpu").manual_seed(k)
    q = torch.randn(2, 16, generator=g).to(dev)
    e = torch.randn(r, 16, generator=g).to(dev)
    sv, si = catalog_topk(q, e, k, method="stream")
    if k > TOURNAMENT_MAX_K:
        assert resolve_method("auto", r, k, 2) == "stream"
        with pytest.raises(ValueError, match=f"the tournament takes k <= {TOURNAMENT_MAX_K}"):
            catalog_topk(q, e, k, method="tournament")
        av, ai = catalog_topk(q, e, k)
        torch.cuda.synchronize()
        assert torch.equal(ai, si) and torch.equal(av, sv)
        return
    assert resolve_method("auto", r, k, 2) == "tournament"
    before = dict(select_topk.launches)
    tv, ti = catalog_topk(q, e, k, method="tournament")
    torch.cuda.synchronize()
    assert select_topk.launches == {"positions": before["positions"] + 1,
                                    "values": before["values"] + 1}
    assert torch.equal(ti, si) and torch.equal(tv, sv)


def test_topk_kernel_raises_on_what_it_lacks(dev):
    """Every index type and both methods now run kernels on the card; what
    they cannot take still raises: an int8 tensor without its scales, a
    non-contiguous index, an index on another device, non-float32 queries."""
    q = torch.randn(4, 8, device=dev)
    e = torch.randn(100, 8, device=dev)
    def launches():
        return sum(catalog_topk.launches.values()), sum(groupmax.launches.values())

    before = launches()
    for method in ("stream", "tournament"):
        for index in (e, e.to(torch.bfloat16), quantize_index(e)):
            assert np.isfinite(catalog_topk(q, index, 5, method=method)[0].cpu().numpy()).all()
    assert launches() == (before[0] + 3, before[1] + 3)
    for method in ("stream", "tournament"):
        with pytest.raises(TypeError, match="QuantizedIndex"):
            catalog_topk(q, e.to(torch.int8), 5, method=method)
        with pytest.raises(ValueError, match="contiguous"):
            catalog_topk(q, torch.randn(8, 200, device=dev).t(), 5, method=method)
        with pytest.raises(ValueError, match="index on"):
            catalog_topk(q, e.cpu(), 5, method=method)
        with pytest.raises(TypeError, match="float32 queries"):
            catalog_topk(q.double(), e, 5, method=method)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("d", [130, 256, 300])
def test_retrieval_kernels_score_rows_wider_than_128(dev, monkeypatch, kind, d):
    """Rows of more than 128 columns run in 128-column chunks: K3 and K4 in
    both layouts within the summation-order tolerance of their plain
    versions, K4's maxima bit-equal to the rerank's group maxima, and the
    tournament (flat and recursive) bit-equal to the stream."""
    import carca_tpu_torch.ops.retrieval_topk as rt

    b, r, k, lim0 = 40, 3_000, 50, 2_900
    g = torch.Generator(device="cpu").manual_seed(d)
    q = torch.randn(b, d, generator=g)
    e = torch.randn(r, d, generator=g)
    e[120:140] = e[3]  # exact ties across a group boundary
    q[1] = 0.0
    q, e = q.to(dev), e.to(dev)
    index = as_index(e, kind)
    rows, scales = rows_of(index)
    before = (catalog_topk.launches[kind], dict(groupmax.launches), tournament_rerank.launches)
    v, i = catalog_topk(q, index, k, method="stream", n_items=lim0)
    pv, pi = catalog_topk_plain(q, index, k, n_items=lim0)
    torch.cuda.synchronize()
    compare_within_order_tol(v, i, pv, pi, q, index)
    n_g = -(-r // GROUP)
    gi = torch.arange(n_g, device=dev).expand(b, n_g).contiguous()
    s = tournament_rerank(q, rows, scales, gi, lim0, True)
    for layout in (0, 1):
        got = groupmax(q, rows, scales, lim0, True, layout)
        want = groupmax_plain(q, rows, scales, lim0, True, layout)
        torch.cuda.synchronize()
        fin = torch.isfinite(want)
        assert torch.equal(torch.isfinite(got), fin)
        bound = SCORE_ORDER_TOL * group_magnitudes(q, rows, scales, layout)
        assert bool(((got - want).abs()[fin] <= bound[fin]).all())
        assert torch.equal(s.view(b, n_g, GROUP).amax(dim=2),
                           got.t() if layout == 0 else got[:, :n_g])
    for recursive in (False, True):
        monkeypatch.setattr(rt, "_RECURSIVE_MIN_GROUPS", 1 if recursive else 1 << 62)
        tv, ti = catalog_topk(q, index, k, method="tournament", n_items=lim0)
        assert torch.equal(ti, i) and torch.equal(tv, v)
    assert catalog_topk.launches[kind] == before[0] + 1
    assert groupmax.launches[0] == before[1][0] + 2 and groupmax.launches[1] == before[1][1] + 2
    assert tournament_rerank.launches == before[2] + 3


@pytest.mark.parametrize("process", ["zipf", "markov"])
def test_device_generators_rerun_bit_equal_on_the_card(dev, process):
    """The card's synthetic catalog is the same for the same seed (what a
    served or resumed run regenerates), on the card; its offsets are the
    host generator's."""
    from carca_tpu_torch.data.synthetic import synthetic_generator

    gen = synthetic_generator(process, device=True, torch_device=dev)
    kw = dict(n_users=3_000, n_real_items=50_000, seed=3)
    a, b = gen(**kw), gen(**kw)
    for name in ("attrs", "items", "ctx_vals"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.device.type == "cuda" and torch.equal(x, y), name
    np.testing.assert_array_equal(a.offsets, b.offsets)
    assert int(a.items.min()) >= 1 and int(a.items.max()) <= 50_000
    assert not bool(a.attrs[0].any())
    assert not torch.equal(a.items, gen(**dict(kw, seed=4)).items)


def test_sparse_step_on_the_card_matches_the_cpu_plain_sparse_step(dev):
    """One row-sparse train step (dropout 0, K1/K2 on the card) against the
    same step on the CPU plain path from the same weights (the CPU's draw,
    copied to the card: the card draws others for a seed) and batch: loss
    within 1e-5 relative; touched item rows within 1e-5 absolute where the
    row's gradient |g| > 1e-6, and within 2·lr elsewhere (a first Adam step
    moves an element by lr·g/(|g| + eps): where |g| nears eps = 1e-8, the
    float32 summation order of g moves it by a share of lr; measured 1.5e-5
    once); first moments (0.1·g) within 1e-2 relative or 1e-9; untouched
    rows, their moments and the pad row bit-equal / exactly 0."""
    from carca_tpu_torch.config import ModelConfig, TrainConfig
    from carca_tpu_torch.data.dataset import BatchBuilder
    from carca_tpu_torch.data.synthetic import synthetic_catalog
    from carca_tpu_torch.train.loop import _sparse_device_update
    from carca_tpu_torch.train.state import create_train_state

    cat = synthetic_catalog(n_users=300, n_real_items=5_000, seed=2)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx, d=64, g=256,
                     seq_len=50, target_len=100, n_blocks=2, n_heads=2, dropout=0.0,
                     decoder="dot")
    tc = TrainConfig(batch_size=64, l2_reg=1e-4)
    builder = BatchBuilder(cat, mc.seq_len, mc.target_len)
    batch = builder.train_batch(builder.users("train")[:64], np.random.default_rng(0))
    batch.pop("n_valid")
    states = {}
    fresh = create_train_state(mc, tc, "cpu").model
    table0 = fresh.embed.items.detach().clone()
    for where in ("cpu", dev):
        st = create_train_state(mc, tc, where, sparse_items=True,
                                model=copy.deepcopy(fresh).to(where))
        st.model.train()
        b = {k: torch.from_numpy(v.copy()).to(where) for k, v in batch.items()}
        launches = fused_attention.launches
        loss = _sparse_device_update(tc, st, b, torch.as_tensor(cat.attrs, device=where))
        assert (fused_attention.launches > launches) == (where != "cpu")
        states[str(where)] = (st, loss.item())
    (cpu, loss_c), (gpu, loss_g) = states["cpu"], states[str(dev)]
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    ids = np.unique(np.concatenate([batch["p_x"].ravel(), batch["o_x"].ravel()]))
    rest = np.setdiff1d(np.arange(mc.n_items), ids)
    items_g, items_c = gpu.model.embed.items.detach().cpu(), cpu.model.embed.items.detach()
    munu_g, munu_c = gpu.items_state["munu"].cpu(), cpu.items_state["munu"]
    d = mc.d
    g_cpu = munu_c[ids, :d] / (1.0 - tc.beta1)
    tol = torch.where(g_cpu.abs() > 1e-6, 1e-5, 2 * tc.lr)
    assert bool(((items_g[ids] - items_c[ids]).abs() <= tol).all())
    assert torch.equal(items_g[rest], table0[rest]) and torch.equal(items_c[rest], table0[rest])
    torch.testing.assert_close(munu_g[ids, :d], munu_c[ids, :d], rtol=1e-2, atol=1e-9)
    assert not bool(munu_g[rest].any()) and not bool(items_g[0].any())
    assert gpu.items_state["count"] == cpu.items_state["count"] == 1


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("method", ["stream", "tournament"])
@pytest.mark.parametrize("n_shards,b,r,k", [(2, 8, 40_001, 60), (4, 64, 100_003, 10),
                                            (2, 1, 1_000_001, 60)])
def test_sharded_topk_merges_bit_equal_to_one_shard(dev, kind, method, n_shards, b, r, k):
    """An index split into row blocks (``mesh.local_rows``: padded to the
    shard count), each block ranked by the kernels with its ``id_offset``
    and the true row count, the blocks' lists merged in shard order
    (``parallel.retrieval.merge_shard_topk``, what the model ranks do after
    their all-gather): the one-device kernel result, ids and values bit for
    bit, since a score depends only on its query and its row."""
    from carca_tpu_torch.parallel.mesh import Mesh, local_rows
    from carca_tpu_torch.parallel.retrieval import merge_shard_topk

    g = torch.Generator(device="cpu").manual_seed(r + b)
    q = torch.randn(b, 64, generator=g).to(dev)
    e = torch.randn(r, 64, generator=g).to(dev)
    index = quantize_index(e) if kind == "int8" else (e.to(torch.bfloat16) if kind == "bf16"
                                                      else e)
    want_v, want_i = catalog_topk(q, index, k, n_items=r, method=method)
    vals, ids = [], []
    for m in range(n_shards):
        mesh = Mesh(n_data=1, n_model=n_shards, rank=m)
        if kind == "int8":
            block = QuantizedIndex(local_rows(index.qvals, mesh).contiguous(),
                                   local_rows(index.scales.T, mesh).T.contiguous())
            rows = block.rows
        else:
            block = local_rows(index, mesh).contiguous()
            rows = block.shape[0]
        v, i = catalog_topk(q, block, min(k, rows), n_items=r, id_offset=m * rows,
                            method=method)
        vals.append(v)
        ids.append(i)
    got_v, got_i = merge_shard_topk(vals, ids, k)
    torch.cuda.synchronize()
    assert torch.equal(got_i, want_i) and torch.equal(got_v, want_v)


# --------------------------------------------------------------------------
# remat: the encoder blocks under activation checkpointing, K1 launched
# again in each block's recompute (models/remat.py)
# --------------------------------------------------------------------------

REMAT_B, REMAT_L, REMAT_K = 32, 50, 3


def remat_calls(dev, remat_on, path, graph, compute_dtype="float32", calls=3):
    """``calls`` train calls of ``path`` ("scanned": the K-step call;
    "sparse": the same with the row-sparse item Adam; "device": the
    one-step device call; "host": the host step) at dropout 0.5 on the
    card, from the weights and generators of seed 5: (losses, state
    tensors, K1 and K2 launches, seeds drawn, the step, steps taken)."""
    from carca_tpu_torch.config import ModelConfig, TrainConfig
    from carca_tpu_torch.data.dataset import BatchBuilder
    from carca_tpu_torch.data.device_pipeline import DeviceDataset
    from carca_tpu_torch.data.synthetic import synthetic_catalog
    from carca_tpu_torch.ops.flash_attention import kernel_seed
    from carca_tpu_torch.train.loop import (make_device_train_step,
                                            make_scanned_device_train_step, make_train_step)
    from carca_tpu_torch.train.state import create_train_state

    cat = synthetic_catalog(n_users=300, n_real_items=2_000, seed=3)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx, d=64, g=256,
                     seq_len=REMAT_L, target_len=100, n_blocks=2, n_heads=2, dropout=0.5,
                     decoder="ca", compute_dtype=compute_dtype, remat=remat_on)
    tc = TrainConfig(batch_size=REMAT_B, inner_steps=REMAT_K, seed=5, lr_schedule="cosine",
                     lr_decay_steps=20)
    sparse = path == "sparse"
    state = create_train_state(mc, tc, dev, sparse_items=sparse)
    attrs = torch.as_tensor(cat.attrs, device=dev)
    start = (fused_attention.launches, attention_bwd.launches, kernel_seed.drawn)
    losses = []
    if path != "host":
        dd = DeviceDataset(cat, mc.seq_len, mc.target_len, device=dev)
        users = dd.users("train")
        k = 1 if path == "device" else REMAT_K
        step = (make_device_train_step(mc, tc, graph=graph) if path == "device" else
                make_scanned_device_train_step(mc, k, tc, sparse_items=sparse, graph=graph))
        for c in range(calls):
            rows = torch.as_tensor(np.stack([np.roll(users, -(c * k + i) * REMAT_B)[:REMAT_B]
                                             for i in range(k)]))
            state, lo = step(state, attrs, dd.arrays, rows[0] if path == "device" else rows)
            losses.append(lo.reshape(-1))
    else:
        builder = BatchBuilder(cat, mc.seq_len, mc.target_len)
        users, rng = builder.users("train"), np.random.default_rng(0)
        step = make_train_step(mc, tc, graph=graph)
        for c in range(calls):
            b = builder.train_batch(np.roll(users, -c * REMAT_B)[:REMAT_B], rng)
            b.pop("n_valid")
            state, lo = step(state, attrs, b)
            losses.append(lo.reshape(1))
    torch.cuda.synchronize()
    tensors = {f"param {n}": p.detach() for n, p in state.model.named_parameters()}
    for i, st in enumerate(state.optimizer.state.values()):
        tensors.update({f"adam {i} {k}": v for k, v in st.items()})
    if sparse:
        tensors["munu"] = state.items_state["munu"]
    tensors["generator"] = state.generator.get_state()
    tensors["seed_generator"] = state.seed_generator.get_state()
    counts = (fused_attention.launches - start[0], attention_bwd.launches - start[1],
              kernel_seed.drawn - start[2])
    return torch.cat(losses), tensors, counts, step, state.step


@pytest.mark.parametrize("path,graph,cd", [
    ("scanned", False, "float32"), ("scanned", None, "float32"),
    ("scanned", None, "bfloat16"), ("sparse", None, "float32"), ("device", None, "float32"),
    ("host", None, "float32")])
def test_remat_equals_no_remat_on_the_card(dev, path, graph, cd):
    """K1/K2 under remat, eager and through a ``GraphedStep`` capture: the
    losses, parameters, Adam's state and both generators bit-equal to the
    call without remat; K1 launched once more per encoder block and step
    (the recompute), K2 as often, the same Philox seeds drawn; the graph
    captured once and replayed."""
    base = remat_calls(dev, False, path, graph, cd)
    got = remat_calls(dev, True, path, graph, cd)
    assert torch.isfinite(base[0]).all()
    assert torch.equal(got[0], base[0])
    assert got[1].keys() == base[1].keys()
    for name in base[1]:
        assert torch.equal(got[1][name].cpu(), base[1][name].cpu()), name
    k = REMAT_K if path in ("scanned", "sparse") else 1
    steps = got[4]
    assert steps == base[4] == 3 * k
    k1, k2, seeds = base[2]
    assert got[2] == (k1 + 2 * steps, k2, seeds) and k1 > 0 and k2 > 0 and seeds > 0
    if graph is None:
        assert (got[3].captures, got[3].replays) == (1, 2)
        assert len(got[3].rewind_gens) == 2 * k


def test_remat_capture_without_rewind_generators_raises(dev):
    """A checkpointed block with dropout captured outside ``GraphedStep``
    (a seed buffer installed, no rewind generators) raises instead of
    recomputing with other bits."""
    from carca_tpu_torch.config import ModelConfig
    from carca_tpu_torch.models.carca import CARCA, encode_profile
    from carca_tpu_torch.ops.flash_attention import seed_slots

    mc = ModelConfig(n_items=100, n_attrs=4, n_ctx=2, d=64, n_blocks=2, seq_len=REMAT_L,
                     dropout=0.5, remat=True)
    model = CARCA(mc, device=dev).train()
    g = torch.Generator(device=dev).manual_seed(0)
    p_x = torch.randint(1, 100, (4, REMAT_L), device=dev, generator=g)
    p_c = torch.zeros(4, REMAT_L, 2, device=dev)
    attrs = torch.zeros(100, 4, device=dev)
    seeds = torch.Generator().manual_seed(0)
    encode_profile(model, (p_x, None, p_c), attrs_table=attrs, generator=g,
                   seed_generator=seeds)[0].sum().backward()
    torch.cuda.synchronize()
    buf = torch.zeros(8, dtype=torch.int64, device=dev)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(g)
    with pytest.raises(RuntimeError, match="needs rewind generators"):
        with seed_slots(buf), torch.cuda.graph(graph):
            encode_profile(model, (p_x, None, p_c), attrs_table=attrs, generator=g,
                           seed_generator=seeds)
