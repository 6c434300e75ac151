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
tournament (K4 and the rerank) = the stream (K3), ids and values, and K3 =
a full sort of the routine's own scores. With weight dropout the plain version is
fed the kernels' own Philox keep mask.
"""

import numpy as np
import pytest
import torch

from carca_tpu_torch.models.attention import MHA, masked_attention
from carca_tpu_torch.ops.flash_attention import (SEED_LIMIT, attention_bwd,
                                                 attention_grads_plain, attention_keep_mask,
                                                 fused_attention)
from carca_tpu_torch.ops.retrieval_topk import (GROUP, SCORE_ORDER_TOL, QuantizedIndex,
                                                catalog_topk, catalog_topk_plain,
                                                compare_within_order_tol, groupmax,
                                                groupmax_plain, quantize_index, stream_plan,
                                                tournament_rerank, tournament_rerank_plain)

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


@pytest.mark.parametrize("causal,lq,lk,b", [(0, 50, 50, 8), (None, 512, 50, 8),
                                            (-1, 50, 50, 8), (0, 33, 70, 3),
                                            (None, 1, 1, 1)])
@pytest.mark.parametrize("cd,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_attention_kernel_matches_plain(dev, causal, lq, lk, b, cd, tol):
    q, k, v, qm, km = attn_inputs(dev, b, lq, lk, 64)
    kw = dict(causal=causal, scale=32 ** 0.5, n_heads=2, compute_dtype=cd)
    got = fused_attention(q, k, v, qm, km, **kw)
    want = masked_attention(q, k, v, qm, km, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert torch.count_nonzero(got[0]) == 0


def seed_of(i):
    """The Philox seed fused_attention draws from Generator().manual_seed(i)."""
    return int(torch.randint(SEED_LIMIT, (), generator=torch.Generator().manual_seed(i)))


@pytest.mark.parametrize("causal,lq,lk,b", [(0, 50, 50, 8), (None, 40, 50, 8),
                                            (-1, 50, 50, 8), (0, 33, 70, 3)])
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


def test_keep_mask_on_the_card_equals_the_numpy_generator(dev):
    shape = (3, 2, 50, 70)
    for seed in (0, 2**40 + 17, SEED_LIMIT - 1):
        assert torch.equal(attention_keep_mask(seed, shape, 0.3, dev).cpu(),
                           attention_keep_mask(seed, shape, 0.3))


def rel(a, b):
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("causal,lq,lk,b", [(0, 50, 50, 8), (-1, 50, 50, 16),
                                            (0, 200, 200, 4), (None, 33, 70, 3),
                                            (0, 1, 1, 1)])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("cd,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_attention_bwd_kernel_matches_plain_autograd(dev, causal, lq, lk, b, rate, cd, tol):
    q, k, v, qm, km = attn_inputs(dev, b, lq, lk, 64)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(9)).to(dev)
    kw = dict(causal=causal, scale=32 ** 0.5, n_heads=2, compute_dtype=cd, dropout_rate=rate)
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


@pytest.mark.parametrize("lq,lk", [(50, 50), (200, 320)])
def test_attention_bwd_kernel_is_deterministic(dev, lq, lk):
    """No atomics: two runs of K2 (and of K1) are bit-equal, with one key
    tile and with several; another seed changes the result."""
    q, k, v, qm, km = attn_inputs(dev, 32, lq, lk, 64)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(dev)
    kw = dict(causal=-1, scale=32 ** 0.5, n_heads=2, dropout_rate=0.5, seed=123)
    a = attention_bwd(q, k, v, qm, km, g, **kw)
    b = attention_bwd(q, k, v, qm, km, g, **kw)
    c = attention_bwd(q, k, v, qm, km, g, **dict(kw, seed=124))
    fkw = dict(causal=-1, scale=32 ** 0.5, n_heads=2, dropout_rate=0.5)
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
@pytest.mark.parametrize("b,r,lim0,mask_row0", [
    (256, 20_000, 20_000, True), (33, 19_156, 15_000, False), (17, 1_000, 1_000, True),
    (9, 300, 250, True), (1, 2_049, 2_049, True), (5, 129, 129, False),
    (300, 3_000, 3_000, True)])
def test_groupmax_kernel_within_order_tol_of_plain(dev, kind, layout, b, r, lim0, mask_row0):
    """K4 against groupmax_plain: -inf groups alike, maxima within
    SCORE_ORDER_TOL of each group's largest sum_j |q_j e_rj| (B = 300 walks
    two query chunks)."""
    g = torch.Generator(device="cpu").manual_seed(b * r)
    q = torch.randn(b, 64, generator=g)
    e = torch.randn(r, 64, generator=g)
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
@pytest.mark.parametrize("b", [1, 8, 256])
def test_groupmax_equals_the_rerank_group_maxima(dev, kind, layout, b):
    """The one scoring routine: K4's maxima equal, bit for bit, the maxima
    over each group of the rerank kernel's scores of every group; the rerank
    is within the summation-order tolerance of its plain version."""
    r, lim0 = 5_000, 4_900
    g = torch.Generator(device="cpu").manual_seed(b + layout)
    q = torch.randn(b, 64, generator=g).to(dev)
    e = torch.randn(r, 64, generator=g).to(dev)
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
    before = sum(groupmax.launches.values()), tournament_rerank.launches
    tv, ti = catalog_topk(q.to(dev), index, k, method="tournament", **kw)
    sv, si = catalog_topk(q.to(dev), index, k, method="stream", **kw)
    torch.cuda.synchronize()
    assert (sum(groupmax.launches.values()), tournament_rerank.launches) == \
        (before[0] + 1, before[1] + 1)
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
    same step on the CPU plain path from the same weights and batch: loss
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
    for where in ("cpu", dev):
        st = create_train_state(mc, tc, where, sparse_items=True)
        st.model.train()
        b = {k: torch.from_numpy(v.copy()).to(where) for k, v in batch.items()}
        launches = fused_attention.launches
        loss = _sparse_device_update(tc, st, b, torch.as_tensor(cat.attrs, device=where))
        assert (fused_attention.launches > launches) == (where != "cpu")
        states[str(where)] = (st, loss.item())
    (cpu, loss_c), (gpu, loss_g) = states["cpu"], states[str(dev)]
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    table0 = create_train_state(mc, tc, "cpu").model.embed.items.detach()
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
