"""The attention backward (K2's plain version and the autograd plumbing
around the kernels) and the weight dropout's bits, on the CPU.

Gradients: the port's ``attention_bwd`` and autograd through its
``fused_attention`` (plain versions, on CPU tensors) against ``jax.vjp`` of
the JAX package's ``fused_attention``, which runs B1/B2 in interpret mode.
Inputs are numpy arrays from a seed; dropout is off, since the two
frameworks' bits cannot agree. Tolerance 1e-5 (f32 summation order);
gradients of fully masked rows must be exactly 0 in both.

Dropout: the numpy Philox against the Random123 known-answer vectors and
against values of ``csrc/philox.cuh`` compiled for the host; the keep mask's
layout, share and determinism; ``masked_attention``'s ``keep_mask`` against
a numpy formula; and the plain draw's keep rate and 1/(1−p) scale.
"""

import jax
import numpy as np
import pytest
import torch

from carca_tpu.ops.flash_attention import fused_attention as jax_fused_attention
from carca_tpu_torch.models.attention import masked_attention
from carca_tpu_torch.ops import flash_attention as fa
from carca_tpu_torch.ops.flash_attention import (WHOLE_ROW_KEYS, attention_bwd,
                                                 attention_grads_plain, attention_keep_mask,
                                                 bwd_branch, fused_attention, keep_bits_words,
                                                 keep_threshold, philox4x32_10, philox_bits)

torch.set_num_threads(1)

TOL = 1e-5
H = 2
D = 16


def make(seed, b, lq, lk, d=D):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, d)).astype(np.float32) for n in (lq, lk, lk))
    g = rng.standard_normal((b, lq, d)).astype(np.float32)
    qm = (rng.random((b, lq)) > 0.2).astype(np.float32)
    km = (rng.random((b, lk)) > 0.2).astype(np.float32)
    qm[0, 0] = 0.0  # a padded query row
    km[1, :] = 0.0  # a batch row with every key masked
    km[0, 0] = 1.0
    return q, k, v, qm, km, g


def jax_grads(q, k, v, qm, km, g, **kw):
    _, vjp = jax.vjp(lambda a, b, c: jax_fused_attention(a, b, c, qm, km, **kw), q, k, v)
    return [np.asarray(x) for x in vjp(g)]


# (batch, Lq, Lk, d, causal): small shapes, then the families' head widths
# (games and fashion: d = 128 in 2 heads of 64 at L = 50; men: 2 heads of 32
# at L = 70, past one 64-key tile, and at L = 130, past three of K2's
# 40-key chunks and two 64-row query tiles, the last one ragged)
BWD_CASES = [(3, lq, lk, D, causal) for causal in (None, 0, -1) for lq, lk in ((8, 8), (12, 5))]
BWD_IDS = [f"{lq}-{lk}-{causal}" for _, lq, lk, _, causal in BWD_CASES]
BWD_CASES += [(2, 50, 50, 128, 0), (2, 50, 50, 128, -1), (2, 70, 70, 64, -1),
              (2, 130, 130, 64, -1)]
BWD_IDS += ["dh64-L50-0", "dh64-L50--1", "dh32-L70--1", "dh32-L130--1"]


@pytest.mark.parametrize("b,lq,lk,d,causal", BWD_CASES, ids=BWD_IDS)
def test_attention_bwd_matches_jax(b, lq, lk, d, causal):
    q, k, v, qm, km, g = make(0, b, lq, lk, d=d)
    kw = dict(causal=causal, scale=(d / H) ** 0.5, n_heads=H)
    t = torch.from_numpy
    got = [x.numpy() for x in attention_bwd(t(q), t(k), t(v), t(qm), t(km), t(g), **kw)]
    want = jax_grads(q, k, v, qm, km, g, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, w, rtol=TOL, atol=TOL, err_msg=name)
    dq, dk, dv = got
    # the all-keys-masked batch row and the padded query row: exact zeros
    assert (dq[1] == 0).all() and (dk[1] == 0).all() and (dv[1] == 0).all()
    assert (dq[0, 0] == 0).all() and (want[0][0, 0] == 0).all()


def test_fused_attention_autograd_on_cpu_matches_jax():
    q, k, v, qm, km, g = make(1, 2, 8, 8)
    kw = dict(causal=0, scale=(D / H) ** 0.5, n_heads=H)
    qq, kk, vv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fused_attention(qq, kk, vv, torch.from_numpy(qm), torch.from_numpy(km), **kw)
    out.backward(torch.from_numpy(g))
    for a, w in zip((qq.grad, kk.grad, vv.grad), jax_grads(q, k, v, qm, km, g, **kw)):
        np.testing.assert_allclose(a.numpy(), w, rtol=TOL, atol=TOL)


def test_kernel_autograd_function_plumbing(monkeypatch):
    """The autograd.Function the card uses (K1 forward, K2 backward), with
    the K1 launch replaced by its plain version fed the same Philox bits
    and K2 by its CPU path: gradients equal autograd of the plain version,
    and the seed reaches both directions."""
    q, k, v, qm, km, g = make(2, 3, 8, 6)
    opts = dict(causal=-1, scale=(D / H) ** 0.5, n_heads=H, compute_dtype="float32",
                dropout_rate=0.5, seed=987654321)
    mask = attention_keep_mask(opts["seed"], (3, H, 8, 6), 0.5)

    def plain_launch(q, k, v, q_mask, k_mask, *, seed, dropout_rate, **kw):
        keep = attention_keep_mask(seed, (q.shape[0], kw["n_heads"], q.shape[1], k.shape[1]),
                                   dropout_rate)
        return masked_attention(q, k, v, q_mask, k_mask, dropout_rate=dropout_rate,
                                keep_mask=keep, **kw)

    monkeypatch.setattr(fa, "_launch_fwd", plain_launch)
    t = torch.from_numpy
    qq, kk, vv = (t(x).requires_grad_() for x in (q, k, v))
    out = fa._KernelAttention.apply(qq, kk, vv, t(qm), t(km), opts)
    out.backward(t(g))
    want = attention_grads_plain(t(q), t(k), t(v), t(qm), t(km), t(g), keep_mask=mask,
                                 **{n: opts[n] for n in ("causal", "scale", "n_heads",
                                                         "dropout_rate")})
    for a, w in zip((qq.grad, kk.grad, vv.grad), want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    assert 0 < mask.float().mean() < 1


def test_keep_mask_all_true_equals_no_dropout():
    q, k, v, qm, km, _ = (torch.from_numpy(x) for x in make(3, 2, 8, 8))
    kw = dict(n_heads=H, causal=0, scale=(D / H) ** 0.5)
    full = masked_attention(q, k, v, qm, km, **kw)
    keep = torch.ones(2, H, 8, 8, dtype=torch.bool)
    assert torch.equal(masked_attention(q, k, v, qm, km, keep_mask=keep, **kw), full)


def test_keep_mask_matches_numpy_formula():
    """out = (keep ? w·m/(1−p) : 0) · V per head, w the reference softmax."""
    q, k, v, qm, km, _ = make(4, 2, 6, 7)
    p, scale, causal = 0.3, (D / H) ** 0.5, 0
    rng = np.random.default_rng(5)
    keep = rng.random((2, H, 6, 7)) < 1 - p
    dh = D // H
    qh, kh, vh = (x.reshape(x.shape[0], x.shape[1], H, dh).transpose(0, 2, 1, 3)
                  for x in (q, k, v))
    m = qm[:, :, None] * km[:, None, :] * np.tril(np.ones((6, 7)), causal)[None]
    z = (np.einsum("bhqe,bhke->bhqk", qh, kh) + np.where(m > 0, 0.0, -(2.0**32) + 1)[:, None])
    z = z / scale
    w = np.exp(z - z.max(-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True) * m[:, None]
    wd = np.where(keep, w / (1 - p), 0.0)
    want = np.einsum("bhqk,bhke->bhqe", wd, vh).transpose(0, 2, 1, 3).reshape(2, 6, D)
    t = torch.from_numpy
    got = masked_attention(t(q), t(k), t(v), t(qm), t(km), n_heads=H, causal=causal,
                           scale=scale, dropout_rate=p, keep_mask=t(keep)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_plain_weight_dropout_keep_rate_and_scale():
    """One-hot values expose the dropped weights: each is 0 or w/(1−p), and
    the kept share is 1−p."""
    b, lq, lk, p = 64, 8, 8, 0.4
    rng = np.random.default_rng(6)
    q, k = (torch.from_numpy(rng.standard_normal((b, n, D)).astype(np.float32))
            for n in (lq, lk))
    v = torch.zeros(b, lk, D)
    for h in range(H):
        v[:, :, h * (D // H): h * (D // H) + lk] = torch.eye(lk)
    ones_q, ones_k = torch.ones(b, lq), torch.ones(b, lk)
    kw = dict(n_heads=H, causal=None, scale=1.0)
    w = masked_attention(q, k, v, ones_q, ones_k, **kw)
    wd = masked_attention(q, k, v, ones_q, ones_k, dropout_rate=p, train=True,
                          generator=torch.Generator().manual_seed(0), **kw)
    kept = wd != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.02
    torch.testing.assert_close(wd[kept], w[kept] / (1 - p))


KAT = [  # Random123 kat_vectors, philox4x32 with 10 rounds: (counter, key, output)
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    got = philox4x32_10([np.array([c], np.uint64) for c in counter], key)
    assert tuple(int(x[0]) for x in got) == want


def test_philox_bits_match_the_cuda_header():
    """``philox_bits`` against ``csrc/philox.cuh::philox_bits`` compiled for
    the host (seed and counter both wider than 32 bits; element idx is word
    idx % 4 of the block at counter idx / 4, so a run of nine indices covers
    every word and three blocks)."""
    seeds = [0, 12345678901234567, 0xFEDCBA9876543210]
    idx = np.array([0, 4294967311, 8589934622], np.uint64)
    got = [int(x) for s in seeds for x in philox_bits(s, idx)]
    assert got == [1713891541, 546332099, 3529594346, 2600972695, 1487611530,
                   4137111991, 3125510988, 3648977377, 1979677775]
    run = [int(x) for x in philox_bits(77, np.arange(1000, 1009, dtype=np.uint64))]
    assert run == [341326468, 301031501, 2197624868, 2816637557, 288712322,
                   1605879960, 2502573607, 90936140, 2758960768]
    words = philox4x32_10([np.array([250], np.uint64), np.array([0], np.uint64),
                           np.array([0], np.uint64), np.array([0], np.uint64)], (77, 0))
    assert run[:4] == [int(w[0]) for w in words]  # 1000 / 4 = block 250


def test_keep_mask_layout_share_and_seeds():
    shape = (4, 2, 50, 50)
    m = attention_keep_mask(77, shape, 0.5)
    assert m.shape == shape and m.dtype == torch.bool
    assert torch.equal(m, attention_keep_mask(77, shape, 0.5))
    assert not torch.equal(m, attention_keep_mask(78, shape, 0.5))
    b, h, i, j = 3, 1, 17, 42  # element ((b·H + h)·Lq + i)·Lk + j
    idx = ((b * 2 + h) * 50 + i) * 50 + j
    assert bool(m[b, h, i, j]) == bool(philox_bits(77, np.array([idx]))[0] < 2**31)
    big = attention_keep_mask(5, (1, 1, 1000, 1000), 0.5)
    assert abs(big.float().mean().item() - 0.5) < 0.002
    assert keep_threshold(0.5) == 2**31 and keep_threshold(0.0) == 2**32 - 1


def test_bwd_wrappers_reject_devices_without_a_path():
    x = torch.zeros(1, 2, 4, device="meta")
    m = torch.ones(1, 2, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        attention_bwd(x, x, x, m, m, x, causal=0, scale=1.0, n_heads=2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        attention_keep_mask(0, (1, 1, 2, 2), 0.5, "meta")


@pytest.mark.parametrize("dh", [132, 256, 300])
@pytest.mark.parametrize("causal", [0, -1])
def test_wide_heads_match_jax(dh, causal):
    """Heads wider than 128 dims, which the kernels take in 128-column
    chunks: the port's output and gradients (plain versions, the ones the
    card tests hold K1/K2 to) against the JAX package's."""
    q, k, v, qm, km, g = make(7, 2, 9, 70, d=H * dh)
    kw = dict(causal=causal, scale=dh ** 0.5, n_heads=H)
    qq, kk, vv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fused_attention(qq, kk, vv, torch.from_numpy(qm), torch.from_numpy(km), **kw)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jax_fused_attention(q, k, v, qm, km, **kw)),
                               rtol=TOL, atol=TOL)
    for a, w in zip((qq.grad, kk.grad, vv.grad), jax_grads(q, k, v, qm, km, g, **kw)):
        np.testing.assert_allclose(a.numpy(), w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 64, 1_280_000, 20_480_000])
def test_keep_bits_words_cover_every_window(n):
    """One bit per weight, and room for the kernels' reads of 64 weights
    (three words) from any weight of the call, the last one included."""
    words = keep_bits_words(n)
    assert words >= -(-n // 32)
    if n:
        assert ((n - 1) >> 5) + 2 < words



def test_bwd_branch_rule():
    """K2's rule on shapes (csrc/attention_bwd.cu::takes_whole_row_bwd): the
    whole-row kernel past one 64-key tile up to men's 200 keys at heads of
    up to 32 dims; bwd_kernel for every other shape, 64-dim heads
    included."""
    assert WHOLE_ROW_KEYS == 200
    lks = (1, 50, 64, 65, 101, 200, 201, 257)
    for dh in (1, 16, 32):
        assert [bwd_branch(lk, dh) for lk in lks] == ["rows"] * 3 + ["whole_row"] * 3 + \
            ["rows"] * 2
    for dh in (33, 64, 128):
        assert {bwd_branch(lk, dh) for lk in lks} == {"rows"}


CHUNK_KEYS, ROW_TILE = 40, 64  # the whole-row kernel's key chunks and query tiles


@pytest.mark.parametrize("causal", [0, -1, 3, -70])
@pytest.mark.parametrize("lq,lk", [(200, 200), (130, 200), (70, 70), (20, 150)])
def test_bwd_keys_past_the_causal_chunk_limit_get_exactly_nothing(causal, lq, lk):
    """The whole-row backward skips, for each 64-row query tile, the 40-key
    chunks past its last row + ``causal``. For the tile's rows (the causal
    offset moved with them), the plain gradient with the keys cut at the
    first such chunk gives the uncut call's dK and dV bit for bit, and dQ
    within 1e-6 (the CPU's matrix product groups its sums by the key
    count); the uncut call's dK and dV of the cut keys are exactly zero;
    and other values in K and V at the cut keys change no gradient bit (dQ
    included: the same key count, and exact zeros where the keys differ)."""
    q, k, v, qm, km, g = (torch.from_numpy(a) for a in make(8, 2, lq, lk, d=64))
    kw = dict(n_heads=H, scale=32 ** 0.5)
    for row0 in range(0, lq, ROW_TILE):
        rows = slice(row0, min(lq, row0 + ROW_TILE))
        lim = min(lk, max(rows.stop + causal, 1))
        cut = min(lk, -(-lim // CHUNK_KEYS) * CHUNK_KEYS)
        tile = dict(kw, causal=causal + row0)
        full = attention_grads_plain(q[:, rows], k, v, qm[:, rows], km, g[:, rows], **tile)
        part = attention_grads_plain(q[:, rows], k[:, :cut], v[:, :cut], qm[:, rows],
                                     km[:, :cut], g[:, rows], **tile)
        torch.testing.assert_close(part[0], full[0], rtol=0, atol=1e-6)
        for got, want in zip(part[1:], full[1:]):
            assert torch.equal(got, want[:, :cut])
            assert torch.count_nonzero(want[:, cut:]) == 0
        other_k, other_v = k.clone(), v.clone()
        other_k[:, cut:] = 1e3 * torch.randn(other_k[:, cut:].shape, dtype=torch.float64).float()
        other_v[:, cut:] = -other_v[:, cut:] + 7.0
        other = attention_grads_plain(q[:, rows], other_k, other_v, qm[:, rows], km,
                                      g[:, rows], **tile)
        for got, want in zip(other, full):
            assert torch.equal(got, want)
