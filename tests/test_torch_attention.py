"""The port's ``fused_attention`` (plain version, on CPU tensors) against
the JAX package's ``fused_attention`` — the Pallas kernel in interpret
mode — and its jnp ``masked_attention``.

Inputs are numpy arrays from a seed. Tolerance: 1e-5 (f32 summation
order); fully masked query rows must be exactly 0 in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carca_tpu.models.attention import masked_attention as jax_masked_attention
from carca_tpu.ops.flash_attention import fused_attention as jax_fused_attention
from carca_tpu_torch.models import layers
from carca_tpu_torch.models.attention import MHA, masked_attention, pair_mask
from carca_tpu_torch.ops.flash_attention import fused_attention

torch.set_num_threads(1)

TOL = 1e-5
H = 2


def make(seed, b, lq, lk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, d)).astype(np.float32)
    qm = (rng.random((b, lq)) > 0.2).astype(np.float32)
    km = (rng.random((b, lk)) > 0.2).astype(np.float32)
    qm[0, 0] = 0.0  # a padded query row
    km[1, :] = 0.0  # a batch row with every key masked
    km[0, 0] = 1.0
    return q, k, v, qm, km


@pytest.mark.parametrize("causal", [0, -1, None])
@pytest.mark.parametrize("lq,lk", [(8, 8), (12, 5)])
def test_fused_attention_matches_jax(causal, lq, lk):
    q, k, v, qm, km = make(0, 3, lq, lk, 16)
    scale = (16 / H) ** 0.5
    kw = dict(causal=causal, scale=scale, n_heads=H)
    t = torch.from_numpy
    got = fused_attention(t(q), t(k), t(v), t(qm), t(km), **kw).numpy()
    want_kernel = np.asarray(jax_fused_attention(q, k, v, qm, km, **kw))
    want_jnp = np.asarray(jax_masked_attention(q, k, v, qm, km, train=False, **kw))
    np.testing.assert_allclose(got, want_kernel, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_jnp, rtol=TOL, atol=TOL)
    # masked query rows and the all-keys-masked batch row are exact zeros
    assert (got[1] == 0).all() and (got[0, 0] == 0).all()
    assert np.isfinite(got).all()


def test_bf16_compute_matches_jax():
    q, k, v, qm, km = make(1, 2, 8, 8, 16)
    kw = dict(causal=0, scale=(16 / H) ** 0.5, n_heads=H)
    t = torch.from_numpy
    got = fused_attention(t(q), t(k), t(v), t(qm), t(km),
                          compute_dtype="bfloat16", **kw).numpy()
    want = np.asarray(jax_masked_attention(q, k, v, qm, km, train=False,
                                           compute_dtype=jnp.bfloat16, **kw))
    # bf16 product inputs are exact in f32; only the sum order differs
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    f32 = fused_attention(t(q), t(k), t(v), t(qm), t(km), **kw).numpy()
    assert np.abs(got - f32).max() > 0  # the rounding really happened


def test_pair_mask_causal_offsets():
    qm = torch.ones(1, 4)
    km = torch.ones(1, 5)
    m = pair_mask(qm, km, -1)[0]
    assert torch.equal(m, torch.tril(torch.ones(4, 5), diagonal=-1))
    assert torch.equal(pair_mask(qm, km, None)[0], torch.ones(4, 5))


def test_mha_kernel_switch_on_cpu_uses_plain_version():
    """On CPU tensors use_kernel=True reaches fused_attention, whose CPU
    path is the plain version: both switches give identical outputs, and
    the kernel's launch count does not move."""
    g = torch.Generator().manual_seed(0)
    mha = MHA(16, g)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 6, 16)).astype(np.float32))
    m = torch.ones(2, 6)
    kw = dict(n_heads=H, causal=0, dropout_rate=0.0, train=False)
    before = fused_attention.launches
    with torch.no_grad():
        a = mha(x, x, x, m, m, use_kernel=True, **kw)
        b = mha(x, x, x, m, m, use_kernel=False, **kw)
    assert torch.equal(a, b)
    assert fused_attention.launches == before


def test_mha_auto_trains_on_cpu_through_the_wrapper():
    """In training, use_kernel="auto" on CPU tensors still reaches
    fused_attention, whose CPU path draws the same weight dropout from the
    generator as the plain version; gradients flow."""
    mha = MHA(16, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 6, 16)).astype(np.float32))
    m = torch.ones(2, 6)
    kw = dict(n_heads=H, causal=0, dropout_rate=0.5, train=True)
    before = fused_attention.launches
    a = mha(x, x, x, m, m, use_kernel="auto",
            generator=torch.Generator().manual_seed(3), **kw)
    b = mha(x, x, x, m, m, use_kernel=False,
            generator=torch.Generator().manual_seed(3), **kw)
    assert torch.equal(a, b)
    a.sum().backward()
    assert mha.wq.w.grad is not None
    assert fused_attention.launches == before


def test_dropout_keep_rate_and_scale():
    x = torch.ones(100_000)
    y = layers.dropout(x, 0.3, True, torch.Generator().manual_seed(1))
    kept = y[y != 0]
    assert abs(kept.numel() / x.numel() - 0.7) < 0.01
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.7))
    assert torch.equal(layers.dropout(x, 0.3, False, None), x)


def test_plain_attention_weight_dropout_needs_generator():
    q, k, v, qm, km = (torch.from_numpy(a) for a in make(3, 2, 16, 16, 16))
    g = torch.Generator().manual_seed(0)
    kw = dict(n_heads=H, causal=None, scale=1.0)
    full = masked_attention(q, k, v, torch.ones_like(qm), torch.ones_like(km), **kw)
    dropped = masked_attention(q, k, v, torch.ones_like(qm), torch.ones_like(km),
                               dropout_rate=0.5, train=True, generator=g, **kw)
    assert full.shape == dropped.shape
    assert not torch.equal(full, dropped)
    with pytest.raises(ValueError, match="generator"):
        masked_attention(q, k, v, qm, km, dropout_rate=0.5, train=True, **kw)


def test_wrapper_rejects_devices_without_a_path():
    x = torch.zeros(1, 2, 4, device="meta")
    m = torch.ones(1, 2, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_attention(x, x, x, m, m, causal=0, scale=1.0, n_heads=2)
