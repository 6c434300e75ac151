"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (they build ``csrc/`` first) and
skip elsewhere. Run them on the card with
``python -m pytest --noconftest tests/test_torch_kernels.py -q`` (the
shared ``tests/conftest.py`` imports jax, which that machine may lack).
Tolerances: K1 1e-5 abs/rel at f32 (summation order), 2e-2 at bf16; K3
ids equal and values within 1e-5 (both sum in the same order).
"""

import numpy as np
import pytest
import torch

from carca_tpu_torch.models.attention import MHA, masked_attention
from carca_tpu_torch.ops.flash_attention import fused_attention
from carca_tpu_torch.ops.retrieval_topk import catalog_topk, catalog_topk_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def attn_inputs(dev, b, lq, lk, d, seed=0):
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


def test_attention_kernel_raises_on_what_it_lacks(dev):
    q, k, v, qm, km = attn_inputs(dev, 2, 8, 8, 16)
    with pytest.raises(NotImplementedError):
        fused_attention(q, k, v, qm, km, causal=0, scale=1.0, n_heads=2, dropout_rate=0.1)
    with pytest.raises(NotImplementedError):
        fused_attention(q.requires_grad_(), k, v, qm, km, causal=0, scale=1.0, n_heads=2)
    big = torch.zeros(1, 4000, 64, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        fused_attention(big[:, :8], big, big, torch.ones(1, 8, device=dev),
                        torch.ones(1, 4000, device=dev), causal=None, scale=1.0, n_heads=1)


def test_mha_auto_on_cuda_raises_instead_of_falling_back(dev):
    """use_kernel="auto" on CUDA tensors never runs the plain version: weight
    dropout and autograd raise; use_kernel=False is the way to the plain
    version on the card."""
    mha = MHA(16, torch.Generator().manual_seed(0)).to(dev)
    x = torch.randn(2, 6, 16, generator=torch.Generator().manual_seed(1)).to(dev)
    m = torch.ones(2, 6, device=dev)
    kw = dict(n_heads=2, causal=0, dropout_rate=0.5)
    g = torch.Generator(device=dev).manual_seed(2)
    with pytest.raises(NotImplementedError, match="dropout"):
        mha(x, x, x, m, m, train=True, generator=g, use_kernel="auto", **kw)
    with pytest.raises(NotImplementedError, match="backward"):
        mha(x, x, x, m, m, train=False, use_kernel="auto", **kw)  # params need grads
    before = fused_attention.launches
    assert mha(x, x, x, m, m, train=True, generator=g, use_kernel=False, **kw).shape == x.shape
    with torch.no_grad():
        mha(x, x, x, m, m, train=False, use_kernel="auto", **kw)
    assert fused_attention.launches == before + 1


@pytest.mark.parametrize("b,r,k,offset,n_items", [
    (33, 19_156, 562, 0, None), (33, 5_000, 10, 0, None), (33, 3_000, 40, 7, 2_500),
    (33, 300, 600, 0, 250), (9, 2_048, 1_024, 0, None), (5, 10_000, 1_500, 0, None),
    (1, 2_049, 1, 0, None), (1, 5, 3, 0, None)])
def test_topk_kernel_matches_plain(dev, b, r, k, offset, n_items):
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
    assert torch.equal(i, pi)
    torch.testing.assert_close(v, pv, rtol=1e-5, atol=1e-5)


def test_topk_kernel_raises_on_what_it_lacks(dev):
    q = torch.randn(4, 8, device=dev)
    e = torch.randn(100, 8, device=dev)
    with pytest.raises(NotImplementedError):
        catalog_topk(q, e, 5, method="tournament")
    with pytest.raises(NotImplementedError):
        catalog_topk(q, e.to(torch.bfloat16), 5)
    assert np.isfinite(catalog_topk(q, e, 5)[0].cpu().numpy()).all()
