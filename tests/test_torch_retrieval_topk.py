"""The port's ``catalog_topk`` (plain version, on CPU tensors) against the
JAX package's streaming Pallas kernel (``method="stream"``, interpret
mode): ids must be equal, values within 1e-5 (f32 summation order).

Cases: exact ties (duplicated rows), ``id_offset``, ``n_items`` limits,
k beyond the valid rows (−inf slots with id 0), and a zero query (every
score 0.0: the lowest ids in order).
"""

import numpy as np
import pytest
import torch

from carca_tpu.ops.retrieval_topk import catalog_topk as jax_catalog_topk
from carca_tpu.ops.retrieval_topk import quantize_index as jax_quantize_index
from carca_tpu_torch.ops.retrieval_topk import (catalog_topk, dequantize_index,
                                                ordered_scores, quantize_index)

torch.set_num_threads(1)

TOL = 1e-5


def check(q, e, k, **kw):
    want_v, want_i = jax_catalog_topk(q, e, k, method="stream", **kw)
    got_v, got_i = catalog_topk(torch.from_numpy(q), torch.from_numpy(e), k, **kw)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=TOL, atol=TOL)
    return got_v.numpy(), got_i.numpy()


def data(seed, b=5, r=300, d=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, d)).astype(np.float32),
            rng.standard_normal((r, d)).astype(np.float32))


@pytest.mark.parametrize("k", [1, 7, 40])
def test_matches_jax_stream_kernel(k):
    q, e = data(0)
    check(q, e, k)


def test_id_offset_and_n_items_limit():
    q, e = data(1)
    check(q, e, 12, n_items=1000 + 250, id_offset=1000)  # rows ≥ 250 masked
    check(q, e, 12, n_items=200)  # pad row 0 and rows ≥ 200 masked


def test_exact_ties_go_to_lowest_id():
    q, e = data(2, r=64)
    e[40] = e[7]
    e[50] = e[7]
    e[33] = e[12]
    v, i = check(q, e, 30)
    for row_v, row_i in zip(v, i):
        for a in range(len(row_v) - 1):
            if row_v[a] == row_v[a + 1]:
                assert row_i[a] < row_i[a + 1]


def test_k_beyond_valid_rows_gives_neg_inf_slots():
    q, e = data(3, r=20)
    v, i = check(q, e, 30, n_items=15)  # 14 valid rows (pad row 0 masked)
    assert np.isneginf(v[:, 14:]).all() and (i[:, 14:] == 0).all()
    assert np.isfinite(v[:, :14]).all()


def test_zero_query_returns_lowest_ids_in_order():
    q, e = data(4)
    q[1] = 0.0
    v, i = check(q, e, 25)
    assert (v[1] == 0).all()
    np.testing.assert_array_equal(i[1], np.arange(1, 26))


def test_ordered_scores_agree_with_matmul():
    q, e = data(5, r=50, d=16)
    s = ordered_scores(torch.from_numpy(q), torch.from_numpy(e)).numpy()
    np.testing.assert_allclose(s, q @ e.T, rtol=TOL, atol=TOL)


def test_ordered_scores_of_an_int8_index_scale_the_bf16_sum():
    """The int8 plain score: the bf16-rounded query against the int8 rows,
    summed, then times the row scale — in float64 the same up to the f32
    sum's rounding."""
    q, e = data(9, r=70, d=16)
    qi = quantize_index(torch.from_numpy(e))
    got = ordered_scores(torch.from_numpy(q), qi).numpy()
    qb = torch.from_numpy(q).to(torch.bfloat16).double().numpy()
    want = (qb @ qi.qvals.double().numpy().T) * qi.scales.double().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_quantize_index_matches_jax():
    _, e = data(6, r=40)
    e[3] = 0.0  # the pad row gets scale 0
    want = jax_quantize_index(e)
    got = quantize_index(torch.from_numpy(e))
    np.testing.assert_array_equal(got.qvals.numpy(), np.asarray(want.qvals))
    np.testing.assert_allclose(got.scales.numpy(), np.asarray(want.scales), rtol=1e-7)
    deq = dequantize_index(got).numpy()
    assert (deq[3] == 0).all()
    assert np.abs(deq - e).max() <= np.abs(e).max(axis=1).max() / 127


def test_unported_variants_raise_on_cpu_too():
    """The tournament and bf16/int8 indexes now run (their kernels are
    ported) and answer as the f32 stream does up to the index's own
    rounding; what no kernel takes still raises on the CPU as on the card:
    int8 rows without their scales, scales of the wrong shape, a float64
    index."""
    q, e = (torch.from_numpy(a) for a in data(7, r=64))
    sv, si = catalog_topk(q, e, 5, method="stream")
    tv, ti = catalog_topk(q, e, 5, method="tournament")
    assert torch.equal(si, ti) and torch.equal(sv, tv)
    for index in (e.to(torch.bfloat16), quantize_index(e)):
        v, i = catalog_topk(q, index, 5)
        assert v.shape == (5, 5) and torch.isfinite(v).all() and (i > 0).all()
    with pytest.raises(TypeError, match="QuantizedIndex"):
        catalog_topk(q, e.to(torch.int8), 5)
    qi = quantize_index(e)
    with pytest.raises(ValueError, match="scales"):
        catalog_topk(q, qi._replace(scales=qi.scales[0]), 5)
    with pytest.raises(TypeError, match="float32, bfloat16"):
        catalog_topk(q, e.double(), 5, method="tournament")


def test_rejects_unknown_method():
    q, e = data(8)
    with pytest.raises(ValueError, match="method"):
        catalog_topk(torch.from_numpy(q), torch.from_numpy(e), 3, method="heap")


def test_wrapper_rejects_devices_without_a_path():
    """CPU tensors take the plain version, CUDA tensors the kernel; any
    other device raises instead of guessing."""
    q = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        catalog_topk(q, torch.zeros(8, 4, device="meta"), 3)


def test_kernel_build_needs_nvcc():
    """Without a CUDA toolkit the build fails with a clear error; with one
    it yields a library path."""
    import shutil
    from pathlib import Path

    from carca_tpu_torch.ops import _build

    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        assert _build.build().path.exists()
    else:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()
    assert len(_build.source_hash()) == 16


@pytest.mark.parametrize("d", [130, 256, 300])
@pytest.mark.parametrize("method", ["stream", "tournament"])
def test_rows_wider_than_128_match_jax(d, method):
    """Any row width, as the JAX package's catalog_topk takes (the card's
    kernels walk 128-column chunks); both methods agree exactly here."""
    q, e = data(d, b=3, r=400, d=d)
    v, i = catalog_topk(torch.from_numpy(q), torch.from_numpy(e), 9, method=method)
    want_v, want_i = jax_catalog_topk(q, e, 9, method="stream")
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(v.numpy(), np.asarray(want_v), rtol=TOL, atol=TOL)
