"""The port's native C++ batch assembler (``carca_tpu_torch/native``).

* Against the JAX package's native assembler: for the same generator state
  every key of every batch is bit-equal, negatives included (train, val and
  test; pad rows; two seeds; 1 and 8 threads).
* Against the port's numpy path: the deterministic keys (profile windows,
  positives, contexts, labels, ``n_valid``) are bit-equal; the negatives
  come from another stream and are held to the sampler contract
  (``src/data.py:77-137``), as ``tests/test_native.py`` holds the JAX pair.
* A failed build or load raises; ``use_native=False`` builds nothing.
"""

import dataclasses

import numpy as np
import pytest
import torch

from carca_tpu.data.dataset import BatchBuilder as JaxBatchBuilder
from carca_tpu.native import get_assembler as jax_get_assembler
from carca_tpu_torch import native
from carca_tpu_torch.config import preset
from carca_tpu_torch.data.dataset import BatchBuilder
from carca_tpu_torch.data.synthetic import synthetic_catalog
from carca_tpu_torch.train.loop import fit

torch.set_num_threads(1)

L, T = 12, 25
MODES = ("train", "val", "test")


@pytest.fixture(scope="module")
def cat():
    return synthetic_catalog(n_users=200, n_real_items=300, seed=7)


def rows_of(builder, mode):
    """62 users of the split and two pad rows."""
    return np.concatenate([builder.users(mode)[:62], [-1, -1]])


def batch_of(builder, mode, rows, seed):
    rng = np.random.default_rng(seed)
    if mode == "train":
        return builder.train_batch(rows, rng)
    return builder.eval_batch(rows, rng, mode)


def profile_set(cat, u):
    return set(cat.items[cat.offsets[u]:cat.offsets[u + 1]].tolist())


@pytest.mark.parametrize("n_threads", [1, 8])
@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("mode", MODES)
def test_batches_bit_equal_the_jax_native_assembler(cat, mode, seed, n_threads):
    ours = BatchBuilder(cat, L, T, native=native.get_assembler(n_threads))
    theirs = JaxBatchBuilder(cat, L, T, native=jax_get_assembler(n_threads))
    rows = rows_of(ours, mode)
    got, want = batch_of(ours, mode, rows, seed), batch_of(theirs, mode, rows, seed)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert int(got["n_valid"]) == 62


@pytest.mark.parametrize("mode", MODES)
def test_thread_counts_give_bit_equal_batches(cat, mode):
    one = BatchBuilder(cat, L, T, native=native.get_assembler(1))
    eight = BatchBuilder(cat, L, T, native=native.get_assembler(8))
    rows = rows_of(one, mode)
    a, b = batch_of(one, mode, rows, 3), batch_of(eight, mode, rows, 3)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_train_batch_equals_numpy_but_for_the_negatives(cat):
    b_np, b_nat = BatchBuilder(cat, L, T), BatchBuilder(cat, L, T, native=native.get_assembler())
    rows = rows_of(b_np, "train")
    ref, got = batch_of(b_np, "train", rows, 0), batch_of(b_nat, "train", rows, 0)
    for key in ("p_x", "p_c", "y_true", "o_c"):  # the negatives inherit the positives' ctx
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    np.testing.assert_array_equal(got["o_x"][:, :L], ref["o_x"][:, :L])
    assert int(got["n_valid"]) == int(ref["n_valid"])
    assert not np.array_equal(got["o_x"][:, L:], ref["o_x"][:, L:])  # another stream
    for b, u in enumerate(rows):
        negs, valid = got["o_x"][b, L:], got["p_x"][b] > 0
        assert (negs[~valid] == 0).all()
        live = negs[valid]
        if u < 0:
            assert live.size == 0
            continue
        assert live.min() >= 1 and live.max() <= cat.n_items - 1
        assert len(set(live.tolist())) == live.size
        assert not set(live.tolist()) & profile_set(cat, int(u))


@pytest.mark.parametrize("mode", ["val", "test"])
def test_eval_batch_equals_numpy_but_for_the_negatives(cat, mode):
    b_np, b_nat = BatchBuilder(cat, L, T), BatchBuilder(cat, L, T, native=native.get_assembler())
    rows = rows_of(b_np, mode)
    ref, got = batch_of(b_np, mode, rows, 1), batch_of(b_nat, mode, rows, 1)
    for key in ("p_x", "p_c", "y_true", "o_c"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    np.testing.assert_array_equal(got["o_x"][:, 0], ref["o_x"][:, 0])  # the held-out item
    assert int(got["n_valid"]) == int(ref["n_valid"])
    for b, u in enumerate(rows):
        negs = got["o_x"][b, 1:]
        if u < 0:
            assert (got["o_x"][b] == 0).all()
            continue
        assert negs.min() >= 1 and negs.max() <= cat.n_items - 1
        assert len(set(negs.tolist())) == T
        assert not set(negs.tolist()) & profile_set(cat, int(u))


def test_user_rows_out_of_range_raise(cat):
    builder = BatchBuilder(cat, L, T, native=native.get_assembler())
    with pytest.raises(ValueError, match="below 200"):
        builder.train_batch(np.array([0, 200]), np.random.default_rng(0))


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    compiler = tmp_path / "cxx"
    compiler.write_text("#!/bin/sh\necho 'cc1plus: error: no such flag' >&2\nexit 1\n")
    compiler.chmod(0o755)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(compiler))
    with pytest.raises(RuntimeError, match="no such flag"):
        native.get_assembler()
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no_compiler_here"))
    with pytest.raises(RuntimeError, match="failed"):
        native.get_assembler()
    assert not list((tmp_path / "build").rglob("*.so*"))  # nothing half-written is left


def test_a_library_that_does_not_load_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    lib = tmp_path / native.source_hash() / native.LIB_NAME
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"not an ELF file")
    with pytest.raises(RuntimeError, match="loading the native assembler"):
        native.get_assembler()


@pytest.mark.parametrize("use_native", [True, False])
def test_fit_assembles_with_the_library_unless_asked_for_numpy(tmp_path, monkeypatch, capsys,
                                                               cat, use_native):
    """use_native=False never builds the library (a build would raise
    here); the run log names the assembler that ran."""
    if not use_native:
        def refuse():
            raise AssertionError("use_native=False built the native library")

        monkeypatch.setattr(native, "build", refuse)
    cfg = preset("smoke", cat.n_items, cat.n_attrs, cat.n_ctx)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, use_native=use_native),
                              train=dataclasses.replace(cfg.train, epochs=1,
                                                        out_dir=str(tmp_path)))
    final = fit(cfg, cat, device="cpu")[1]
    out = capsys.readouterr().out
    assert out.count("assembler: ") == 1
    assert f"assembler: {'native' if use_native else 'numpy'}" in out
    assert 0.0 <= final["test_hr"] <= 1.0
