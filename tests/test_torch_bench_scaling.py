"""``python -m carca_tpu_torch.bench_scaling`` against the JAX package's
``scripts/bench_scaling.py``, on the CPU.

* The summary: the port's ``summarize`` prints the lines the JAX script's
  ``main`` prints for the same per-size child lines (its ``subprocess.run``
  replaced by canned children, ``--platform native``), with and without
  ``--shard_embeddings``, from size 1 and from size 2.
* The model and the batch: the JAX script's ``run_one`` is run up to its
  step builder, which records what it was given and stops the run; its
  ``ModelConfig`` equals the harness's field by field (less
  ``use_pallas``/``use_kernel``), and the batch its ``BatchBuilder`` built
  equals the harness's key by key.
* End to end: ``main(--sizes 1,2 --device cpu)`` over gloo rank processes,
  with and without ``--shard_embeddings``; without ``--device cpu`` and
  no card it raises.
"""

import dataclasses
import importlib.util
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from carca_tpu_torch import bench_scaling

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def jax_script():
    spec = importlib.util.spec_from_file_location("jax_bench_scaling",
                                                  ROOT / "scripts" / "bench_scaling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child_line(n: int, shard: bool, rate: float, per_chip_batch: int = 256) -> dict:
    data_axis = n // 2 if (shard and n % 2 == 0) else n
    return {"devices": n, "data_axis": data_axis, "global_batch": per_chip_batch * data_axis,
            "examples_per_sec": rate}


RATES = {1: 1234.5, 2: 2101.7, 4: 3333.3, 8: 5555.9}


@pytest.mark.parametrize("sizes,shard", [("1,2,4", False), ("1,2,4", True), ("2,4,8", False),
                                         ("2,4", True)])
def test_summary_equals_the_jax_scripts(monkeypatch, capsys, sizes, shard):
    mod = jax_script()

    def canned(cmd, **kw):
        n = int(cmd[cmd.index("--_child") + 1])
        assert ("--shard_embeddings" in cmd) == shard
        return types.SimpleNamespace(returncode=0, stderr="",
                                     stdout=json.dumps(child_line(n, shard, RATES[n])) + "\n")

    monkeypatch.setattr(mod, "subprocess", types.SimpleNamespace(run=canned))
    argv = ["bench_scaling.py", "--sizes", sizes, "--platform", "native"]
    monkeypatch.setattr("sys.argv", argv + (["--shard_embeddings"] if shard else []))
    mod.main()
    want = capsys.readouterr().out.splitlines()
    lines = [child_line(int(n), shard, RATES[int(n)]) for n in sizes.split(",")]
    got = [json.dumps(r) for r in bench_scaling.summarize(lines)]
    assert got == want
    first = sizes.split(",")[0]
    assert all(f"efficiency_vs_{first}dev" in json.loads(ln) for ln in got)


class Stop(Exception):
    """Raised by the recording step builder: run_one goes no further."""


@pytest.fixture(scope="module", params=[(1, False), (2, False), (2, True)],
                ids=["size1", "size2", "size2_shard"])
def jax_run_one(request):
    """What the JAX script's run_one hands its step builder and its batch
    builder, at a per-chip batch of 8, its mesh over the first n of the
    test session's virtual devices (its child process would see n)."""
    import carca_tpu.parallel
    import jax
    from carca_tpu.data.dataset import BatchBuilder

    n, shard = request.param
    mod = jax_script()
    seen = {}
    real_batch = BatchBuilder.train_batch

    def recording_batch(self, rows, rng):
        seen["rows"] = np.array(rows)
        seen["batch"] = real_batch(self, rows, rng)
        return seen["batch"]

    def recording_step(mc, tx, mesh, shard_embeddings=False):
        seen.update(mc=mc, mesh_shape=dict(mesh.shape), shard_embeddings=shard_embeddings)
        raise Stop

    real_mesh = carca_tpu.parallel.make_mesh

    def mesh_of_the_child(shape, axes):  # the child sees exactly n devices
        return real_mesh(shape, axes, devices=jax.devices()[:int(np.prod(shape))])

    mp = pytest.MonkeyPatch()
    mp.setattr(carca_tpu.parallel, "make_mesh", mesh_of_the_child)
    mp.setattr(BatchBuilder, "train_batch", recording_batch)
    mp.setattr(carca_tpu.parallel, "make_sharded_train_step", recording_step)
    try:
        with pytest.raises(Stop):
            mod.run_one(n, types.SimpleNamespace(shard_embeddings=shard, per_chip_batch=8,
                                                 steps=1))
    finally:
        mp.undo()
    return n, shard, seen


def test_model_config_and_mesh_equal_run_ones(jax_run_one):
    n, shard, seen = jax_run_one
    mc = bench_scaling.model_config(bench_scaling.catalog())
    jmc = dataclasses.asdict(seen["mc"])
    ours = dataclasses.asdict(mc)
    common = (set(jmc) & set(ours)) - {"use_pallas", "use_kernel"}
    assert {"n_items", "n_attrs", "n_ctx", "d", "g", "seq_len", "target_len", "n_blocks",
            "n_heads", "dropout", "embedding", "decoder"} <= common
    assert {k: ours[k] for k in common} == {k: jmc[k] for k in common}
    assert mc.use_kernel == "auto" and seen["mc"].use_pallas is False
    model_par = bench_scaling.model_parallel(n, shard)
    assert seen["shard_embeddings"] == (model_par > 1)
    assert seen["mesh_shape"].get("model", 1) == model_par
    assert seen["mesh_shape"]["data"] == n // model_par


def test_batch_equals_run_ones(jax_run_one):
    n, shard, seen = jax_run_one
    cat = bench_scaling.catalog()
    data_axis = n // bench_scaling.model_parallel(n, shard)
    batch = bench_scaling.host_batch(cat, bench_scaling.model_config(cat), 8 * data_axis)
    want = seen["batch"]
    assert "n_valid" not in want and sorted(batch) == sorted(want)
    assert len(seen["rows"]) == 8 * data_axis
    for key, v in want.items():
        np.testing.assert_array_equal(batch[key], np.asarray(v), err_msg=key)
        assert batch[key].shape == np.asarray(v).shape, key


@pytest.mark.parametrize("shard", [False, True], ids=["data", "shard_embeddings"])
def test_main_runs_sizes_1_and_2_over_gloo_ranks(monkeypatch, capsys, shard):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["--sizes", "1,2", "--per_chip_batch", "8", "--steps", "2", "--device", "cpu"]
    out = bench_scaling.main(argv + (["--shard_embeddings"] if shard else []))
    captured = capsys.readouterr()
    assert [json.loads(ln) for ln in captured.out.splitlines()] == out
    keys = ["devices", "data_axis", "global_batch", "examples_per_sec", "per_chip",
            "efficiency_vs_1dev"]
    assert [list(r) for r in out] == [keys, keys]
    assert [r["devices"] for r in out] == [1, 2]
    assert [r["data_axis"] for r in out] == [1, 1 if shard else 2]
    assert [r["global_batch"] for r in out] == [8, 8 if shard else 16]
    for r in out:
        assert np.isfinite(r["examples_per_sec"]) and r["examples_per_sec"] > 0
        assert r["per_chip"] == round(r["examples_per_sec"] / r["data_axis"], 1)
    assert out[0]["efficiency_vs_1dev"] == 1.0
    # every rank said where it ran, and the size-2 group took gloo on the CPU
    launches = [json.loads(ln[len("launches: "):]) for ln in captured.err.splitlines()
                if ln.startswith("launches: ")]
    assert [(r["size"], r["rank"]) for r in launches] == [(1, 0), (2, 0), (2, 1)]
    assert all(r["device"] == "cpu" and r["attention_fwd"] == 0 for r in launches)
    assert captured.err.count("backend gloo (ranks on the CPU)") == 2


def test_without_a_card_it_raises_and_never_runs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--sizes", "1"], ["--sizes", "1,2", "--shard_embeddings"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            bench_scaling.main(argv)
