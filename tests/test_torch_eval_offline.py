"""``python -m carca_tpu_torch.eval_retrieval_offline`` on a saved run.

* A port run (d = 16, the dot decoder, 2 epochs, on the CPU):
  the module's JSON line equals ``evaluate_retrieval`` in this process on
  the same checkpoint's parameters, for best/ and latest/, the seen and the
  full index, f32 and int8, and carries the JAX script's keys.
* A JAX run crossed over into a port run directory (as
  ``test_torch_serve.py::test_a_jax_run_served_by_the_port``): the JAX
  script's ``main`` on the JAX run and the port's on the crossed-over run
  agree within 1 / N_USERS (one user's rank, the tolerance of
  ``test_torch_retrieval_eval.py``) and on every provenance key.
"""

import dataclasses
import importlib.util
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from carca_tpu.config import DataConfig as JaxDataConfig
from carca_tpu.config import preset as jax_preset
from carca_tpu.data.synthetic import synthetic_catalog as jax_synthetic_catalog
from carca_tpu.serve.recommender import config_from_run_dir as jax_config_from_run_dir
from carca_tpu.train.checkpoint import CheckpointKeeper as JaxKeeper
from carca_tpu.train.loop import fit as jax_fit
from carca_tpu.train.state import create_train_state as jax_create_train_state
from carca_tpu.train.state import make_optimizer as jax_make_optimizer
from carca_tpu_torch import cli, eval_retrieval_offline
from carca_tpu_torch.bridge import load_into
from carca_tpu_torch.models.carca import CARCA
from carca_tpu_torch.serve.recommender import config_from_run_dir
from carca_tpu_torch.train.checkpoint import CheckpointKeeper
from carca_tpu_torch.train.loop import evaluate_retrieval

torch.set_num_threads(1)

N_USERS, N_REAL = 150, 120
KEYS = {"retrieval_test_hr", "retrieval_test_ndcg", "run_dir", "which", "epoch", "k", "loss",
        "n_train_negatives", "neg_distribution"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("offline")
    run = str(root / "ours")
    cli.main(["--synthetic", "true", "--d_dim", "16", "--g_dim", "32", "--n_blocks", "1",
              "--seq_len", "6", "--target_seq_len", "8", "--batch_size", "32", "--decoder",
              "dot", "--epochs", "2", "--synthetic_users", str(N_USERS), "--synthetic_items",
              str(N_REAL), "--resume", "false", "--out_dir", run], device="cpu")
    return run


def line_of(capsys, argv):
    got = eval_retrieval_offline.main(argv, device="cpu")
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == got
    return got


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("full_index", [False, True])
@pytest.mark.parametrize("which", ["best", "latest"])
def test_the_line_equals_evaluate_retrieval_in_process(run, capsys, which, full_index,
                                                       quantized):
    argv = [run, "--which", which] + ["--full_index"] * full_index + ["--quantized"] * quantized
    got = line_of(capsys, argv)
    assert set(got) == KEYS
    cfg = config_from_run_dir(run)
    model = CARCA(cfg.model, device="cpu")
    keeper = CheckpointKeeper(f"{run}/ckpt")
    epoch = (keeper.restore_best(model) if which == "best"
             else keeper.restore_latest_model(model))
    cat = cli.load_catalog(None, dc=cfg.data, device="cpu")
    want = evaluate_retrieval(cfg, cat, model, mode="test", k=10, log=False,
                              seen_only=not full_index, quantized=quantized)
    assert {k: got[k] for k in want} == want
    assert (got["which"], got["epoch"], got["k"], got["run_dir"]) == (which, epoch, 10, run)
    assert (got["loss"], got["n_train_negatives"], got["neg_distribution"]) == ("bce", 1,
                                                                               "uniform")
    assert 0.0 < got["retrieval_test_hr"] <= 1.0


def test_val_mode_k_and_a_missing_checkpoint(run, capsys, tmp_path):
    got = line_of(capsys, [run, "--mode", "val", "--k", "5"])
    assert set(got) >= {"retrieval_val_hr", "retrieval_val_ndcg"} and got["k"] == 5
    shutil.copy(f"{run}/args.json", tmp_path / "args.json")
    with pytest.raises(FileNotFoundError, match="no 'best' checkpoint"):
        eval_retrieval_offline.main([str(tmp_path)], device="cpu")


def jax_script():
    """``scripts/eval_retrieval_offline.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_eval_retrieval_offline", cli.__file__.replace(
            "carca_tpu_torch/cli.py", "scripts/eval_retrieval_offline.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_a_jax_run_agrees_with_the_jax_script(tmp_path, capsys):
    cat = jax_synthetic_catalog(n_users=N_USERS, n_real_items=N_REAL, seed=0)
    jc = jax_preset("smoke", cat.n_items, cat.n_attrs, cat.n_ctx)
    jrun = str(tmp_path / "jax")
    jax_fit(dataclasses.replace(
        jc, model=dataclasses.replace(jc.model, decoder="dot"),
        data=JaxDataConfig(synthetic=True, synthetic_users=N_USERS, synthetic_items=N_REAL),
        train=dataclasses.replace(jc.train, epochs=2, out_dir=jrun)), cat, log=False)
    jcfg = jax_config_from_run_dir(jrun)
    template = jax_create_train_state(jax.random.PRNGKey(0), jcfg.model, jcfg.train,
                                      jax_make_optimizer(jcfg.train))
    keeper = JaxKeeper(f"{jrun}/ckpt")
    try:
        epoch, state = keeper.restore_best(template)
        metrics = keeper.best_metrics()
    finally:
        keeper.close()
    ours_run = tmp_path / "ours"
    ours_run.mkdir()
    shutil.copy(f"{jrun}/args.json", ours_run / "args.json")
    cfg = config_from_run_dir(str(ours_run))
    model = load_into(CARCA(cfg.model, device="cpu"), jax.tree.map(np.asarray, state.params))
    ours_keeper = CheckpointKeeper(str(ours_run / "ckpt"))
    try:
        ours_keeper.save(epoch, model, metrics)
    finally:
        ours_keeper.close()  # the write runs on a thread of its own: land it first
    script = jax_script()
    for flags in ([], ["--full_index"], ["--quantized"]):
        capsys.readouterr()
        script.main([jrun, *flags])
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        got = line_of(capsys, [str(ours_run), *flags])
        assert set(got) == set(want) == KEYS
        for key in KEYS - {"retrieval_test_hr", "retrieval_test_ndcg", "run_dir"}:
            assert got[key] == want[key], key
        for key in ("retrieval_test_hr", "retrieval_test_ndcg"):
            assert abs(got[key] - want[key]) <= 1.0 / N_USERS, (flags, key, got[key], want[key])
