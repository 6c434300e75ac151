"""``fit`` over a 2x2 mesh (two data ranks × two model ranks, the item and
attrs tables row-sharded), on the CPU over gloo, against the one-device
port fit: the final metrics within 5e-3, as ``tests/test_parallel.py``
holds the JAX package's mesh fit to its one-device fit (the gradients'
sum over data reorders float additions; dropout is 0, so nothing else
differs).

The ranks run once for the module (4 processes of ``tests/torch_ranks.py``,
``suite_mesh_fit``), importing no jax. They fit three configurations:

* ``host``: the host pipeline (``make_sharded_train_step``, the ``ca``
  decoder, eval on host batches);
* ``device``: the device pipeline with K = 2 steps per call, EMA, and the
  per-epoch retrieval monitor (rank 0 over the gathered tables) selecting
  best/ by retrieval HR;
* ``resume``: one epoch more on a run directory a one-device fit wrote
  (a one-device ``latest/`` resumed under the mesh);
* ``sparse``: the row-sparse item Adam over the row-sharded table with
  the device pipeline, K = 2 (the JAX package's ``test_everything_composes``
  without its lane-packed tables, which the port does not have);
* ``sparse_resume``: ``resume`` with the row-sparse Adam (the row state
  of a one-device ``latest/`` loaded as blocks).

Rank 0 alone writes: each run directory holds one CSV, one line of
``metrics.jsonl`` per epoch and the one-device checkpoint layout, which
loads on one device and serves.
"""

import dataclasses
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from carca_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from carca_tpu_torch.data.synthetic import synthetic_catalog
from carca_tpu_torch.serve.recommender import load_recommender
from carca_tpu_torch.train.checkpoint import CheckpointKeeper
from carca_tpu_torch.train.loop import fit
from tests.torch_ranks import launch

torch.set_num_threads(1)

METRIC_TOL = 5e-3
CATALOG = dict(n_users=96, n_real_items=60, seed=5)
MESH = dict(mesh_shape=(2, 2), mesh_axes=("data", "model"), shard_embeddings=True)


def configs(root):
    cat = synthetic_catalog(**CATALOG)

    def mc(decoder):
        return ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx, d=16,
                           g=32, seq_len=8, target_len=12, n_blocks=2, n_heads=2, dropout=0.0,
                           decoder=decoder)

    def tc(out, **kw):
        return TrainConfig(batch_size=16, epochs=2, early_stop=10, seed=0,
                           out_dir=os.path.join(root, out), **kw)

    return cat, {
        "host": Config(mc("ca"), DataConfig(), tc("host")),
        "device": Config(mc("dot"), DataConfig(device_pipeline=True),
                         tc("device", inner_steps=2, ema_decay=0.9, eval_retrieval_every=1,
                            select_by="retrieval_hr")),
        "resume": Config(mc("ca"), DataConfig(device_pipeline=True),
                         tc("resume", inner_steps=2)),
        "sparse": Config(mc("dot"), DataConfig(device_pipeline=True),
                         tc("sparse", inner_steps=2, sparse_items_adam=True)),
        "sparse_resume": Config(mc("ca"), DataConfig(device_pipeline=True),
                                tc("sparse_resume", inner_steps=2, sparse_items_adam=True)),
    }
RESUMED = ("resume", "sparse_resume")


def on_mesh(cfg):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **MESH))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_fit"))
    cat, cfgs = configs(root)
    single = {}
    for name, cfg in cfgs.items():
        one = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, out_dir=cfg.train.out_dir + "_one"))
        _, single[name] = fit(one, cat, device="cpu", log=False)
    # the resume cases: one epoch on one device into the directory the mesh
    # then resumes from
    for name in RESUMED:
        first = cfgs[name]
        fit(dataclasses.replace(first, train=dataclasses.replace(first.train, epochs=1)), cat,
            device="cpu", log=False)
    meshed = {name: on_mesh(cfg) for name, cfg in cfgs.items()}
    ranks = launch(4, "mesh_fit", {"catalog": CATALOG, "configs": meshed})
    return {"cat": cat, "cfgs": meshed, "single": single, "ranks": ranks}


NAMES = ["host", "device", "resume", "sparse", "sparse_resume"]


@pytest.mark.parametrize("name", NAMES)
def test_mesh_fit_matches_one_device(runs, name):
    """Every rank returns the same metrics, within METRIC_TOL of the
    one-device fit's."""
    want = runs["single"][name]
    got = [r[name] for r in runs["ranks"]]
    assert all(g == got[0] for g in got)
    assert got[0]["epochs_run"] == want["epochs_run"] == 2
    keys = [k for k in want if k != "epochs_run"]
    if name == "device":
        assert "retrieval_val_hr" in keys
    for key in keys:
        assert np.isfinite(got[0][key]), key
        np.testing.assert_allclose(got[0][key], want[key], atol=METRIC_TOL, err_msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_rank0_alone_writes_the_run_directory(runs, name):
    out = runs["cfgs"][name].train.out_dir
    csvs = glob.glob(os.path.join(out, "*.csv"))
    lines = [json.loads(ln) for ln in open(os.path.join(out, "metrics.jsonl"))]
    epochs = [ln["epoch"] for ln in lines if "train_loss" in ln]
    if name in RESUMED:  # the one-device epoch 1 (its log off), then the mesh's epoch 2
        assert epochs == [2] and len(csvs) == 1
    else:
        assert epochs == [1, 2] and len(csvs) == 1
    for f in ("args.json", "ckpt/best/params.pt", "ckpt/best/metrics.json",
              "ckpt/latest/state.pt"):
        assert os.path.exists(os.path.join(out, f)), f
    assert not glob.glob(os.path.join(out, "**", "*.tmp*"), recursive=True)


def test_mesh_run_loads_and_serves_on_one_device(runs):
    """The 2x2 run's checkpoints hold the whole tables (the pad rows cut)
    and the one-device layout: load_recommender serves best/, and latest/
    resumes a one-device state."""
    cat = runs["cat"]
    cfg = runs["cfgs"]["host"]
    run = cfg.train.out_dir
    rec = load_recommender(run, cat.attrs, device="cpu", shortlist=16,
                           index_ids=np.unique(cat.items))
    ids, scores = rec.recommend([[1, 2, 3], [4]], k=5)
    assert ids.shape == (2, 5) and np.isfinite(scores).all()
    assert rec.model.embed.items.shape == (cat.n_items, cfg.model.d)
    from carca_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg.model, cfg.train, device="cpu")
    assert CheckpointKeeper(os.path.join(run, "ckpt")).restore_latest(state) == 2
    moments = state.optimizer.state[state.model.embed.items]
    assert moments["exp_avg"].shape == (cat.n_items, cfg.model.d)
    assert state.step > 0


def test_sparse_mesh_run_crosses_to_one_device(runs):
    """The 2x2 row-sparse run: finite metrics and val HR > 0; its latest/
    holds the whole row state (pad rows cut), equal to the ranks' blocks
    gathered, and resumes a one-device sparse state and a one-device fit
    (one epoch more); best/ loads and serves on one device."""
    cat = runs["cat"]
    cfg = runs["cfgs"]["sparse"]
    final = runs["ranks"][0]["sparse"]
    assert final["val_hr"] > 0 and all(np.isfinite(v) for v in final.values())
    for name in ("sparse", "sparse_resume"):
        munu, count = runs["ranks"][0][name, "row_state"]
        for r in runs["ranks"][1:]:
            np.testing.assert_array_equal(r[name, "row_state"][0], munu)
        assert munu.shape == (cat.n_items, 2 * cfg.model.d) and count > 0
    munu, count = runs["ranks"][0]["sparse", "row_state"]
    from carca_tpu_torch.train.state import create_train_state

    run = cfg.train.out_dir
    state = create_train_state(cfg.model, cfg.train, device="cpu", sparse_items=True)
    assert CheckpointKeeper(os.path.join(run, "ckpt")).restore_latest(state) == 2
    assert state.items_state["count"] == count == state.step
    np.testing.assert_array_equal(state.items_state["munu"].numpy(), munu)
    copy = run + "_resumed_on_one_device"  # the run directory itself stays as written
    shutil.copytree(run, copy)
    one = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, mesh_shape=(), shard_embeddings=False, epochs=3, out_dir=copy))
    state, m = fit(one, cat, device="cpu", log=False)
    assert m["epochs_run"] == 3 and np.isfinite(m["val_loss"]) and state.items_state is not None
    assert state.items_state["count"] > count
    rec = load_recommender(run, cat.attrs, device="cpu", shortlist=16,
                           index_ids=np.unique(cat.items))
    ids, scores = rec.recommend([[1, 2, 3], [4]], k=5)
    assert ids.shape == (2, 5) and np.isfinite(scores).all()
