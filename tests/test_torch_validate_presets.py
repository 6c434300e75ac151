"""``python -m carca_tpu_torch.validate_presets`` against the JAX package's
``scripts/validate_presets.py``.

* ``family_config`` is the Config the JAX script's ``run_ours`` builds, for
  each of the three families (through ``bridge.config_from_jax``), and
  ``family_catalog`` its catalog, array for array.
* A tiny games-shaped family (d = 16, 300 users) at dropout 0 for 2
  epochs, fitted by the port and by the JAX ``fit`` from the same initial
  weights with the native assembler on both sides (so bit-equal batches,
  negatives included): each epoch's train and val loss within
  ``test_torch_fit``'s 1e-4 relative, val and test HR/NDCG within
  2 / n_users.
* ``main`` writes ``VALIDATION_<family>.json`` with the JAX script's keys,
  the reference read from ``VALIDATION_games_ref.json``.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from carca_tpu.config import Config as JaxConfig
from carca_tpu.config import DataConfig as JaxDataConfig
from carca_tpu.config import ModelConfig as JaxModelConfig
from carca_tpu.config import TrainConfig as JaxTrainConfig
from carca_tpu.data.synthetic import canonicalize_repeat_ctx as jax_canonicalize_repeat_ctx
from carca_tpu.data.synthetic import synthetic_catalog as jax_synthetic_catalog
from carca_tpu.train.loop import fit as jax_fit
from carca_tpu.train.state import create_train_state as jax_create_train_state
from carca_tpu.train.state import make_optimizer as jax_make_optimizer
from carca_tpu_torch import validate_presets as vp
from carca_tpu_torch.bridge import config_from_jax, load_into
from carca_tpu_torch.models.carca import CARCA
from carca_tpu_torch.train.loop import fit
from carca_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)

LOSS_RTOL = 1e-4  # test_torch_fit.py's: Adam's float32 rounding over the steps
TINY = dict(vp.FAMILIES["games"], users=300, items=400, d_dim=16, g_dim=32, seq_len=10)


def jax_catalog(fam):
    """``scripts/validate_presets.py::run_ours``'s catalog."""
    cat = jax_synthetic_catalog(
        n_users=fam["users"], n_real_items=fam["items"],
        n_attrs=fam["n_attrs"], n_ctx=fam["n_ctx"],
        min_len=fam["min_len"], max_len=fam["max_len"], seed=0)
    return jax_canonicalize_repeat_ctx(cat)


def jax_run_ours_config(fam, cat, epochs, early_stop, out_dir):
    """``scripts/validate_presets.py::run_ours``'s Config, line for line."""
    mc = JaxModelConfig(
        n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx,
        d=fam["d_dim"], g=fam["g_dim"], seq_len=fam["seq_len"],
        target_len=100, n_blocks=2, n_heads=2, dropout=0.5,
        embedding=fam["embedding"], encoding="identity",
        decoder=fam["decoder"], use_pallas="auto")
    return JaxConfig(
        model=mc,
        data=JaxDataConfig(synthetic=True),
        train=JaxTrainConfig(batch_size=256, epochs=epochs,
                             early_stop=early_stop, seed=0, out_dir=out_dir,
                             checkpoint_resume=True))


@pytest.mark.parametrize("name", sorted(vp.FAMILIES))
def test_family_config_is_the_jax_scripts(name):
    fam = vp.FAMILIES[name]
    jcat = jax_catalog(fam)
    want = config_from_jax(jax_run_ours_config(fam, jcat, 25, 8, "out"))
    assert vp.family_config(fam, 25, 8, "out") == want
    cat = vp.family_catalog(fam)
    for field in ("attrs", "user_ids", "items", "offsets", "ctx_vals"):
        np.testing.assert_array_equal(getattr(cat, field), getattr(jcat, field), err_msg=field)


def metrics_rows(run):
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def test_a_tiny_family_fit_agrees_with_jax(tmp_path):
    jcat, cat = jax_catalog(TINY), vp.family_catalog(TINY)
    jcfg = jax_run_ours_config(TINY, jcat, 2, 8, str(tmp_path / "jax"))
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, dropout=0.0))
    assert jcfg.data.use_native
    jstate = jax_create_train_state(jax.random.PRNGKey(0), jcfg.model, jcfg.train,
                                    jax_make_optimizer(jcfg.train))
    init = jax.tree.map(np.asarray, jstate.params)  # fit donates the state
    theirs = jax_fit(jcfg, jcat, state=jstate)[1]
    cfg = vp.family_config(TINY, 2, 8, str(tmp_path / "ours"))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=0.0))
    model = load_into(CARCA(cfg.model, device="cpu"), init)
    ours = fit(cfg, cat, state=create_train_state(cfg.model, cfg.train, model=model),
               device="cpu")[1]
    rows, jrows = metrics_rows(tmp_path / "ours"), metrics_rows(tmp_path / "jax")
    assert [r["epoch"] for r in rows] == [r["epoch"] for r in jrows] == [1, 2]
    for a, b in zip(rows, jrows):
        for key in ("train_loss", "val_loss"):
            assert abs(a[key] - b[key]) <= LOSS_RTOL * abs(b[key]), (key, a[key], b[key])
    assert set(ours) == set(theirs) and ours["epochs_run"] == theirs["epochs_run"] == 2
    for key in ("val_hr", "val_ndcg", "test_hr", "test_ndcg"):
        assert abs(ours[key] - theirs[key]) <= 2.0 / TINY["users"], key


def test_main_writes_the_jax_scripts_keys(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(vp.FAMILIES, "games", TINY)
    out = tmp_path / "validation"
    root_files = {p.name: p.read_bytes() for p in vp.ROOT.glob("VALIDATION_*.json")}
    results = vp.main(["games", "--epochs", "1", "--early_stop", "1", "--out", str(out)],
                      device="cpu")
    written = json.loads((out / "VALIDATION_games.json").read_text())
    assert set(written) >= {"family", "config", "carca_tpu_torch", "reference"}
    assert written == json.loads(json.dumps(results["games"]))
    assert written["family"] == "games" and written["config"] == TINY
    assert written["reference"] == json.loads((vp.ROOT / "VALIDATION_games_ref.json").read_text())
    ours = written["carca_tpu_torch"]
    assert set(ours) == {"val_hr", "val_ndcg", "val_loss", "epochs_run", "test_hr", "test_ndcg",
                         "test_loss"}
    assert ours["epochs_run"] == 1 and 0.0 <= ours["test_hr"] <= 1.0
    assert written["device"] == "cpu" and written["launches"]["attention_fwd"] == 0
    printed = capsys.readouterr().out
    assert "assembler: native" in printed
    assert (f"[games] test HR@10 ours={ours['test_hr']:.4f} ref=0.7048 | test NDCG@10 "
            f"ours={ours['test_ndcg']:.4f} ref=0.5546") in printed
    assert (out / "run_games" / "ckpt" / "best" / "params.pt").exists()
    assert {p.name: p.read_bytes() for p in vp.ROOT.glob("VALIDATION_*.json")} == root_files
