"""Checkpoints, resume and the EMA of the port's fit loop, on the CPU at
the ``smoke`` preset's size.

* A run of 2 epochs resumed for 2 more gives the same losses, metrics and
  weights as one run of 4 (dropout on: the generators' states are saved),
  on both pipelines and under EMA.
* The faults of the JAX package's checkpoints are not copied: the EMA
  shadow is saved in ``latest/`` with the state, in one atomic write, so a
  save cut after its first write still resumes; a shadow whose step is
  not ``latest/``'s (in ``latest/`` or in the older layout's ``ema/``) is
  refused; a resumed run keeps early stop's counter and stops where the
  uninterrupted run stops; ``ema_decay`` 1.0 is
  refused; the EMA rolls after every optimizer step, so with K-step calls
  the shadow is the one-step updates' (at ``inner_steps=1`` the JAX
  package's ``ema_update`` sequence, to float32 rounding).
* best/ keeps the best; files are replaced whole; ``checkpoint=False``
  writes nothing; ``checkpoint_resume=False`` drops a stale ``ckpt/``;
  ``profile`` writes a trace of the second epoch.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carca_tpu.train.loop import ema_update as jax_ema_update
from carca_tpu_torch.config import preset
from carca_tpu_torch.data.dataset import BatchBuilder, epoch_batches
from carca_tpu_torch.data.device_pipeline import DeviceDataset
from carca_tpu_torch.data.synthetic import synthetic_catalog
from carca_tpu_torch.train.checkpoint import CheckpointKeeper
from carca_tpu_torch.train.loop import (ema_update, fit, make_device_train_step,
                                        make_scanned_device_train_step, make_train_step,
                                        to_device)
from carca_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cat():
    return synthetic_catalog(n_users=120, n_real_items=80, seed=1)


def smoke(cat, out_dir, *, device_pipeline=False, **train):
    cfg = preset("smoke", cat.n_items, cat.n_attrs, cat.n_ctx)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, device_pipeline=device_pipeline),
        train=dataclasses.replace(cfg.train, out_dir=str(out_dir),
                                  **{"early_stop": 50, "inner_steps": 2, **train}))


def metrics_rows(run):
    with open(os.path.join(run, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def latest_weights(run):
    return torch.load(os.path.join(run, "ckpt", "latest", "state.pt"), weights_only=False)


@pytest.mark.parametrize("device_pipeline,ema_decay", [(False, 0.0), (True, 0.0), (True, 0.9)])
def test_resume_equals_an_uninterrupted_run(tmp_path, cat, device_pipeline, ema_decay):
    kw = dict(device_pipeline=device_pipeline, ema_decay=ema_decay)
    whole = fit(smoke(cat, tmp_path / "whole", epochs=4, **kw), cat, device="cpu")[1]
    fit(smoke(cat, tmp_path / "split", epochs=2, **kw), cat, device="cpu")
    resumed = fit(smoke(cat, tmp_path / "split", epochs=4, **kw), cat, device="cpu")[1]
    a, b = metrics_rows(tmp_path / "whole"), metrics_rows(tmp_path / "split")
    assert [r["epoch"] for r in b] == [1, 2, 3, 4]
    for key in ("train_loss", "val_loss", "val_hr", "val_ndcg"):
        assert [r[key] for r in a] == [r[key] for r in b], key
    assert resumed == whole
    wa, wb = latest_weights(tmp_path / "whole"), latest_weights(tmp_path / "split")
    assert wa["step"] == wb["step"] and wa["epoch"] == wb["epoch"] == 4
    for name, t in wa["model"].items():
        assert torch.equal(t, wb["model"][name]), name
    if ema_decay:
        ea, eb = wa["ema"], wb["ema"]  # the shadow saved in latest/ with the state
        assert ea["step"] == eb["step"] == wa["step"]
        assert all(torch.equal(t, eb["params"][n]) for n, t in ea["params"].items())


def test_resume_refuses_an_ema_of_another_step(tmp_path, cat):
    cfg = smoke(cat, tmp_path, epochs=2, ema_decay=0.5)
    fit(cfg, cat, device="cpu")
    path = tmp_path / "ckpt" / "latest" / "state.pt"
    ck = torch.load(path, weights_only=False)
    ck["ema"]["step"] -= 1
    torch.save(ck, path)
    with pytest.raises(ValueError, match="mismatched resume"):
        fit(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, epochs=3)), cat,
            device="cpu")


def to_legacy_layout(ckpt) -> dict:
    """Rewrite a run's latest/ in the layout of a directory written before
    the shadow joined it: the shadow in ema/ema.pt, none in state.pt.
    Returns the shadow."""
    path = ckpt / "latest" / "state.pt"
    ck = torch.load(path, weights_only=False)
    shadow = dict(ck.pop("ema"), epoch=ck["epoch"])
    ck.pop("progress")
    torch.save(ck, path)
    os.makedirs(ckpt / "ema", exist_ok=True)
    torch.save(shadow, ckpt / "ema" / "ema.pt")
    return shadow


def test_a_directory_of_the_older_layout_resumes_and_refuses_a_mismatch(tmp_path, cat):
    """latest/ with its shadow in ema/ema.pt resumes to the run the same
    directory in the current layout gives; a shadow there of another step
    is refused."""
    kw = dict(epochs=2, ema_decay=0.5)
    for name in ("now", "older", "mismatched"):
        fit(smoke(cat, tmp_path / name, **kw), cat, device="cpu")
    to_legacy_layout(tmp_path / "older" / "ckpt")
    shadow = to_legacy_layout(tmp_path / "mismatched" / "ckpt")
    torch.save(dict(shadow, step=shadow["step"] - 1),
               tmp_path / "mismatched" / "ckpt" / "ema" / "ema.pt")
    kw["epochs"] = 3
    want = fit(smoke(cat, tmp_path / "now", **kw), cat, device="cpu")[1]
    got = fit(smoke(cat, tmp_path / "older", **kw), cat, device="cpu")[1]
    assert got == want and want["epochs_run"] == 3
    assert latest_weights(tmp_path / "older")["ema"]["step"] == latest_weights(
        tmp_path / "now")["ema"]["step"]
    with pytest.raises(ValueError, match="mismatched resume"):
        fit(smoke(cat, tmp_path / "mismatched", **kw), cat, device="cpu")


class Killed(BaseException):
    """The process dies here."""


def test_a_save_latest_cut_after_its_first_write_still_resumes(tmp_path, cat, monkeypatch):
    """A save_latest that dies right after its first file write (the
    resume state's, where the shadow once followed in a file of its own)
    leaves a directory that resumes to the state and shadow of one step;
    the temporary files a killed writer leaves are not read."""
    from carca_tpu_torch.train import checkpoint

    cfg = smoke(cat, tmp_path, epochs=2, ema_decay=0.5)
    fit(cfg, cat, device="cpu")
    mc, tc = cfg.model, cfg.train
    keeper = CheckpointKeeper(str(tmp_path / "ckpt"))
    state = create_train_state(mc, tc, device="cpu")
    assert keeper.restore_latest(state) == 2
    ema = create_train_state(mc, tc, device="cpu").model
    assert keeper.restore_latest_ema(ema, state.step)
    with torch.no_grad():  # one step on, the live weights and the shadow apart
        for p, e in zip(state.model.parameters(), ema.parameters()):
            p.add_(0.25)
            e.sub_(0.5)
    state.step += 1
    real, written = checkpoint._save, []

    def dies_after_the_first_write(obj, path):
        real(obj, path)
        written.append(path)
        raise Killed

    monkeypatch.setattr(checkpoint, "_save", dies_after_the_first_write)
    with pytest.raises(Killed):
        keeper.save_latest(3, state, ema=ema)
    monkeypatch.undo()
    assert written == [keeper.latest]
    for d in ("latest", "ema"):  # what a SIGKILL mid-write leaves
        os.makedirs(tmp_path / "ckpt" / d, exist_ok=True)
        (tmp_path / "ckpt" / d / f"{'state' if d == 'latest' else 'ema'}.pt.tmp99999"
         ).write_bytes(b"torn")

    back = create_train_state(mc, tc, device="cpu")
    again = CheckpointKeeper(str(tmp_path / "ckpt"))
    assert again.restore_latest(back) == 3 and back.step == state.step
    shadow = create_train_state(mc, tc, device="cpu").model
    assert again.restore_latest_ema(shadow, back.step)
    for got, want in ((back.model, state.model), (shadow, ema)):
        for (n, a), b in zip(got.state_dict().items(), want.state_dict().values()):
            assert torch.equal(a, b), n
    final = fit(dataclasses.replace(cfg, train=dataclasses.replace(tc, epochs=4)), cat,
                device="cpu")[1]
    assert final["epochs_run"] == 4 and np.isfinite(final["test_ndcg"])


def test_a_resumed_run_stops_where_the_uninterrupted_run_stops(tmp_path, cat):
    """Early stop's counter and the best value travel with latest/: a run
    split where the counter stands above 0 stops at the same epoch, with
    the same metrics, as the run never split; a run resumed after its
    early stop trains no further epoch."""
    kw = dict(epochs=40, early_stop=2)
    whole = fit(smoke(cat, tmp_path / "whole", **kw), cat, device="cpu")[1]
    rows = metrics_rows(tmp_path / "whole")
    assert whole["epochs_run"] < kw["epochs"], "the run never stopped early"
    best, counts = 0.0, []
    for r in rows:  # the counter after each epoch, as fit keeps it
        counts.append(0 if r["val_ndcg"] > best else counts[-1] + 1)
        best = max(best, r["val_ndcg"])
    split_at = counts.index(1) + 1
    fit(smoke(cat, tmp_path / "split", **dict(kw, epochs=split_at)), cat, device="cpu")
    resumed = fit(smoke(cat, tmp_path / "split", **kw), cat, device="cpu")[1]
    assert resumed == whole
    keys = ("epoch", "train_loss", "val_loss", "val_hr", "val_ndcg")
    assert ([[r[k] for k in keys] for r in metrics_rows(tmp_path / "split")]
            == [[r[k] for k in keys] for r in rows])
    again = fit(smoke(cat, tmp_path / "split", **kw), cat, device="cpu")[1]
    assert "val_hr" not in again and again["test_ndcg"] == whole["test_ndcg"]


@pytest.mark.parametrize("decay", [1.0, -0.5, 1.5])
def test_ema_decay_outside_the_open_interval_is_refused(tmp_path, cat, decay):
    with pytest.raises(ValueError, match=r"\(0, 1\)"):
        fit(smoke(cat, tmp_path, epochs=1, ema_decay=decay), cat, device="cpu")


def test_ema_at_one_step_per_call_equals_the_jax_sequence(cat):
    """Three host-pipeline train steps, the shadow rolled after each: the
    port's ema_update against the JAX package's on the same weights."""
    cfg = smoke(cat, "unused")
    state = create_train_state(cfg.model, cfg.train, device="cpu")
    shadow = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    ema = create_train_state(cfg.model, cfg.train, device="cpu").model
    jshadow = {n: jnp.asarray(p.numpy()) for n, p in shadow.items()}
    builder = BatchBuilder(cat, cfg.model.seq_len, cfg.model.target_len)
    step = make_train_step(cfg.model, cfg.train)
    rng = np.random.default_rng(0)
    attrs = torch.from_numpy(cat.attrs)
    for rows in list(epoch_batches(builder.users("train"), 32, rng))[:3]:
        batch = builder.train_batch(rows, rng)
        batch.pop("n_valid")
        state, _ = step(state, attrs, to_device(batch, "cpu"))
        ema_update(ema, state.model, 0.75)
        params = {n: jnp.asarray(p.detach().numpy()) for n, p in state.model.named_parameters()}
        jshadow = jax_ema_update(jshadow, params, jnp.float32(0.75))
    for n, p in ema.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jshadow[n]), rtol=1e-6,
                                   atol=1e-7, err_msg=n)


def test_ema_rolls_after_every_step_of_a_k_step_call(cat):
    """The K-step call's on_step hook gives the shadow of K single steps."""
    cfg = smoke(cat, "unused", device_pipeline=True)
    mc, tc = cfg.model, cfg.train
    dd = DeviceDataset(cat, mc.seq_len, mc.target_len, device="cpu")
    attrs = torch.from_numpy(cat.attrs)
    rows = torch.as_tensor(np.stack(list(epoch_batches(dd.users("train"), 32,
                                                       np.random.default_rng(0)))[:3]))
    shadows = []
    for k_step in (True, False):
        state = create_train_state(mc, tc, device="cpu")
        ema = create_train_state(mc, tc, device="cpu").model

        def roll(st, ema=ema):
            ema_update(ema, st.model, 0.6)

        if k_step:
            make_scanned_device_train_step(mc, 3, tc, on_step=roll)(state, attrs, dd.arrays, rows)
        else:
            one = make_device_train_step(mc, tc)
            for r in rows:
                state, _ = one(state, attrs, dd.arrays, r)
                roll(state)
        shadows.append([p.detach().clone() for p in ema.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*shadows))


def test_keeper_retains_the_best_and_leaves_no_temporary_file(tmp_path, cat):
    cfg = smoke(cat, "unused")
    state = create_train_state(cfg.model, cfg.train, device="cpu")
    keeper = CheckpointKeeper(str(tmp_path))
    keeper.save(1, state.model, {"ndcg": 0.5, "hr": 0.6, "epoch": 1})
    first = {n: t.clone() for n, t in state.model.state_dict().items()}
    with torch.no_grad():
        next(state.model.parameters()).add_(1.0)
    keeper.save(2, state.model, {"ndcg": 0.3, "hr": 0.4, "epoch": 2})  # worse: not kept
    assert keeper.best_metrics() == {"ndcg": 0.5, "hr": 0.6, "epoch": 1}
    fresh = create_train_state(cfg.model, cfg.train, device="cpu").model
    assert keeper.restore_best(fresh) == 1
    assert all(torch.equal(t, first[n]) for n, t in fresh.state_dict().items())
    keeper.save(3, state.model, {"ndcg": 0.7, "hr": 0.7, "epoch": 3})
    assert keeper.best_metrics()["epoch"] == 3
    keeper.save_latest(3, state)
    assert keeper.restore_latest(create_train_state(cfg.model, cfg.train, device="cpu")) == 3
    names = [f for _, _, files in os.walk(tmp_path) for f in files]
    assert sorted(names) == ["metrics.json", "params.pt", "state.pt"]


def test_checkpoint_false_writes_nothing(tmp_path, cat):
    final = fit(smoke(cat, tmp_path, epochs=2, checkpoint=False), cat, device="cpu")[1]
    assert not os.path.exists(tmp_path / "ckpt") and final["epochs_run"] == 2


def test_resume_false_drops_a_stale_checkpoint(tmp_path, cat):
    fit(smoke(cat, tmp_path, epochs=2), cat, device="cpu")
    stale = tmp_path / "ckpt" / "best" / "metrics.json"
    stale.write_text(json.dumps({"ndcg": 2.0, "hr": 1.0, "epoch": 9}))
    final = fit(smoke(cat, tmp_path, epochs=1, checkpoint_resume=False), cat, device="cpu")[1]
    assert final["epochs_run"] == 1
    assert json.loads(stale.read_text())["epoch"] == 1
    # resuming a finished run trains no further epoch: the loop starts past its end
    again = fit(smoke(cat, tmp_path, epochs=1), cat, device="cpu")[1]
    assert "val_hr" not in again and "test_hr" in again


def test_profile_traces_the_second_epoch(tmp_path, cat):
    fit(smoke(cat, tmp_path, epochs=2, profile=True, checkpoint=False), cat, device="cpu")
    assert os.listdir(tmp_path / "profile") == ["epoch002.trace.json"]
    with open(tmp_path / "profile" / "epoch002.trace.json") as fh:
        assert json.load(fh)["traceEvents"]
