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
* Saves are asynchronous (a writer thread per kind, gated here): a save
  returns while its write is blocked and the file appears only after it;
  the file holds the snapshot taken in the call, bit for bit, whatever is
  changed in place afterwards; a write's exception is raised, the same
  object, at the next save, wait or close; two saves of one kind write in
  order; every read waits for the write it reads; ``fit`` returns with no
  writer alive and a complete run directory.
"""

import dataclasses
import json
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carca_tpu.train.loop import ema_update as jax_ema_update
from carca_tpu_torch.config import preset
from carca_tpu_torch.data.dataset import BatchBuilder, epoch_batches
from carca_tpu_torch.data.device_pipeline import DeviceDataset
from carca_tpu_torch.data.synthetic import synthetic_catalog
from carca_tpu_torch.train.checkpoint import (CheckpointKeeper, _load_optimizer,
                                              _portable_optimizer)
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


def test_a_latest_with_cpu_step_tensors_resumes_exactly(tmp_path, cat):
    """latest/ holds Adam's steps as CPU float32 tensors and its lr as a
    float, the CPU Adam's layout, which every latest/ written before the
    card's Adam held device steps has; such a directory resumes to the
    uninterrupted run."""
    whole = fit(smoke(cat, tmp_path / "whole", epochs=3, device_pipeline=True), cat,
                device="cpu")[1]
    fit(smoke(cat, tmp_path / "split", epochs=2, device_pipeline=True), cat, device="cpu")
    opt = latest_weights(tmp_path / "split")["optimizer"]
    steps = [st["step"] for st in opt["state"].values()]
    assert steps and all(t.device.type == "cpu" and t.dtype == torch.float32 and t.ndim == 0
                         for t in steps)
    assert all(isinstance(g["lr"], float) for g in opt["param_groups"])
    resumed = fit(smoke(cat, tmp_path / "split", epochs=3, device_pipeline=True), cat,
                  device="cpu")[1]
    assert resumed == whole
    wa, wb = latest_weights(tmp_path / "whole"), latest_weights(tmp_path / "split")
    for name, t in wa["model"].items():
        assert torch.equal(t, wb["model"][name]), name


def test_the_capturable_adams_state_is_saved_portable_and_loaded_in_each_form():
    """The card's Adam (``capturable``, a tensor lr, 0-dim step tensors on
    its parameters' device) is written in the CPU Adam's layout, and a
    state_dict of either layout loads into either optimizer in its own
    form: a tensor lr stays the live tensor holding the saved value, the
    capturable flag stays, the steps go where the optimizer keeps them."""
    params = [torch.nn.Parameter(torch.randn(3, 2)), torch.nn.Parameter(torch.randn(4))]
    lr = torch.tensor(2e-3, dtype=torch.float32)
    card = torch.optim.Adam(params, lr=lr, capturable=True)
    for i, p in enumerate(params):
        card.state[p] = {"step": torch.tensor(7.0 + i), "exp_avg": torch.randn_like(p),
                         "exp_avg_sq": torch.rand_like(p)}
    sd = _portable_optimizer(card.state_dict())
    assert [type(g["lr"]) for g in sd["param_groups"]] == [float]
    assert all(st["step"].dtype == torch.float32 and st["step"].device.type == "cpu"
               for st in sd["state"].values())
    plain = torch.optim.Adam([torch.nn.Parameter(p.detach().clone()) for p in params], lr=1e-3)
    _load_optimizer(plain, sd)
    g = plain.param_groups[0]
    assert isinstance(g["lr"], float) and g["lr"] == float(lr) and not g["capturable"]
    lr2 = torch.tensor(5.0)
    again = torch.optim.Adam([torch.nn.Parameter(p.detach().clone()) for p in params], lr=lr2,
                             capturable=True)
    _load_optimizer(again, plain.state_dict())
    g = again.param_groups[0]
    assert g["lr"] is lr2 and lr2.item() == lr.item() and g["capturable"]
    for p, q in zip(params, again.param_groups[0]["params"]):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(card.state[p][key], again.state[q][key]), key


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
    the temporary files a killed writer leaves are not read. The write runs
    on the keeper's writer thread, so its death is raised at the next
    wait."""
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
    keeper.save_latest(3, state, ema=ema)
    with pytest.raises(Killed):
        keeper.wait()
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


# --------------------------------------------------------------------------
# asynchronous saves
# --------------------------------------------------------------------------

class Gate:
    """``checkpoint._save`` held until ``release()``: ``started`` is set
    when a write begins; ``order`` logs each write's (event, file, epoch)."""

    def __init__(self, monkeypatch, closed=True):
        from carca_tpu_torch.train import checkpoint

        self.real, self.open = checkpoint._save, threading.Event()
        self.started, self.order = threading.Event(), []
        if not closed:
            self.open.set()
        monkeypatch.setattr(checkpoint, "_save", self.save)

    def save(self, obj, path):
        name = os.path.basename(path)
        self.order.append(("start", name, obj.get("epoch") if "epoch" in obj else None))
        self.started.set()
        assert self.open.wait(30), "the gate was never released"
        self.real(obj, path)
        self.order.append(("end", name, obj.get("epoch") if "epoch" in obj else None))

    def release(self):
        self.open.set()


def trained_state(cat, sparse=False):
    """A smoke-preset state one host step on (Adam's moments filled); with
    ``sparse`` the row-sparse row state, filled at random."""
    cfg = smoke(cat, "unused")
    state = create_train_state(cfg.model, cfg.train, device="cpu", sparse_items=sparse)
    if sparse:
        state.items_state["munu"].uniform_(-1.0, 1.0, generator=torch.Generator().manual_seed(3))
        state.items_state["count"] = 5
        return cfg, state
    builder = BatchBuilder(cat, cfg.model.seq_len, cfg.model.target_len)
    rng = np.random.default_rng(0)
    batch = builder.train_batch(next(iter(epoch_batches(builder.users("train"), 32, rng))), rng)
    batch.pop("n_valid")
    make_train_step(cfg.model, cfg.train, graph=False)(state, torch.from_numpy(cat.attrs),
                                                       batch)
    return cfg, state


def writer_threads():
    return [t for t in threading.enumerate() if t.name.startswith("checkpoint-")]


def test_save_latest_returns_while_its_write_is_blocked(tmp_path, cat, monkeypatch):
    _, state = trained_state(cat)
    gate = Gate(monkeypatch)
    keeper = CheckpointKeeper(str(tmp_path))
    keeper.save_latest(1, state)  # returns: the write waits at the gate
    assert gate.started.wait(10)
    assert not os.path.exists(keeper.latest) and len(writer_threads()) == 1
    gate.release()
    keeper.wait()
    assert not writer_threads()
    assert torch.load(keeper.latest, weights_only=False)["epoch"] == 1


@pytest.mark.parametrize("sparse", [False, True])
def test_a_file_holds_the_snapshot_whatever_changes_in_place_after(tmp_path, cat, monkeypatch,
                                                                   sparse):
    cfg, state = trained_state(cat, sparse)
    ema = create_train_state(cfg.model, cfg.train, device="cpu").model
    want_model = {n: t.clone() for n, t in state.model.state_dict().items()}
    want_ema = {n: t.clone() for n, t in ema.state_dict().items()}
    want_opt = {i: {k: v.clone() for k, v in st.items()}
                for i, st in _portable_optimizer(state.optimizer.state_dict())["state"].items()}
    want_rows = None if not sparse else state.items_state["munu"].clone()
    assert sparse or want_opt, "no Adam moments to change"
    gate = Gate(monkeypatch)
    keeper = CheckpointKeeper(str(tmp_path))
    keeper.save_latest(2, state, ema=ema)
    keeper.save(2, state.model, {"ndcg": 0.5, "hr": 0.5, "epoch": 2})
    with torch.no_grad():  # what the next epoch's replays do, in place
        for p in [*state.model.parameters(), *ema.parameters()]:
            p.mul_(-3.0).add_(1.0)
        for st in state.optimizer.state.values():
            for k in ("exp_avg", "exp_avg_sq"):
                if k in st:
                    st[k].add_(7.0)
        if sparse:
            state.items_state["munu"].add_(7.0)
    gate.release()
    keeper.close()
    ck = torch.load(keeper.latest, weights_only=False)
    best = torch.load(keeper.best_params, weights_only=False)
    for got, want in ((ck["model"], want_model), (best, want_model),
                      (ck["ema"]["params"], want_ema)):
        assert got.keys() == want.keys()
        assert all(torch.equal(got[n], want[n]) for n in want)
    for i, st in want_opt.items():
        assert all(torch.equal(ck["optimizer"]["state"][i][k], v) for k, v in st.items())
    if sparse:
        assert torch.equal(ck["items_state"]["munu"], want_rows)
        assert ck["items_state"]["count"] == 5


class DiskFull(RuntimeError):
    pass


@pytest.mark.parametrize("next_call", ["save", "save_latest", "wait", "close"])
def test_a_writes_exception_is_raised_at_the_next_call(tmp_path, cat, monkeypatch, next_call):
    from carca_tpu_torch.train import checkpoint

    _, state = trained_state(cat)
    raised = DiskFull("no space left on device")

    def fails(obj, path):
        raise raised

    monkeypatch.setattr(checkpoint, "_save", fails)
    keeper = CheckpointKeeper(str(tmp_path))
    keeper.save_latest(1, state)  # returns; the write fails on its thread
    deadline = time.monotonic() + 10
    while writer_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    monkeypatch.undo()
    call = {"save": lambda: keeper.save(2, state.model, {"ndcg": 0.1, "hr": 0.1, "epoch": 2}),
            "save_latest": lambda: keeper.save_latest(2, state),
            "wait": keeper.wait, "close": keeper.close}[next_call]
    with pytest.raises(DiskFull) as err:
        call()
    assert err.value is raised  # the writer's own exception, unchanged
    keeper.save_latest(3, state)  # raised once; the keeper goes on
    keeper.close()
    assert torch.load(keeper.latest, weights_only=False)["epoch"] == 3


@pytest.mark.parametrize("kind", ["best", "latest"])
def test_two_saves_of_one_kind_write_in_order(tmp_path, cat, monkeypatch, kind):
    _, state = trained_state(cat)
    gate = Gate(monkeypatch, closed=False)
    keeper = CheckpointKeeper(str(tmp_path))
    for epoch in (1, 2):
        if kind == "best":
            keeper.save(epoch, state.model, {"ndcg": 0.1 * epoch, "hr": 0.1, "epoch": epoch})
        else:
            keeper.save_latest(epoch, state)
        with torch.no_grad():
            next(state.model.parameters()).add_(1.0)
    keeper.close()
    name = "params.pt" if kind == "best" else "state.pt"
    epochs = [None, None] if kind == "best" else [1, 2]
    assert gate.order == [("start", name, epochs[0]), ("end", name, epochs[0]),
                          ("start", name, epochs[1]), ("end", name, epochs[1])]
    if kind == "best":
        assert keeper.best_metrics()["epoch"] == 2
    else:
        assert torch.load(keeper.latest, weights_only=False)["epoch"] == 2


READS = ["best_metrics", "restore_best", "restore_latest", "restore_latest_model",
         "latest_progress", "restore_latest_ema"]


@pytest.mark.parametrize("read", READS)
def test_every_read_waits_for_the_write_it_reads(tmp_path, cat, monkeypatch, read):
    cfg, state = trained_state(cat)
    ema = create_train_state(cfg.model, cfg.train, device="cpu").model
    gate = Gate(monkeypatch)
    keeper = CheckpointKeeper(str(tmp_path))
    if read in ("best_metrics", "restore_best"):
        keeper.save(4, state.model, {"ndcg": 0.5, "hr": 0.5, "epoch": 4})
    else:
        keeper.save_latest(4, state, ema=ema, progress={"best": 0.5, "no_improve": 1,
                                                        "select_by": "ndcg"})
    assert gate.started.wait(10)
    fresh = create_train_state(cfg.model, cfg.train, device="cpu")
    calls = {"best_metrics": lambda: keeper.best_metrics()["epoch"],
             "restore_best": lambda: keeper.restore_best(fresh.model),
             "restore_latest": lambda: keeper.restore_latest(fresh),
             "restore_latest_model": lambda: keeper.restore_latest_model(fresh.model),
             "latest_progress": keeper.latest_progress,
             "restore_latest_ema": lambda: keeper.restore_latest_ema(ema, state.step)}
    got = []
    reader = threading.Thread(target=lambda: got.append(calls[read]()))
    reader.start()
    reader.join(0.3)
    assert reader.is_alive() and not got  # held while the write is blocked
    gate.release()
    reader.join(30)
    assert not reader.is_alive()
    want = {"latest_progress": None, "restore_latest_ema": False}.get(read, 4)
    assert got == [want]


def test_fit_returns_with_no_writer_alive_and_a_complete_run(tmp_path, cat, monkeypatch):
    from carca_tpu_torch.train import checkpoint

    real = checkpoint._save

    def slow(obj, path):  # every write outlasts the epoch that follows it
        time.sleep(0.3)
        real(obj, path)

    monkeypatch.setattr(checkpoint, "_save", slow)
    final = fit(smoke(cat, tmp_path, epochs=2, ema_decay=0.5), cat, device="cpu")[1]
    assert not writer_threads() and final["epochs_run"] == 2
    names = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                   for d, _, files in os.walk(tmp_path) for f in files)
    assert [n for n in names if not n.endswith(".csv")] == [
        "args.json", "ckpt/best/metrics.json", "ckpt/best/params.pt", "ckpt/latest/state.pt",
        "metrics.jsonl"]
    ck = latest_weights(tmp_path)  # the smoke preset saves latest/ every epoch
    assert ck["epoch"] == 2 and ck["ema"]["step"] == ck["step"]
