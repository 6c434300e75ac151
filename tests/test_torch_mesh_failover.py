"""The failure path of a mesh run on the CPU (the port of
``tests/test_multihost.py::test_two_process_failover_resume``, at its
runner's config, ``tests/multihost_runner.py``): a 2-rank ``fit`` over
gloo with a ``latest/`` snapshot every epoch has one rank SIGKILLed once
its first snapshot is committed; the pair restarted on the same run
directory resumes from ``latest/`` and ends at epoch 3, and its final
metrics equal an uninterrupted 3-epoch run's within rtol 1e-6 (dropout 0,
the per-epoch host rng, the restored generators and step: the resumed
epochs are the uninterrupted run's). The temporary files a killed writer
may leave are never read.

The ranks (``tests/torch_ranks.py``, ``suite_failover``) import no jax.

The same path through the entry point: ``chip_smoke.py``'s phase 13b
(``failover``: ``torchrun ... -m carca_tpu_torch.cli --mesh 2``, rank 1
SIGKILLed once ``latest/state.pt`` exists, ``--resume true`` to epoch 3,
a control beside it) run with ``--device cpu`` at the config above.
"""

import json
import os

import numpy as np
import torch

from carca_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from carca_tpu_torch.data.synthetic import synthetic_catalog
from tests.torch_ranks import launch, launch_and_kill

torch.set_num_threads(1)

CATALOG = dict(n_users=320, n_real_items=60, seed=5)
EPOCHS = 3


def config(out_dir, epochs: int, resume: bool = False) -> Config:
    cat = synthetic_catalog(**CATALOG)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx, d=16, g=32,
                     seq_len=8, target_len=12, n_blocks=1, n_heads=2, dropout=0.0, decoder="ca")
    tc = TrainConfig(batch_size=16, epochs=epochs, early_stop=50, seed=0, out_dir=str(out_dir),
                     mesh_shape=(2,), mesh_axes=("data",), inner_steps=8, checkpoint=True,
                     checkpoint_interval=1, checkpoint_resume=resume)
    return Config(model=mc, data=DataConfig(synthetic=True), train=tc)


def metrics_rows(run):
    with open(os.path.join(run, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def test_a_killed_mesh_run_resumes_equal_to_an_uninterrupted_run(tmp_path):
    run, control = tmp_path / "run_failover", tmp_path / "run_control"
    latest = run / "ckpt" / "latest" / "state.pt"
    codes = launch_and_kill(2, "failover", {"catalog": CATALOG, "config": config(run, 99)},
                            watch=str(latest))
    assert any(c != 0 for c in codes), f"expected an unclean death, exit codes {codes}"
    assert latest.exists(), "the kill erased the committed snapshot"
    resumed_from = torch.load(latest, weights_only=False)["epoch"]
    assert 1 <= resumed_from < EPOCHS, f"latest/ at epoch {resumed_from}: nothing to resume"
    # what a writer killed mid-save leaves beside the files: never read
    for d, name in (("latest", "state.pt"), ("best", "params.pt"), ("ema", "ema.pt")):
        os.makedirs(run / "ckpt" / d, exist_ok=True)
        (run / "ckpt" / d / f"{name}.tmp99999").write_bytes(b"torn")

    rb = launch(2, "failover", {"catalog": CATALOG,
                                "config": config(run, EPOCHS, resume=True)})
    rc = launch(2, "failover", {"catalog": CATALOG, "config": config(control, EPOCHS)})
    assert rb[0]["epochs_run"] == rb[1]["epochs_run"] == rc[0]["epochs_run"] == EPOCHS
    for k in ("val_hr", "val_ndcg", "test_ndcg"):
        assert np.isfinite(rb[0][k]), k
        np.testing.assert_allclose(rb[0][k], rb[1][k], rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(rb[0][k], rc[0][k], rtol=1e-6, err_msg=(
            f"{k}: the resumed run diverged from the uninterrupted control"))
    # the restarted pair trained the epochs after latest/'s, and those
    # epochs are the control's
    after = EPOCHS - resumed_from
    resumed_rows, control_rows = metrics_rows(run)[-after:], metrics_rows(control)
    assert [r["epoch"] for r in resumed_rows] == list(range(resumed_from + 1, EPOCHS + 1))
    for got, want in zip(resumed_rows, control_rows[resumed_from:]):
        for k in ("train_loss", "val_loss", "val_hr", "val_ndcg"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=(k, got["epoch"]))
    assert torch.load(latest, weights_only=False)["epoch"] == EPOCHS


def test_the_cli_resumes_a_killed_mesh_run_as_chip_smoke_drives_it(tmp_path, monkeypatch):
    import chip_smoke

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    base = ["-m", "carca_tpu_torch.cli", "--device", "cpu", "--synthetic", "true",
            "--synthetic_users", "320", "--synthetic_items", "60", "--d_dim", "16",
            "--g_dim", "32", "--seq_len", "8", "--target_seq_len", "12", "--n_blocks", "1",
            "--batch_size", "16", "--dropout", "0.0", "--early_stop", "50", "--seed", "0",
            "--mesh", "2"]
    res = chip_smoke.failover("cpu", base, str(tmp_path))
    assert res["run_a"]["torchrun_exit"] != 0
    assert res["epochs_after_resume"] == list(range(res["resumed_from_epoch"] + 1, EPOCHS + 1))
    assert res["train_loss_rel_diff"] == [0.0] * len(res["epochs_after_resume"])
    assert res["ndcg10_abs_diff"] == {"val_ndcg": 0.0, "test_ndcg": 0.0}
    assert res["run_b"]["final"] == res["run_control"]["final"]
