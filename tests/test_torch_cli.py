"""The port's training command line (``python -m carca_tpu_torch.cli``)
against the JAX package's: the same flags with the same defaults, the
preset overlay, the flags the port cannot honour yet, a CPU run end to end
(when the caller asks for the CPU), and the presets."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from carca_tpu import cli as jax_cli
from carca_tpu.config import preset as jax_preset
from carca_tpu_torch import cli
from carca_tpu_torch.bridge import config_from_jax
from carca_tpu_torch.config import PRESETS, parse_bool, parse_kernel_flag, preset

torch.set_num_threads(1)

SMOKE = ["--synthetic", "true", "--preset", "smoke", "--epochs", "2", "--resume", "false"]


def test_parser_has_the_jax_flags_and_defaults():
    ours = {a.dest: a.default for a in cli.build_parser()._actions if a.dest != "help"}
    theirs = {a.dest: a.default for a in jax_cli.build_parser()._actions if a.dest != "help"}
    assert set(ours) == set(theirs)
    for name, default in theirs.items():
        assert ours[name] == default, name


@pytest.mark.parametrize("argv", [
    ["--d_dim", "32", "--decoder", "CA", "--embedding", "AttrCtx", "--use_pallas", "1",
     "--compute_dtype", "bfloat16", "--lr_schedule", "cosine", "--lr_decay_steps", "100"],
    ["--synthetic", "true", "--seed", "5", "--ema_decay", "0.9", "--inner_steps", "2",
     "--device_pipeline", "true", "--exact_rejection", "false", "--loss", "softmax",
     "--n_train_negatives", "3", "--checkpoint_interval", "4"],
    ["--preset", "beauty", "--inner_steps", "1", "--epochs", "3", "--batch_size", "32",
     "--use_pallas", "false"],
    ["--preset", "games", "--dropout", "0.2", "--seed", "3", "--data_dir", "d"],
    ["--preset", "beauty"],
])
def test_config_from_args_equals_jax(argv):
    """Flags map onto the same Config in both packages (use_pallas becomes
    use_kernel; the TPU-only pack_tables/remat have no field here)."""
    ours = cli.config_from_args(cli.build_parser().parse_args(argv), 100, 8, 4)
    theirs = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv), 100, 8, 4)
    assert ours == config_from_jax(theirs)


def test_preset_overlays_explicit_cli_flags():
    args = cli.build_parser().parse_args(["--preset", "beauty", "--inner_steps", "1", "--epochs",
                                          "3", "--batch_size", "32", "--use_pallas", "false"])
    cfg = cli.config_from_args(args, n_items=100, n_attrs=8, n_ctx=4)
    assert (cfg.train.inner_steps, cfg.train.epochs, cfg.train.batch_size) == (1, 3, 32)
    assert cfg.model.use_kernel is False
    base = preset("beauty", 100, 8, 4)
    assert (cfg.model.seq_len, cfg.model.d) == (base.model.seq_len, base.model.d)
    assert cli.config_from_args(cli.build_parser().parse_args(["--preset", "beauty"]),
                                100, 8, 4) == base


@pytest.mark.parametrize("name", PRESETS)
def test_presets_equal_jax(name):
    assert preset(name, 100, 8, 4) == config_from_jax(jax_preset(name, 100, 8, 4))


def test_flag_parsers_are_strict():
    assert parse_bool("False") is False and parse_bool("1") is True
    assert parse_kernel_flag("auto") == "auto" and parse_kernel_flag("no") is False
    with pytest.raises(ValueError):
        parse_bool("maybe")
    with pytest.raises(ValueError):
        parse_kernel_flag("sometimes")
    with pytest.raises(ValueError):
        preset("nonsense")


@pytest.mark.parametrize("extra,item", [
    (["--mesh", "2"], "world size of 2"), (["--mesh", "4x2"], "world size of 8"),
    (["--device_sampling", "true", "--mesh", "2"], "world size of 2"),
    (["--model", "svd"], "knn"),
    (["--select_by", "retrieval_hr"], "eval_retrieval_every"),
    (["--select_by", "retrieval_ndcg"], "eval_retrieval_every"),
    (["--eval_retrieval_every", "1", "--select_by", "retrieval_hr"], "dot-family"),
    (["--ema_decay", "1.0"], "ema_decay"), (["--n_train_negatives", "2"], "device_pipeline"),
    (["--neg_distribution", "popularity"], "device_pipeline"),
    (["--sparse_items_adam", "true", "--device_pipeline", "false"], "device_pipeline"),
])
def test_flags_not_ported_yet_raise(tmp_path, extra, item):
    """What the port refuses: a mesh whose product is not the world size
    (here one process, not launched by torchrun), and the flag
    combinations the JAX package refuses too (smoke's decoder is ca)."""
    argv = SMOKE + ["--out_dir", str(tmp_path)] + extra
    with pytest.raises((NotImplementedError, ValueError), match=item):
        cli.main(argv, device="cpu")


TINY_10M = ["--preset", "synthetic10m", "--synthetic_users", "120", "--synthetic_items", "150",
            "--epochs", "2", "--batch_size", "32", "--inner_steps", "2", "--resume", "false"]


@pytest.mark.parametrize("extra", [
    ["--synthetic_process", "markov", "--eval_retrieval_every", "1", "--select_by",
     "retrieval_hr", "--eval_retrieval", "10"],
    ["--eval_retrieval", "10", "--retrieval_index", "full", "--sparse_items_adam", "true"],
])
def test_synthetic10m_preset_trains_and_evaluates_retrieval(tmp_path, capsys, extra):
    """The synthetic10m preset at a tiny catalog, on the CPU: the catalog
    generated on the run's device, device_sampling accepted on one device,
    per-epoch retrieval monitoring retained on retrieval HR, and the
    retrieval eval at the end."""
    metrics = cli.main(TINY_10M + ["--out_dir", str(tmp_path)] + extra, device="cpu")
    out = capsys.readouterr().out
    assert metrics["epochs_run"] == 2 and 0.0 <= metrics["retrieval_test_hr"] <= 1.0
    assert "Retrieval@10 (test" in out and "launches: " in out
    cfg = json.loads((tmp_path / "args.json").read_text())
    assert (cfg["decoder"], cfg["compute_dtype"], cfg["device_pipeline"],
            cfg["device_sampling"]) == ("dot", "bfloat16", True, True)
    if "--select_by" in extra:
        rows = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl").read_text().splitlines()]
        curve = [r["retrieval_val_hr"] for r in rows if "retrieval_val_hr" in r]
        assert len(curve) == 2
        best = json.loads((tmp_path / "ckpt" / "best" / "metrics.json").read_text())
        assert best["select_by"] == "retrieval_hr"
        assert best["epoch"] == 1 + int(np.argmax(curve))


def test_model_knn_evaluates_the_baseline(capsys):
    """--model knn evaluates the content baseline through the sampled eval
    and trains nothing, with the JAX package's numbers (the same numpy
    catalog and sampler)."""
    from carca_tpu.train.loop import evaluate_knn as jax_evaluate_knn

    argv = ["--synthetic", "true", "--preset", "smoke", "--model", "knn"]
    metrics = cli.main(argv, device="cpu")
    assert "KNN val" in capsys.readouterr().out
    jargs = jax_cli.build_parser().parse_args(argv)
    jcat = jax_cli.load_catalog(jargs)
    want = jax_evaluate_knn(jax_cli.config_from_args(jargs, jcat.n_items, jcat.n_attrs,
                                                     jcat.n_ctx), jcat, log=False)
    assert set(metrics) == set(want)
    for key in ("val_hr", "test_hr", "val_ndcg", "test_ndcg"):
        assert abs(metrics[key] - want[key]) <= 1e-6, key


def test_main_trains_on_the_cpu_when_asked(tmp_path, capsys):
    metrics = cli.main(SMOKE + ["--out_dir", str(tmp_path), "--pack_tables", "true"],
                       device="cpu")
    out = capsys.readouterr().out
    assert "note: --pack_tables is a TPU knob; ignored" in out
    assert "note: --use_native" in out
    final = next(line for line in out.splitlines() if line.startswith("final: "))
    assert metrics["epochs_run"] == 2 and str(metrics["test_hr"]) in final
    assert (tmp_path / "args.json").exists() and (tmp_path / "ckpt" / "best").is_dir()


def test_the_card_is_the_default_device(monkeypatch, tmp_path):
    """Nothing falls back to the CPU: without a device argument the run goes
    to "cuda"; --device or main(device=) picks another."""
    import carca_tpu_torch.train.loop as loop

    seen = []
    monkeypatch.setattr(loop, "fit", lambda cfg, cat, device: seen.append(device) or (None, {}))
    argv = SMOKE + ["--out_dir", str(tmp_path)]
    cli.main(argv)
    cli.main(argv + ["--device", "cpu"])
    cli.main(argv, device="cpu")
    assert seen == ["cuda", "cpu", "cpu"]


def test_load_catalog_regenerates_the_synthetic_catalog():
    args = cli.build_parser().parse_args(["--synthetic", "true", "--seed", "5",
                                          "--synthetic_users", "30", "--synthetic_items", "25"])
    ours, theirs = cli.load_catalog(args), jax_cli.load_catalog(
        jax_cli.build_parser().parse_args(["--synthetic", "true", "--seed", "5",
                                           "--synthetic_users", "30",
                                           "--synthetic_items", "25"]))
    assert ours.n_users == 30 and ours.n_items == 26
    for f in dataclasses.fields(ours):
        np.testing.assert_array_equal(getattr(ours, f.name), np.asarray(getattr(theirs, f.name)))


def test_parse_mesh():
    assert cli.parse_mesh("") == ((), ("data",))
    assert cli.parse_mesh("4x2") == ((4, 2), ("data", "model"))
    with pytest.raises(ValueError):
        cli.parse_mesh("2x2x2")
