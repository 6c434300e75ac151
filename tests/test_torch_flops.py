"""The port's step accounting (``carca_tpu_torch/utils/flops.py``) against
the JAX package's (``carca_tpu/utils/flops.py``): the same arithmetic on
each package's own preset ``ModelConfig``, equal to 1e-12 relative; the
peak tables by card name (None on the CPU and on an unknown card); the
bench's utilisation keys; ``profile_step``'s aggregation."""

import dataclasses

import numpy as np
import pytest
import torch

from carca_tpu import config as jax_config
from carca_tpu.utils import flops as jax_flops
from carca_tpu_torch import config
from carca_tpu_torch.utils import flops

DIMS = {"synthetic10m": (10_000_001, 64, 8)}  # the others: a beauty-sized catalog
RTOL = 1e-12


def model_configs(name):
    n_items, n_attrs, n_ctx = DIMS.get(name, (2_001, 12, 4))
    jmc = jax_config.preset(name, n_items, n_attrs, n_ctx).model
    mc = config.preset(name, n_items, n_attrs, n_ctx).model
    return jmc, mc


def test_the_presets_are_the_jax_packages():
    for name in config.PRESETS:
        jax_config.preset(name)
    for make in (config.preset, jax_config.preset):
        with pytest.raises(ValueError, match="unknown preset"):
            make("no_such_preset")


@pytest.mark.parametrize("name", config.PRESETS)
@pytest.mark.parametrize("batch", [256, 1024])
def test_flops_and_bytes_equal_jax(name, batch):
    jmc, mc = model_configs(name)
    for field in ("n_items", "n_attrs", "n_ctx", "d", "g", "seq_len", "target_len",
                  "n_blocks", "embedding", "decoder"):
        assert getattr(mc, field) == getattr(jmc, field), field
    for n_targets in (2 * mc.seq_len, mc.target_len + 1):
        np.testing.assert_allclose(flops.forward_flops_per_example(mc, n_targets),
                                   jax_flops.forward_flops_per_example(jmc, n_targets),
                                   rtol=RTOL)
    np.testing.assert_allclose(flops.train_step_flops(mc, batch),
                               jax_flops.train_step_flops(jmc, batch), rtol=RTOL)
    for sparse in (False, True):
        np.testing.assert_allclose(flops.train_step_hbm_bytes(mc, batch, sparse_items=sparse),
                                   jax_flops.train_step_hbm_bytes(jmc, batch,
                                                                  sparse_items=sparse),
                                   rtol=RTOL)


@pytest.mark.parametrize("embedding", ["all", "attrctx", "attr", "id", "mlpid"])
@pytest.mark.parametrize("decoder", ["ca", "dot", "wdot"])
def test_every_embedding_and_decoder_equals_jax(embedding, decoder):
    jmc, mc = model_configs("beauty")
    jmc = dataclasses.replace(jmc, embedding=embedding, decoder=decoder)
    mc = dataclasses.replace(mc, embedding=embedding, decoder=decoder)
    np.testing.assert_allclose(flops.train_step_flops(mc, 256),
                               jax_flops.train_step_flops(jmc, 256), rtol=RTOL)
    np.testing.assert_allclose(flops.train_step_hbm_bytes(mc, 256, True),
                               jax_flops.train_step_hbm_bytes(jmc, 256, True), rtol=RTOL)


def test_the_flagship_step_counts():
    """The flagship shape (bench.py's: 2,001 ids, g = 256, batch 256): 47.04
    MFLOP per example, ~309 MB per step."""
    _, mc = model_configs("beauty")
    mc = dataclasses.replace(mc, g=256)
    assert abs(flops.train_step_flops(mc, 256) / 256 / 1e6 - 47.04) < 0.01
    assert abs(flops.train_step_hbm_bytes(mc, 256) / 1e6 - 309) < 1


def as_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)


def test_peaks_by_card_name(monkeypatch):
    assert flops.device_peak_flops("cpu") is None and flops.device_peak_hbm_bps("cpu") is None
    as_card(monkeypatch, "NVIDIA H100 80GB HBM3")
    assert flops.device_peak_flops("cuda") == 989.4e12
    assert flops.device_peak_hbm_bps("cuda") == 3.35e12
    assert flops.device_peak_flops("cpu") is None
    as_card(monkeypatch, "Some Future Card")
    assert flops.device_peak_flops("cuda") is None and flops.device_peak_hbm_bps("cuda") is None


def test_utilisation_uses_the_jax_formulas(monkeypatch):
    _, mc = model_configs("beauty")
    rate, batch = 21_547.0, 256
    out = flops.utilisation(mc, batch, rate, False, "cpu")
    assert set(out) == {"hbm_gbps"}
    gbps = jax_flops.train_step_hbm_bytes(model_configs("beauty")[0], batch) * rate / batch / 1e9
    np.testing.assert_allclose(out["hbm_gbps"], gbps, rtol=RTOL)
    as_card(monkeypatch, "NVIDIA H100 80GB HBM3")
    out = flops.utilisation(mc, batch, rate, True, "cuda")
    np.testing.assert_allclose(out["mfu"], flops.train_step_flops(mc, batch) * rate / batch
                               / 989.4e12, rtol=RTOL)
    np.testing.assert_allclose(out["hbm_bw_util"], out["hbm_gbps"] * 1e9 / 3.35e12, rtol=RTOL)
    _, big = model_configs("synthetic10m")  # the row-sparse model moves fewer bytes there
    assert (flops.utilisation(big, batch, rate, True, "cuda")["hbm_gbps"]
            < flops.utilisation(big, batch, rate, False, "cuda")["hbm_gbps"])


def test_bench_setup_records_the_resolved_item_adam():
    """The bench's byte model follows ``build_setup``'s own decision, not the
    config's name: the flagship resolves the dense Adam."""
    from carca_tpu_torch.bench import build_setup

    s = build_setup("flagship", 8, device="cpu", dropout=0.0)
    assert s.sparse_items is False and s.state.items_state is None


def test_op_table_and_busy_time():
    from carca_tpu_torch.profile_step import busy_us, op_table

    ops = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("k1", 30.0, 40.0), ("copy", 35.0, 36.0)]
    assert busy_us((s, e) for _, s, e in ops) == 30.0
    rows = op_table(ops, steps=4, calls=2)
    assert [r[0] for r in rows] == ["k1", "k2", "copy"]
    name, us, pct, per_call = rows[0]
    assert us == 20.0 / 4 and per_call == 1.0
    np.testing.assert_allclose(pct, 100 * 20 / 36)
    np.testing.assert_allclose(sum(r[2] for r in rows), 100.0)


def test_device_trace_refuses_a_trace_without_a_device():
    """On the CPU the trace holds no device operation: the profiler tool
    raises rather than report a host-only figure as device time."""
    from carca_tpu_torch.profile_step import device_trace

    x = torch.ones(64, 64)

    def run():
        (x @ x).sum()
        return 1.0

    with pytest.raises(RuntimeError, match="no device operation"):
        device_trace(run, steps=1)
