"""``carca_tpu_torch.bridge``: JAX parameter trees and configs into the
PyTorch port, with lane-packed (``pack_tables=True``) and plain item
tables."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from carca_tpu.config import ModelConfig as JaxModelConfig
from carca_tpu.models.carca import carca_apply as jax_carca_apply
from carca_tpu.models.carca import carca_init
from carca_tpu.ops.packed_table import unpack_rows
from carca_tpu_torch.bridge import load_into, model_config_from_jax, params_from_jax
from carca_tpu_torch.config import ModelConfig
from carca_tpu_torch.models.carca import CARCA, carca_apply

torch.set_num_threads(1)

N_ITEMS = 37  # not a multiple of the pack factor 128/16 = 8


def jcfg(embedding="all", pack=False):
    return JaxModelConfig(n_items=N_ITEMS, n_attrs=4, n_ctx=2, d=16, g=32,
                          seq_len=6, n_blocks=2, n_heads=2, dropout=0.0,
                          embedding=embedding, decoder="ca", pack_tables=pack,
                          use_pallas=False)


@pytest.mark.parametrize("embedding", ["all", "mlpid"])
@pytest.mark.parametrize("pack", [True, False])
def test_params_roundtrip(embedding, pack):
    cfg = jcfg(embedding, pack)
    params = jax.tree.map(np.asarray, carca_init(jax.random.PRNGKey(0), cfg))
    width = 32 if embedding == "mlpid" else 16
    if pack:
        assert params["embed"]["items"].shape[-1] == 128  # really packed
    pcfg = model_config_from_jax(dataclasses.asdict(cfg))
    sd = params_from_jax(params, pcfg)
    model = load_into(CARCA(pcfg), params)  # strict: same keys and shapes
    assert set(sd) == set(model.state_dict())
    want_items = unpack_rows(params["embed"]["items"], width)[:N_ITEMS]
    np.testing.assert_array_equal(model.embed.items.detach().numpy(), want_items)
    np.testing.assert_array_equal(sd["blocks.1.attn.wq.w"].numpy(),
                                  params["blocks"][1]["attn"]["wq"]["w"])


def test_packed_and_plain_tables_give_the_same_model():
    """Packing happens after init, so one key gives one logical table: the
    port's state_dicts and outputs agree for pack_tables True and False."""
    sds = [params_from_jax(jax.tree.map(np.asarray, carca_init(
        jax.random.PRNGKey(3), jcfg(pack=p))), model_config_from_jax(
            dataclasses.asdict(jcfg(pack=p)))) for p in (True, False)]
    assert sds[0].keys() == sds[1].keys()
    for key in sds[0]:
        assert torch.equal(sds[0][key], sds[1][key]), key


def test_packed_params_score_like_jax():
    cfg = jcfg(pack=True)
    params = carca_init(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(0)
    p_x = rng.integers(0, N_ITEMS, size=(2, 6)).astype(np.int32)
    p_c = rng.standard_normal((2, 6, 2)).astype(np.float32)
    o_x = rng.integers(1, N_ITEMS, size=(2, 5)).astype(np.int32)
    o_c = rng.standard_normal((2, 5, 2)).astype(np.float32)
    attrs = rng.standard_normal((N_ITEMS, 4)).astype(np.float32)
    want = np.asarray(jax_carca_apply(params, cfg, (p_x, None, p_c),
                                      [(o_x, None, o_c)], train=False,
                                      attrs_table=attrs))
    model = load_into(CARCA(model_config_from_jax(dataclasses.asdict(cfg))),
                      jax.tree.map(np.asarray, params)).eval()
    t = torch.from_numpy
    with torch.no_grad():
        got = carca_apply(model, (t(p_x), None, t(p_c)), [(t(o_x), None, t(o_c))],
                          attrs_table=t(attrs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_model_config_mapping():
    cfg = jcfg()
    pcfg = model_config_from_jax(cfg)  # a dataclass is accepted too
    assert pcfg.use_kernel is False and pcfg.d == 16 and pcfg.decoder == "ca"
    assert model_config_from_jax(dataclasses.asdict(
        dataclasses.replace(cfg, use_pallas="auto"))).use_kernel == "auto"
    with pytest.raises(ValueError, match="no counterpart"):
        model_config_from_jax(dict(dataclasses.asdict(cfg), mystery=1))
    with pytest.raises(ValueError, match="use_kernel"):
        ModelConfig(n_items=3, n_attrs=1, n_ctx=1, use_kernel="yes")
