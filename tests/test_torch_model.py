"""The PyTorch port's model against the JAX package's, in eval mode.

Weights come from ``carca_tpu.models.carca.carca_init`` and reach the port
through ``carca_tpu_torch.bridge``; inputs are numpy arrays from a seed.
JAX runs its plain jnp attention (``use_pallas=False``) at the conftest's
"highest" matmul precision. Tolerance: 1e-5 (f32 summation order).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from carca_tpu.config import ModelConfig as JaxModelConfig
from carca_tpu.models.carca import carca_apply as jax_carca_apply
from carca_tpu.models.carca import carca_init
from carca_tpu_torch.bridge import load_into, model_config_from_jax
from carca_tpu_torch.models.carca import CARCA, carca_apply

torch.set_num_threads(1)

B, L, T = 3, 8, 6
N_ITEMS, N_ATTRS, N_CTX = 40, 5, 3
TOL = 1e-5


def make_inputs(seed):
    rng = np.random.default_rng(seed)
    p_x = rng.integers(1, N_ITEMS, size=(B, L)).astype(np.int32)
    p_x[0, :3] = 0  # left padding
    p_x[2, :] = 0  # an all-pad profile: its rows must stay finite
    p_c = rng.standard_normal((B, L, N_CTX)).astype(np.float32)
    o_x = rng.integers(1, N_ITEMS, size=(B, T)).astype(np.int32)
    o_x[1, -2:] = 0  # padded candidates
    o_c = rng.standard_normal((B, T, N_CTX)).astype(np.float32)
    attrs = rng.standard_normal((N_ITEMS, N_ATTRS)).astype(np.float32)
    attrs[0] = 0.0
    return p_x, p_c, o_x, o_c, attrs


def run_both(jcfg, targets_twice=False, seed=0):
    params = carca_init(jax.random.PRNGKey(seed), jcfg)
    p_x, p_c, o_x, o_c, attrs = make_inputs(seed)
    groups = [(o_x, None, o_c)] * (2 if targets_twice else 1)
    want = np.asarray(jax_carca_apply(
        params, jcfg, (p_x, None, p_c), groups, train=False, attrs_table=attrs))

    model = CARCA(model_config_from_jax(dataclasses.asdict(jcfg)))
    load_into(model, jax.tree.map(np.asarray, params)).eval()
    t = torch.from_numpy
    with torch.no_grad():
        got = carca_apply(model, (t(p_x), None, t(p_c)),
                          [(t(o_x), None, t(o_c))] * len(groups),
                          attrs_table=t(attrs)).numpy()
    return got, want


def jax_cfg(**kw):
    base = dict(n_items=N_ITEMS, n_attrs=N_ATTRS, n_ctx=N_CTX, d=16, g=32,
                seq_len=L, target_len=T, n_blocks=2, n_heads=2, dropout=0.0,
                use_pallas=False)
    base.update(kw)
    return JaxModelConfig(**base)


@pytest.mark.parametrize("decoder", ["ca", "dot", "wdot"])
@pytest.mark.parametrize("embedding", ["all", "attrctx", "attr", "id", "mlpid"])
def test_carca_apply_matches_jax(embedding, decoder):
    got, want = run_both(jax_cfg(embedding=embedding, decoder=decoder,
                                 l2_norm=decoder == "wdot"))
    assert got.shape == want.shape == (B, T)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("encoding", ["identity", "learnable", "positional"])
def test_encodings_match_jax(encoding):
    got, want = run_both(jax_cfg(encoding=encoding, decoder="ca"), seed=1)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_same_shape_target_groups_fold_matches_jax():
    got, want = run_both(jax_cfg(decoder="ca"), targets_twice=True, seed=2)
    assert got.shape == (B, 2 * T)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_fresh_init_is_seeded_and_zero_pads():
    cfg = model_config_from_jax(dataclasses.asdict(jax_cfg()))
    a = CARCA(cfg, generator=torch.Generator().manual_seed(5))
    b = CARCA(cfg, generator=torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert torch.count_nonzero(a.embed.items[0]) == 0
