"""``ModelConfig.remat`` in the port: each encoder block under activation
checkpointing (``carca_tpu_torch/models/remat.py``), the counterpart of the
JAX package's ``jax.checkpoint`` of the encoder stack
(``carca_tpu/models/carca.py:67-77``).

On the CPU (d = 16, L = 8, ~100 items, one thread):

* against the JAX package: the port's remat forward and gradients against
  ``carca_apply(remat=True)`` with ``train=False``, as
  ``tests/test_model.py::test_remat_matches_no_remat`` sets it up, the
  weights through ``bridge.py``. Values within 1e-5
  (``test_torch_model.py``'s tolerance: float32 summation order);
  gradients within 1e-4 relative norm per tensor, the norm floored at 1e-3
  of the whole gradient's (``test_torch_train.py``'s, for the same reason);
* within the port: remat against no remat in train mode at dropout 0.5 —
  the loss, every parameter's gradient and the generator's state after the
  step bit-equal — over decoder (ca, dot) and compute dtype (float32,
  bfloat16);
* across the train paths: three steps of the host step, the device
  pipeline's one-step call, the K-step call, the row-sparse item Adam and a
  2-rank gloo mesh step, remat against no remat: losses, parameters,
  Adam's state and both generators bit-equal;
* that remat keeps fewer and smaller tensors for the backward
  (``torch.autograd.graph.saved_tensors_hooks``), and keeps nothing more
  at inference;
* that the flag reaches everywhere: ``cli --remat true`` writes it to
  ``args.json`` with no note, a JAX run's ``args.json`` and the bridge
  carry it;
* no fallback: under a capture a checkpointed block's rewind takes the
  installed generators in order and raises with none or past them.

The card's cases (K1/K2 under remat against no remat, eager and through a
``GraphedStep`` capture, with the same seed count) are in
``tests/test_torch_kernels.py``.
"""

import dataclasses
import json
import types

import jax
import numpy as np
import pytest
import torch

from carca_tpu.config import ModelConfig as JaxModelConfig
from carca_tpu.config import preset as jax_preset
from carca_tpu.models.carca import carca_apply as jax_carca_apply
from carca_tpu.models.carca import carca_init
from carca_tpu_torch import cli
from carca_tpu_torch.bridge import (config_from_jax, load_into, model_config_from_jax,
                                    params_from_jax)
from carca_tpu_torch.config import TrainConfig, preset
from carca_tpu_torch.data.dataset import BatchBuilder
from carca_tpu_torch.data.device_pipeline import DeviceDataset
from carca_tpu_torch.data.synthetic import synthetic_catalog
from carca_tpu_torch.models import remat
from carca_tpu_torch.models.carca import CARCA, carca_apply
from carca_tpu_torch.serve.recommender import config_from_run_dir
from carca_tpu_torch.train.loop import (make_device_train_step, make_scanned_device_train_step,
                                        make_train_step)
from carca_tpu_torch.train.state import create_train_state
from torch_ranks import launch

torch.set_num_threads(1)

B, L, T, K, D = 6, 8, 10, 3, 16
N_ITEMS, N_ATTRS, N_CTX = 40, 5, 3
VALUE_TOL, GRAD_TOL, GRAD_NORM_FLOOR = 1e-5, 1e-4, 1e-3


def make_inputs(seed=0, b=3, t=6):
    rng = np.random.default_rng(seed)
    p_x = rng.integers(1, N_ITEMS, size=(b, L)).astype(np.int32)
    p_x[0, :3] = 0  # left padding
    p_c = rng.standard_normal((b, L, N_CTX)).astype(np.float32)
    o_x = rng.integers(1, N_ITEMS, size=(b, t)).astype(np.int32)
    o_x[1, -2:] = 0  # padded candidates
    o_c = rng.standard_normal((b, t, N_CTX)).astype(np.float32)
    attrs = rng.standard_normal((N_ITEMS, N_ATTRS)).astype(np.float32)
    attrs[0] = 0.0
    return p_x, p_c, o_x, o_c, attrs


def jax_cfg(**kw):
    base = dict(n_items=N_ITEMS, n_attrs=N_ATTRS, n_ctx=N_CTX, d=D, g=32, seq_len=L,
                target_len=6, n_blocks=2, n_heads=2, dropout=0.0, use_pallas=False)
    base.update(kw)
    return JaxModelConfig(**base)


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("decoder", ["ca", "dot"])
def test_remat_values_and_gradients_match_jax_remat(decoder):
    jcfg = jax_cfg(decoder=decoder, remat=True)
    params = carca_init(jax.random.PRNGKey(9), jcfg)
    p_x, p_c, o_x, o_c, attrs = make_inputs()

    def jax_loss(params):
        y = jax_carca_apply(params, jcfg, (p_x, None, p_c), [(o_x, None, o_c)], train=False,
                            attrs_table=attrs)
        return (y ** 2).sum()

    want, want_g = jax.value_and_grad(jax_loss)(params)
    want_grads = params_from_jax(jax.tree.map(np.asarray, want_g), model_config_from_jax(
        dataclasses.asdict(jcfg)))

    mc = model_config_from_jax(dataclasses.asdict(jcfg))
    assert mc.remat is True
    model = CARCA(mc, device="cpu")
    load_into(model, jax.tree.map(np.asarray, params)).eval()
    t = torch.from_numpy
    y = carca_apply(model, (t(p_x), None, t(p_c)), [(t(o_x), None, t(o_c))],
                    attrs_table=t(attrs))
    loss = (y ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=VALUE_TOL, atol=VALUE_TOL)
    floor = GRAD_NORM_FLOOR * float(torch.sqrt(sum((g.double() ** 2).sum()
                                                   for g in want_grads.values())))
    for name, p in model.named_parameters():
        g, w = p.grad.double(), want_grads[name].double()
        err = float((g - w).norm()) / max(float(w.norm()), floor)
        assert err <= GRAD_TOL, (name, err)


# --------------------------------------------------------------------------
# within the port: remat against no remat, train mode
# --------------------------------------------------------------------------

def forward_backward(cfg, seed_weights=1, seed_drop=3):
    """(loss, gradients, the dropout generator's state after the step) of
    one train-mode forward and backward at ``cfg``."""
    model = CARCA(cfg, generator=torch.Generator().manual_seed(seed_weights), device="cpu")
    model.train()
    p_x, p_c, o_x, o_c, attrs = (torch.from_numpy(a) for a in make_inputs(4, b=4, t=L))
    gen = torch.Generator().manual_seed(seed_drop)
    y = carca_apply(model, (p_x, None, p_c), [(o_x, None, o_c), (p_x, None, p_c)],
                    attrs_table=attrs, generator=gen)
    loss = (y ** 2).mean()
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}, gen.get_state()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decoder", ["ca", "dot"])
def test_remat_equals_no_remat_bit_for_bit_in_train_mode(decoder, compute_dtype):
    cfg = model_config_from_jax(dataclasses.asdict(jax_cfg(
        decoder=decoder, dropout=0.5, compute_dtype=compute_dtype, use_pallas="auto")))
    base = forward_backward(cfg)
    got = forward_backward(dataclasses.replace(cfg, remat=True))
    assert torch.equal(got[0], base[0])
    assert got[1].keys() == base[1].keys()
    for name in base[1]:
        assert torch.equal(got[1][name], base[1][name]), name
    assert torch.equal(got[2], base[2])
    # the dropout drew: another generator seed gives another loss
    assert not torch.equal(forward_backward(cfg, seed_drop=4)[0], base[0])


# --------------------------------------------------------------------------
# across the train paths
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cat():
    return synthetic_catalog(n_users=60, n_real_items=100, seed=3)


def small(cat, remat_on: bool):
    cfg = preset("smoke", cat.n_items, cat.n_attrs, cat.n_ctx)
    mc = dataclasses.replace(cfg.model, d=D, g=32, seq_len=L, target_len=T, n_blocks=2,
                             n_heads=2, dropout=0.5, embedding="all", decoder="ca",
                             remat=remat_on)
    tc = TrainConfig(batch_size=B, inner_steps=K, seed=5, lr_schedule="cosine",
                     lr_decay_steps=7, lr_decay_rate=0.1, l2_reg=1e-3)
    return mc, tc


def state_tensors(state) -> dict:
    out = {f"param {n}": p.detach().clone() for n, p in state.model.named_parameters()}
    for i, st in enumerate(state.optimizer.state.values()):
        out.update({f"adam {i} {k}": torch.as_tensor(v).clone() for k, v in st.items()})
    if state.items_state is not None:
        out["munu"] = state.items_state["munu"].clone()
    out["generator"] = state.generator.get_state()
    out["seed_generator"] = state.seed_generator.get_state()
    return out


def run_path(cat, path: str, remat_on: bool):
    """Three train steps of ``path`` at ``remat``: (losses, state tensors)."""
    mc, tc = small(cat, remat_on)
    sparse = path == "sparse"
    state = create_train_state(mc, tc, device="cpu", sparse_items=sparse)
    attrs = torch.as_tensor(cat.attrs)
    losses = []
    if path == "host":
        builder = BatchBuilder(cat, L, T)
        users, rng = builder.users("train"), np.random.default_rng(0)
        step = make_train_step(mc, tc)
        for i in range(K):
            b = builder.train_batch(np.roll(users, -i * B)[:B], rng)
            b.pop("n_valid")
            state, loss = step(state, attrs, b)
            losses.append(loss.reshape(1))
    else:
        dd = DeviceDataset(cat, L, T, device="cpu")
        users = dd.users("train")
        rows = torch.as_tensor(np.stack([np.roll(users, -i * B)[:B] for i in range(K)]),
                               dtype=torch.int64)
        if path == "scanned":
            state, loss = make_scanned_device_train_step(mc, K, tc)(state, attrs, dd.arrays,
                                                                    rows)
            losses.append(loss)
        else:
            step = make_device_train_step(mc, tc, sparse_items=sparse)
            for r in rows:
                state, loss = step(state, attrs, dd.arrays, r)
                losses.append(loss.reshape(1))
    assert state.step == K
    return torch.cat(losses), state_tensors(state)


@pytest.mark.parametrize("path", ["host", "device", "scanned", "sparse"])
def test_remat_equals_no_remat_on_every_train_path(cat, path):
    base_losses, base = run_path(cat, path, False)
    losses, got = run_path(cat, path, True)
    assert torch.isfinite(base_losses).all()
    assert torch.equal(losses, base_losses)
    assert got.keys() == base.keys()
    for name in base:
        assert torch.equal(got[name], base[name]), name


def test_remat_equals_no_remat_on_a_two_rank_mesh_step(cat):
    """The device pipeline's K-step call over a gloo mesh of 2 data ranks
    (each rank's dropout generators derived per step,
    ``parallel.mesh.rank_generators``), remat against no remat on every
    rank."""
    configs = {r: small(cat, r) for r in (False, True)}
    ranks = launch(2, "remat", {"configs": configs,
                                "catalog": dict(n_users=60, n_real_items=100, seed=3)})
    for res in ranks:
        assert np.isfinite(res[False]["losses"]).all()
        np.testing.assert_array_equal(res[True]["losses"], res[False]["losses"])
        assert res[True]["tensors"].keys() == res[False]["tensors"].keys()
        for name, want in res[False]["tensors"].items():
            np.testing.assert_array_equal(res[True]["tensors"][name], want, err_msg=name)
    np.testing.assert_array_equal(ranks[0][True]["losses"], ranks[1][True]["losses"])


# --------------------------------------------------------------------------
# what remat keeps
# --------------------------------------------------------------------------

def saved_for_backward(remat_on: bool, grad: bool = True):
    """(tensors, bytes) the forward of a train step keeps for its backward,
    counted by storage through ``saved_tensors_hooks``."""
    cfg = model_config_from_jax(dataclasses.asdict(jax_cfg(
        decoder="ca", dropout=0.5, remat=remat_on, use_pallas="auto")))
    model = CARCA(cfg, generator=torch.Generator().manual_seed(1), device="cpu").train()
    p_x, p_c, o_x, o_c, attrs = (torch.from_numpy(a) for a in make_inputs(4, b=4, t=L))
    kept = {}

    def pack(t):
        s = t.untyped_storage()
        kept[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
            torch.set_grad_enabled(grad):
        y = carca_apply(model, (p_x, None, p_c), [(o_x, None, o_c)], attrs_table=attrs,
                        generator=torch.Generator().manual_seed(3))
    return len(kept), sum(kept.values()), y


def test_remat_keeps_fewer_tensors_for_the_backward():
    n0, bytes0, y0 = saved_for_backward(False)
    n1, bytes1, y1 = saved_for_backward(True)
    assert torch.equal(y0, y1)
    assert n1 < n0 and bytes1 < bytes0, ((n0, bytes0), (n1, bytes1))
    # at inference nothing is kept either way, and remat changes nothing
    assert saved_for_backward(False, grad=False)[:2] == saved_for_backward(True, grad=False)[:2]


# --------------------------------------------------------------------------
# the flag, end to end
# --------------------------------------------------------------------------

SMOKE = ["--synthetic", "true", "--preset", "smoke", "--epochs", "1", "--resume", "false"]


def test_cli_remat_true_reaches_args_json_without_a_note(tmp_path, capsys):
    cli.main(SMOKE + ["--out_dir", str(tmp_path), "--remat", "true"], device="cpu")
    out = capsys.readouterr().out
    assert "note: --remat" not in out and "ignored" not in out
    with open(tmp_path / "args.json") as fh:
        assert json.load(fh)["remat"] is True
    assert config_from_run_dir(str(tmp_path)).model.remat is True
    args = cli.build_parser().parse_args(SMOKE + ["--remat", "true"])
    assert cli.config_from_args(args, 101, 12, 4).model.remat is True


def test_a_jax_runs_args_json_and_the_bridge_carry_remat(tmp_path):
    jcfg = jax_preset("beauty", 100, 8, 4)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, remat=True))
    jcfg.dump_args_json(str(tmp_path / "args.json"))
    assert config_from_run_dir(str(tmp_path)).model.remat is True
    assert config_from_jax(jcfg).model.remat is True
    assert model_config_from_jax(jcfg.model).remat is True
    assert model_config_from_jax(dataclasses.asdict(jax_cfg())).remat is False


# --------------------------------------------------------------------------
# no fallback
# --------------------------------------------------------------------------

def test_a_rewind_under_capture_takes_the_installed_generators_and_raises_without(monkeypatch):
    card = types.SimpleNamespace(device=torch.device("cuda"))  # stands in for a CUDA generator
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="needs rewind generators"):
        remat.Rewind(card)
    gens = [torch.Generator(), torch.Generator()]
    with remat.rewind_slots(gens) as taken:
        assert [remat.Rewind(card).generator() for _ in gens] == gens
        assert taken() == 2
        with pytest.raises(RuntimeError, match="more than the 2 rewind generators"):
            remat.Rewind(card)
        with pytest.raises(RuntimeError, match="already installed"):
            with remat.rewind_slots(gens):
                pass
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    g = torch.Generator().manual_seed(11)
    with remat.recording() as rec:
        r = remat.Rewind(g)
    want = torch.rand(5, generator=g)
    assert torch.equal(torch.rand(5, generator=r.generator()), want)
    assert torch.equal(torch.rand(5, generator=r.generator()), want)  # each recompute alike
    assert rec == [(g, None)]
