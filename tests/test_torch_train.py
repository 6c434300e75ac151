"""The port's train step against the JAX package's, on the CPU.

Weights come from ``carca_tpu.models.carca.carca_init`` through
``carca_tpu_torch.bridge``; batches from the JAX package's
``assemble_train``, as numpy arrays. Dropout is 0 wherever values are
compared (the two frameworks' random bits cannot agree).

Tolerances, each from float32 summation order: losses 1e-6 absolute;
parameter gradients 1e-4 relative norm per tensor (a bias's gradient sums
every batch position, positives and negatives cancelling, in another
order: 3e-5 was seen), the norm floored at 1e-3 of the whole
gradient's — the key projections' bias gets a gradient that exact
arithmetic makes zero (softmax ignores a per-row shift), so both sides hold
rounding noise there; Adam parameters 1e-6 absolute after 3
updates of size ~lr = 1e-3 (torch folds the bias corrections into the step
size and the denominator, optax divides the moments: the same math,
rounded at other places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from carca_tpu.config import ModelConfig as JaxModelConfig
from carca_tpu.config import TrainConfig as JaxTrainConfig
from carca_tpu.data.device_pipeline import DeviceDataset as JaxDeviceDataset
from carca_tpu.data.device_pipeline import assemble_train as jax_assemble_train
from carca_tpu.data.synthetic import synthetic_catalog as jax_synthetic_catalog
from carca_tpu.models.carca import carca_init
from carca_tpu.models.losses import masked_bce as jax_masked_bce
from carca_tpu.models.losses import sampled_softmax as jax_sampled_softmax
from carca_tpu.train.loop import train_loss as jax_train_loss
from carca_tpu.train.state import make_optimizer as jax_make_optimizer
from carca_tpu.train.state import make_schedule as jax_make_schedule
from carca_tpu_torch import bench
from carca_tpu_torch.bridge import (load_into, model_config_from_jax, params_from_jax,
                                    train_config_from_jax)
from carca_tpu_torch.config import TrainConfig
from carca_tpu_torch.data.device_pipeline import DeviceDataset
from carca_tpu_torch.data.synthetic import synthetic_catalog
from carca_tpu_torch.models.carca import CARCA
from carca_tpu_torch.models.losses import masked_bce, sampled_softmax
from carca_tpu_torch.ops.flash_attention import attention_bwd, fused_attention
from carca_tpu_torch.train.loop import (make_device_train_step,
                                        make_scanned_device_train_step, train_loss)
from carca_tpu_torch.train.state import create_train_state, make_optimizer, make_schedule

torch.set_num_threads(1)

L, B = 8, 6
LOSS_TOL, GRAD_TOL, ADAM_TOL = 1e-6, 1e-4, 1e-6


def jax_cfg(**kw):
    base = dict(n_items=101, n_attrs=12, n_ctx=4, d=16, g=32, seq_len=L, target_len=10,
                n_blocks=2, n_heads=2, dropout=0.0, embedding="all", encoding="identity",
                decoder="ca", use_pallas=False)
    base.update(kw)
    return JaxModelConfig(**base)


@pytest.fixture(scope="module")
def catalog():
    return jax_synthetic_catalog(n_users=60, n_real_items=100, seed=3)


def jax_batch(cat, n_neg=1, seed=0):
    dd = JaxDeviceDataset(cat, L, 10, test=True)
    rows = np.concatenate([dd.users("train")[:B - 1], [-1]]).astype(np.int32)
    got = jax_assemble_train(dd.arrays, L, cat.n_items, jnp.asarray(rows),
                             jax.random.PRNGKey(seed), n_neg=n_neg)
    return {k: np.asarray(v) for k, v in got.items() if k != "n_valid"}


def rel(a, b, floor=1e-30):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), floor)


@pytest.mark.parametrize("saturate", [False, True])
def test_masked_bce_matches_jax(saturate):
    rng = np.random.default_rng(0)
    y = rng.random((4, 10)).astype(np.float32)
    if saturate:
        y[0, :3] = 1.0  # a sigmoid saturated at exactly 1.0
        y[1, :2] = 0.0
    yt = (rng.random((4, 10)) > 0.5).astype(np.float32)
    yt[0, :3] = 0.0  # negatives at ŷ = 1: the maximum() barrier's case
    m = (rng.random((4, 10)) > 0.3).astype(np.float32)
    m[0, :3] = 1.0
    want, want_g = jax.value_and_grad(lambda p: jax_masked_bce(p, yt, m))(y)
    yy = torch.from_numpy(y).requires_grad_()
    got = masked_bce(yy, torch.from_numpy(yt), torch.from_numpy(m))
    got.backward()
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(yy.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-5)


def test_masked_bce_all_masked_is_zero():
    y = torch.full((2, 3), 0.5, requires_grad=True)
    loss = masked_bce(y, torch.ones(2, 3), torch.zeros(2, 3))
    loss.backward()
    assert loss.item() == 0.0 and float(jax_masked_bce(np.full((2, 3), .5), np.ones((2, 3)),
                                                       np.zeros((2, 3)))) == 0.0
    assert torch.isfinite(y.grad).all()


@pytest.mark.parametrize("logq_on", [False, True])
@pytest.mark.parametrize("n_groups", [2, 4])
def test_sampled_softmax_matches_jax(logq_on, n_groups):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, n_groups * 5)).astype(np.float32) * 3
    o_x = rng.integers(1, 30, size=(3, n_groups * 5)).astype(np.int32)
    o_x[0, :2] = 0  # padded positive slots
    logq = (np.log(rng.random(30) + 0.01) if logq_on else None)
    logq = None if logq is None else logq.astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda z: jax_sampled_softmax(z, o_x, n_groups, logq=logq))(logits)
    zz = torch.from_numpy(logits).requires_grad_()
    got = sampled_softmax(zz, torch.from_numpy(o_x), n_groups,
                          logq=None if logq is None else torch.from_numpy(logq))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(zz.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)
    zero = sampled_softmax(zz, torch.zeros_like(torch.from_numpy(o_x)), n_groups)
    assert zero.item() == 0.0


@pytest.mark.parametrize("use_pallas,loss_kind,n_neg", [
    (False, "bce", 1), (True, "bce", 1), (False, "softmax", 2)])
def test_train_loss_and_gradients_match_jax(catalog, use_pallas, loss_kind, n_neg):
    """Loss and every parameter's gradient of one train step, dropout 0,
    against ``jax.value_and_grad`` of the JAX package's ``train_loss``
    (with ``use_pallas=True`` the JAX side runs B1/B2 in interpret mode)."""
    jcfg = jax_cfg(use_pallas=use_pallas)
    params = carca_init(jax.random.PRNGKey(7), jcfg)
    batch = jax_batch(catalog, n_neg=n_neg)
    attrs = np.asarray(catalog.attrs, np.float32)
    logq = (np.log(np.arange(1, catalog.n_items + 1, dtype=np.float32) / catalog.n_items)
            if loss_kind == "softmax" else None)
    want, want_g = jax.value_and_grad(lambda p: jax_train_loss(
        jcfg, p, batch, jax.random.PRNGKey(0), attrs, loss_kind=loss_kind,
        logq=logq))(params)

    model = CARCA(model_config_from_jax(dataclasses.asdict(jcfg)), device="cpu")
    load_into(model, jax.tree.map(np.asarray, params)).train()
    tb = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    got = train_loss(model, tb, torch.from_numpy(attrs), loss_kind=loss_kind,
                     logq=None if logq is None else torch.from_numpy(logq))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_TOL, atol=LOSS_TOL)
    want_grads = params_from_jax(jax.tree.map(np.asarray, want_g), model.cfg)
    assert set(want_grads) == {n for n, _ in model.named_parameters()}
    floor = 1e-3 * np.sqrt(sum(float((g.double() ** 2).sum()) for g in want_grads.values()))
    for name, p in model.named_parameters():
        assert rel(p.grad.numpy(), want_grads[name].numpy(), floor) <= GRAD_TOL, name


def test_adam_with_l2_and_cosine_matches_optax():
    """torch.optim.Adam fed the JAX package's gradients, against
    ``make_optimizer(tc).update``, 3 updates with l2_reg > 0 and a cosine
    schedule. Both sides get the same gradients, so Adam's amplification of
    near-zero gradients' signs stays out of the comparison."""
    jcfg = jax_cfg()
    jtc = JaxTrainConfig(lr=1e-3, l2_reg=1e-2, lr_schedule="cosine", lr_decay_steps=4,
                         lr_decay_rate=0.2)
    params = carca_init(jax.random.PRNGKey(1), jcfg)
    tx = jax_make_optimizer(jtc)
    opt_state = tx.init(params)
    model = CARCA(model_config_from_jax(dataclasses.asdict(jcfg)), device="cpu")
    load_into(model, jax.tree.map(np.asarray, params))
    tc = train_config_from_jax(jtc)
    state = create_train_state(model.cfg, tc, device="cpu", model=model)
    rng = np.random.default_rng(2)
    for step in range(3):
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        g = params_from_jax(grads, model.cfg)
        for name, p in model.named_parameters():
            p.grad = g[name].clone()
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(step)
        state.optimizer.step()
        want = params_from_jax(jax.tree.map(np.asarray, params), model.cfg)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=0, atol=ADAM_TOL, err_msg=f"{name} step {step}")


@pytest.mark.parametrize("kind,rate", [("cosine", 0.1), ("exponential", 0.5), ("none", 0.1)])
def test_schedules_match_optax(kind, rate):
    jtc = JaxTrainConfig(lr=2e-3, lr_schedule=kind, lr_decay_steps=10, lr_decay_rate=rate)
    want, got = jax_make_schedule(jtc), make_schedule(train_config_from_jax(jtc))
    if kind == "none":
        assert want is None and got is None
        return
    for count in (0, 1, 5, 10, 17):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6)


def test_make_optimizer_is_torch_adam_with_the_reference_settings():
    tc = TrainConfig(lr=3e-3, beta1=0.8, beta2=0.9, l2_reg=0.5)
    opt = make_optimizer(tc, [torch.nn.Parameter(torch.zeros(2))])
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.Adam)
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        3e-3, (0.8, 0.9), 1e-8, 0.5)


def small_setup(dropout=0.5):
    cat = synthetic_catalog(n_users=60, n_real_items=100, seed=3)
    mc = model_config_from_jax(dataclasses.asdict(jax_cfg(dropout=dropout, use_pallas="auto")))
    tc = TrainConfig(batch_size=B, inner_steps=2)
    dd = DeviceDataset(cat, L, 10, device="cpu")
    users = dd.users("train")
    rows = torch.as_tensor(np.stack([users[:B], users[B:2 * B]]), dtype=torch.int64)
    return mc, tc, dd, torch.as_tensor(cat.attrs), rows


@pytest.mark.parametrize("variant", ["reference", "full-history popularity softmax"])
def test_scanned_step_equals_single_steps(variant):
    """K = 2 steps in one call equal two single steps from the same
    generators: same losses, bit-equal parameters. The second variant
    rejects negatives against the full history, draws them by popularity
    (3 per positive) and trains the logQ-corrected sampled softmax."""
    mc, tc, dd, attrs, rows = small_setup()
    kw = {}
    if variant != "reference":
        tc = dataclasses.replace(tc, loss="softmax", n_train_negatives=3)
        counts = torch.bincount(dd.arrays["items"].long(), minlength=mc.n_items).float()
        kw = dict(reject_width=dd.hist_max, neg_pop=True,
                  logq=torch.log(counts.clamp_min(1.0) / counts.sum()))
    a = create_train_state(mc, tc, device="cpu")
    b = create_train_state(mc, tc, device="cpu")
    a, losses = make_scanned_device_train_step(mc, 2, tc, **kw)(a, attrs, dd.arrays, rows)
    step = make_device_train_step(mc, tc, **kw)
    single = []
    for r in rows:
        b, loss = step(b, attrs, dd.arrays, r)
        single.append(loss)
    assert losses.shape == (2,) and torch.equal(losses, torch.stack(single))
    assert a.step == b.step == 2
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    assert torch.isfinite(losses).all()


def test_train_step_moves_the_weights_and_uses_the_kernel_switch_on_cpu():
    """use_kernel="auto" (the default) on CPU tensors trains through the
    wrapper's plain version: no kernel launches, the weights move."""
    mc, tc, dd, attrs, rows = small_setup()
    assert mc.use_kernel == "auto"
    state = create_train_state(mc, tc, device="cpu")
    before = [p.detach().clone() for p in state.model.parameters()]
    launches = (fused_attention.launches, attention_bwd.launches)
    state, loss = make_device_train_step(mc, tc)(state, attrs, dd.arrays, rows[0])
    assert (fused_attention.launches, attention_bwd.launches) == launches
    assert loss.ndim == 0 and torch.isfinite(loss)
    assert any(not torch.equal(p, q) for p, q in zip(state.model.parameters(), before))
    assert state.model.training


def test_unported_options_raise():
    """The bridge keeps a mesh; the row-sparse Adam (ported) builds, and a
    step refuses a state built for the other item-table optimizer."""
    mc, tc, dd, attrs, rows = small_setup()
    sparse_tc = dataclasses.replace(tc, sparse_items_adam=True)
    step = make_device_train_step(mc, sparse_tc)
    with pytest.raises(ValueError, match="item-table Adam"):
        step(create_train_state(mc, sparse_tc, device="cpu"), attrs, dd.arrays, rows[0])
    state, loss = step(create_train_state(mc, sparse_tc, device="cpu", sparse_items=True),
                       attrs, dd.arrays, rows[0])
    assert torch.isfinite(loss) and state.items_state["count"] == 1
    with pytest.raises(ValueError, match="unknown config"):
        bench.build_setup("100m", device="cpu")
    assert train_config_from_jax(JaxTrainConfig(mesh_shape=(8,))).mesh_shape == (8,)
    assert train_config_from_jax(JaxTrainConfig(sparse_items_adam=True)).sparse_items_adam is True
    with pytest.raises(ValueError, match="loss"):
        TrainConfig(loss="hinge")


def test_train_config_from_jax_keeps_the_step_fields():
    jtc = JaxTrainConfig(lr=5e-4, loss="softmax", n_train_negatives=3, beta2=0.99,
                         l2_reg=1e-4, batch_size=128, seed=4, inner_steps=2, epochs=7)
    tc = train_config_from_jax(jtc)
    for f in dataclasses.fields(TrainConfig):
        assert getattr(tc, f.name) == getattr(jtc, f.name), f.name
    assert TrainConfig() == train_config_from_jax(JaxTrainConfig())


def test_bench_setup_is_the_flagship_shape_on_cpu():
    """bench.build_setup builds bench.py's flagship model and batches (the
    timing itself needs a card)."""
    s = bench.build_setup("flagship", batch=256, device="cpu")
    mc = s.mc
    assert (mc.d, mc.g, mc.n_blocks, mc.n_heads, mc.seq_len, mc.target_len) == (
        64, 256, 2, 2, 50, 100)
    assert (mc.dropout, mc.embedding, mc.encoding, mc.decoder, mc.use_kernel) == (
        0.5, "all", "identity", "ca", "auto")
    assert s.inner == 8 and len(s.chunks) == 4
    assert all(c.shape == (8, 256) and bool((c >= 0).all()) for c in s.chunks)
    assert s.dd.n_items == 2001
