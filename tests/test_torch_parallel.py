"""The port's multi-device layer on the CPU (gloo): the row-sharded lookup,
the sharded top-k, the sharded train steps, against plain gathers, the
JAX package (on ``tests/conftest.py``'s virtual CPU devices) and the port's
single-device steps.

The port's ranks run once for the module, as 4 processes of
``tests/torch_ranks.py`` (``suite_parallel``), which import no jax; the
JAX references run here. Tolerances, each named where it is held:

* (a) the lookup: values and gradients exact (the cotangents are small
  integers, so every sum of them is exact in float32);
* (b) the top-k: ids equal except near-ties, whose float64 scores lie
  within ``SCORE_ORDER_TOL`` · Σ|q e| of each other;
* (c) one step at 2x2 against the JAX package's: loss 1e-6 relative,
  gradients 1e-4 relative per tensor (floored at 1e-3 of the whole
  gradient's norm), parameters 1e-5 where |g| > 1e-6 and 2·lr elsewhere
  (Adam's first step is g/(|g| + 1e-8)·lr: a gradient at rounding-noise
  size moves its parameter by anything up to lr on either side);
* (c') three row-sparse updates at 2x2 against the JAX package's
  ``_sparse_device_update`` over its sharded lookup: losses as in (c),
  parameters as in (c) with |g| taken over the steps that touch a row,
  the moments ``MOMENT_TOL`` absolute (as ``test_torch_sparse_adam.py``
  holds one device), untouched rows bit-equal, the counts equal;
* (d) K = 2 device steps at mesh 4 and 2x2 against the port's single
  device, with the dense and with the row-sparse item Adam: batches
  bit-equal, losses 1e-6 relative, parameters as in (c) with |g| taken
  over both steps (for the item table, over the steps touching the row),
  the row-sparse moments as in (c').
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carca_tpu.config import ModelConfig as JaxModelConfig
from carca_tpu.config import TrainConfig as JaxTrainConfig
from carca_tpu.data.dataset import BatchBuilder as JaxBatchBuilder
from carca_tpu.data.synthetic import synthetic_catalog as jax_synthetic_catalog
from carca_tpu.models.carca import carca_init
from carca_tpu.ops.retrieval_topk import QuantizedIndex as JaxQuantizedIndex
from carca_tpu.ops.retrieval_topk import quantize_index as jax_quantize_index
from carca_tpu.parallel import make_mesh as jax_make_mesh
from carca_tpu.parallel import make_sharded_train_step as jax_make_sharded_train_step
from carca_tpu.parallel import shard_batch as jax_shard_batch
from carca_tpu.parallel import topk_given_queries_sharded as jax_topk_sharded
from carca_tpu.parallel.embedding import make_sharded_lookup as jax_make_sharded_lookup
from carca_tpu.parallel.mesh import pad_table_rows as jax_pad_table_rows
from carca_tpu.parallel.mesh import prepare_state_for_mesh as jax_prepare_state_for_mesh
from carca_tpu.parallel.step import _jit_sharded as jax_jit_sharded
from carca_tpu.train.loop import _sparse_device_update as jax_sparse_update
from carca_tpu.train.loop import train_loss as jax_train_loss
from carca_tpu.train.state import create_train_state as jax_create_train_state
from carca_tpu.train.state import make_optimizer as jax_make_optimizer
from carca_tpu_torch.bridge import model_config_from_jax, params_from_jax, train_config_from_jax
from carca_tpu_torch.config import ModelConfig, TrainConfig
from carca_tpu_torch.data.device_pipeline import DeviceDataset, assemble_train
from carca_tpu_torch.data.synthetic import synthetic_catalog
from carca_tpu_torch.ops.retrieval_topk import SCORE_ORDER_TOL
from carca_tpu_torch.models.losses import masked_mean
from carca_tpu_torch.parallel.mesh import make_mesh
from carca_tpu_torch.train.loop import make_device_train_step, train_loss_terms
from carca_tpu_torch.train.state import create_train_state
from tests.conftest import skip_unless_devices
from tests.torch_ranks import launch

torch.set_num_threads(1)

L, B, LR = 8, 8, 1e-3
GRAD_TOL, LOSS_TOL, PARAM_TOL, TINY_GRAD = 1e-4, 1e-6, 1e-5, 1e-6
MOMENT_TOL = 1e-6
LO = 51  # 2x2: the first row of model rank 1's block (101 ids padded to 102)
K, E = 6, 3  # top-k and excluded ids per query


def jax_cfg(**kw):
    base = dict(n_items=101, n_attrs=12, n_ctx=4, d=16, g=32, seq_len=L, target_len=10,
                n_blocks=2, n_heads=2, dropout=0.0, embedding="all", encoding="identity",
                decoder="dot", use_pallas=False)
    base.update(kw)
    return JaxModelConfig(**base)


def host_batch(cat, jcfg):
    """A host train batch of B users whose two halves (the data ranks of a
    2x2 mesh) hold different numbers of valid targets."""
    builder = JaxBatchBuilder(cat, jcfg.seq_len, jcfg.target_len, test=True)
    users = builder.users("train")
    lengths = np.diff(cat.offsets)[users]
    users = np.concatenate([users[np.argsort(-lengths)][:B // 2],
                            users[np.argsort(lengths)][:B // 2]])
    batch = builder.train_batch(users, np.random.default_rng(0))
    batch.pop("n_valid")
    halves = batch["y_true"].reshape(2, B // 2, -1).sum(axis=(1, 2))
    assert halves[0] != halves[1], halves
    return {k: np.asarray(v) for k, v in batch.items()}


def sparse_batches(cat, jcfg, n=3):
    """n host train batches of B distinct users each; the first and the
    last touch row LO, the first row of model rank 1's block at 2x2, and
    the middle one does not, so LO's moments take a lazy gap."""
    builder = JaxBatchBuilder(cat, jcfg.seq_len, jcfg.target_len, test=True)
    users = builder.users("train")
    rng = np.random.default_rng(1)
    out = []
    for i in range(n):
        want = i != 1
        for _ in range(200):
            pick = rng.choice(users, B, replace=False)
            b = builder.train_batch(pick, rng)
            b.pop("n_valid")
            if (LO in b["p_x"] or LO in b["o_x"]) == want:
                break
        else:
            raise AssertionError("no batch of the wanted kind")
        out.append({k: np.asarray(v) for k, v in b.items()})
    return out


def index_payload(rng, rows, d, n_shards):
    """A decoder-space index of ``rows`` rows padded for ``n_shards``, as
    f32 and as the JAX package's int8 (the same bits go to the port)."""
    e = rng.standard_normal((rows, d)).astype(np.float32)
    e[0] = 0.0  # the pad row
    pad = (-rows) % n_shards
    e = np.concatenate([e, np.zeros((pad, d), np.float32)])
    qi = jax_quantize_index(jnp.asarray(e))
    return e, (np.asarray(qi.qvals), np.asarray(qi.scales))


@pytest.fixture(scope="module")
def world():
    """The payload, the ranks' results and the JAX references."""
    skip_unless_devices(4)
    rng = np.random.default_rng(0)
    cat = jax_synthetic_catalog(n_users=60, n_real_items=100, seed=3)
    jcfg = jax_cfg()
    mc = model_config_from_jax(dataclasses.asdict(jcfg))
    jtc = JaxTrainConfig(batch_size=B, lr=LR, seed=0)
    tc = train_config_from_jax(jtc)

    lookup = {"table": rng.standard_normal((37, 12)).astype(np.float32),
              "ids": rng.integers(0, 37, (8, 5)),
              "co": rng.integers(-2, 3, (8, 5, 12)).astype(np.float32)}

    row_ids = np.concatenate([[0], np.sort(rng.choice(np.arange(1, 101), 36, replace=False))])
    q = rng.standard_normal((4, 16)).astype(np.float32)
    topk = {"mc": mc, "k": K, "q": q, "row_ids": row_ids,
            "exclude": np.stack([rng.choice(row_ids[1:], E, replace=False) for _ in q])}
    for n in (2, 4):
        topk[f"index_{n}_f32"], topk[f"index_{n}_int8"] = index_payload(
            np.random.default_rng(n), len(row_ids), 16, n)

    params = carca_init(jax.random.PRNGKey(7), jcfg)
    np_params = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, params),
                                                          mc).items()}
    prof_users = np.arange(4)
    fc = {"mc": mc, "tc": tc, "params": np_params, "attrs": np.asarray(cat.attrs, np.float32),
          "k": K, "profile": (cat.items[cat.offsets[prof_users, None] + np.arange(L)],
                              None, np.zeros((4, L, cat.n_ctx), np.float32)),
          "exclude": rng.integers(1, 101, (4, E))}
    batch = host_batch(cat, jcfg)
    step = {"mc": mc, "tc": tc, "params": np_params, "attrs": np.asarray(cat.attrs),
            "batch": batch}
    sparse_step = dict(step, batches=sparse_batches(cat, jcfg))
    del sparse_step["batch"]

    dcat = dict(n_users=60, n_real_items=100, seed=3)
    dmc = ModelConfig(n_items=101, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx, d=16, g=32,
                      seq_len=L, target_len=10, n_blocks=2, n_heads=2, dropout=0.0,
                      decoder="ca")
    dtc = TrainConfig(batch_size=B, lr=LR, inner_steps=2)
    dd = DeviceDataset(synthetic_catalog(**dcat), L, 10, device="cpu")
    users = dd.users("train")
    drows = np.stack([users[:B], users[B:2 * B]]).astype(np.int64)
    device_step = {"mc": dmc, "tc": dtc, "catalog": dcat, "rows": drows}

    import tempfile
    with tempfile.TemporaryDirectory() as out_dir:
        payload = {"lookup": lookup, "topk": topk, "full_catalog": fc, "step": step,
                   "sparse_step": sparse_step, "device_step": device_step, "out_dir": out_dir}
        ranks = launch(4, "parallel", payload)
    return {"payload": payload, "ranks": ranks, "jcfg": jcfg, "jtc": jtc, "params": params,
            "cat": cat}


def test_sharded_lookup_values_and_gradients_exact(world):
    """(a) At 2x2, every rank's rows equal the plain gather of its data
    slice (f32 and bf16), its block's gradient equals the plain gather's
    gradient over its slice's ids, and summed over data, over the whole
    batch's ids: exact."""
    lk = world["payload"]["lookup"]
    table = torch.as_tensor(lk["table"])
    ids, co = torch.as_tensor(lk["ids"]), torch.as_tensor(lk["co"])
    for r, got in enumerate(world["ranks"]):
        d_idx, m_idx = divmod(r, 2)
        sl = slice(d_idx * 4, (d_idx + 1) * 4)
        assert np.array_equal(got["lookup"]["rows_f32"], table[ids[sl]].numpy())
        assert np.array_equal(got["lookup"]["rows_bf16"],
                              table.to(torch.bfloat16)[ids[sl]].float().numpy())
        block = slice(m_idx * 19, (m_idx + 1) * 19)  # 37 rows padded to 38
        for name, part in (("grad_local", sl), ("grad_summed", slice(None))):
            t = torch.cat([table, torch.zeros(1, 12)]).requires_grad_(True)
            (t[ids[part]] * co[part]).sum().backward()
            assert np.array_equal(got["lookup"][name], t.grad[block].numpy()), (r, name)


def test_gather_rows_on_rank0_holds_the_table_on_rank0_alone(world):
    """The checkpoint's gather at 2x2 and 1x4: rank 0 gets the whole table
    from the padded blocks, pad rows cut, exactly; every other rank gets
    None."""
    table = world["payload"]["lookup"]["table"]
    for tag in ("2x2", "1x4"):
        got = [r["gather_rank0"][tag] for r in world["ranks"]]
        assert np.array_equal(got[0], table), tag
        assert all(g is None for g in got[1:]), tag


def near_tie_only(v, ids, pv, pids, q, e_rows, row_of):
    """Ids equal except where the two sides' float64 scores of the
    differing ids lie within SCORE_ORDER_TOL of Σ|q e| of each other."""
    np.testing.assert_array_equal(np.isfinite(v), np.isfinite(pv))
    diff = (ids != pids) & np.isfinite(pv)
    for b, j in zip(*np.nonzero(diff)):
        sa = float(np.dot(q[b].astype(np.float64), e_rows[row_of[ids[b, j]]]))
        sb = float(np.dot(q[b].astype(np.float64), e_rows[row_of[pids[b, j]]]))
        mag = float(np.abs(q[b]).astype(np.float64) @ np.abs(e_rows[row_of[pids[b, j]]]))
        assert abs(sa - sb) <= SCORE_ORDER_TOL * mag, (b, j, sa, sb)
    return int(diff.sum())


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_topk_given_queries_sharded_matches_jax(world, n_shards, kind):
    """(b) Against the JAX package's topk_given_queries_sharded over a
    ``model`` mesh of the same size, with exclusions, row_ids and
    sharding-pad rows; the port with its kernel wrapper (the plain version
    on CPU tensors) and with use_kernel=False; every rank alike."""
    skip_unless_devices(n_shards)
    tk = world["payload"]["topk"]
    jcfg = world["jcfg"]
    mesh = jax_make_mesh((n_shards,), ("model",), devices=jax.devices()[:n_shards])
    idx = tk[f"index_{n_shards}_{kind}"]
    e = (JaxQuantizedIndex(jnp.asarray(idx[0]), jnp.asarray(idx[1])) if kind == "int8"
         else jnp.asarray(idx))
    # over int8 rows the JAX reference is its kernel path (the tournament,
    # in interpret mode), which scores the bf16-rounded query as the port
    # does; its plain branch scores the float query
    jv, ji = jax_topk_sharded(jnp.asarray(tk["q"]), e, jcfg, K, mesh,
                              exclude=jnp.asarray(tk["exclude"]),
                              row_ids=jnp.asarray(tk["row_ids"]), use_kernel=kind == "int8",
                              method="tournament")
    jv, ji = np.asarray(jv), np.asarray(ji)
    rows = (idx[0].astype(np.float64) * idx[1][0][:, None] if kind == "int8"
            else idx.astype(np.float64))
    row_of = {int(i): r for r, i in enumerate(tk["row_ids"])}
    q = tk["q"]
    if kind == "int8":  # the query as an int8 index scores it: rounded to bf16
        q = torch.as_tensor(q).to(torch.bfloat16).float().numpy()
    for got in world["ranks"]:
        for use_kernel in (True, False):
            v, i = got["topk"][(n_shards, kind, use_kernel)]
            assert v.shape == (4, K)
            assert not any(np.isin(i[b], tk["exclude"][b]).any() for b in range(4))
            near_tie_only(v, i, jv, ji, q, rows, row_of)
            np.testing.assert_allclose(v, jv, rtol=0, atol=SCORE_ORDER_TOL * 16 * 8)


def test_full_catalog_topk_mesh_branch_equals_one_device(world):
    """The mesh branch of full_catalog_topk at 2x2 (the profile lookups
    sharded, each rank embedding its block of the catalog) returns the
    one-device branch's values and ids for its data slice, exactly."""
    for got in world["ranks"]:
        v1, i1, v2, i2 = got["topk"]["full_catalog"]
        np.testing.assert_array_equal(i2, i1)
        np.testing.assert_array_equal(v2, v1)


def rel(a, b, floor):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), floor)


def hold_params(got, want, grad_mag, lr, steps=1):
    """Parameters within PARAM_TOL where every step's |g| > TINY_GRAD, and
    within 2·steps·lr elsewhere."""
    for name, w in want.items():
        g = got[name]
        big = grad_mag[name] > TINY_GRAD
        err = np.abs(g - w)
        assert err[big].max(initial=0.0) <= PARAM_TOL, (name, err[big].max())
        assert err.max(initial=0.0) <= 2 * steps * lr, (name, err.max())


def test_sharded_train_step_matches_jax_at_2x2(world):
    """(c) One host-pipeline step at mesh (2, 2) with row-sharded tables,
    from the same (bridged) parameters and host batch as the JAX package's
    make_sharded_train_step on a (2, 2) mesh. The batch's data halves hold
    different numbers of valid targets, so a step that averaged per-rank
    means, or averaged the gradients, would miss the global loss and the
    JAX package's gradient."""
    skip_unless_devices(4)
    jcfg, jtc, params, cat = world["jcfg"], world["jtc"], world["params"], world["cat"]
    batch = world["payload"]["step"]["batch"]
    attrs = np.asarray(cat.attrs, np.float32)
    want_loss, want_g = jax.value_and_grad(lambda p: jax_train_loss(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0),
        jnp.asarray(attrs)))(params)
    mesh = jax_make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    tx = jax_make_optimizer(jtc)
    state = jax_create_train_state(jax.random.PRNGKey(1), jcfg, jtc, tx)
    state = jax_prepare_state_for_mesh(state.replace(params=params, opt_state=tx.init(params)),
                                       mesh, tx)
    step = jax_make_sharded_train_step(jcfg, tx, mesh, shard_embeddings=True, tc=jtc)
    jstate, jloss = step(state, jnp.asarray(jax_pad_table_rows(attrs, mesh)),
                         jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh))
    np.testing.assert_allclose(float(jloss), float(want_loss), rtol=LOSS_TOL)
    mc = world["payload"]["step"]["mc"]
    want_params = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, jstate.params), mc).items()}
    want_params["embed.items"] = want_params["embed.items"][:mc.n_items]
    grads = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, want_g),
                                                      mc).items()}
    floor = 1e-3 * np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                               for g in grads.values()))
    for got in world["ranks"]:
        s = got["step"]
        np.testing.assert_allclose(s["loss"], float(jloss), rtol=LOSS_TOL)
        for name, g in grads.items():
            assert rel(s["grads"][name], g, floor) <= GRAD_TOL, name
        hold_params(s["params"], want_params, {k: np.abs(g) for k, g in grads.items()}, LR)


def test_sparse_update_at_2x2_matches_jax(world):
    """(c') Three updates of the row-sparse item Adam at mesh (2, 2) with
    row-sharded tables, on global host batches, from the same (bridged)
    parameters as the JAX package's ``_sparse_device_update`` over its
    sharded lookup on a (2, 2) mesh, its state built by
    ``prepare_state_for_mesh(sparse_items=True)``. Row LO, the first row of
    model rank 1's block, is touched in steps 1 and 3 and not in step 2 (a
    lazy gap); every batch leaves fill slots."""
    skip_unless_devices(4)
    jcfg, jtc, cat = world["jcfg"], world["jtc"], world["cat"]
    params = carca_init(jax.random.PRNGKey(7), jcfg)  # the world's (test (c) donates those)
    sp = world["payload"]["sparse_step"]
    mc = sp["mc"]
    mesh = jax_make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    tx = jax_make_optimizer(jtc)
    state = jax_create_train_state(jax.random.PRNGKey(1), jcfg, jtc, tx, sparse_items=True)
    state = jax_prepare_state_for_mesh(state.replace(params=params), mesh, tx, sparse_items=True)
    lookup = jax_make_sharded_lookup(mesh)
    attrs = np.asarray(cat.attrs, np.float32)

    def body(st, attrs_table, batch):
        rng, step_rng = jax.random.split(st.rng)
        return jax_sparse_update(jcfg, jtc, tx, st, batch, step_rng, rng, attrs_table,
                                 base_lookup=lookup)

    step = jax_jit_sharded(body, jcfg, mesh, True, donate=False)
    mag = {}
    table0 = np.asarray(state.params["embed"]["items"])[:mc.n_items]
    touched = np.zeros(mc.n_items, bool)
    for i, b in enumerate(sp["batches"]):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        g = jax.grad(lambda p: jax_train_loss(jcfg, p, jb, jax.random.PRNGKey(0),
                                              jnp.asarray(attrs)))(state.params)
        g = {k: np.abs(v.numpy()) for k, v in params_from_jax(jax.tree.map(np.asarray, g),
                                                             mc).items()}
        ids = np.unique(np.concatenate([b["p_x"].ravel(), b["o_x"].ravel()]))
        rows = np.full(mc.n_items, np.inf, np.float32)
        rows[ids] = 0.0
        g["embed.items"] = np.maximum(g["embed.items"][:mc.n_items], rows[:, None])
        mag = {k: np.minimum(mag[k], v) if k in mag else v for k, v in g.items()}
        touched[ids] = True
        state, jloss = step(state, jnp.asarray(jax_pad_table_rows(attrs, mesh)),
                            jax_shard_batch(jb, mesh))
        want_munu = np.asarray(state.opt_state["items"]["munu"])[:mc.n_items]
        for r, got in enumerate(world["ranks"]):
            s = got["sparse_step"]
            np.testing.assert_allclose(s["losses"][i], float(jloss), rtol=LOSS_TOL)
            munu, count = s["row_states"][i]
            assert count == int(state.opt_state["items"]["count"]) == i + 1
            np.testing.assert_allclose(munu, want_munu, rtol=0, atol=MOMENT_TOL,
                                       err_msg=f"rank {r} step {i}")
            assert not munu[~touched].any()
    assert LO in sp["batches"][0]["o_x"] or LO in sp["batches"][0]["p_x"]
    want = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, state.params),
                                                     mc).items()}
    want["embed.items"] = want["embed.items"][:mc.n_items]
    for got in world["ranks"]:
        s = got["sparse_step"]
        assert s["block_rows"] == 51
        hold_params(s["params"], want, mag, LR, steps=len(sp["batches"]))
        np.testing.assert_array_equal(s["params"]["embed.items"][~touched], table0[~touched])


def items_grad(state, batch, attrs):
    """|d loss / d items| of ``state``'s model on ``batch`` (a copy of the
    model, dropout 0), with rows the batch does not touch set to inf: the
    lazy Adam leaves them alone in that step, so they take no part in the
    least |g| of a row."""
    model = copy.deepcopy(state.model)
    model.zero_grad(set_to_none=True)
    masked_mean(train_loss_terms(model, batch, attrs)).backward()
    g = model.embed.items.grad.abs().numpy()
    ids = torch.unique(torch.cat([batch["p_x"].reshape(-1), batch["o_x"].reshape(-1)])).numpy()
    rows = np.full(g.shape[0], np.inf, np.float32)
    rows[ids] = 0.0
    return np.maximum(g, rows[:, None])


def single_device_steps(dv, sparse=False):
    """The port's single-device device step, twice from a fresh state:
    (the batches, the losses, the parameters, the least |g| per element,
    the row state or None)."""
    mc, tc = dv["mc"], dv["tc"]
    cat = synthetic_catalog(**dv["catalog"])
    dd = DeviceDataset(cat, mc.seq_len, mc.target_len, device="cpu")
    state = create_train_state(mc, tc, device="cpu", sparse_items=sparse)
    probe = torch.Generator().set_state(state.generator.get_state())
    rows = torch.as_tensor(dv["rows"])
    batches = [assemble_train(dd.arrays, mc.seq_len, mc.n_items, r, probe) for r in rows]
    step = make_device_train_step(mc, tc, sparse_items=sparse)
    attrs = torch.as_tensor(cat.attrs)
    losses, mag = [], {}
    for r, b in zip(rows, batches):
        g_items = items_grad(state, b, attrs) if sparse else None
        state, loss = step(state, attrs, dd.arrays, r)
        losses.append(float(loss))
        for n, p in state.model.named_parameters():
            g = g_items if (sparse and n == "embed.items") else np.abs(p.grad.numpy())
            mag[n] = np.minimum(mag[n], g) if n in mag else g
    params = {n: p.detach().numpy().copy() for n, p in state.model.named_parameters()}
    rows_state = ((state.items_state["munu"].numpy().copy(), state.items_state["count"])
                  if sparse else None)
    return batches, np.asarray(losses), params, mag, rows_state


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("mesh", ["4", "2x2"])
def test_sharded_device_train_step_equals_one_device(world, mesh, sparse):
    """(d) K = 2 device-pipeline steps in one call at mesh 4 (data
    parallel) and 2x2 (row-sharded tables) against two single-device
    steps from the same seed, with the dense and with the row-sparse item
    Adam: every data rank's slices of the batches concatenate to the
    single-device batches bit for bit; losses, parameters and moments as
    the module says."""
    dv = world["payload"]["device_step"]
    batches, losses, params, mag, rows_state = single_device_steps(dv, sparse)
    n_data = 4 if mesh == "4" else 2
    per = B // n_data
    for r, got in enumerate(world["ranks"]):
        res = got["device_step"][mesh, sparse]
        d = res["d_idx"]
        np.testing.assert_array_equal(res["rows"], dv["rows"][:, d * per:(d + 1) * per])
        for mine, whole in zip(res["batches"], batches):
            for k, v in whole.items():
                want = v.numpy() if v.ndim == 0 else v[d * per:(d + 1) * per].numpy()
                np.testing.assert_array_equal(mine[k], want, err_msg=f"rank {r} {k}")
        np.testing.assert_allclose(res["losses"], losses, rtol=LOSS_TOL)
        hold_params(res["params"], params, mag, dv["tc"].lr, steps=2)
        if sparse:
            munu, count = res["row_state"]
            assert count == rows_state[1] == 2
            np.testing.assert_allclose(munu, rows_state[0], rtol=0, atol=MOMENT_TOL)
        else:
            assert res["row_state"] is None


def test_bad_meshes_are_refused(world):
    """(g) A batch the data axis does not divide, and a mesh whose product
    is not the world size (here a world of one)."""
    for got in world["ranks"]:
        assert "not divisible by the data-axis size 4" in got["bad_batch"]
    with pytest.raises(ValueError, match="world size of 2"):
        make_mesh((2,), ("data",))
    with pytest.raises(ValueError, match="world size of 4"):
        make_mesh((2, 2), ("data", "model"))


@pytest.mark.parametrize("mesh", ["4", "2x2"])
def test_dropout_draws_differ_by_data_rank_only(world, mesh):
    """Under more than one data rank each data rank draws its own dropout
    masks and attention-kernel seeds, the model ranks of one data index the
    same ones, and the shared generators (the resume state) stay equal on
    every rank."""
    drops = [r["dropout"][mesh] for r in world["ranks"]]
    by_data = {}
    for d in drops:
        by_data.setdefault(d["d_idx"], []).append(d)
    for group in by_data.values():
        assert all(np.array_equal(g["mask"], group[0]["mask"]) and g["seed"] == group[0]["seed"]
                   for g in group)
    firsts = [g[0] for g in by_data.values()]
    assert len({f["seed"] for f in firsts}) == len(firsts) > 1
    assert not np.array_equal(firsts[0]["mask"], firsts[1]["mask"])
    for d in drops:
        for a, b in zip(d["shared"], drops[0]["shared"]):
            np.testing.assert_array_equal(a, b)


def test_sharded_train_step_draws_device_negatives(world):
    """``device_negatives`` (the host pipeline's ``device_sampling`` under a
    mesh) replaces the host batch's negatives with ones drawn on the device
    from the shared generator: every rank reports the same finite loss,
    not the host-negative step's, and the same updated parameters."""
    got = [r["step_device_negatives"] for r in world["ranks"]]
    assert np.isfinite(got[0]["loss"]) and got[0]["loss"] != world["ranks"][0]["step"]["loss"]
    for g in got[1:]:
        assert g["loss"] == got[0]["loss"]
        for name, p in g["params"].items():
            np.testing.assert_array_equal(p, got[0]["params"][name])
