"""Rank groups for the port's multi-device tests on the CPU.

``launch(world, suite, payload)`` starts ``world`` processes of this file
with the environment torchrun gives its ranks (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, a localhost rendezvous); each joins the gloo group through
``carca_tpu_torch.parallel.mesh.initialize_distributed(device="cpu")``,
runs ``SUITES[suite](payload)`` and pickles what it returns. ``launch``
returns the ranks' results in rank order, and raises with the ranks'
stderr if one fails or the group outlives ``timeout``.
``launch_and_kill(world, suite, payload, watch)`` starts them the same way
and SIGKILLs one rank once the path ``watch`` exists (the failure path of
a mesh run); it returns the ranks' exit codes.

The ranks import torch, numpy and the port only, never jax: the test
modules hold the JAX references and pass plain arrays in the payload.

    python tests/torch_ranks.py SUITE PAYLOAD.pkl OUT_DIR   # one rank (env as above)
"""

from __future__ import annotations

import io
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(world: int, suite: str, payload, tmp: str) -> list:
    """The ranks' processes, each with its stderr (and stdout) in
    ``tmp/rank{r}.err``: [(Popen, file), ...]."""
    with open(os.path.join(tmp, "payload.pkl"), "wb") as fh:
        pickle.dump(payload, fh)
    port = _free_port()
    procs = []
    for r in range(world):
        env = {k: v for k, v in os.environ.items() if k not in ("PYTHONSTARTUP",)}
        env.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        err = open(os.path.join(tmp, f"rank{r}.err"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, suite, os.path.join(tmp, "payload.pkl"), tmp],
            env=env, cwd=str(ROOT), stdout=err, stderr=subprocess.STDOUT), err))
    return procs


def _logs(tmp: str, world: int) -> str:
    return "".join(f"--- rank {r} ---\n" + Path(tmp, f"rank{r}.err").read_text()[-3000:]
                   for r in range(world))


def _reap(procs) -> None:
    for p, err in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
        err.close()


def launch(world: int, suite: str, payload, timeout: float = 240.0) -> list:
    with tempfile.TemporaryDirectory(prefix="carca_ranks_") as tmp:
        procs = _start(world, suite, payload, tmp)
        failed = []
        for r, (p, err) in enumerate(procs):
            try:
                rc = p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q, _ in procs:
                    q.kill()
                rc = "timeout"
            err.close()
            if rc != 0:
                failed.append((r, rc))
        if failed:
            raise RuntimeError(f"ranks {failed} failed\n{_logs(tmp, world)}")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out


def launch_and_kill(world: int, suite: str, payload, watch: str, victim: int = 1,
                    grace: float = 60.0, timeout: float = 300.0) -> list:
    """Start the ranks as ``launch`` does; once the path ``watch`` exists,
    SIGKILL rank ``victim``. A survivor that outlives the kill by ``grace``
    seconds is killed too (the supervisor's part). Returns the ranks'
    return codes; raises if ``watch`` never appears within ``timeout`` or
    the ranks all end before it does."""
    with tempfile.TemporaryDirectory(prefix="carca_ranks_") as tmp:
        procs = _start(world, suite, payload, tmp)
        try:
            end = time.monotonic() + timeout
            while not os.path.exists(watch):
                if all(p.poll() is not None for p, _ in procs):
                    raise RuntimeError(f"the ranks ended before {watch} appeared\n"
                                       f"{_logs(tmp, world)}")
                if time.monotonic() > end:
                    raise RuntimeError(f"no {watch} within {timeout} s\n{_logs(tmp, world)}")
                time.sleep(0.01)
            procs[victim][0].kill()
            end = time.monotonic() + grace
            for p, _ in procs:
                try:
                    p.wait(timeout=max(0.0, end - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
        finally:
            _reap(procs)
        return [p.returncode for p, _ in procs]


# --------------------------------------------------------------------------
# the ranks' side: torch, numpy and the port only
# --------------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy().copy()


def _model(mc, params):
    import torch

    from carca_tpu_torch.models.carca import CARCA

    model = CARCA(mc, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    return model


def _whole_params(state, mesh, sharded: bool):
    from carca_tpu_torch.parallel.mesh import gather_rows

    out = {n: _np(p) for n, p in state.model.named_parameters()}
    grads = {n: (_np(p.grad) if p.grad is not None else None)
             for n, p in state.model.named_parameters()}
    if sharded:
        n_items = state.model.cfg.n_items
        items = state.model.embed.items
        out["embed.items"] = _np(gather_rows(items.detach(), mesh, n_items))
        grads["embed.items"] = (None if items.grad is None
                                else _np(gather_rows(items.grad, mesh, n_items)))
    return out, grads


def _row_state(state, mesh, sharded: bool):
    """The row-sparse Adam's (munu, count), munu whole (pad rows cut)."""
    from carca_tpu_torch.parallel.mesh import gather_rows

    rows = state.items_state
    munu = rows["munu"]
    if sharded:
        munu = gather_rows(munu, mesh, state.model.cfg.n_items)
    return _np(munu), int(rows["count"])


def suite_parallel(p):
    """Cases (a)-(d) and (g) of tests/test_torch_parallel.py."""
    import dataclasses
    import itertools

    import numpy as np
    import torch

    from carca_tpu_torch.config import Config, DataConfig
    from carca_tpu_torch.data.device_pipeline import DeviceDataset, assemble_train
    from carca_tpu_torch.data.synthetic import synthetic_catalog
    from carca_tpu_torch.ops.retrieval_topk import QuantizedIndex
    from carca_tpu_torch.parallel.embedding import make_sharded_lookup
    from carca_tpu_torch.parallel.mesh import (all_reduce_sum, gather_rows_on_rank0, local_rows,
                                               make_mesh, prepare_state_for_mesh, shard_batch)
    from carca_tpu_torch.parallel.retrieval import full_catalog_topk, topk_given_queries_sharded
    from carca_tpu_torch.parallel.step import (make_sharded_device_train_step,
                                               make_sharded_train_step)
    from carca_tpu_torch.train.loop import _sparse_device_update, attrs_dtype, fit
    from carca_tpu_torch.train.state import create_train_state

    out = {}
    m22 = make_mesh((2, 2), ("data", "model"))
    m4 = make_mesh((4,), ("data",))
    m14 = make_mesh((1, 4), ("data", "model"))

    # (a) the sharded lookup at 2x2: values, and the block's gradient before
    # and after the sum over data
    lk = p["lookup"]
    ids = shard_batch({"ids": torch.as_tensor(lk["ids"])}, m22)["ids"]
    co = shard_batch({"co": torch.as_tensor(lk["co"])}, m22)["co"]
    lookup = make_sharded_lookup(m22)
    got = {}
    for name in ("f32", "bf16"):
        table = torch.as_tensor(lk["table"])
        if name == "bf16":
            table = table.to(torch.bfloat16)
        block = local_rows(table, m22).clone().requires_grad_(name == "f32")
        rows = lookup(block, ids)
        got[f"rows_{name}"] = _np(rows.float())
        if name == "f32":
            (rows * co).sum().backward()
            got["grad_local"] = _np(block.grad)
            got["grad_summed"] = _np(all_reduce_sum(block.grad.clone(), m22.data_group))
    out["lookup"] = got

    # (b) the sharded top-k at 2 shards (2x2: each data rank a replica) and
    # 4 shards (1x4), f32 and int8, with exclude, row_ids and pad rows
    tk = p["topk"]
    mc = tk["mc"]
    res = {}
    for mesh, tag in ((m22, 2), (m14, 4)):
        for kind in ("f32", "int8"):
            idx = tk[f"index_{tag}_{kind}"]
            if kind == "int8":
                e = QuantizedIndex(local_rows(torch.as_tensor(idx[0]), mesh).contiguous(),
                                   local_rows(torch.as_tensor(idx[1]).T, mesh).T.contiguous())
            else:
                e = local_rows(torch.as_tensor(idx), mesh).contiguous()
            for use_kernel in (True, False):
                v, i = topk_given_queries_sharded(
                    torch.as_tensor(tk["q"]), e, mc, tk["k"], mesh,
                    exclude=torch.as_tensor(tk["exclude"]),
                    row_ids=torch.as_tensor(tk["row_ids"]), use_kernel=use_kernel)
                res[(tag, kind, use_kernel)] = (_np(v), _np(i))
    # full_catalog_topk's mesh branch at 2x2 against its one-device branch
    fc = p["full_catalog"]
    model = _model(fc["mc"], fc["params"]).eval()
    one = full_catalog_topk(model, tuple(torch.as_tensor(x) if x is not None else None
                                         for x in fc["profile"]),
                            torch.as_tensor(fc["attrs"]), fc["k"],
                            exclude=torch.as_tensor(fc["exclude"]))
    sh = _model(fc["mc"], fc["params"]).eval()
    state = create_train_state(fc["mc"], fc["tc"], device="cpu", model=sh)
    prepare_state_for_mesh(state, m22, True)
    prof = shard_batch({"p_x": torch.as_tensor(fc["profile"][0]),
                        "p_c": torch.as_tensor(fc["profile"][2]),
                        "exclude": torch.as_tensor(fc["exclude"])}, m22)
    with torch.inference_mode():
        two = full_catalog_topk(sh, (prof["p_x"], None, prof["p_c"]),
                                local_rows(torch.as_tensor(fc["attrs"]), m22).contiguous(),
                                fc["k"], exclude=prof["exclude"], mesh=m22)
    res["full_catalog"] = (_np(shard_batch({"v": one[0]}, m22)["v"]),
                           _np(shard_batch({"i": one[1]}, m22)["i"]), _np(two[0]), _np(two[1]))
    out["topk"] = res

    # (c) one host-pipeline step at 2x2 with sharded tables from the JAX
    # package's parameters (dropout 0)
    st = p["step"]
    mc, tc = st["mc"], st["tc"]
    state = create_train_state(mc, tc, device="cpu", model=_model(mc, st["params"]))
    prepare_state_for_mesh(state, m22, True)
    attrs = local_rows(torch.as_tensor(st["attrs"]), m22).contiguous()
    batch = {k: torch.as_tensor(v) for k, v in st["batch"].items()}
    state, loss = make_sharded_train_step(mc, tc, m22, shard_embeddings=True)(
        state, attrs, batch)
    params, grads = _whole_params(state, m22, True)
    out["step"] = {"loss": float(loss), "params": params, "grads": grads}
    # the same step drawing its negatives on the device (device_sampling)
    state = create_train_state(mc, tc, device="cpu", model=_model(mc, st["params"]))
    prepare_state_for_mesh(state, m22, True)
    state, loss = make_sharded_train_step(mc, tc, m22, shard_embeddings=True,
                                          device_negatives=True)(state, attrs, batch)
    out["step_device_negatives"] = {"loss": float(loss), "params": _whole_params(
        state, m22, True)[0]}

    # (c') two row-sparse updates at 2x2 with row-sharded tables, on the
    # global host batches, from the JAX package's parameters (dropout 0)
    sp = p["sparse_step"]
    mc, tc = sp["mc"], sp["tc"]
    state = create_train_state(mc, tc, device="cpu", model=_model(mc, sp["params"]))
    prepare_state_for_mesh(state, m22, True, sparse_items=True)
    state.model.train()
    attrs = local_rows(torch.as_tensor(sp["attrs"]), m22).contiguous()
    lookup = make_sharded_lookup(m22)
    losses, munus = [], []
    for b in sp["batches"]:
        loss = _sparse_device_update(tc, state, {k: torch.as_tensor(v) for k, v in b.items()},
                                     attrs, mesh=m22, lookup=lookup)
        losses.append(float(loss))
        munus.append(_row_state(state, m22, True))
    out["sparse_step"] = {"losses": losses, "params": _whole_params(state, m22, True)[0],
                          "row_states": munus, "block_rows": state.model.embed.items.shape[0]}

    # (d) the K-step device train step (K = 2) at mesh 4 and 2x2 against the
    # port's single-device step (run by the test), from the same state, with
    # the dense and with the row-sparse item Adam
    dv = p["device_step"]
    mc, tc = dv["mc"], dv["tc"]
    cat = synthetic_catalog(**dv["catalog"])
    dd = DeviceDataset(cat, mc.seq_len, mc.target_len, device="cpu")
    rows = torch.as_tensor(dv["rows"])
    attrs_whole = torch.as_tensor(cat.attrs, dtype=attrs_dtype(mc))
    dres = {}
    for (mesh, tag, shard), sparse in itertools.product(
            ((m4, "4", False), (m22, "2x2", True)), (False, True)):
        state = create_train_state(mc, tc, device="cpu")
        batches = []
        probe = torch.Generator().set_state(state.generator.get_state())
        for r in rows:  # the batches the step draws, from a copy of its generator
            b = assemble_train(dd.arrays, mc.seq_len, mc.n_items, r, probe)
            batches.append({k: _np(v) for k, v in shard_batch(b, mesh).items()})
        prepare_state_for_mesh(state, mesh, shard, sparse_items=sparse)
        attrs = local_rows(attrs_whole, mesh).contiguous() if shard else attrs_whole
        step = make_sharded_device_train_step(mc, tc, mesh, shard_embeddings=shard,
                                              inner_steps=rows.shape[0], sparse_items=sparse)
        state, losses = step(state, attrs, dd.arrays, rows)
        params, _ = _whole_params(state, mesh, shard and mesh.n_model > 1)
        dres[tag, sparse] = {"losses": _np(losses), "params": params, "batches": batches,
                             "rows": _np(shard_batch({"rows": rows}, mesh, dim=1)["rows"]),
                             "d_idx": mesh.d_idx,
                             "row_state": _row_state(state, mesh, shard) if sparse else None}
    out["device_step"] = dres

    # dropout under a mesh: per data rank, shared by the model ranks of one
    # data index; the shared generators advance alike on every rank
    from carca_tpu_torch.parallel.mesh import rank_generators

    drops = {}
    for mesh, tag in ((m4, "4"), (m22, "2x2")):
        state = create_train_state(dv["mc"], dv["tc"], device="cpu")
        gen, sgen = rank_generators(state, mesh, 0.5)
        drops[tag] = {"mask": _np(torch.rand(16, generator=gen)),
                      "seed": int(torch.randint(0, 2**62, (), generator=sgen)),
                      "shared": (_np(state.generator.get_state()),
                                 _np(state.seed_generator.get_state())),
                      "d_idx": mesh.d_idx}
    out["dropout"] = drops

    # the checkpoint's gather: the whole table on rank 0 alone, block by block
    # (at 2x2 the ranks of data index 1 take no part)
    table = torch.as_tensor(lk["table"])
    whole = {}
    for mesh, tag in ((m22, "2x2"), (m14, "1x4")):
        got = gather_rows_on_rank0(local_rows(table, mesh).contiguous(), mesh, table.shape[0])
        whole[tag] = None if got is None else _np(got)
    out["gather_rank0"] = whole

    # (g) a batch the data axis does not divide
    cfg = Config(dv["mc"], DataConfig(device_pipeline=True),
                 dataclasses.replace(dv["tc"], batch_size=6, mesh_shape=(4,), epochs=1,
                                     out_dir=p["out_dir"], checkpoint=False))
    try:
        fit(cfg, cat, device="cpu", log=False)
        out["bad_batch"] = None
    except ValueError as exc:
        out["bad_batch"] = str(exc)
    assert not np.isnan(out["step"]["loss"])
    return out


def suite_mesh_fit(p):
    """Case (e) of tests/test_torch_mesh_fit.py: fits over a 2x2 mesh; for
    the row-sparse ones also the final row state, whole."""
    from carca_tpu_torch.data.synthetic import synthetic_catalog
    from carca_tpu_torch.parallel.mesh import make_mesh
    from carca_tpu_torch.train.loop import fit

    cat = synthetic_catalog(**p["catalog"])
    out = {}
    for name, cfg in p["configs"].items():
        state, final = fit(cfg, cat, device="cpu")
        out[name] = final
        if state.items_state is not None:
            tc = cfg.train
            mesh = make_mesh(tc.mesh_shape, tc.mesh_axes)
            out[name, "row_state"] = _row_state(state, mesh, tc.shard_embeddings
                                                and mesh.n_model > 1)
    return out


def suite_serve(p):
    """Case (f) of tests/test_torch_mesh_serve.py: the service with a
    row-sharded index; rank 0's stdout."""
    from carca_tpu_torch.serve import service

    out = {}
    for name, argv in p["runs"].items():
        buf = io.StringIO()
        service.main(argv, device="cpu", stdin=io.StringIO(p["stdin"]), stdout=buf)
        out[name] = buf.getvalue()
    return out


def suite_failover(p):
    """tests/test_torch_mesh_failover.py: one fit over the mesh (run a is
    killed mid-fit and never returns); the final metrics."""
    from carca_tpu_torch.data.synthetic import synthetic_catalog
    from carca_tpu_torch.train.loop import fit

    return fit(p["config"], synthetic_catalog(**p["catalog"]), device="cpu")[1]


def suite_remat(p):
    """tests/test_torch_remat.py's mesh case: the K-step device call over a
    mesh of 2 data ranks, with and without remat; losses and the state."""
    import numpy as np
    import torch

    from carca_tpu_torch.data.device_pipeline import DeviceDataset
    from carca_tpu_torch.data.synthetic import synthetic_catalog
    from carca_tpu_torch.parallel.mesh import make_mesh, prepare_state_for_mesh
    from carca_tpu_torch.parallel.step import make_sharded_device_train_step
    from carca_tpu_torch.train.state import create_train_state

    cat = synthetic_catalog(**p["catalog"])
    mesh = make_mesh((2,), ("data",))
    out = {}
    for remat_on, (mc, tc) in p["configs"].items():
        dd = DeviceDataset(cat, mc.seq_len, mc.target_len, device="cpu")
        users = dd.users("train")
        b = tc.batch_size
        rows = torch.as_tensor(np.stack([np.roll(users, -i * b)[:b]
                                         for i in range(tc.inner_steps)]), dtype=torch.int64)
        state = create_train_state(mc, tc, device="cpu")
        prepare_state_for_mesh(state, mesh, False)
        step = make_sharded_device_train_step(mc, tc, mesh, inner_steps=tc.inner_steps)
        state, losses = step(state, torch.as_tensor(cat.attrs), dd.arrays, rows)
        tensors = {f"param {n}": _np(t) for n, t in state.model.named_parameters()}
        for i, st in enumerate(state.optimizer.state.values()):
            tensors.update({f"adam {i} {k}": _np(torch.as_tensor(v)) for k, v in st.items()})
        tensors["generator"] = _np(state.generator.get_state())
        tensors["seed_generator"] = _np(state.seed_generator.get_state())
        out[remat_on] = {"losses": _np(losses), "tensors": tensors}
    return out


SUITES = {"parallel": suite_parallel, "mesh_fit": suite_mesh_fit, "serve": suite_serve,
          "failover": suite_failover, "remat": suite_remat}


def main() -> None:
    suite, payload, out_dir = sys.argv[1:4]
    import torch

    torch.set_num_threads(1)
    from carca_tpu_torch.parallel.mesh import initialize_distributed, rank

    initialize_distributed("cpu")
    with open(payload, "rb") as fh:
        p = pickle.load(fh)
    result = SUITES[suite](p)
    with open(os.path.join(out_dir, f"rank{rank()}.pkl"), "wb") as fh:
        pickle.dump(result, fh)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "carca_tpu"))
    if bad:
        raise RuntimeError(f"a rank imported {bad}")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
