"""Train-state checkpoints with best-metric retention (counterpart of
``carca_tpu/train/checkpoint.py``), written with ``torch.save``, so a run
directory is read without orbax. Under ``ckpt/``, one of each:

* ``best/params.pt`` — the best epoch's parameters (the model's
  ``state_dict``) and ``best/metrics.json`` beside them (the metrics ``fit``
  selected on, and the epoch; under ``select_by=retrieval_*`` also
  ``select_by`` and the ``select`` value compared);
* ``latest/state.pt`` — the full resume state: the model's and Adam's
  ``state_dict``, the row-sparse Adam's row state of the item table (None
  under the dense Adam), the states of both generators
  (``TrainState.generator`` and ``seed_generator``), the step, the epoch,
  the EMA shadow at that step (``ema``: its ``state_dict`` and step, None
  for a run without EMA) and ``fit``'s retention state (``progress``: the
  best selection value so far and the epochs since it improved), so that a
  resumed run retains and stops where an uninterrupted one would.

Adam's state is written in one layout whatever device trained it: every
``step`` a CPU float32 tensor and the lr a float, as the CPU's Adam keeps
them. The card's Adam (``capturable``, ``train/state.py``) holds its steps
and lr on the device; a restore loads into the live optimizer's own form
and keeps its lr tensor, so a checkpoint moves between the card and the CPU
either way, and a ``latest/`` written before the card's Adam held device
steps still resumes.

The resume state and its shadow are one file, so one ``os.replace``
commits both: no crash can leave them at different steps. A run
directory written before they were one file keeps the shadow in
``ema/ema.pt``; it still resumes, and a shadow there whose step is not
``latest/``'s is refused.

Every file is written to a temporary name in its directory
(``<name>.tmp<pid>``) and then ``os.replace``d, so a crash never leaves a
torn checkpoint; a temporary file a killed process left behind is never
read.

Saves are asynchronous, as the JAX package's orbax saves are: ``save`` and
``save_latest`` block only for the snapshot, a copy of what they save in
host memory made on the calling thread (the graph replays update the
parameters, Adam's moments, the row state and the EMA shadow in place, so
the file must not read the live tensors). A CUDA tensor streams into
fresh pageable memory through two page-locked chunks that the keeper
allocates once and reuses (``_Bounce``); a CPU tensor is copied by
``.to("cpu")``. Then they return, and a
background thread per kind (best/, latest/) runs the ``torch.save`` and
the ``os.replace`` while the next epoch trains. That thread makes no CUDA
call: the snapshot is complete before the save returns, and it is
released on the calling thread at the next wait (a CUDA call from another
thread would break a graph capture, which runs in the ``"global"`` error
mode). Each kind waits for its own earlier write before it snapshots
again; every read (``best_metrics``, ``latest_progress`` and the
restores) waits for the writes it reads, and ``wait()`` and ``close()``
for all of them. The owner of a keeper that saves calls ``close()`` when
it is done (``fit`` does, before it returns). An exception in a write is
raised again, unchanged, at the keeper's next wait, save or ``close()``.

Over a mesh (``parallel/mesh.py``) every rank calls every method; rank 0
alone writes. A save's gathers run in its snapshot, which ends in a
barrier; only rank 0's file write goes to the thread, and a wait for a
write in flight ends in a barrier, so no rank reads a file before rank 0
has written it; ``close()`` ends in a barrier. With the item table
row-sharded (``table_rows``, its true row count), a save assembles the
table and its Adam moments on rank 0 in host memory, block by block
(``gather_rows_on_rank0``: no other rank ever holds the whole table), and
cuts the pad rows, so a mesh run writes the same files a one-device run
writes; a restore re-pads and takes the rank's block, so either kind of
run resumes or serves the other's checkpoints. The row-sparse Adam's row
state of a row-sharded table (``munu``, one block per rank) travels the
same way: whole on disk, a block in each rank.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from carca_tpu_torch.parallel.mesh import Mesh, barrier, gather_rows_on_rank0, local_rows


def _replace_atomically(path: str, write) -> None:
    """Write the file at ``path`` through ``write(tmp_path)`` and a rename."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _save(obj: Any, path: str) -> None:
    _replace_atomically(path, lambda tmp: torch.save(obj, tmp))


def _load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=False)


BOUNCE_BYTES = 64 << 20  # each of the two page-locked chunks a snapshot streams through


def _page_locked(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


class _Bounce:
    """Two page-locked chunks of ``chunk_bytes`` that the snapshot of a CUDA
    tensor streams through into fresh pageable host memory, allocated at the
    keeper's first such snapshot and reused by every later one: the card
    copies chunk i into one while the host copies chunk i − 1 out of the
    other (a CPU ``copy_``, on PyTorch's threads), so the device-to-host
    copy overlaps the host's page faults and copies, where a pageable
    ``.to("cpu")`` stages through the CUDA runtime's buffers on one thread.
    Pinning the snapshot itself costs more than it saves where each kind
    saves once a fit (``PERF.md``). The chunks are drained before
    ``copy`` returns, so no writer ever reads them. Every call is made on
    the keeper's calling thread."""

    def __init__(self, chunk_bytes: int = BOUNCE_BYTES) -> None:
        self.chunk_bytes = chunk_bytes
        self.chunks: List[torch.Tensor] = []

    @property
    def nbytes(self) -> int:
        return sum(c.numel() for c in self.chunks)

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        """A pageable host copy of the CUDA tensor ``t``, bit for bit."""
        out = torch.empty(t.shape, dtype=t.dtype)
        src = t.detach().contiguous().view(-1).view(torch.uint8)
        dst = out.view(-1).view(torch.uint8)
        if not self.chunks:
            self.chunks = [_page_locked(self.chunk_bytes) for _ in range(2)]
        stream = torch.cuda.current_stream(t.device)
        inflight: List[tuple] = []  # (event, chunk, start, end), oldest first
        for i, a in enumerate(range(0, src.numel(), self.chunk_bytes)):
            if len(inflight) == 2:  # the chunk to refill: its bytes out first
                self._drain(dst, *inflight.pop(0))
            b = min(a + self.chunk_bytes, src.numel())
            chunk = self.chunks[i % 2][:b - a]
            chunk.copy_(src[a:b], non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
            inflight.append((event, chunk, a, b))
        for item in inflight:
            self._drain(dst, *item)
        return out

    @staticmethod
    def _drain(dst: torch.Tensor, event, chunk: torch.Tensor, a: int, b: int) -> None:
        event.synchronize()
        dst[a:b].copy_(chunk)


def _host_copy(obj: Any, keep: Sequence[Optional[torch.Tensor]] = (),
               bounce: Optional[_Bounce] = None) -> Any:
    """``obj`` (a state_dict, an optimizer's, and the dicts, lists and
    tuples around them) with every tensor copied to host memory, but the
    tensors in ``keep``, which are host copies already (the gathered
    item table). A state_dict keeps its ``_metadata``. With ``bounce``, a
    CUDA tensor streams through its page-locked chunks; a CPU tensor, and
    every tensor without ``bounce``, is copied by ``.to("cpu")``. Either
    way the copy is fresh pageable memory."""
    if torch.is_tensor(obj):
        if any(obj is t for t in keep):
            return obj
        if bounce is not None and obj.is_cuda:
            return bounce.copy(obj)
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        out = type(obj)((k, _host_copy(v, keep, bounce)) for k, v in obj.items())
        if hasattr(obj, "_metadata"):
            out._metadata = obj._metadata
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v, keep, bounce) for v in obj)
    return obj


class _Writer:
    """One kind's file writes (best/ or latest/), one at a time, each on a
    thread of its own. ``pending`` is set on every rank of a mesh alike,
    though rank 0 alone runs a thread."""

    def __init__(self, kind: str):
        self.kind = kind
        self.pending = False
        self._thread: Optional[threading.Thread] = None
        self._snapshot: Any = None
        self._error: Optional[BaseException] = None

    def start(self, write: Optional[Callable[[], None]], snapshot: Any) -> None:
        """``write()`` on a new thread (None: another rank writes). The
        ``snapshot`` it writes is held here, so that it is released at
        ``wait``, on the caller's thread."""
        self.pending, self._snapshot = True, snapshot
        if write is None:
            return

        def run() -> None:
            try:
                write()
            except BaseException as e:  # raised again at the next wait
                self._error = e

        self._thread = threading.Thread(target=run, name=f"checkpoint-{self.kind}")
        self._thread.start()

    def failed(self) -> bool:
        """Whether a write has ended in an exception not raised yet."""
        return (self._thread is not None and not self._thread.is_alive()
                and self._error is not None)

    def wait(self) -> Optional[BaseException]:
        """Join the write in flight and release its snapshot; its exception,
        or None."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.pending, self._snapshot = False, None
        err, self._error = self._error, None
        return err


def _portable_optimizer(sd: Dict[str, Any]) -> Dict[str, Any]:
    """An optimizer state_dict with every ``step`` a CPU float32 tensor and
    each group's lr a float (the CPU Adam's layout)."""
    state = {i: {k: v.detach().to("cpu", torch.float32) if k == "step" else v
                 for k, v in st.items()} for i, st in sd["state"].items()}
    groups = [dict(g, lr=float(g["lr"])) if torch.is_tensor(g["lr"]) else g
              for g in sd["param_groups"]]
    return dict(sd, state=state, param_groups=groups)


def _load_optimizer(optimizer: torch.optim.Optimizer, sd: Dict[str, Any]) -> None:
    """Load ``sd`` (either layout) into ``optimizer`` in its own form: a
    tensor lr stays the same tensor, holding the saved value, the
    ``capturable`` flags stay, and the steps go where the optimizer keeps
    them (its parameters' device when capturable, else the CPU)."""
    live = [(g["lr"], g.get("capturable", False)) for g in optimizer.param_groups]
    optimizer.load_state_dict(sd)
    for g, (lr, capturable) in zip(optimizer.param_groups, live):
        if torch.is_tensor(lr):
            lr.fill_(float(g["lr"]))
            g["lr"] = lr
        g["capturable"] = capturable
        for p in g["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(p.device if capturable else "cpu", torch.float32)


def _selection_metric(metrics: Dict[str, Any], select_by: str = "ndcg") -> float:
    """The value ``fit`` compared when it decided to save
    (``carca_tpu/train/checkpoint.py:31-47``): under ``select_by="ndcg"``
    the sampled NDCG; under ``select_by="retrieval_*"`` the saved
    ``select`` entry, but only from a checkpoint saved under the same
    ``select_by`` (another regime's scores 0.0, so the first save under
    this one outranks it)."""
    if select_by == "ndcg":
        return metrics["ndcg"]
    if metrics.get("select_by") == select_by:
        return metrics["select"]
    return 0.0


ITEMS = "embed.items"  # the row-sharded table's state_dict key


class CheckpointKeeper:
    """``best/``, ``latest/`` and ``ema/`` under ``directory``; best/ is
    retained by ``_selection_metric`` under ``select_by``. ``mesh`` and
    ``table_rows``: the ranks of a mesh run, and the item table's true row
    count when it is row-sharded over ``model``."""

    def __init__(self, directory: str, select_by: str = "ndcg", mesh: Optional[Mesh] = None,
                 table_rows: Optional[int] = None):
        self.select_by = select_by
        self.mesh = mesh
        self.table_rows = table_rows
        self.writer = mesh is None or mesh.rank == 0
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.best_params = os.path.join(self.dir, "best", "params.pt")
        self.best_sidecar = os.path.join(self.dir, "best", "metrics.json")
        self.latest = os.path.join(self.dir, "latest", "state.pt")
        self.legacy_ema = os.path.join(self.dir, "ema", "ema.pt")  # before the shadow joined latest/
        self._resumed: Optional[Dict[str, Any]] = None  # what restore_latest read beside the state
        self._best, self._latest = _Writer("best"), _Writer("latest")
        self._bounce = _Bounce()  # the snapshots' page-locked chunks

    def _whole(self, sd: Dict[str, Any], gather: Callable) -> Dict[str, Any]:
        """A state_dict with the item table whole on rank 0 (in host memory,
        through ``gather``), None in its place on the other ranks."""
        if self.table_rows is None or ITEMS not in sd:
            return sd
        return dict(sd, **{ITEMS: gather(sd[ITEMS])})

    def _gather(self, block: torch.Tensor) -> Optional[torch.Tensor]:
        return gather_rows_on_rank0(block, self.mesh, self.table_rows)

    def _block(self, sd: Dict[str, Any]) -> Dict[str, Any]:
        """A whole state_dict with the item table cut to this rank's block."""
        if self.table_rows is None or ITEMS not in sd:
            return sd
        return dict(sd, **{ITEMS: local_rows(sd[ITEMS], self.mesh)})

    def _moments(self, state, sd: Dict[str, Any], convert) -> Dict[str, Any]:
        """An optimizer state_dict of ``state``'s Adam with the item table's
        moments passed through ``convert`` (the state_dict keys a parameter
        by its place in the param groups, the same in both layouts)."""
        if self.table_rows is None or not hasattr(state.model.embed, "items"):
            return sd
        ids = [id(p) for g in state.optimizer.param_groups for p in g["params"]]
        if id(state.model.embed.items) not in ids:
            return sd  # the row-sparse Adam holds the table's moments
        slot = ids.index(id(state.model.embed.items))
        if slot not in sd["state"]:
            return sd
        moments = {k: convert(v) if k in ("exp_avg", "exp_avg_sq") else v
                   for k, v in sd["state"][slot].items()}
        return dict(sd, state={**sd["state"], slot: moments})

    def _gatherer(self) -> tuple:
        """(gather, gathered): ``gather(block)`` is ``_gather``, and
        ``gathered`` lists what it returned, host copies of their own."""
        gathered: List[Optional[torch.Tensor]] = []

        def gather(block: torch.Tensor) -> Optional[torch.Tensor]:
            gathered.append(self._gather(block))
            return gathered[-1]

        return gather, gathered

    def _start(self, writer: _Writer, snapshot: Any, gathered: list,
               write: Callable[[Any], None]) -> None:
        """Snapshot ``snapshot`` to host memory (rank 0 alone writes, so the
        other ranks copy nothing) and hand ``write(host copy)`` to
        ``writer``'s thread; under a mesh every rank then meets at a
        barrier."""
        if self.writer:
            host = _host_copy(snapshot, gathered, self._bounce)
            writer.start(lambda: write(host), host)
        else:
            writer.start(None, None)
        if self.mesh is not None:
            barrier()

    def _wait(self, *writers: _Writer) -> None:
        """Wait for ``writers``' writes in flight; under a mesh every rank
        then meets at a barrier, so that no rank reads a file rank 0 has
        not written. Raises a write's exception, unchanged."""
        pending = [w for w in writers if w.pending]
        errors = [w.wait() for w in pending]
        if pending and self.mesh is not None:
            barrier()
        for err in errors:
            if err is not None:
                raise err

    def _raise_failed(self) -> None:
        """Raise the exception of a write that has ended in one (a save's
        first step, so that no failed write goes unreported until close)."""
        for w in (self._best, self._latest):
            if w.failed():
                raise w.wait()

    def wait(self) -> None:
        """Wait for every write in flight (raises a write's exception)."""
        self._wait(self._best, self._latest)

    def close(self) -> None:
        """Wait for every write in flight and let the snapshots' chunks go;
        under a mesh end in a barrier. Raises a write's exception,
        unchanged."""
        try:
            self.wait()
        finally:
            self._bounce.chunks = []
            if self.mesh is not None:
                barrier()

    @property
    def pinned_bytes(self) -> int:
        """The bytes of page-locked memory the keeper's snapshots hold."""
        return self._bounce.nbytes

    def save(self, epoch: int, model: torch.nn.Module, metrics: Dict[str, Any]) -> None:
        """Retain ``model``'s parameters as best/ unless the kept best
        selects higher: a host snapshot, written in the background."""
        self._raise_failed()
        prev = self.best_metrics()  # waits for best/'s earlier write
        if prev is not None and (_selection_metric(metrics, self.select_by)
                                 < _selection_metric(prev, self.select_by)):
            return
        gather, gathered = self._gatherer()
        sidecar = json.dumps(dict(metrics, epoch=epoch))

        def write_sidecar(tmp: str) -> None:
            with open(tmp, "w") as fh:
                fh.write(sidecar)

        def write(params) -> None:
            _save(params, self.best_params)
            _replace_atomically(self.best_sidecar, write_sidecar)

        self._start(self._best, self._whole(model.state_dict(), gather), gathered, write)

    def save_latest(self, epoch: int, state, ema: Optional[torch.nn.Module] = None,
                    progress: Optional[Dict[str, Any]] = None) -> None:
        """The resume checkpoint: with ``ema``, the shadow at the same step,
        and ``progress``, ``fit``'s retention state, in the same file; a
        host snapshot, written in the background once latest/'s earlier
        write has ended."""
        self._raise_failed()
        self._wait(self._latest)
        gather, gathered = self._gatherer()
        rows = state.items_state
        if rows is not None and self.table_rows is not None:
            rows = dict(rows, munu=gather(rows["munu"]))
        ck = {"model": self._whole(state.model.state_dict(), gather),
              "optimizer": self._moments(state, _portable_optimizer(
                  state.optimizer.state_dict()), gather),
              "items_state": rows,
              "generator": state.generator.get_state(),
              "seed_generator": state.seed_generator.get_state(),
              "step": state.step, "epoch": epoch,
              "ema": None if ema is None else {"params": self._whole(ema.state_dict(), gather),
                                               "step": state.step},
              "progress": progress}
        self._start(self._latest, ck, gathered, lambda host: _save(host, self.latest))

    def restore_latest(self, state) -> Optional[int]:
        """Load latest/ into ``state`` in place; its epoch, or None without one.
        Raises ValueError, before changing anything, when latest/ was saved
        with the other item-table optimizer (row-sparse or dense). The
        shadow and the retention state saved with it wait for
        ``restore_latest_ema`` and ``latest_progress``."""
        self._wait(self._latest)
        self._resumed = None
        if not os.path.exists(self.latest):
            return None
        ck = _load(self.latest)
        saved = ck.get("items_state")
        if (saved is None) != (state.items_state is None):
            raise ValueError(f"{self.latest} holds the {'dense' if saved is None else 'sparse'} "
                             "item-table Adam's state; the state to restore uses the other")
        state.model.load_state_dict(self._block(ck["model"]))
        _load_optimizer(state.optimizer, self._moments(
            state, ck["optimizer"], lambda t: local_rows(t, self.mesh)))
        if saved is not None:
            munu = saved["munu"]
            state.items_state["munu"].copy_(munu if self.table_rows is None
                                            else local_rows(munu, self.mesh))
            state.items_state["count"] = int(saved["count"])
        state.generator.set_state(ck["generator"])
        state.seed_generator.set_state(ck["seed_generator"])
        state.step = int(ck["step"])
        self._resumed = {k: ck[k] for k in ("ema", "progress") if k in ck}
        return int(ck["epoch"])

    def latest_progress(self) -> Optional[Dict[str, Any]]:
        """``fit``'s retention state saved with the restored latest/; None
        before a restore or for a latest/ saved without one."""
        self._wait(self._latest)
        return (self._resumed or {}).get("progress")

    def restore_latest_model(self, model: torch.nn.Module) -> Optional[int]:
        """Load latest/'s parameters alone into ``model``; its epoch, or None."""
        self._wait(self._latest)
        if not os.path.exists(self.latest):
            return None
        ck = _load(self.latest)
        model.load_state_dict(self._block(ck["model"]))
        return int(ck["epoch"])

    def restore_latest_ema(self, ema: torch.nn.Module, step: int) -> bool:
        """Load the shadow saved with the restored latest/ into ``ema``; False
        when the run saved none. Raises when its step is not ``step``
        (latest/'s): a shadow in latest/ always has it, a directory of the
        older layout (``ema/ema.pt``) may not."""
        self._wait(self._latest)
        resumed = self._resumed or {}
        if "ema" in resumed:
            ck, where = resumed.pop("ema"), self.latest
        elif os.path.exists(self.legacy_ema):
            ck, where = _load(self.legacy_ema), self.legacy_ema
        else:
            return False
        if ck is None:
            return False
        if int(ck["step"]) != int(step):
            raise ValueError(f"{where} holds the EMA shadow of step {ck['step']}, but "
                             f"latest/ is at step {step}: refusing a mismatched resume")
        ema.load_state_dict(self._block(ck["params"]))
        return True

    def restore_best(self, model: torch.nn.Module) -> Optional[int]:
        """Load best/ into ``model`` in place; its epoch, or None without one."""
        self._wait(self._best)
        if not os.path.exists(self.best_params):
            return None
        model.load_state_dict(self._block(_load(self.best_params)))
        return int(self.best_metrics()["epoch"])

    def best_metrics(self) -> Optional[Dict[str, Any]]:
        """best/'s metrics, once its write in flight has ended; None without
        one."""
        self._wait(self._best)
        if not os.path.exists(self.best_sidecar):
            return None
        with open(self.best_sidecar) as fh:
            return json.load(fh)
