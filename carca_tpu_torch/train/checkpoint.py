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

The resume state and its shadow are one file, so one ``os.replace``
commits both: no crash can leave them at different steps. A run
directory written before they were one file keeps the shadow in
``ema/ema.pt``; it still resumes, and a shadow there whose step is not
``latest/``'s is refused.

Every file is written to a temporary name in its directory
(``<name>.tmp<pid>``) and then ``os.replace``d, so a crash never leaves a
torn checkpoint; a temporary file a killed process left behind is never
read. Saves are synchronous.

Over a mesh (``parallel/mesh.py``) every rank calls every method; rank 0
alone writes, and each save ends in a barrier. With the item table
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
from typing import Any, Dict, Optional

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

    def _whole(self, sd: Dict[str, Any]) -> Dict[str, Any]:
        """A state_dict with the item table whole on rank 0 (in host memory),
        None in its place on the other ranks."""
        if self.table_rows is None or ITEMS not in sd:
            return sd
        return dict(sd, **{ITEMS: self._gather(sd[ITEMS])})

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

    def _write(self, write) -> None:
        """``write()`` on rank 0 alone, then every rank waits for it."""
        if self.writer:
            write()
        if self.mesh is not None:
            barrier()

    def save(self, epoch: int, model: torch.nn.Module, metrics: Dict[str, Any]) -> None:
        """Retain ``model``'s parameters as best/ unless the kept best
        selects higher."""
        prev = self.best_metrics()
        if prev is not None and (_selection_metric(metrics, self.select_by)
                                 < _selection_metric(prev, self.select_by)):
            return
        params = self._whole(model.state_dict())

        def write_sidecar(tmp: str) -> None:
            with open(tmp, "w") as fh:
                json.dump(dict(metrics, epoch=epoch), fh)

        def write() -> None:
            _save(params, self.best_params)
            _replace_atomically(self.best_sidecar, write_sidecar)

        self._write(write)

    def save_latest(self, epoch: int, state, ema: Optional[torch.nn.Module] = None,
                    progress: Optional[Dict[str, Any]] = None) -> None:
        """The resume checkpoint: with ``ema``, the shadow at the same step,
        and ``progress``, ``fit``'s retention state, in the same file."""
        rows = state.items_state
        if rows is not None and self.table_rows is not None:
            rows = dict(rows, munu=self._gather(rows["munu"]))
        ck = {"model": self._whole(state.model.state_dict()),
              "optimizer": self._moments(state, state.optimizer.state_dict(),
                                         self._gather),
              "items_state": rows,
              "generator": state.generator.get_state(),
              "seed_generator": state.seed_generator.get_state(),
              "step": state.step, "epoch": epoch,
              "ema": None if ema is None else {"params": self._whole(ema.state_dict()),
                                               "step": state.step},
              "progress": progress}

        self._write(lambda: _save(ck, self.latest))

    def restore_latest(self, state) -> Optional[int]:
        """Load latest/ into ``state`` in place; its epoch, or None without one.
        Raises ValueError, before changing anything, when latest/ was saved
        with the other item-table optimizer (row-sparse or dense). The
        shadow and the retention state saved with it wait for
        ``restore_latest_ema`` and ``latest_progress``."""
        self._resumed = None
        if not os.path.exists(self.latest):
            return None
        ck = _load(self.latest)
        saved = ck.get("items_state")
        if (saved is None) != (state.items_state is None):
            raise ValueError(f"{self.latest} holds the {'dense' if saved is None else 'sparse'} "
                             "item-table Adam's state; the state to restore uses the other")
        state.model.load_state_dict(self._block(ck["model"]))
        state.optimizer.load_state_dict(self._moments(
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
        return (self._resumed or {}).get("progress")

    def restore_latest_model(self, model: torch.nn.Module) -> Optional[int]:
        """Load latest/'s parameters alone into ``model``; its epoch, or None."""
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
        if not os.path.exists(self.best_params):
            return None
        model.load_state_dict(self._block(_load(self.best_params)))
        return int(self.best_metrics()["epoch"])

    def best_metrics(self) -> Optional[Dict[str, Any]]:
        if not os.path.exists(self.best_sidecar):
            return None
        with open(self.best_sidecar) as fh:
            return json.load(fh)
