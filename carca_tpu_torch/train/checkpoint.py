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
  (``TrainState.generator`` and ``seed_generator``), the step and the
  epoch;
* ``ema/ema.pt`` — the EMA shadow's ``state_dict`` and its step, refreshed
  with ``latest/``; a resume refuses a shadow whose step is not
  ``latest/``'s.

Every file is written to a temporary name in its directory and then
``os.replace``d, so a crash never leaves a torn checkpoint. Saves are
synchronous.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch


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


class CheckpointKeeper:
    """``best/``, ``latest/`` and ``ema/`` under ``directory``; best/ is
    retained by ``_selection_metric`` under ``select_by``."""

    def __init__(self, directory: str, select_by: str = "ndcg"):
        self.select_by = select_by
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.best_params = os.path.join(self.dir, "best", "params.pt")
        self.best_sidecar = os.path.join(self.dir, "best", "metrics.json")
        self.latest = os.path.join(self.dir, "latest", "state.pt")
        self.ema = os.path.join(self.dir, "ema", "ema.pt")

    def save(self, epoch: int, model: torch.nn.Module, metrics: Dict[str, Any]) -> None:
        """Retain ``model``'s parameters as best/ unless the kept best
        selects higher."""
        prev = self.best_metrics()
        if prev is not None and (_selection_metric(metrics, self.select_by)
                                 < _selection_metric(prev, self.select_by)):
            return
        _save(model.state_dict(), self.best_params)

        def write_sidecar(tmp: str) -> None:
            with open(tmp, "w") as fh:
                json.dump(dict(metrics, epoch=epoch), fh)

        _replace_atomically(self.best_sidecar, write_sidecar)

    def save_latest(self, epoch: int, state, ema: Optional[torch.nn.Module] = None) -> None:
        """The resume checkpoint; with ``ema``, the shadow at the same step."""
        _save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
               "items_state": state.items_state,
               "generator": state.generator.get_state(),
               "seed_generator": state.seed_generator.get_state(),
               "step": state.step, "epoch": epoch}, self.latest)
        if ema is not None:
            _save({"params": ema.state_dict(), "step": state.step, "epoch": epoch}, self.ema)

    def restore_latest(self, state) -> Optional[int]:
        """Load latest/ into ``state`` in place; its epoch, or None without one.
        Raises ValueError, before changing anything, when latest/ was saved
        with the other item-table optimizer (row-sparse or dense)."""
        if not os.path.exists(self.latest):
            return None
        ck = _load(self.latest)
        saved = ck.get("items_state")
        if (saved is None) != (state.items_state is None):
            raise ValueError(f"{self.latest} holds the {'dense' if saved is None else 'sparse'} "
                             "item-table Adam's state; the state to restore uses the other")
        state.model.load_state_dict(ck["model"])
        state.optimizer.load_state_dict(ck["optimizer"])
        if saved is not None:
            state.items_state["munu"].copy_(saved["munu"])
            state.items_state["count"] = int(saved["count"])
        state.generator.set_state(ck["generator"])
        state.seed_generator.set_state(ck["seed_generator"])
        state.step = int(ck["step"])
        return int(ck["epoch"])

    def restore_latest_model(self, model: torch.nn.Module) -> Optional[int]:
        """Load latest/'s parameters alone into ``model``; its epoch, or None."""
        if not os.path.exists(self.latest):
            return None
        ck = _load(self.latest)
        model.load_state_dict(ck["model"])
        return int(ck["epoch"])

    def restore_latest_ema(self, ema: torch.nn.Module, step: int) -> bool:
        """Load the shadow saved with latest/ into ``ema``; False when the run
        saved none. Raises when its step is not ``step`` (latest/'s)."""
        if not os.path.exists(self.ema):
            return False
        ck = _load(self.ema)
        if int(ck["step"]) != int(step):
            raise ValueError(f"{self.ema} holds the EMA shadow of step {ck['step']}, but "
                             f"latest/ is at step {step}: refusing a mismatched resume")
        ema.load_state_dict(ck["params"])
        return True

    def restore_best(self, model: torch.nn.Module) -> Optional[int]:
        """Load best/ into ``model`` in place; its epoch, or None without one."""
        if not os.path.exists(self.best_params):
            return None
        model.load_state_dict(_load(self.best_params))
        return int(self.best_metrics()["epoch"])

    def best_metrics(self) -> Optional[Dict[str, Any]]:
        if not os.path.exists(self.best_sidecar):
            return None
        with open(self.best_sidecar) as fh:
            return json.load(fh)
