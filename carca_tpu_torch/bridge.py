"""Weights and configs from the JAX package into this one.

``params_from_jax`` turns a ``carca_tpu`` parameter tree — the nested dict
(with a list of encoder blocks) that ``models.carca.carca_init`` returns,
its leaves as numpy arrays — into a ``state_dict`` for ``CARCA``: path
components join with "." (``blocks/0/attn/wq/w`` → ``blocks.0.attn.wq.w``),
and the layouts already agree (dense weights stay [in, out]). A
lane-packed item table (``pack_tables=True``, or "auto" at ≥1M rows, in
the JAX package) is unpacked by a reshape to [-1, width] and trimmed to
``n_items`` rows (``carca_tpu/ops/packed_table.py::unpack_rows``).

``model_config_from_jax``, ``data_config_from_jax``,
``train_config_from_jax`` and ``config_from_jax`` map the JAX package's
config dataclasses (or their ``dataclasses.asdict`` dicts) onto this
package's.

This module reads numpy arrays only; it never imports JAX.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch

from carca_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from carca_tpu_torch.models.embeddings import item_table_width

# JAX ModelConfig fields with no counterpart here: TPU-only knobs
_DROPPED = ("remat", "pack_tables")


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def params_from_jax(np_tree: Mapping, cfg: ModelConfig) -> "OrderedDict[str, torch.Tensor]":
    """JAX parameter tree → ``CARCA`` state_dict (CPU tensors)."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(np_tree, "", flat)
    items = flat.get("embed.items")
    if items is not None:
        width = item_table_width(cfg)
        if items.shape[-1] != width:
            flat["embed.items"] = items.reshape(-1, width)[: cfg.n_items]
    return OrderedDict((k, torch.from_numpy(np.array(v, copy=True)))
                       for k, v in flat.items())


def load_into(module: torch.nn.Module, np_tree: Mapping) -> torch.nn.Module:
    """Copy a JAX parameter tree into ``module`` (a ``CARCA``), strictly:
    every parameter and buffer must be present, and nothing else."""
    module.load_state_dict(params_from_jax(np_tree, module.cfg), strict=True)
    return module


def _as_dict(cfg: Any) -> Dict[str, Any]:
    return dict(dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else cfg)


def model_config_from_jax(cfg: Any) -> ModelConfig:
    """A ``carca_tpu`` ModelConfig (or its dict) → this package's
    ``ModelConfig``; ``use_pallas`` maps to ``use_kernel``, the TPU-only
    ``pack_tables`` and ``remat`` are dropped."""
    d = _as_dict(cfg)
    if "use_pallas" in d:
        d["use_kernel"] = d.pop("use_pallas")
    for name in _DROPPED:
        d.pop(name, None)
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"JAX config fields with no counterpart here: {sorted(unknown)}")
    return ModelConfig(**d)


def data_config_from_jax(cfg: Any) -> DataConfig:
    """A ``carca_tpu`` DataConfig (or its dict) → this package's."""
    return DataConfig(**_as_dict(cfg))


def train_config_from_jax(cfg: Any) -> TrainConfig:
    """A ``carca_tpu`` TrainConfig (or its dict), or a whole ``carca_tpu``
    Config, → this package's ``TrainConfig``, every field kept
    (``sparse_items_adam`` included: the port's ``sparse_adam.resolve``
    takes the JAX package's decision; ``mesh_shape`` and ``mesh_axes`` as
    tuples)."""
    whole = hasattr(cfg, "train") and hasattr(cfg, "model")
    d = _as_dict(cfg.train if whole else cfg)
    for key in ("mesh_shape", "mesh_axes"):
        if isinstance(d.get(key), list):
            d[key] = tuple(d[key])
    return TrainConfig(**d)


def config_from_jax(cfg: Any) -> Config:
    """A whole ``carca_tpu`` Config → this package's ``Config``."""
    return Config(model=model_config_from_jax(cfg.model), data=data_config_from_jax(cfg.data),
                  train=train_config_from_jax(cfg))
