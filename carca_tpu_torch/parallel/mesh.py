"""Ranks, the (data, model) grid and table shards (counterpart of
``carca_tpu/parallel/mesh.py``), on ``torch.distributed``.

One process per rank, launched by ``python -m torch.distributed.run``
(torchrun), which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the
rendezvous address. A world of one builds no process group and runs the
single-device code.

The grid is the JAX package's mesh ``(data, model)``, ranks laid out row
major: ``world = n_data · n_model`` and ``rank = d_idx · n_model + m_idx``.
Each data index has one ``model`` group (its row of the grid: the ranks
that hold the shards of one table and see the same batch), each model
index one ``data`` group (its column: the ranks that hold the same shard
and see different slices of the batch). The groups come from
``dist.new_group``, so the same code runs on gloo and NCCL, and the layer
uses ``all_reduce``, ``all_gather`` (the list form) and ``broadcast``
only, which gloo carries on CPU and CUDA tensors alike.

Tables shard by rows over ``model``: a table's rows are padded to a
multiple of ``n_model`` (pad rows are zeros and never indexed) and model
rank m holds rows ``m · R/n .. (m+1) · R/n``.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

AXES = ("data", "model")


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def initialize_distributed(device: str | torch.device = "cuda") -> torch.device:
    """Join the process group torchrun's environment describes, once, and
    return this rank's device: ``device`` itself when it is the CPU, else
    ``cuda:{LOCAL_RANK % device_count}``.

    Benign only where there is nothing to join: no rendezvous in the
    environment, or a world of one (no group is built), or a group already
    joined. A failed init raises. The transport follows a stated rule,
    logged on stderr: ``nccl`` when every local rank has a card of its own,
    ``gloo`` when ranks share a card or run on the CPU."""
    device = torch.device(device)
    if dist.is_initialized():
        return _rank_device(device)
    if "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ:
        return device
    world = int(os.environ["WORLD_SIZE"])
    if world == 1:
        return device
    rank_ = int(os.environ["RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = _rank_device(device)
    if dev.type == "cpu":
        backend, why = "gloo", "ranks on the CPU"
    else:
        torch.cuda.set_device(dev)
        n_cards = torch.cuda.device_count()
        if n_cards >= local_world:
            backend, why = "nccl", f"{local_world} local ranks on {n_cards} cards"
        else:
            backend, why = "gloo", f"{local_world} local ranks share {n_cards} card(s)"
    dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank_)
    sys.stderr.write(f"initialize_distributed: rank {rank_}/{world} on {dev}, "
                     f"backend {backend} ({why})\n")
    return dev


def _rank_device(device: torch.device) -> torch.device:
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for this rank; pass device='cpu' to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclass
class Mesh:
    """This rank's place in the ``(data, model)`` grid and its two groups
    (None for an axis of size 1, where no collective is needed)."""

    n_data: int
    n_model: int
    rank: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def d_idx(self) -> int:
        return self.rank // self.n_model

    @property
    def m_idx(self) -> int:
        return self.rank % self.n_model


def make_mesh(shape: Sequence[int] = (), axes: Sequence[str] = ("data",)) -> Mesh:
    """The grid of ``shape`` over ``axes`` (a sub-sequence of ("data",
    "model"); ``shape=()`` puts every rank on the first axis). The world
    size must equal the product of the shape. Every rank must call this,
    in the same order as every other group it builds."""
    world = world_size()
    if not shape:
        shape = (world,) + (1,) * (len(axes) - 1)
    if len(shape) != len(axes) or any(a not in AXES for a in axes):
        raise ValueError(f"mesh axes {tuple(axes)} of shape {tuple(shape)}: want a shape per "
                         f"axis, axes from {AXES}")
    sizes = dict(zip(axes, (int(s) for s in shape)))
    n_data, n_model = sizes.get("data", 1), sizes.get("model", 1)
    if n_data * n_model != world:
        raise ValueError(f"mesh {tuple(shape)} over {tuple(axes)} needs a world size of "
                         f"{n_data * n_model} (torchrun --nproc_per_node "
                         f"{n_data * n_model}); this run has {world}")
    mesh = Mesh(n_data, n_model, rank())
    if world == 1:
        return mesh
    # new_group is collective: every rank builds every group, in one order
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)]) if n_model > 1 else None
        if d == mesh.d_idx:
            mesh.model_group = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)]) if n_data > 1 else None
        if m == mesh.m_idx:
            mesh.data_group = g
    return mesh


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in place (no-op for None); returns it."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, group, size: int) -> List[torch.Tensor]:
    """The list of every member's ``t`` over ``group``, in rank order."""
    if group is None:
        return [t]
    out = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def sum_gradients(params: Sequence[torch.Tensor], group) -> None:
    """The gradients of ``params`` (the dense optimizer's parameters)
    summed over ``group`` (no-op for None): one flat buffer per dtype, one
    all-reduce each. A missing gradient counts as zeros and stays missing.
    Under the row-sparse item Adam the item table is not among them: its
    gradient reaches the gathered sub-table, which is summed on its own."""
    if group is None:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    for params in by_dtype.values():
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        all_reduce_sum(flat, group)
        for p, g in zip(params, torch.split(flat, [p.numel() for p in params])):
            if p.grad is not None:
                p.grad.copy_(g.view_as(p))


def rank_generators(state, mesh: Optional[Mesh], dropout: float):
    """(device generator, CPU seed generator) for one step's dropouts: the
    state's shared ones on one device or one data rank, else ones seeded
    from one shared draw with the data index folded in. The attention
    kernels key their Philox bits by the element's index in the *local*
    batch, so without the fold every data rank would draw the same masks;
    the model ranks of one data index share theirs."""
    if mesh is None or mesh.n_data == 1 or dropout <= 0.0:
        return state.generator, state.seed_generator
    s = int(torch.randint(0, 2**62, (), generator=state.seed_generator))
    a, b = np.random.SeedSequence([s, mesh.d_idx]).generate_state(2, np.uint64)
    return (torch.Generator(device=state.generator.device).manual_seed(int(a)),
            torch.Generator().manual_seed(int(b)))


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def pad_table_rows(table, mesh: Mesh):
    """Pad a table's rows (numpy or a tensor) to a multiple of the model
    axis with zero rows, which are never indexed (ids < n_items)."""
    pad = (-table.shape[0]) % mesh.n_model
    if not pad:
        return table
    if isinstance(table, np.ndarray):
        return np.concatenate([table, np.zeros((pad,) + table.shape[1:], table.dtype)])
    return torch.cat([table, table.new_zeros((pad,) + tuple(table.shape[1:]))])


def local_rows(table, mesh: Mesh):
    """This model rank's block of ``table``'s rows, padded first."""
    table = pad_table_rows(table, mesh)
    per = table.shape[0] // mesh.n_model
    return table[mesh.m_idx * per:(mesh.m_idx + 1) * per]


def gather_rows(block: torch.Tensor, mesh: Mesh, n_rows: int) -> torch.Tensor:
    """The whole table from the model ranks' blocks, pad rows cut (every
    model rank takes part and gets it)."""
    return torch.cat(all_gather(block, mesh.model_group, mesh.n_model))[:n_rows]


def gather_rows_on_rank0(block: torch.Tensor, mesh: Mesh, n_rows: int,
                         device: torch.device | str = "cpu") -> Optional[torch.Tensor]:
    """The whole table on rank 0, on ``device``, pad rows cut; None on every
    other rank. The blocks travel one at a time, each broadcast by its
    owner over the model group of data index 0, so the whole table exists
    on rank 0 alone and no other rank holds more than one block beside its
    own. The ranks of data index 0 take part; the others return at once."""
    if mesh.d_idx != 0:
        return None
    if mesh.model_group is None:
        return block[:n_rows].to(device) if mesh.rank == 0 else None
    parts = []
    for m in range(mesh.n_model):
        buf = block.contiguous() if m == mesh.m_idx else torch.empty_like(block)
        dist.broadcast(buf, src=m, group=mesh.model_group)  # data index 0: global rank m
        if mesh.rank == 0:
            parts.append(buf.to(device))
        del buf
    return torch.cat(parts)[:n_rows] if mesh.rank == 0 else None


def shard_batch(batch: Dict, mesh: Mesh, dim: int = 0) -> Dict:
    """This data rank's slice of a global batch (tensors or numpy arrays)
    along ``dim`` (1 for the ``[K, B]`` rows of a K-step call); 0-d entries
    stay whole."""
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) <= dim:
            out[k] = v
            continue
        n = v.shape[dim]
        if n % mesh.n_data:
            raise ValueError(f"batch dim {n} of {k!r} not divisible by the data axis "
                             f"{mesh.n_data}")
        per = n // mesh.n_data
        idx = [slice(None)] * v.ndim
        idx[dim] = slice(mesh.d_idx * per, (mesh.d_idx + 1) * per)
        out[k] = v[tuple(idx)]
    return out


def prepare_state_for_mesh(state, mesh: Mesh, shard_embeddings: bool,
                           sparse_items: Optional[bool] = None):
    """Row-shard the item table over ``model`` (when ``shard_embeddings``
    and the model axis has more than one rank): the model keeps its padded
    block as ``embed.items``. With ``sparse_items`` (by default: whether
    the state holds a row state) the item table takes the row-sparse Adam:
    the row state is built for the rank's block (or the whole table) and
    the dense Adam over every other parameter, the JAX package's split
    ``{"dense", "items"}`` state. Adam is rebuilt over the local parameters
    wherever something changed. Call once before training, before a
    restore (which then loads blocks)."""
    from carca_tpu_torch.train import sparse_adam

    sparse = state.items_state is not None if sparse_items is None else bool(sparse_items)
    embed = state.model.embed
    has_table = hasattr(embed, "items")
    sharded = shard_embeddings and mesh.n_model > 1 and has_table
    if sharded:
        with torch.no_grad():
            block = local_rows(embed.items.detach(), mesh).clone()
        embed.items = nn.Parameter(block)
    elif sparse == (state.items_state is not None):
        return state
    if sparse and not has_table:
        raise ValueError("the row-sparse item Adam needs an item table")
    opt = state.optimizer
    params = [p for n, p in state.model.named_parameters()
              if not (sparse and n == "embed.items")]
    state.optimizer = type(opt)(params, **opt.defaults)
    # a capturable Adam (the card's) runs eagerly over a mesh: quiet, as make_optimizer's
    state.optimizer._warned_capturable_if_run_uncaptured = True
    state.items_state = sparse_adam.init_state(embed.items.detach()) if sparse else None
    return state
