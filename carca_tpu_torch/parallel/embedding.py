"""Row-sharded table lookup (counterpart of
``carca_tpu/parallel/embedding.py``).

The 10M-item catalog (BASELINE.json configs[4]) does not replicate its
tables: each model rank holds a block of rows (``mesh.local_rows``). A
lookup gathers the ids that fall in the rank's block (others read row 0
and are zeroed) and sums the rows over the ``model`` group, which is exact
(x + 0 = x): one collective of [.., W] rows per lookup instead of an
all-gather of the table.

The backward is a local scatter-add into the block's rows with no
collective: the model ranks of one data index hold the same batch and so
receive the same cotangent of the summed rows (in the JAX package, the
transpose of ``psum`` under ``shard_map`` is the identity on a replicated
cotangent). It is ``F.embedding``'s own backward (ids sorted, each id's
rows summed as one segment), so a block's gradient is the one a
single-device table would get on those rows.
"""

from __future__ import annotations

import torch

from carca_tpu_torch.parallel.mesh import Mesh, all_reduce_sum


class ShardedLookup(torch.autograd.Function):
    """rows = Σ over the model group of (the rank's masked local gather)."""

    @staticmethod
    def forward(ctx, block: torch.Tensor, ids: torch.Tensor, lo: int, group):
        n = block.shape[0]
        loc = ids.long() - lo
        valid = (loc >= 0) & (loc < n)
        loc = torch.where(valid, loc, 0)
        rows = torch.nn.functional.embedding(loc, block)
        rows = torch.where(valid[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                               device=rows.device))
        ctx.save_for_backward(loc, valid)
        ctx.n = n
        return all_reduce_sum(rows, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        loc, valid = ctx.saved_tensors
        g = torch.where(valid[..., None], grad, torch.zeros((), dtype=grad.dtype,
                                                            device=grad.device))
        d_block = torch.ops.aten.embedding_dense_backward(g, loc, ctx.n, -1, False)
        return d_block, None, None, None


def make_sharded_lookup(mesh: Mesh):
    """``lookup(block, ids) -> rows`` for a table row-sharded over the
    model axis: ``block`` is this rank's block of the padded table
    (``mesh.local_rows``), ``ids`` any shape of global row ids; rows [...,
    W] on every model rank alike. Plugs into the model as
    ``embeddings.Embedding``'s ``lookup``."""

    def lookup(block: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return ShardedLookup.apply(block, ids, mesh.m_idx * block.shape[0], mesh.model_group)

    return lookup
