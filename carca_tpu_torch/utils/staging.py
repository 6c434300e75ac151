"""What the CUDA graphs of the train and eval steps (``train/graph.py``)
and of serving (``serve/graph.py``) share: the staging region, the
side-stream warm-up, the capture and the size of a graph's memory pool.

A graph reads its per-call inputs from fixed addresses, so a call writes
them into a ``Region``: named ``(name, dtype, shape)`` sections of one byte
buffer on the device, each starting where a fresh tensor of the caching
allocator would (``ALIGN``). cuBLAS and the kernels choose their code by
the alignment of what they are given, so a replay reading a section runs
the same kernels as the eager call reading a fresh tensor: the two agree
bit for bit. The host twin is pinned when the device is a card, and one
``non_blocking`` copy moves every section.

A graph's first call runs its eager call on a side stream
(``side_stream_call``): kernel builds and the lazy set-up of cuBLAS, the
allocator and Adam happen there, outside any capture. ``capture`` then
records the call on that stream, into a given pool or a private one.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

ALIGN = 512  # the caching allocator's alignment: a section starts where a fresh tensor would


class Region:
    """Named sections ``(name, dtype, shape)`` of one byte buffer on
    ``device`` (``d``) and of its host twin (``np``, numpy views), pinned
    when the device is a card: one copy moves them all."""

    def __init__(self, sections: Sequence[Tuple[str, torch.dtype, tuple]], device):
        spans, end = [], 0
        for name, dtype, shape in sections:
            start = -(-end // ALIGN) * ALIGN
            end = start + math.prod(shape) * dtype.itemsize
            spans.append((name, dtype, tuple(shape), start, end))
        device = torch.device(device)
        self.host = torch.empty(end, dtype=torch.uint8, pin_memory=device.type == "cuda")
        self.dev = torch.empty(end, dtype=torch.uint8, device=device)

        def views(buf) -> Dict[str, torch.Tensor]:
            return {name: buf[s:e].view(dtype).view(shape) for name, dtype, shape, s, e in spans}

        self.d = views(self.dev)
        self.np = {name: t.numpy() for name, t in views(self.host).items()}


def torch_dtype(a) -> torch.dtype:
    """The torch dtype of a tensor or a numpy array (or numpy scalar)."""
    return a.dtype if torch.is_tensor(a) else torch.from_numpy(np.empty(0, a.dtype)).dtype


def sections_of(arrays: Mapping[str, object]) -> list:
    """The ``(name, dtype, shape)`` sections that hold ``arrays`` (numpy
    arrays or tensors), in their order."""
    return [(name, torch_dtype(a), tuple(a.shape)) for name, a in arrays.items()]


def side_stream_call(stream: torch.cuda.Stream, fn: Callable):
    """``fn()`` on ``stream``, ordered after and before the current stream's
    work; the tensors it returns are marked used by the current stream."""
    main = torch.cuda.current_stream(stream.device)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        out = fn()
    main.wait_stream(stream)
    for t in out if isinstance(out, tuple) else (out,):
        if torch.is_tensor(t):
            t.record_stream(main)
    return out


def capture(fn: Callable, stream: torch.cuda.Stream, pool=None,
            generators: Sequence[Optional[torch.Generator]] = ()):
    """(graph, what ``fn()`` returned): ``fn`` captured on ``stream`` into
    ``pool`` (a private pool when None), with each of ``generators`` (None
    skipped) registered so that each replay advances it as the eager call
    would."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        if g is not None:
            graph.register_generator_state(g)
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        out = fn()
    return graph, out


def pool_bytes(pool) -> int:
    """Device bytes reserved by the CUDA graph memory pool ``pool`` (a
    ``graph_pool_handle()`` or ``CUDAGraph.pool()``), 0 for None."""
    if pool is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))
