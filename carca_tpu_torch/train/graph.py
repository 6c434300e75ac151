"""The K-step train call as one device dispatch: a CUDA graph of the eager
call ``loop.make_scanned_device_train_step`` builds. The JAX package has no
module for this: there ``jax.jit`` compiles its ``lax.scan`` of K steps
into one dispatch (``carca_tpu/train/loop.py::make_scanned_device_train_step``).

``GraphedStep`` wraps the eager K-step call on one card:

* its first call runs the eager call on a side stream: the warm-up that
  builds Adam's lazy state, loads the kernel library and fills the
  allocator. It trains as the eager call does;
* its second call captures the eager call on that stream (a capture runs
  the Python once and executes nothing) and replays the graph once;
* every later call replays the graph: one ``CUDAGraph.replay()``.

What differs per call the graph reads from static device memory, written
before each replay through one pinned host buffer and one ``non_blocking``
copy: the user rows [K, B], the schedule's K learning rates (which
``loop.apply_gradients`` copies into Adam's lr tensor), the row-sparse
Adam's K (lr, 1 − b1^t, 1 − b2^t) and one Philox seed per attention call
with dropout, drawn from ``TrainState.seed_generator`` in the eager call's
order (the kernels read them through ``flash_attention.seed_slots``). The
device generator that draws the negatives and the plain dropouts is
registered with the graph, so each replay advances it as the eager call
would. The host's counters — ``TrainState.step``, the sparse row state's
count, the attention kernels' launch counts — are put back after the
capture and advanced by K steps' worth at each replay. So a replay is the
eager call, bit for bit, as far as the eager call repeats itself.

The graph is keyed by the identity of what it reads and writes in place:
the parameters and buffers, Adam's state tensors and lr, the sparse
moments, the tensors ``watch`` names (the EMA shadow), the catalog arrays,
the attrs table and the batch shape. ``CheckpointKeeper.restore_latest``
and ``parallel.mesh.prepare_state_for_mesh`` replace Adam's tensors, so the
call after either captures anew; it never replays into stale tensors. A
capture that fails raises with its error: there is no eager retry.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from carca_tpu_torch.ops import launches
from carca_tpu_torch.ops.flash_attention import SEED_LIMIT, kernel_seed, seed_slots
from carca_tpu_torch.train import sparse_adam


class _Capture:
    """The capturing call's per-step inputs, handed out in step order."""

    def __init__(self, lrs: torch.Tensor, scalars: torch.Tensor):
        self.lrs, self.scalars = lrs, scalars
        self.n_lrs = self.n_scalars = 0

    def lr(self) -> torch.Tensor:
        """The next step's learning rate, a 0-dim float32 slot."""
        if self.n_lrs >= self.lrs.shape[0]:
            raise RuntimeError(f"the capture takes more than {self.lrs.shape[0]} learning rates")
        self.n_lrs += 1
        return self.lrs[self.n_lrs - 1]

    def row_scalars(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The next sparse update's (lr, 1 − b1^t, 1 − b2^t), 0-dim slots."""
        if self.n_scalars >= self.scalars.shape[0]:
            raise RuntimeError(f"the capture takes more than {self.scalars.shape[0]} "
                               "row-sparse updates")
        self.n_scalars += 1
        row = self.scalars[self.n_scalars - 1]
        return row[0], row[1], row[2]


_active: List[_Capture] = []  # the capture in progress, at most one


def capture_in_progress(device) -> Optional[_Capture]:
    """The ``GraphedStep`` capture in progress, or None when the step runs
    eagerly. A capture of the train step by anything else raises: its
    learning rates and bias corrections would be frozen into the graph."""
    if _active:
        return _active[0]
    if torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the train step is captured outside train/graph.py's GraphedStep: "
                           "its learning rates would repeat on every replay")
    return None


def step_lrs(schedule: Optional[Callable[[int], float]], step: int, k: int) -> np.ndarray:
    """The learning rates of updates ``step`` … ``step + k − 1`` in float32
    (zeros without a schedule, where Adam's lr tensor keeps ``tc.lr``)."""
    if schedule is None:
        return np.zeros(k, np.float32)
    return np.array([schedule(step + i) for i in range(k)], dtype=np.float32)


def row_scalars(tc, count: int, k: int) -> np.ndarray:
    """[k, 3] float32: ``sparse_adam.step_scalars`` of the row state's counts
    ``count`` … ``count + k − 1``."""
    return np.stack([sparse_adam.step_scalars(tc, count + i) for i in range(k)])


def draw_seeds(seed_generator: torch.Generator, n: int) -> torch.Tensor:
    """[n] int64: the seeds ``n`` eager ``kernel_seed`` calls draw, in order
    (one ``randint`` of n values draws the same sequence)."""
    return torch.randint(SEED_LIMIT, (n,), generator=seed_generator, dtype=torch.int64)


# the kernels' launch counters, read before and put back after a capture
launch_counts = launches.snapshot
_set_launch_counts = launches.restore


class _StaticInputs:
    """The graph's per-call inputs on the device, and their pinned host
    staging: int64 user rows [K, B] and seeds [n], float32 lrs [K] and row
    scalars [K, 3], one byte buffer each side, so one copy moves them."""

    def __init__(self, k: int, b: int, n_seeds: int, device):
        sizes = [8 * k * b, 8 * n_seeds, 4 * k, 12 * k]  # int64 sections first: aligned
        ends = np.cumsum(sizes).tolist()
        self.host = torch.empty(ends[-1], dtype=torch.uint8, pin_memory=True)
        self.dev = torch.empty(ends[-1], dtype=torch.uint8, device=device)
        self.copied: Optional[torch.cuda.Event] = None

        def views(buf):
            cut = [buf[s:e] for s, e in zip([0] + ends[:-1], ends)]
            return (cut[0].view(torch.int64).view(k, b), cut[1].view(torch.int64),
                    cut[2].view(torch.float32), cut[3].view(torch.float32).view(k, 3))

        self.h_rows, self.h_seeds, self.h_lrs, self.h_scalars = views(self.host)
        self.rows, self.seeds, self.lrs, self.scalars = views(self.dev)

    def write(self, state, tc, user_rows: torch.Tensor, n_seeds: int) -> None:
        """Stage one call's inputs and copy them to the device."""
        if self.copied is not None:
            self.copied.synchronize()  # the last call's copy has read the host buffer
        k = self.lrs.shape[0]
        if n_seeds:
            self.h_seeds.copy_(draw_seeds(state.seed_generator, n_seeds))
            kernel_seed.drawn += n_seeds
        self.h_lrs.copy_(torch.from_numpy(step_lrs(state.schedule, state.step, k)))
        if state.items_state is not None:
            self.h_scalars.copy_(torch.from_numpy(row_scalars(tc, state.items_state["count"], k)))
        on_host = user_rows.device.type == "cpu"
        if on_host:
            self.h_rows.copy_(user_rows)
        self.dev.copy_(self.host, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record()
        if not on_host:
            self.rows.copy_(user_rows)


def _adam_ready(optimizer) -> bool:
    """Whether every parameter that took a gradient has its Adam state, so
    that no state is created lazily inside a capture."""
    with_grad = [p for g in optimizer.param_groups for p in g["params"] if p.grad is not None]
    return bool(with_grad) and all(optimizer.state.get(p) for p in with_grad)


class GraphedStep:
    """The K-step call ``eager`` (state, attrs_table, arrays, user_rows
    [K, B]) → (state, losses [K]) as one CUDA graph on a CUDA state (see
    the module's docstring); on a CPU state it runs ``eager``, or raises
    when the graph was ``required``. ``user_rows`` may lie on the host
    (staged with the other inputs) or on the card. ``watch()`` lists tensors
    the call updates in place beyond the train state (the EMA shadow)."""

    mode = "graph"

    def __init__(self, eager: Callable, inner_steps: int, tc, required: bool = False,
                 watch: Optional[Callable[[], Iterable[torch.Tensor]]] = None):
        self.eager, self.k, self.tc = eager, inner_steps, tc
        self.required, self.watch = required, watch
        self.stream: Optional[torch.cuda.Stream] = None
        self.warm = False
        self.n_seeds = 0  # seeds one call draws, counted in the warm-up
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.key = None
        self.inputs: Optional[_StaticInputs] = None
        self.losses: Optional[torch.Tensor] = None
        self.launched = None  # the captured call's kernel launches
        self.captures = 0
        self.replays = 0

    def __call__(self, state, attrs_table, arrays, user_rows):
        device = next(state.model.parameters()).device
        if device.type != "cuda":
            if self.required:
                raise ValueError("graph=True needs a CUDA state: a CUDA graph captures the "
                                 f"card's work, and this state lies on {device}")
            return self.eager(state, attrs_table, arrays, user_rows)
        if user_rows.shape[0] != self.k:
            raise ValueError(f"user_rows holds {user_rows.shape[0]} batches, "
                             f"the step takes {self.k}")
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        key = self._key(state, attrs_table, arrays, user_rows)
        if self.graph is not None and key == self.key:
            self.inputs.write(state, self.tc, user_rows, self.n_seeds)
            return self._replay(state)
        if not self.warm or not _adam_ready(state.optimizer):
            return self._warm_up(state, attrs_table, arrays, user_rows)
        return self._capture(state, attrs_table, arrays, user_rows, key)

    def _key(self, state, attrs_table, arrays, user_rows) -> tuple:
        opt = state.optimizer
        tensors = [*state.model.parameters(), *state.model.buffers(), attrs_table,
                   *arrays.values()]
        tensors += [g["lr"] for g in opt.param_groups if torch.is_tensor(g["lr"])]
        tensors += [v for st in opt.state.values() for v in st.values() if torch.is_tensor(v)]
        if state.items_state is not None:
            tensors.append(state.items_state["munu"])
        if self.watch is not None:
            tensors += list(self.watch())
        return (id(state.generator), tuple(user_rows.shape),
                tuple(t.data_ptr() for t in tensors))

    def _warm_up(self, state, attrs_table, arrays, user_rows):
        main = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(main)
        drawn = kernel_seed.drawn
        with torch.cuda.stream(self.stream):
            state, losses = self.eager(state, attrs_table, arrays, user_rows)
        main.wait_stream(self.stream)
        losses.record_stream(main)
        self.n_seeds = kernel_seed.drawn - drawn
        self.warm = True
        return state, losses

    def _capture(self, state, attrs_table, arrays, user_rows, key):
        self.graph = self.key = self.inputs = self.losses = None  # frees an older graph
        inputs = _StaticInputs(self.k, user_rows.shape[1], self.n_seeds, self.stream.device)
        inputs.write(state, self.tc, user_rows, self.n_seeds)
        rows = state.items_state
        host = (state.step, None if rows is None else rows["count"],
                state.seed_generator.get_state(), launch_counts())
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        cap = _Capture(inputs.lrs, inputs.scalars)
        _active.append(cap)
        try:
            with seed_slots(inputs.seeds) as taken:
                with torch.cuda.graph(graph, stream=self.stream):
                    _, losses = self.eager(state, attrs_table, arrays, inputs.rows)
                n_taken = taken()
            after = launch_counts()
            if n_taken != self.n_seeds:
                raise RuntimeError(f"the capture took {n_taken} seeds, the warm-up drew "
                                   f"{self.n_seeds}")
            for n, want, what in ((cap.n_lrs, self.k if state.schedule else 0, "learning rates"),
                                  (cap.n_scalars, self.k if rows is not None else 0,
                                   "row-sparse updates")):
                if n != want:
                    raise RuntimeError(f"the capture took {n} {what}, the call has {want}")
        finally:
            _active.clear()
            # the capture ran the Python once and executed nothing: no host
            # counter it moved may stand
            state.step = host[0]
            if rows is not None:
                rows["count"] = host[1]
            state.seed_generator.set_state(host[2])
            _set_launch_counts(host[3])
        self.launched = launches.since(host[3], after)
        if self._key(state, attrs_table, arrays, user_rows) != key:
            raise RuntimeError("the capture created or replaced state tensors (Adam's lazy "
                               "state?): a replay would write into tensors no one reads")
        self.graph, self.key, self.inputs, self.losses = graph, key, inputs, losses
        self.captures += 1
        return self._replay(state)

    def _replay(self, state):
        self.graph.replay()
        self.replays += 1
        state.step += self.k
        if state.items_state is not None:
            state.items_state["count"] += self.k
        launches.add(self.launched)
        return state, self.losses.clone()
