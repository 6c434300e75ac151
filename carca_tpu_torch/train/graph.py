"""Each train and eval step as one device dispatch: CUDA graphs of the
eager calls ``train/loop.py``'s step builders make. The JAX package has no
module for this: there ``jax.jit`` compiles each step (and the K-step
call's ``lax.scan``) into one dispatch (``carca_tpu/train/loop.py``:
``make_train_step``, ``make_device_train_step``,
``make_scanned_device_train_step``, ``make_eval_step``,
``make_device_eval_step``, ``make_scanned_device_eval_step``).

``GraphedStep`` wraps a train call on one card — the K-step call, the
device pipeline's one-step call or the host pipeline's step:

* its first call runs the eager call on a side stream: the warm-up that
  builds Adam's lazy state, loads the kernel library and fills the
  allocator. It trains as the eager call does;
* its second call captures the eager call on that stream (a capture runs
  the Python once and executes nothing) and replays the graph once;
* every later call replays the graph: one ``CUDAGraph.replay()``.

What differs per call the graph reads from static device memory, one
``utils/staging.py`` ``Region`` written before each replay through its
pinned host twin and one ``non_blocking`` copy: the batch (user rows [K, B]
or [B] of the device pipeline; p_x, p_c, o_x, o_c and y_true of a host
batch), the schedule's K learning rates (which ``loop.apply_gradients``
copies into Adam's lr tensor), the row-sparse Adam's K (lr, 1 − b1^t,
1 − b2^t) and one Philox seed per attention call with dropout, drawn from
``TrainState.seed_generator`` in the eager call's order (the kernels read
them through ``flash_attention.seed_slots``). The device generator that
draws the negatives and the plain dropouts is registered with the graph,
so each replay advances it as the eager call would. Under
``ModelConfig.remat`` each checkpointed encoder block's recompute draws
that generator's bits again from a generator of its own
(``models/remat.py``): the warm-up records where the train generator
stood at each block's start, the capture hands the blocks one registered
generator each, and each replay first sets them there
(``remat.position``). The host's counters —
``TrainState.step``, the sparse row state's count, the attention kernels'
launch counts — are put back after the capture and advanced by K steps'
worth at each replay. So a replay is the eager call, bit for bit, as far
as the eager call repeats itself. A call waits, before it writes the
pinned twin, for the last call's copy to have read it (the ``copied``
event): the host stays at most one call ahead of the card.

The graph is keyed by the identity of what it reads and writes in place:
the parameters and buffers, Adam's state tensors and lr, the sparse
moments, the tensors ``watch`` names (the EMA shadow), the catalog arrays,
the attrs table and the batch's shapes and dtypes.
``CheckpointKeeper.restore_latest`` and
``parallel.mesh.prepare_state_for_mesh`` replace Adam's tensors, so the
call after either captures anew; it never replays into stale tensors.

``GraphedEval`` wraps an eval step (the JAX package's jitted eval steps,
``make_knn_eval_step`` and the retrieval evaluator's ``embed_fn``,
``space_fn``, ``quant_fn`` and ``batch_metrics``): one graph per key — the data pointers
of the model's parameters and buffers, the attrs table and the catalog
arrays (for the retrieval evaluator also its index and row ids), the input
shapes and the eval generator — each with an eager warm-up, then a capture
and a replay, then replays. A step with no model (the KNN baseline's)
runs on its attrs table's device and is keyed by it. The eval generator is
registered with the graph; re-seeding it (``manual_seed``) between calls
restarts what the replays draw, as it restarts the eager draws. Its
graphs share one memory pool, apart from the train graph's: they replay
one at a time on one stream, and what a graph keeps between calls (its
region and outputs) stays allocated. The outputs are cloned after each
replay, which overwrites them. ``restore_best`` and ``load_state_dict``
copy into the parameters in place, so a replay reads the new values.

A capture that fails raises with its error: there is no eager retry. A
capture is made in the default ``"global"`` error mode, so no other
thread may call into CUDA meanwhile: the prefetch thread
(``data/prefetch.py``) assembles numpy batches and the checkpoint writers
(``train/checkpoint.py``) write host snapshots, and neither makes a CUDA
call.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from carca_tpu_torch.models import remat
from carca_tpu_torch.ops import launches
from carca_tpu_torch.ops.flash_attention import SEED_LIMIT, kernel_seed, seed_slots
from carca_tpu_torch.train import sparse_adam
from carca_tpu_torch.utils import staging
from carca_tpu_torch.utils.staging import Region, sections_of


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


class Feed(NamedTuple):
    """One call's arguments as a graph takes them: ``keyed`` tensors read in
    place (part of the key), ``staged`` arrays copied into the region each
    call, ``args(views)`` the eager call's arguments over the region's
    device views, and the eval ``generator`` (registered with the graph)."""

    keyed: List[torch.Tensor]
    staged: Dict[str, object]
    args: Callable[[Dict[str, torch.Tensor]], tuple]
    generator: Optional[torch.Generator] = None


def device_feed(k: Optional[int]) -> Callable[..., Feed]:
    """The device pipeline's arguments (catalog arrays, user rows [k, B],
    or [B] when ``k`` is None, and an eval step's generator): the arrays
    read in place, the rows staged."""
    ndim = 1 if k is None else 2

    def feed(arrays, user_rows, *generator) -> Feed:
        if user_rows.ndim != ndim or (k is not None and user_rows.shape[0] != k):
            raise ValueError(f"user_rows of shape {tuple(user_rows.shape)}: the step takes "
                             + ("[B]" if k is None else f"[{k}, B]"))
        return Feed(list(arrays.values()), {"rows": user_rows},
                    lambda d: (arrays, d["rows"], *generator),
                    generator[0] if generator else None)

    return feed


def host_feed(batch) -> Feed:
    """A host batch (``BatchBuilder``'s numpy arrays, or tensors), staged
    whole."""
    return Feed([], dict(batch), lambda d: (d,))


def fixed_feed(tensors: Dict[str, torch.Tensor]) -> Feed:
    """Tensors read in place and nothing staged: a call whose inputs stay
    put in device memory (the retrieval index's rows and row ids)."""
    return Feed(list(tensors.values()), {}, lambda d: (tensors,))


def train_sections(staged: Dict[str, object], k: int, n_seeds: int) -> list:
    """The sections of a train call's region: the batch's arrays, then int64
    seeds [n_seeds], float32 learning rates [k] and row-sparse scalars
    [k, 3]."""
    return [*sections_of(staged), ("seeds", torch.int64, (n_seeds,)),
            ("lrs", torch.float32, (k,)), ("scalars", torch.float32, (k, 3))]


class _Inputs:
    """A graph's per-call inputs: a ``Region`` on the card, written from the
    host once per call."""

    def __init__(self, sections, device):
        self.region = Region(sections, device)
        self.d = self.region.d
        self.copied: Optional[torch.cuda.Event] = None

    def write(self, values: Dict[str, object]) -> None:
        """Stage ``values`` (numpy arrays, host or card tensors) into their
        sections and copy the host twin to the device (card tensors go
        device to device after it)."""
        if self.copied is not None:
            self.copied.synchronize()  # the last call's copy has read the host twin
        on_card = {}
        for name, v in values.items():
            if torch.is_tensor(v):
                if v.device.type != "cpu":
                    on_card[name] = v
                    continue
                v = v.numpy()
            self.region.np[name][...] = v
        self.region.dev.copy_(self.region.host, non_blocking=True)
        if self.region.dev.is_cuda:
            self.copied = torch.cuda.Event()
            self.copied.record()
        for name, v in on_card.items():
            self.d[name].copy_(v)


def _adam_ready(optimizer) -> bool:
    """Whether every parameter that took a gradient has its Adam state, so
    that no state is created lazily inside a capture."""
    with_grad = [p for g in optimizer.param_groups for p in g["params"] if p.grad is not None]
    return bool(with_grad) and all(optimizer.state.get(p) for p in with_grad)


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def _cpu_call(required: bool, device: torch.device) -> bool:
    """Whether a call on ``device`` runs the eager step (it is not a card);
    raises when the graph was ``required``."""
    if device.type == "cuda":
        return False
    if required:
        raise ValueError("graph=True needs a CUDA state: a CUDA graph captures the "
                         f"card's work, and this state lies on {device}")
    return True


class GraphedStep:
    """The train call ``eager`` (state, attrs_table, *args) → (state,
    losses) as one CUDA graph on a CUDA state (see the module's docstring);
    on a CPU state it runs ``eager``, or raises when the graph was
    ``required``. ``feed`` says how ``args`` reach the graph (by default the
    K-step call's catalog arrays and user rows [K, B], which may lie on the
    host or on the card). ``watch()`` lists tensors the call updates in
    place beyond the train state (the EMA shadow)."""

    mode = "graph"

    def __init__(self, eager: Callable, inner_steps: int, tc, required: bool = False,
                 watch: Optional[Callable[[], Iterable[torch.Tensor]]] = None,
                 feed: Optional[Callable[..., Feed]] = None):
        self.eager, self.k, self.tc = eager, inner_steps, tc
        self.required, self.watch = required, watch
        self.feed = feed or device_feed(inner_steps)
        self.stream: Optional[torch.cuda.Stream] = None
        self.warm = False
        self.n_seeds = 0  # seeds one call draws, counted in the warm-up
        self.rewinds: List[int] = []  # the generator's offset at each remat block, in the warm-up
        self.rewind_gens: List[torch.Generator] = []  # the graph's, one per remat block
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.key = None
        self.inputs: Optional[_Inputs] = None
        self.losses: Optional[torch.Tensor] = None
        self.launched = None  # the captured call's kernel launches
        self.captures = 0
        self.replays = 0

    def __call__(self, state, attrs_table, *args):
        device = _device_of(state.model)
        if _cpu_call(self.required, device):
            return self.eager(state, attrs_table, *args)
        f = self.feed(*args)
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        key = self._key(state, attrs_table, f)
        if self.graph is not None and key == self.key:
            self._write(state, f.staged)
            return self._replay(state)
        if not self.warm or not _adam_ready(state.optimizer):
            return self._warm_up(state, attrs_table, args)
        return self._capture(state, attrs_table, f, key)

    def _key(self, state, attrs_table, f: Feed) -> tuple:
        opt = state.optimizer
        tensors = [*state.model.parameters(), *state.model.buffers(), attrs_table, *f.keyed]
        tensors += [g["lr"] for g in opt.param_groups if torch.is_tensor(g["lr"])]
        tensors += [v for st in opt.state.values() for v in st.values() if torch.is_tensor(v)]
        if state.items_state is not None:
            tensors.append(state.items_state["munu"])
        if self.watch is not None:
            tensors += list(self.watch())
        return (id(state.generator), tuple(sections_of(f.staged)),
                tuple(t.data_ptr() for t in tensors))

    def _write(self, state, staged: Dict[str, object]) -> None:
        """Stage one call's batch, seeds, learning rates and row scalars."""
        values = dict(staged, lrs=step_lrs(state.schedule, state.step, self.k))
        if self.n_seeds:
            values["seeds"] = draw_seeds(state.seed_generator, self.n_seeds)
            kernel_seed.drawn += self.n_seeds
        if state.items_state is not None:
            values["scalars"] = row_scalars(self.tc, state.items_state["count"], self.k)
        self.inputs.write(values)

    def _warm_up(self, state, attrs_table, args):
        drawn, start = kernel_seed.drawn, state.generator.get_offset()
        with remat.recording() as rewinds:
            state, losses = staging.side_stream_call(
                self.stream, lambda: self.eager(state, attrs_table, *args))
        self.n_seeds = kernel_seed.drawn - drawn
        if any(g is not state.generator for g, _ in rewinds):
            raise RuntimeError("a checkpointed block draws from a generator the graph does not "
                               "register: its replays would not draw the eager bits")
        self.rewinds = [offset - start for _, offset in rewinds]
        self.warm = True
        return state, losses

    def _capture(self, state, attrs_table, f: Feed, key):
        self.graph = self.key = self.inputs = self.losses = None  # frees an older graph
        self.rewind_gens = []
        self.inputs = _Inputs(train_sections(f.staged, self.k, self.n_seeds), self.stream.device)
        self._write(state, f.staged)
        d = self.inputs.d
        rows = state.items_state
        host = (state.step, None if rows is None else rows["count"],
                state.seed_generator.get_state(), launch_counts())
        cap = _Capture(d["lrs"], d["scalars"])
        gens = [torch.Generator(device=self.stream.device) for _ in self.rewinds]
        _active.append(cap)
        try:
            with seed_slots(d["seeds"]) as taken, remat.rewind_slots(gens) as rewound:
                graph, (_, losses) = staging.capture(
                    lambda: self.eager(state, attrs_table, *f.args({n: d[n] for n in f.staged})),
                    self.stream, generators=(state.generator, *gens))
                n_taken, n_rewound = taken(), rewound()
            after = launch_counts()
            if n_taken != self.n_seeds:
                raise RuntimeError(f"the capture took {n_taken} seeds, the warm-up drew "
                                   f"{self.n_seeds}")
            if n_rewound != len(gens):
                raise RuntimeError(f"the capture rewound {n_rewound} checkpointed blocks, the "
                                   f"warm-up {len(gens)}")
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
        if self._key(state, attrs_table, f) != key:
            raise RuntimeError("the capture created or replaced state tensors (Adam's lazy "
                               "state?): a replay would write into tensors no one reads")
        self.graph, self.key, self.losses = graph, key, losses
        self.rewind_gens = gens
        self.captures += 1
        return self._replay(state)

    def _replay(self, state):
        state.model.train()  # what the eager call leaves
        if self.rewind_gens:
            remat.position(self.rewind_gens, state.generator, self.rewinds)
        self.graph.replay()
        self.replays += 1
        state.step += self.k
        if state.items_state is not None:
            state.items_state["count"] += self.k
        launches.add(self.launched)
        return state, self.losses.clone()

    def pool_bytes(self) -> int:
        """Device bytes reserved by the graph's private memory pool."""
        return staging.pool_bytes(None if self.graph is None else self.graph.pool())


class _EvalGraph:
    """One eval graph: its inputs, outputs and launches; it holds the eval
    generator of its key, so that the generator's id stays its own."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: Optional[_Inputs] = None
        self.outputs: tuple = ()
        self.launched = launches.Launches()


class GraphedEval:
    """The eval step ``eager`` (model, attrs_table, *args) → a tuple of
    tensors as CUDA graph replays on a CUDA model, one graph per key (see
    the module's docstring); on a CPU model it runs ``eager``, or raises
    when the graph was ``required``. ``feed`` says how ``args`` reach the
    graph."""

    mode = "graph"

    def __init__(self, eager: Callable, feed: Callable[..., Feed], required: bool = False):
        self.eager, self.feed, self.required = eager, feed, required
        self.stream: Optional[torch.cuda.Stream] = None
        self.pool = None
        self.entries: Dict[tuple, _EvalGraph] = {}
        self.captures = 0
        self.replays = 0

    def __call__(self, model, attrs_table, *args):
        # a step with no model (the KNN baseline's) runs where its attrs lie
        device = attrs_table.device if model is None else _device_of(model)
        if _cpu_call(self.required, device):
            return self.eager(model, attrs_table, *args)
        f = self.feed(*args)
        key = self._key(model, attrs_table, f)
        entry = self.entries.get(key)
        if entry is None:
            out = self._warm_up(device, lambda: self.eager(model, attrs_table, *args))
            self.entries[key] = _EvalGraph(f.generator)
            return out
        if entry.graph is None:
            self._capture(entry, device, model, attrs_table, f)
        else:
            entry.inputs.write(f.staged)
        if model is not None:
            model.eval()  # what the eager call leaves
        entry.graph.replay()
        self.replays += 1
        launches.add(entry.launched)
        return tuple(t.clone() for t in entry.outputs)

    def _key(self, model, attrs_table, f: Feed) -> tuple:
        tensors = [] if model is None else [*model.parameters(), *model.buffers()]
        tensors += [attrs_table, *f.keyed]
        return (id(f.generator), tuple(sections_of(f.staged)),
                tuple((t.data_ptr(), t.shape, t.dtype) for t in tensors))

    def _warm_up(self, device, fn: Callable) -> tuple:
        """The eager call ``fn()`` on the side stream, outside any capture."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        return staging.side_stream_call(self.stream, fn)

    def _record(self, fn: Callable, generator: Optional[torch.Generator]):
        """(graph, outputs): ``fn`` captured on the side stream into the
        eval graphs' pool, ``generator`` registered with it."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        return staging.capture(fn, self.stream, self.pool, (generator,))

    def _capture(self, entry: _EvalGraph, device, model, attrs_table, f: Feed) -> None:
        inputs = _Inputs(sections_of(f.staged), device)
        inputs.write(f.staged)
        before = launches.snapshot()
        try:
            graph, outputs = self._record(
                lambda: self.eager(model, attrs_table, *f.args(inputs.d)), f.generator)
            launched = launches.since(before)
        finally:
            launches.restore(before)  # the capture launched nothing
        entry.graph, entry.inputs, entry.outputs, entry.launched = graph, inputs, outputs, launched
        self.captures += 1

    def pool_bytes(self) -> int:
        """Device bytes reserved by the eval graphs' pool."""
        return staging.pool_bytes(self.pool)
