"""Activation checkpointing of the encoder stack, ``ModelConfig.remat``
(counterpart of the JAX package's ``jax.checkpoint`` of each encoder
block, ``carca_tpu/models/carca.py:67-77``).

``checkpointed_block`` runs one ``EncoderBlock`` under
``torch.utils.checkpoint`` (non-reentrant): the forward keeps the block's
input and drops what the block's operations would save for the backward;
the backward runs the block again and differentiates through the original
graph, so the gradients are summed in the same order as without remat.
Only the blocks are checkpointed, as in the JAX package: not the
embeddings, the final norm or the decoder.

The recompute must draw the forward's random bits, or the loss would be of
one function and the gradients of another. JAX's dropout keys are explicit
arguments; here each source of a block's bits is fixed before its forward:

* the attention kernels' Philox seed (``flash_attention.kernel_seed``) is
  drawn once, before the forward, and handed to both runs (a value, or
  under a CUDA graph capture a slot of the seed buffer): one seed per
  attention call, as without remat;
* the dropouts' ``generator`` (the FFN's two, and the plain attention's
  weight dropout) is rewound: the recompute draws from a generator set
  where ``generator`` stood before the forward (``Rewind``), and
  ``generator`` itself advances by the forward's draws alone.

``torch.utils.checkpoint(preserve_rng_state=True)`` would save and restore
the default generators only; this package draws from explicit ones, so
the checkpoint here preserves none.

Under a CUDA graph capture a generator's state can be neither read nor
set: a captured draw is an offset from where the generator stands at each
replay. There a rewind takes the next generator of those the capturing
call installed (``rewind_slots``); the graph registers them, and before
each replay ``position`` sets each to the train generator's state plus the
offset that generator had reached at that block's start in the eager
warm-up (``recording``), which the capture repeats (``train/graph.py``).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from carca_tpu_torch.ops.flash_attention import kernel_seed


class _Installed:
    """The rewind generators of the capture in progress, and the offsets a
    warm-up records."""
    generators: Optional[List[torch.Generator]] = None
    taken = 0
    recorded: Optional[List[Tuple[torch.Generator, Optional[int]]]] = None


@contextlib.contextmanager
def rewind_slots(generators: Sequence[torch.Generator]):
    """Install ``generators`` (CUDA, registered with the graph) for one
    capture: the rewinds of checkpointed blocks take them in call order.
    Yields a function that returns the number taken so far."""
    if _Installed.generators is not None:
        raise RuntimeError("rewind generators are already installed")
    _Installed.generators, _Installed.taken = list(generators), 0
    try:
        yield lambda: _Installed.taken
    finally:
        _Installed.generators, _Installed.taken = None, 0


@contextlib.contextmanager
def recording():
    """Yields the list that collects, for each rewind an eager call makes,
    (its generator, that generator's offset then; None for a CPU one)."""
    if _Installed.recorded is not None:
        raise RuntimeError("rewinds are already being recorded")
    _Installed.recorded = []
    try:
        yield _Installed.recorded
    finally:
        _Installed.recorded = None


def position(generators: Sequence[torch.Generator], source: torch.Generator,
             offsets: Sequence[int]) -> None:
    """Set each of ``generators`` to ``source``'s seed at ``source``'s
    offset plus its own of ``offsets``: before a replay, where the captured
    forward of each checkpointed block starts drawing."""
    state, base = source.get_state(), source.get_offset()
    for g, offset in zip(generators, offsets):
        g.set_state(state)
        g.set_offset(base + offset)


class Rewind:
    """Where ``generator`` stands now: ``generator()`` gives a generator
    that draws what ``generator`` draws from here on."""

    def __init__(self, generator: torch.Generator):
        self.device = generator.device
        self.slot: Optional[torch.Generator] = None
        self.state: Optional[torch.Tensor] = None
        if self.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            gens = _Installed.generators
            if gens is None:
                raise RuntimeError("a checkpointed block with dropout under CUDA graph capture "
                                   "needs rewind generators (remat.rewind_slots): its recompute "
                                   "would draw other bits than its forward")
            if _Installed.taken >= len(gens):
                raise RuntimeError(f"the capture takes more than the {len(gens)} rewind "
                                   "generators installed")
            self.slot = gens[_Installed.taken]
            _Installed.taken += 1
            return
        self.state = generator.get_state()
        if _Installed.recorded is not None:
            _Installed.recorded.append(
                (generator, generator.get_offset() if self.device.type == "cuda" else None))

    def generator(self) -> torch.Generator:
        if self.slot is not None:
            return self.slot
        g = torch.Generator(device=self.device)
        g.set_state(self.state)
        return g


def checkpointed_block(block, x: torch.Tensor, mask: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       seed_generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``block(x, mask, generator, seed_generator)`` (an ``EncoderBlock``)
    under activation checkpointing: the same output, gradients and
    generator states, with the block's activations recomputed in the
    backward instead of kept."""
    cfg = block.cfg
    drops = block.training and cfg.dropout > 0.0
    seed = None
    if drops and cfg.use_kernel is not False and x.device.type == "cuda":
        seed = kernel_seed(seed_generator)
    rewind = Rewind(generator) if drops and generator is not None else None
    ran = False

    def run(x):
        nonlocal ran
        g = generator if not ran or rewind is None else rewind.generator()
        ran = True
        return block(x, mask, g, seed_generator, seed=seed)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
