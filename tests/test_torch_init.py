"""Where the port's fresh weights are drawn (``utils/initializers.py``, the
modules of ``models/``, ``train/state.py``) and the checkpoint keeper's
snapshot buffers (``train/checkpoint.py``).

On the CPU:

* with a CPU generator, ``xavier_uniform``, ``embedding_init``, ``CARCA``
  and ``create_train_state(device="cpu")`` give the weights of the explicit
  recipe bit for bit: per parameter, in construction order, ``torch.rand``
  then u·2a − a with a = sqrt(6 / (fan_in + fan_out)), the item table's
  pad row zero, the biases and LayerNorm's shift zero, its scale one, the
  sinusoid table of the positional encoding;
* a model whose generator lies on its device creates every parameter and
  buffer there and moves nothing (no ``Tensor.to``, no ``Module.to``); one
  whose generator lies elsewhere is drawn there and moved once;
* every weight lies in ±a and the pad row is zero;
* the keeper's snapshots of CPU tensors stay pageable and pin nothing, and
  a kind's second save writes what a fresh ``_host_copy`` gives; the bounce
  chunks' pipeline (every byte, tails, the same two chunks, each waited
  for before it is refilled) with stand-ins for the page-locked chunks and
  the events.

The JAX parity tests load JAX weights through ``bridge.params_from_jax``
into a model drawn by these initializers (``test_torch_train.py``,
``test_torch_models.py``), so they hold whatever the draw.

On the card (``cuda`` marker, skipped here; run there with ``python -m
pytest --noconftest tests/test_torch_init.py -q -m cuda``): the default
generator and ``create_train_state`` draw on the card (the same seed the
same weights twice, in ±a, the pad row zero, nothing moved); snapshots
stream through two page-locked chunks into pageable memory, bit-equal to
the device state, the same chunks at every save, and a write in flight
keeps reading its own snapshot while another save streams.
"""

import math
import threading

import pytest
import torch

from carca_tpu_torch.config import ModelConfig, TrainConfig
from carca_tpu_torch.models.carca import CARCA
from carca_tpu_torch.train import checkpoint
from carca_tpu_torch.train.checkpoint import CheckpointKeeper, _Bounce, _host_copy
from carca_tpu_torch.train.state import create_train_state
from carca_tpu_torch.utils.initializers import embedding_init, xavier_uniform

torch.set_num_threads(1)

DRAWN = ("w", "items", "table")  # the Xavier-drawn parameters' names


def config(embedding="all", encoding="learnable", decoder="ca", n_items=41) -> ModelConfig:
    return ModelConfig(n_items=n_items, n_attrs=5, n_ctx=3, d=16, g=24, seq_len=8,
                       target_len=6, n_blocks=2, n_heads=2, embedding=embedding,
                       encoding=encoding, decoder=decoder)


CONFIGS = [("all", "learnable", "ca"), ("mlpid", "positional", "dot"),
           ("attr", "identity", "wdot"), ("id", "positional", "ca"),
           ("attrctx", "learnable", "dot")]


def recipe(model: CARCA, seed: int) -> dict:
    """The weights today's CPU draw gives ``model``'s parameters from
    ``seed``, written out: one ``torch.rand`` per drawn parameter in
    construction order, then u·2a − a. That is ``named_parameters``' order
    but for the learnable encoding's table, which ``Embedding`` makes
    before its item table."""
    g = torch.Generator().manual_seed(seed)
    params = dict(model.named_parameters())
    order = sorted(params, key=lambda n: n != "embed.enc.table")  # a stable sort
    want = {}
    for name in order:
        p = params[name]
        leaf = name.rsplit(".", 1)[-1]
        if leaf in DRAWN:
            a = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            want[name] = torch.rand(tuple(p.shape), generator=g) * (2.0 * a) - a
            if leaf == "items":
                want[name][0] = 0.0
        elif leaf == "scale":
            want[name] = torch.ones(p.shape)
        else:
            want[name] = torch.zeros(p.shape)
    return want


def sinusoid(max_len: int, d: int) -> torch.Tensor:
    pos = torch.arange(max_len, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32) * (-math.log(10000.0) / d))
    pe = torch.zeros(max_len, d)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def assert_recipe(model: CARCA, seed: int) -> None:
    want = recipe(model, seed)
    got = dict(model.named_parameters())
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert torch.equal(got[name].detach(), w), name
    if model.cfg.encoding == "positional":
        assert torch.equal(model.embed.enc.pe, sinusoid(model.cfg.seq_len, model.cfg.d))


@pytest.mark.parametrize("shape,gain", [((7, 5), 1.0), ((1, 33), 1.0), ((12, 4), 0.5)])
def test_xavier_uniform_on_a_cpu_generator_is_the_recipe(shape, gain):
    got = xavier_uniform(shape, torch.Generator().manual_seed(3), gain=gain)
    a = gain * math.sqrt(6.0 / (shape[0] + shape[1]))
    u = torch.rand(shape, generator=torch.Generator().manual_seed(3))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert torch.equal(got, u * (2.0 * a) - a)


@pytest.mark.parametrize("zero_pad_row", [True, False])
def test_embedding_init_on_a_cpu_generator_is_the_recipe(zero_pad_row):
    got = embedding_init(30, 8, torch.Generator().manual_seed(4), zero_pad_row=zero_pad_row)
    a = math.sqrt(6.0 / 38)
    want = torch.rand((30, 8), generator=torch.Generator().manual_seed(4)) * (2.0 * a) - a
    if zero_pad_row:
        want[0] = 0.0
    assert torch.equal(got, want)


@pytest.mark.parametrize("embedding,encoding,decoder", CONFIGS)
def test_carca_on_a_cpu_generator_is_the_recipe(embedding, encoding, decoder):
    mc = config(embedding, encoding, decoder)
    model = CARCA(mc, generator=torch.Generator().manual_seed(9), device="cpu")
    assert_recipe(model, 9)
    assert_recipe(CARCA(mc, device="cpu"), 0)  # the default generator: seed 0


@pytest.mark.parametrize("sparse", [False, True])
def test_create_train_state_on_the_cpu_is_the_recipe(sparse):
    tc = TrainConfig(seed=17)
    state = create_train_state(config(), tc, device="cpu", sparse_items=sparse)
    assert_recipe(state.model, tc.seed)
    if sparse:
        assert not state.items_state["munu"].any()
        assert state.items_state["munu"].shape == (41, 32)


@pytest.fixture
def spies(monkeypatch):
    """Every ``Tensor.to`` and ``Module.to`` call, recorded."""
    calls = []
    tensor_to, module_to = torch.Tensor.to, torch.nn.Module.to

    def on_tensor(self, *a, **kw):
        calls.append(("Tensor.to", a, kw))
        return tensor_to(self, *a, **kw)

    def on_module(self, *a, **kw):
        calls.append(("Module.to", a, kw))
        return module_to(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "to", on_tensor)
    monkeypatch.setattr(torch.nn.Module, "to", on_module)
    return calls


@pytest.mark.parametrize("embedding,encoding,decoder", CONFIGS)
def test_a_generator_on_the_model_device_creates_everything_there_and_moves_nothing(
        spies, embedding, encoding, decoder):
    mc = config(embedding, encoding, decoder)
    model = CARCA(mc, generator=torch.Generator(device="cpu").manual_seed(1), device="cpu")
    default = CARCA(mc, device="cpu")
    state = create_train_state(mc, TrainConfig(), device="cpu")
    assert spies == []
    for m in (model, default, state.model):
        assert all(t.device.type == "cpu" for t in [*m.parameters(), *m.buffers()])


def test_a_generator_elsewhere_draws_there_and_moves_the_model_once(spies):
    mc = config(encoding="positional")
    model = CARCA(mc, generator=torch.Generator().manual_seed(2), device="meta")
    assert [c[0] for c in spies].count("Module.to") == 1
    assert all(t.device.type == "meta" for t in [*model.parameters(), *model.buffers()])


@pytest.mark.parametrize("embedding,encoding,decoder", CONFIGS)
def test_weights_lie_within_the_xavier_bound_and_the_pad_row_is_zero(
        embedding, encoding, decoder):
    model = CARCA(config(embedding, encoding, decoder), device="cpu")
    drawn = 0
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in DRAWN:
            a = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            assert float(p.detach().abs().max()) <= a, name
            drawn += 1
    assert drawn > 0
    if hasattr(model.embed, "items"):
        assert not model.embed.items[0].any()


# --------------------------------------------------------------------------
# the keeper's snapshots
# --------------------------------------------------------------------------

def state_dict_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def train_in_place(state) -> None:
    """What a replay does between two saves: every parameter and moment
    changed in place."""
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(0.25)
    for st in state.optimizer.state.values():
        for v in st.values():
            if torch.is_tensor(v) and v.dim():
                v.add_(1.0)


def one_step(state) -> None:
    """One Adam step on a made-up loss, so that Adam holds its moments."""
    loss = sum((p * p).sum() for p in state.model.parameters())
    loss.backward()
    state.optimizer.step()
    state.optimizer.zero_grad()
    state.step += 1


def test_cpu_snapshots_stay_pageable_and_a_second_save_is_a_fresh_host_copy(
        tmp_path, monkeypatch):
    written = []
    real = checkpoint._save

    def recorded(obj, path):
        written.append(obj)
        real(obj, path)

    monkeypatch.setattr(checkpoint, "_save", recorded)
    state = create_train_state(config(), TrainConfig(seed=3), device="cpu", sparse_items=True)
    one_step(state)
    keeper = CheckpointKeeper(str(tmp_path))
    for epoch in (1, 2):
        keeper.save_latest(epoch, state)
        keeper.save(epoch, state.model, {"ndcg": float(epoch)})
        keeper.wait()
        assert keeper.pinned_bytes == 0
        if epoch == 1:
            train_in_place(state)
    tensors = [t for obj in written for t in leaves(obj)]
    assert tensors and not any(t.is_pinned() for t in tensors)
    ck = torch.load(keeper.latest, weights_only=False)
    assert state_dict_equal(ck["model"], _host_copy(state.model.state_dict()))
    fresh = _host_copy(checkpoint._portable_optimizer(state.optimizer.state_dict()))
    for slot, st in fresh["state"].items():
        assert all(torch.equal(ck["optimizer"]["state"][slot][k], v) for k, v in st.items())
    assert torch.equal(ck["items_state"]["munu"], state.items_state["munu"])
    best = torch.load(keeper.best_params, weights_only=False)
    assert state_dict_equal(best, _host_copy(state.model.state_dict()))
    keeper.close()


def leaves(obj) -> list:
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in leaves(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in leaves(v)]
    return []


class FakeEvent:
    """Stands in for ``torch.cuda.Event`` (a CPU copy has ended already)."""

    log: list = []

    def record(self, stream):
        FakeEvent.log.append(("record", id(self)))

    def synchronize(self):
        FakeEvent.log.append(("wait", id(self)))


@pytest.mark.parametrize("dtype,shape", [(torch.float32, (37, 5)), (torch.int64, (3,)),
                                         (torch.bool, (9, 2)), (torch.float32, ()),
                                         (torch.float32, (0, 4)), (torch.bfloat16, (31,))])
def test_the_bounce_chunks_stream_every_byte_and_are_reused(monkeypatch, dtype, shape):
    """The chunk pipeline, on the CPU with stand-ins for the page-locked
    chunks and the events: bit-equal copies at a chunk of 16 bytes (tails
    and several refills), the same two chunks for every tensor, each
    chunk's event waited for before it is refilled."""
    monkeypatch.setattr(checkpoint, "_page_locked", lambda n: torch.zeros(n, dtype=torch.uint8))
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    FakeEvent.log = []
    bounce = _Bounce(chunk_bytes=16)
    g = torch.Generator().manual_seed(5)
    x = (torch.rand(shape, generator=g) * 100).to(dtype)
    got = bounce.copy(x)
    assert got.dtype == dtype and got.shape == x.shape and torch.equal(got, x)
    assert (x.numel() == 0 or got.data_ptr() != x.data_ptr()) and bounce.nbytes == 32
    chunks = [c.data_ptr() for c in bounce.chunks]
    again = bounce.copy(x[..., None] if x.dim() else x)
    assert torch.equal(again.reshape(x.shape), x)
    assert [c.data_ptr() for c in bounce.chunks] == chunks
    n = math.ceil(x.numel() * x.element_size() / 16)
    records = [e for kind, e in FakeEvent.log if kind == "record"]
    waits = [e for kind, e in FakeEvent.log if kind == "wait"]
    assert len(records) == len(waits) == 2 * n and sorted(records) == sorted(waits)
    for i, (kind, e) in enumerate(FakeEvent.log):  # a chunk is refilled after its wait
        if kind == "record" and records.index(e) % n >= 2:
            prev = records[records.index(e) - 2]
            assert FakeEvent.log.index(("wait", prev)) < i


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the weights are drawn by the card's generator")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("embedding,encoding,decoder", CONFIGS)
def test_card_the_default_generator_draws_on_the_card(dev, spies, embedding, encoding,
                                                       decoder):
    mc = config(embedding, encoding, decoder, n_items=20_001)
    a, b = CARCA(mc, device=dev), CARCA(mc, device=dev)
    assert spies == []  # drawn where they live: no move
    tc = TrainConfig(seed=5)
    sparse = hasattr(a.embed, "items")  # the row state of an item table, where there is one
    s1, s2 = (create_train_state(mc, tc, dev, sparse_items=sparse) for _ in range(2))
    assert "Module.to" not in [c[0] for c in spies]
    for m in (a, s1.model):
        assert all(t.is_cuda for t in [*m.parameters(), *m.buffers()])
    assert state_dict_equal(a.state_dict(), b.state_dict())
    assert state_dict_equal(s1.model.state_dict(), s2.model.state_dict())
    if sparse:
        assert s1.items_state["munu"].is_cuda and not s1.items_state["munu"].any()
    cpu = recipe(a, 0)
    for name, p in a.named_parameters():
        if name.rsplit(".", 1)[-1] in DRAWN:
            bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            assert float(p.detach().abs().max()) <= bound, name
            assert not torch.equal(p.detach().cpu(), cpu[name]), name  # the card's stream
    if hasattr(a.embed, "items"):
        assert not a.embed.items[0].any() and not s1.model.embed.items[0].any()
    if encoding == "positional":
        torch.testing.assert_close(a.embed.enc.pe.cpu(), sinusoid(mc.seq_len, mc.d),
                                   rtol=0, atol=1e-6)


def card_state(dev):
    state = create_train_state(config(n_items=5_001), TrainConfig(seed=7), dev,
                               sparse_items=True)
    one_step(state)
    return state


def device_state(state) -> dict:
    return {"model": {k: v.cpu() for k, v in state.model.state_dict().items()},
            "munu": state.items_state["munu"].cpu()}


def assert_file_is(keeper, want: dict) -> None:
    ck = torch.load(keeper.latest, weights_only=False)
    assert state_dict_equal(ck["model"], want["model"])
    assert torch.equal(ck["items_state"]["munu"], want["munu"])


@pytest.mark.cuda
def test_card_snapshots_stream_through_the_same_pinned_chunks(dev, tmp_path, monkeypatch):
    """Snapshots bit-equal to the device state through 1 MiB chunks (the
    5,001 × 16 table and its row state span several, with a tail), the same
    two page-locked chunks at every save of either kind, the files in
    pageable memory, the chunks let go at close."""
    monkeypatch.setattr(checkpoint._Bounce.__init__, "__defaults__", (1 << 20,))
    written = []
    real = checkpoint._save

    def recorded(obj, path):
        written.append(obj)
        real(obj, path)

    monkeypatch.setattr(checkpoint, "_save", recorded)
    state = card_state(dev)
    keeper = CheckpointKeeper(str(tmp_path))
    pointers = []
    for epoch in (1, 2):
        want = device_state(state)
        keeper.save_latest(epoch, state)
        keeper.save(epoch, state.model, {"ndcg": float(epoch)})
        chunks = keeper._bounce.chunks
        assert len(chunks) == 2 and all(c.is_pinned() for c in chunks)
        pointers.append([c.data_ptr() for c in chunks])
        keeper.wait()
        assert_file_is(keeper, want)
        assert state_dict_equal(torch.load(keeper.best_params, weights_only=False),
                                want["model"])
        train_in_place(state)
    assert pointers[0] == pointers[1] and keeper.pinned_bytes == 2 << 20
    tensors = [t for obj in written for t in leaves(obj)]
    assert tensors and not any(t.is_pinned() or t.is_cuda for t in tensors)
    keeper.close()
    assert keeper.pinned_bytes == 0


@pytest.mark.cuda
def test_card_a_write_in_flight_reads_its_own_snapshot_while_another_save_streams(
        dev, tmp_path, monkeypatch):
    """latest/'s write is held while best/ snapshots through the same
    chunks and the state changes: latest/'s file is still the first state."""
    monkeypatch.setattr(checkpoint._Bounce.__init__, "__defaults__", (1 << 20,))
    gate, started = threading.Event(), threading.Event()
    real = checkpoint._save

    def gated(obj, path):
        if path.endswith("state.pt"):
            started.set()
            assert gate.wait(60)
        real(obj, path)

    monkeypatch.setattr(checkpoint, "_save", gated)
    state = card_state(dev)
    keeper = CheckpointKeeper(str(tmp_path))
    first = device_state(state)
    keeper.save_latest(1, state)
    assert started.wait(60)
    train_in_place(state)
    keeper.save(1, state.model, {"ndcg": 1.0})
    keeper._best.wait()  # best/'s write has ended; latest/'s is still held
    assert keeper._latest.pending
    gate.set()
    keeper.wait()
    assert_file_is(keeper, first)
    assert state_dict_equal(torch.load(keeper.best_params, weights_only=False),
                            device_state(state)["model"])
    keeper.close()
    assert not any(t.name.startswith("checkpoint-") for t in threading.enumerate())
