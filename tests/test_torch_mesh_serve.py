"""``service --index_shards 2`` on the CPU: two ranks over gloo (2
processes of ``tests/torch_ranks.py``, ``suite_serve``, importing no jax),
each embedding and holding one block of the stage-1 index, rank 0 reading
stdin and writing stdout. Its answers equal the one-shard service's on the
same run directory and requests, line for line (ids, and scores as the
service rounds them); with a row-sharded index the same rows are scored
with the same arithmetic, so the plain versions agree exactly.

Runs: the ``smoke`` preset (``ca`` decoder: stage 1 then the rerank) over
the seen f32 index, and its shape with the ``dot`` decoder (stage 1
alone) over the full int8 index of 101 rows, which two shards split with one pad row;
then ``--bench``. A world whose size is not ``--index_shards`` is
refused.
"""

import io
import json

import pytest
import torch

from carca_tpu_torch import cli
from carca_tpu_torch.serve import service
from tests.torch_ranks import launch

torch.set_num_threads(1)

USERS, ITEMS = 200, 100


def request_lines(n_ctx):
    return [json.dumps({"user": u, "id": f"u{u}"}) for u in (3, 17, 150, 199)] + [
        json.dumps({"history": [5, 9, 2, 40], "k": 6, "id": "hist"}),
        json.dumps({"history": [4, 9, 2], "ctx": [[0.1] * n_ctx] * 3, "k": 2}),
        json.dumps({"user": 11, "k": 12, "id": "k-override"}),
        "{not json", json.dumps({"user": USERS, "id": "out of range"})]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_serve")
    base = ["--synthetic", "true", "--preset", "smoke", "--epochs", "1", "--resume", "false",
            "--synthetic_users", str(USERS), "--synthetic_items", str(ITEMS)]
    cli.main(base + ["--out_dir", str(root / "ca")], device="cpu")
    # the smoke preset's shape with the dot decoder (a preset keeps its own
    # decoder against the flag's default, "dot")
    cli.main(base[:2] + base[4:] + ["--d_dim", "16", "--g_dim", "32", "--n_blocks", "2",
                                    "--seq_len", "10", "--target_seq_len", "20",
                                    "--batch_size", "32", "--out_dir", str(root / "dot")],
             device="cpu")
    stdin = "\n".join(request_lines(4)) + "\n"
    runs = {
        "ca seen f32": ["--run_dir", str(root / "ca"), "--k", "5", "--shortlist", "16"],
        "dot full int8": ["--run_dir", str(root / "dot"), "--k", "5", "--index", "full",
                          "--quantize_index", "true"],
        "dot bench": ["--run_dir", str(root / "dot"), "--bench", "--iters", "2"],
    }
    sharded = launch(2, "serve", {"stdin": stdin, "runs": {
        name: argv + ["--index_shards", "2"] for name, argv in runs.items()}})
    one = {}
    for name, argv in runs.items():
        buf = io.StringIO()
        service.main(argv, device="cpu", stdin=io.StringIO(stdin), stdout=buf)
        one[name] = buf.getvalue()
    return {"sharded": sharded, "one": one, "root": root}


@pytest.mark.parametrize("name", ["ca seen f32", "dot full int8"])
def test_index_shards_answers_equal_one_shard(served, name):
    got = [json.loads(ln) for ln in served["sharded"][0][name].splitlines()]
    want = [json.loads(ln) for ln in served["one"][name].splitlines()]
    assert len(got) == len(want) == 9
    assert got == want
    assert sum("error" in g for g in got) == 2 and len(got[6]["items"]) == 12
    assert served["sharded"][1][name] == ""  # rank 1 writes nothing


def test_index_shards_bench(served):
    rows = [json.loads(ln) for ln in served["sharded"][0]["dot bench"].splitlines()]
    assert [r["batch"] for r in rows] == [1, 8, 64, 256]
    assert all(r["p50_ms"] > 0 for r in rows)


def test_index_shards_other_than_the_world_is_refused(served):
    """(g) One process asked for two shards."""
    with pytest.raises(ValueError, match="world size of 2"):
        service.main(["--run_dir", str(served["root"] / "ca"), "--index_shards", "2"],
                     device="cpu")
