"""Each entry driven whole at a tiny test-only configuration on the CPU
through the harness (the look for a card skipped): a sound run of the
program comes out correct, and its result line holds the contract's
keys, the cell's metrics, and each checked number beside its limit,
last. The command itself refuses to run without a card."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import cells

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return cells.make_root(str(tmp_path_factory.mktemp("root")))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(cells.CELLS))
def test_entry_runs_and_prints_the_contracts_line(root, cell, trace):
    result = cells.run(root, cell, trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if trace else []) + [
        "checks"]
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    manifest = cells.manifest()
    if trace:
        wanted = {m["name"] for m in harness.per_layer(manifest, cell)}
        # The CPU has no device trace: only the host-clock readers read.
        assert set(result["metrics"]) <= wanted
        assert ("train_mfu" if cell == "tiny_train" else "serve_mfu") in \
            result["metrics"]
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in result["device"] and "window_s" in result["device"]
    else:
        wanted = {m["name"] for m in harness.end_to_end(manifest, cell)}
        assert set(result["metrics"]) == wanted
        assert all(m["value"] > 0 for m in result["metrics"].values())
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}
    json.dumps(result)


def test_same_seed_same_inputs_and_the_same_work():
    """A seed gives the same inputs again (a seed wider than 32 bits
    too); another seed other inputs, but the same caption lengths and
    image count, in another order."""
    from portbench import traffic

    with open(os.path.join(cells.DATA, "tiny_train.json")) as f:
        tr = json.load(f)
    with open(os.path.join(cells.DATA, "tiny-sat.json")) as f:
        cfg = json.load(f)
    seed = 2 ** 33 + 5
    a = traffic.train_batches(tr, cfg, seed)
    b = traffic.train_batches(tr, cfg, seed)
    c = traffic.train_batches(tr, cfg, seed + 1)
    for x, y in zip(a, b):
        assert (x["imgs"] == y["imgs"]).all()
        assert (x["captions"] == y["captions"]).all()
    assert any((x["imgs"] != y["imgs"]).any() for x, y in zip(a, c))
    lengths = lambda bs: sorted(x["captions"].shape[1] for x in bs)  # noqa
    assert lengths(a) == lengths(c)
    assert (traffic.request_ids(tr, seed, 3)
            == traffic.request_ids(tr, seed, 3)).all()


def test_command_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "sat_beam_b64",
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout == ""
