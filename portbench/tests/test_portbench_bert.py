"""The BERT configuration's entry (``entries/train_bert.py``) at the tiny
cell ``tiny_train_bert`` on the CPU through the harness: the contract's
line, sound, and not correct under its controls and faults; its inputs
from the seed, with new words at every step and a WordPiece vocabulary
in bert-base-uncased's layout; the readers of its four metrics; the device-time join on a
hand-made trace; and BERT's frozen count against ``chip_smoke``'s."""

import json
import math
import os

import numpy as np
import pytest

from portbench import bert_inputs, harness, traffic
from portbench.counts import bert as cb
from portbench.entries import train_bert
from portbench.metrics import (bert_device_ms, bert_forward_host_ms,
                               bert_roofline_pct, bert_tokenize_host_ms)
from portbench.reference import bert as ref_bert
from portbench.tests import bert_cells, cells
from portbench.trace import Reading

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
CELL = bert_cells.CELL
SPANS = ("bert_tokenize_host_ms", "bert_forward_host_ms")
DEVICE = ("bert_device_ms", "bert_roofline_pct")


def _json(*path):
    with open(os.path.join(*path)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bert_cells.make_root(str(tmp_path_factory.mktemp("root")))


@pytest.mark.parametrize("trace", [False, True])
def test_entry_prints_the_contracts_line(root, trace):
    result = cells.run(root, CELL, trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if trace else []) + [
        "checks"]
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result["checks"]) == [
        "piece_mismatch", "embed_gap", "loss_gap", "grad_gap", "change_gap",
        "bn_gap"]
    assert result["checks"]["piece_mismatch"]["value"] == 0
    manifest = bert_cells.manifest()
    if trace:
        wanted = {m["name"] for m in harness.per_layer(manifest, CELL)}
        assert set(SPANS + DEVICE) <= wanted
        # BERT's spans are on the producer thread; the CPU has no device
        # trace, so the device readers stay silent.
        for name in SPANS + ("train_forward_host_ms", "train_mfu"):
            value = result["metrics"][name]["value"]
            assert math.isfinite(value) and value > 0, name
        assert not set(DEVICE) & set(result["metrics"])
    else:
        assert set(result["metrics"]) == {"train_images_per_s", "setup_s"}
    json.dumps(result)


@pytest.mark.parametrize("variant", ["unpadded"])
def test_a_control_fails_the_limits(root, variant):
    result = cells.run(root, CELL, variant=variant)
    checks = result["checks"]
    assert result["correct"] is False
    assert checks["piece_mismatch"]["value"] > 0
    assert checks["embed_gap"]["value"] > checks["embed_gap"]["limit"]


@pytest.mark.parametrize("fault", sorted(train_bert.FAULTS))
def test_a_training_fault_is_not_correct(root, fault):
    result = cells.run(root, CELL, fault=train_bert.FAULTS[fault], seconds=0)
    assert result["correct"] is False, result["checks"]


def _tiny():
    return (_json(cells.DATA, "tiny-sat-bert.json"),
            _json(cells.DATA, "tiny_train_bert.json"))


def test_same_seed_same_inputs_new_words_each_step():
    cfg, tr = _tiny()
    seed = 2 ** 33 + 5
    pool = traffic.train_batches(tr, cfg, seed)
    batch = pool[0]
    a = bert_inputs.fresh_captions(batch, cfg["vocab_size"], seed, 0)
    again = bert_inputs.fresh_captions(batch, cfg["vocab_size"], seed, 0)
    step1 = bert_inputs.fresh_captions(batch, cfg["vocab_size"], seed, 1)
    other = bert_inputs.fresh_captions(batch, cfg["vocab_size"], seed + 1, 0)
    assert (a["captions"] == again["captions"]).all()
    for x in (a, step1, other):
        words = x["captions"] != batch["captions"]
        # <start>, <end> and the padding stay; only words change.
        assert (x["captions"] == 0).sum() == (batch["captions"] == 0).sum()
        assert (x["captions"][:, 0] == batch["captions"][:, 0]).all()
        assert (x["imgs"] is batch["imgs"])
        assert words.any()
        live = x["captions"][(x["captions"] > 0)
                             & (x["captions"] < cfg["vocab_size"] - 3)]
        assert live.min() >= 1 and live.max() <= cfg["vocab_size"] - 4
    assert (a["captions"] != step1["captions"]).any()
    assert (a["captions"] != other["captions"]).any()
    assert "captions" in batch and batch["captions"] is not a["captions"]
    assert bert_inputs.caption_words(cfg, seed) == \
        bert_inputs.caption_words(cfg, seed)
    assert bert_inputs.caption_words(cfg, seed) != \
        bert_inputs.caption_words(cfg, seed + 1)


def test_wordpiece_vocab_is_bert_base_uncased_sized_and_laid_out(tmp_path):
    cfg = _json(ROOT, "portbench", "configs", "sat-bert-resnet101.json")
    seed = 4294967311
    words = bert_inputs.caption_words(cfg, seed)
    assert len(words) == cfg["vocab_size"] == 10000
    assert len(set(words)) == len(words)
    assert words[0] == "<pad>" and words[-3:] == ["<start>", "<end>", "<unk>"]
    assert all(3 <= len(w) <= 10 and w.isalpha() and w.islower()
               for w in words[1:-3])
    path = bert_inputs.write_wordpiece_vocab(str(tmp_path / "vocab.txt"),
                                             cfg, words, seed)
    with open(path) as f:
        lines = f.read().split("\n")[:-1]
    assert len(lines) == len(set(lines)) == 30522
    assert lines[0] == "[PAD]" and lines[1] == "[unused0]"
    assert lines[100:104] == ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    assert lines[998] == "[unused993]"
    tok = ref_bert.Tokenizer(path)
    pieces = [len(tok.tokenize(w)) for w in words[1:-3]]
    whole = sum(n == 1 for n in pieces) / len(pieces)
    assert 0.88 <= whole <= 0.92
    assert 1.10 <= np.mean(pieces) <= 1.25
    assert [tok.tokenize(w) for w in ("<start>", "<end>", "<pad>")] == [
        ["<", "start", ">"], ["<", "end", ">"], ["<", "pad", ">"]]


def _event(cat, name, ts, dur, tid, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "tid": tid, "pid": 1}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_device_time_joins_launches_inside_bert_forward_on_its_thread():
    producer, step = 7, 3
    events = [
        _event("user_annotation", "bert_forward", 100, 50, producer),
        _event("user_annotation", "train_step", 90, 80, step),
        # counted: launched inside the span, on its thread
        _event("cuda_runtime", "cudaLaunchKernel", 110, 2, producer, 1),
        _event("cuda_driver", "cuLaunchKernelEx", 120, 2, producer, 2),
        _event("cuda_runtime", "cudaMemcpyAsync", 101, 2, producer, 3),
        # not counted: the step's thread at the same time
        _event("cuda_runtime", "cudaLaunchKernel", 115, 2, step, 4),
        # not counted: the producer outside the span
        _event("cuda_runtime", "cudaLaunchKernel", 160, 2, producer, 5),
        _event("kernel", "gemm", 200, 10, 0, 1),
        _event("kernel", "gemm", 215, 20, 0, 2),
        _event("gpu_memcpy", "Memcpy HtoD", 199, 1, 0, 3),
        _event("kernel", "trunk", 230, 400, 0, 4),
        _event("kernel", "later", 700, 300, 0, 5),
    ]
    assert train_bert.bert_device_seconds(events) == pytest.approx(31e-6)
    assert train_bert.bert_device_seconds(events[1:]) is None


def _reading(counters, spans=()):
    return Reading(list(spans), [], 1.0, counters)


def test_bert_readers_on_hand_made_readings():
    spans = [("window", 0.0, 1.0)] + [
        (name, t + a, t + b) for t in (0.1, 0.5) for name, a, b in (
            ("train_step", 0.0, 0.1), ("bert_tokenize", 0.0, 0.002),
            ("bert_forward", 0.002, 0.012))]
    reading = _reading({"traced_steps": 2, "bert_device_s": 0.02,
                        "bert_bound_s": 0.008}, spans)
    assert bert_tokenize_host_ms.read(reading) == pytest.approx(2.0)
    assert bert_forward_host_ms.read(reading) == pytest.approx(10.0)
    assert bert_device_ms.read(reading) == pytest.approx(10.0)
    assert bert_roofline_pct.read(reading) == pytest.approx(40.0)
    # A program without BERT's spans (the parent of this cell's PR).
    older = _reading({"traced_steps": 2, "bert_bound_s": 0.008},
                     [s for s in spans if not s[0].startswith("bert_")])
    for reader in (bert_tokenize_host_ms, bert_forward_host_ms,
                   bert_device_ms, bert_roofline_pct):
        assert reader.read(older) is None


def test_bert_count_is_chip_smokes():
    import chip_smoke

    cfg = _json(ROOT, "portbench", "configs", "sat-bert-resnet101.json")
    lengths = [40, 57, 33, 61]
    mask = np.zeros((4, 61))
    for r, n in enumerate(lengths):
        mask[r, :n] = 1
    assert cb.forward_flops(lengths, cfg["bert"]) == pytest.approx(
        chip_smoke.bert_forward_gflop(mask) * 1e9, rel=1e-12)
    # A batch of ~50 pieces a caption is bound by its operations.
    flops = cb.forward_flops([50] * 32, cfg["bert"])
    assert cb.bound_s([50] * 32, cfg["bert"]) == pytest.approx(flops / 67e12)
