"""The training data path's aids in the port, each held to the run
without it on the CPU (tolerance: none, the losses are compared to the
bit), and the device image cache's protocol against icd_tpu's.

- ``DeviceImageCache.rewrite`` gives icd_tpu's ``idx``, slots (icd_tpu's
  without its power-of-two padding), fresh pixels, hits and misses on
  one id stream, eviction included; ``insert`` + ``gather`` give back
  each batch's pixels.
- ``python -m icd_tpu_torch.train``'s epoch losses are the same with
  ``ICD_TPU_DEVICE_IMAGE_CACHE`` (a budget for every image, and one of
  a single batch under the loader's queue of 2, which evicts),
  ``ICD_TPU_IMAGE_CACHE``, ``ICD_TPU_LOSS_FETCH_BLOCK=1`` and
  ``ICD_TPU_CKPT_ASYNC=1`` (whose checkpoint is byte-equal to the
  synchronous one) as without them, and the train loop's
  ``device_prefetch`` staging gives the losses of a synchronous loop.
- An async save holds the values at save time while training changes
  the parameters and Adam's moments in place at once (the writer held
  back on purpose); a snapshot that reads the live tensors would not.
- ``ICD_TPU_PROFILE`` writes a trace with the ``train_step`` and
  ``checkpoint`` spans; unset, nothing.

The fixture: 12 train images of 40x40 with 3 captions each, batch 4
(9 steps), a (1, 1, 1, 1) ResNet of widths (4, 4, 8, 8), A = 10,
H = 12, E = 16, dropout 0.5 (the same generator stream in every run).
"""

import functools
import json
import os
import time

import numpy as np
import pytest
import torch

from icd_tpu.data.pipeline import Batch as JaxBatch
from icd_tpu.data.pipeline import DeviceImageCache as JaxDeviceImageCache
import icd_tpu_torch.checkpoint as checkpoint
import icd_tpu_torch.training.attention as ta
from icd_tpu_torch import train as port_train
from icd_tpu_torch.data import dataset as port_dataset
from icd_tpu_torch.data.pipeline import Batch, DataLoader, DeviceImageCache
from icd_tpu_torch.models.attention import init_attention_decoder
from icd_tpu_torch.models.encoder import EncoderAttention
from icd_tpu_torch.models.resnet import init_resnet
from icd_tpu_torch.params import adam_state_to_jax, decoder_to_jax
from icd_tpu_torch.training import common
from icd_tpu_torch.utils import profiling
from helpers import SMALL_DEPTHS, SMALL_DIM, SMALL_WIDTHS

N_IMAGES, CAPTIONS_EACH, BATCH = 12, 3, 4
WORDS = ["a", "man", "dog", "cat", "red", "blue", "runs", "sits", "on",
         "the", "grass", "table", "near", "small", "big"]


# ---------------------------------------------------------------------------
# The rewrite protocol
# ---------------------------------------------------------------------------

def _id_stream(n_batches, pool, batch, seed):
    rng = np.random.default_rng(seed)
    return [list(rng.choice(pool, batch)) for _ in range(n_batches)]


def _img(i):
    return np.random.default_rng(int(i)).integers(0, 256, (4, 4, 3),
                                                  dtype=np.uint8)


@pytest.mark.parametrize("budget_rows", [64, BATCH])
def test_rewrite_matches_icd_tpu(budget_rows):
    """Same slots, idx, fresh pixels, hits and misses as icd_tpu's cache
    on one id stream (20 ids in batches of 4; a budget of 4 rows evicts
    every batch)."""
    budget_gb = budget_rows * 48 / (1 << 30)
    ours = DeviceImageCache(budget_gb, (4, 4, 3), BATCH)
    theirs = JaxDeviceImageCache(budget_gb, (4, 4, 3), BATCH)
    assert ours.capacity == theirs.capacity == max(budget_rows, BATCH)
    buf = ours.init_buffer("cpu")
    for ids in _id_stream(30, 20, BATCH, seed=1):
        imgs = np.stack([_img(i) for i in ids])
        caps = np.zeros((BATCH, 5), np.int32)
        got = ours.rewrite(Batch(imgs=imgs, img_ids=list(ids),
                                 captions=caps))
        want = theirs.rewrite(JaxBatch(imgs=imgs, img_ids=list(ids),
                                       captions=caps))
        k = int((want["fresh_slots"] != theirs.capacity).sum())
        np.testing.assert_array_equal(got["idx"], want["idx"])
        np.testing.assert_array_equal(got["fresh_slots"],
                                      want["fresh_slots"][:k])
        np.testing.assert_array_equal(
            got["fresh_imgs"].reshape(k, 48), want["fresh_imgs"][:k])
        assert (ours.hits, ours.misses) == (theirs.hits, theirs.misses)
        assert ours.slot_of == theirs.slot_of
        ours.insert(buf, torch.from_numpy(got["fresh_slots"]),
                    torch.from_numpy(got["fresh_imgs"]))
        gathered = ours.gather(buf, torch.from_numpy(got["idx"]))
        np.testing.assert_array_equal(gathered.numpy(), imgs)
    if budget_rows == BATCH:
        assert ours.misses > 20  # evicted and shipped again


# ---------------------------------------------------------------------------
# The train CLI with and without each aid
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def aids_root(tmp_path_factory):
    from PIL import Image

    from icd_tpu_torch.data.coco import COCO
    from icd_tpu_torch.vocabulary import build_vocab, save_vocab

    root = tmp_path_factory.mktemp("aids_root")
    img_dir = root / "cocoapi" / "images" / "train2014"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    images, annotations = [], []
    for i in range(N_IMAGES):
        name = "COCO_train2014_{:012d}.jpg".format(i + 1)
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
                        ).save(str(img_dir / name))
        images.append({"id": i + 1, "file_name": name, "height": 40,
                       "width": 40})
        for j in range(CAPTIONS_EACH):
            words = rng.choice(WORDS, int(rng.integers(3, 8)))
            annotations.append({"id": 100 + 10 * i + j, "image_id": i + 1,
                                "caption": " ".join(words) + "."})
    (root / "cocoapi" / "annotations").mkdir(parents=True)
    with open(str(root / "cocoapi" / "annotations" /
                  "captions_train2014.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    (root / "pkldata").mkdir()
    mp = pytest.MonkeyPatch()
    mp.setenv("ICD_TPU_ROOT", str(root))
    try:
        save_vocab(build_vocab(threshold=1, coco=COCO(
            str(root / "cocoapi" / "annotations" /
                "captions_train2014.json"))))
    finally:
        mp.undo()
    return str(root)


def _small_encoder(generator, dtype=None, device=None):
    return EncoderAttention(init_resnet(generator, SMALL_DEPTHS,
                                        SMALL_WIDTHS, device=device))


_AIDS = ("ICD_TPU_DEVICE_IMAGE_CACHE", "ICD_TPU_IMAGE_CACHE",
         "ICD_TPU_LOSS_FETCH_BLOCK", "ICD_TPU_CKPT_ASYNC", "ICD_TPU_PROFILE",
         "ICD_TPU_NATIVE_LOADER")


@pytest.fixture()
def small_train(aids_root, monkeypatch):
    """``train(name, **env)`` -> (epoch-0 losses, checkpoint bytes): the
    port's train CLI on the fixture with the aids' variables ``env``."""
    monkeypatch.setenv("ICD_TPU_ROOT", aids_root)
    monkeypatch.setattr(ta, "init_encoder_attention", _small_encoder)
    monkeypatch.setattr(ta, "init_attention_decoder", functools.partial(
        init_attention_decoder, encoder_dim=SMALL_DIM))
    for var in _AIDS:
        monkeypatch.delenv(var, raising=False)

    def train(name, **env):
        with monkeypatch.context() as m:
            for key, value in env.items():
                m.setenv(key, value)
            port_train.main([name, "--model", "attention", "--device", "cpu",
                             "--batch_size", str(BATCH), "--embed_size",
                             "16", "--decoder_dim", "12", "--attention_dim",
                             "10", "--workers", "0", "--print_freq", "100"])
        path = os.path.join(aids_root, "checkpoints", name + "_0.ckpt")
        with open(path, "rb") as f:
            data = f.read()
        losses = checkpoint.load_checkpoint(
            name=name + "_0.ckpt", verbose=False)["metrics"]["epoch_losses"]
        return losses, data

    return train


ONE_BATCH_GB = repr(BATCH * 224 * 224 * 3 / (1 << 30))


@pytest.mark.parametrize("aid", [
    dict(ICD_TPU_DEVICE_IMAGE_CACHE="1"),
    dict(ICD_TPU_DEVICE_IMAGE_CACHE=ONE_BATCH_GB),
    dict(ICD_TPU_IMAGE_CACHE="1"),
    dict(ICD_TPU_LOSS_FETCH_BLOCK="1"),
    dict(ICD_TPU_CKPT_ASYNC="1"),
], ids=["device_cache", "device_cache_one_batch", "host_cache",
        "loss_block_1", "async_ckpt"])
def test_aid_keeps_the_losses(small_train, aid):
    want, want_bytes = small_train("aid")
    got, got_bytes = small_train("aid", **aid)
    assert len(got[0]) == N_IMAGES * CAPTIONS_EACH // BATCH
    assert got == want
    if "ICD_TPU_CKPT_ASYNC" in aid:
        assert got_bytes == want_bytes


def test_device_cache_one_batch_budget_evicts(aids_root, monkeypatch):
    """The one-batch budget of the test above holds 4 rows of 12 images:
    its slots are reused while the producer runs two batches ahead."""
    from icd_tpu_torch.data.pipeline import device_image_cache_from_env

    monkeypatch.setenv("ICD_TPU_ROOT", aids_root)
    monkeypatch.setenv("ICD_TPU_DEVICE_IMAGE_CACHE", ONE_BATCH_GB)
    dataset = port_dataset.COCODataset("train")
    cache = device_image_cache_from_env(dataset, BATCH)
    assert dataset.return_ids and cache.capacity == BATCH
    loader = DataLoader(dataset, BATCH, pad_idx=0)
    buf = cache.init_buffer("cpu")
    for batch in common.stage_batches(loader, "cpu", img_cache=cache,
                                      buf=buf):
        assert batch["imgs"].shape == (BATCH, 224, 224, 3)
    assert cache.misses > N_IMAGES


def test_host_image_cache_decodes_each_image_once(aids_root, monkeypatch):
    monkeypatch.setenv("ICD_TPU_ROOT", aids_root)
    calls = []
    decode = port_dataset.decode_image
    monkeypatch.setattr(port_dataset, "decode_image",
                        lambda *a: calls.append(a) or decode(*a))
    monkeypatch.setenv("ICD_TPU_IMAGE_CACHE", "1")
    dataset = port_dataset.COCODataset("train")
    items = [dataset[i] for i in range(len(dataset))]
    assert len(calls) == N_IMAGES
    assert not any(img.flags.writeable for img, _ in items)
    monkeypatch.setenv("ICD_TPU_IMAGE_CACHE", "0")
    plain = port_dataset.COCODataset("train")
    for i, (img, _) in enumerate(items):
        np.testing.assert_array_equal(plain[i][0], img)
    assert len(calls) == N_IMAGES + N_IMAGES * CAPTIONS_EACH


def test_loss_fetch_block(monkeypatch):
    monkeypatch.setenv("ICD_TPU_LOSS_FETCH_BLOCK", "1")
    seen = []
    drain = common.LossDrain(lambda v, i, dt: seen.append((i, v)))
    assert drain.block == 1
    drain.push(torch.tensor(2.5), 0)
    assert seen == [(0, 2.5)]
    monkeypatch.delenv("ICD_TPU_LOSS_FETCH_BLOCK")
    assert common.LossDrain(None).block == 16


def test_device_prefetch_staging_matches_a_synchronous_loop(small_train,
                                                            aids_root):
    """The train CLI's losses (its loop stages each batch through
    ``device_prefetch`` on a producer thread) equal a loop that reads
    the loader and ships each batch in the step, from the same seeded
    models."""
    want, _ = small_train("prefetched")
    args = port_train.build_parser().parse_args(["sync", "--model", "attention",
                                  "--batch_size", str(BATCH),
                                  "--embed_size", "16", "--decoder_dim",
                                  "12", "--attention_dim", "10",
                                  "--workers", "0"])
    dataset = port_dataset.COCODataset("train")
    vocab = dataset.vocab
    loader = DataLoader(dataset, BATCH, shuffle=True, pad_idx=0)
    _, enc, dec, _, _ = common.resume_or_build(args, ta.build_attention,
                                               vocab, "cpu")
    optimizer = common.make_adam(args, enc, dec, None)
    step = ta.make_train_step(enc, dec, optimizer, args.alpha_c,
                              args.decoder_dropout, args.grad_clip)
    run = ta.batch_step(step, "cpu", torch.Generator("cpu").manual_seed(1))
    got = common.train_epoch(run, iter(loader), num_batches=len(loader),
                             verbose=False)
    assert [got] == want


def test_device_prefetch_passes_values_and_stops_early():
    from icd_tpu_torch.data.pipeline import device_prefetch

    items = ({"a": np.full(3, i), "n": i, "names": ["x"]} for i in range(5))
    it = device_prefetch(items, "cpu", size=2)
    first = next(it)
    assert isinstance(first["a"], torch.Tensor) and first["n"] == 0
    assert first["names"] == ["x"]
    it.close()  # the producer is unblocked and drained


# ---------------------------------------------------------------------------
# The async writer's snapshot
# ---------------------------------------------------------------------------

def _trained(seed=0):
    from icd_tpu_torch.models.attention import AttentionDecoderParams
    from types import SimpleNamespace

    g = torch.Generator().manual_seed(seed)
    enc = _small_encoder(g, device="cpu")
    params = AttentionDecoderParams()
    params.attention_dim, params.decoder_dim, params.embed_size = 10, 12, 16
    params.vocab = range(19)
    dec = init_attention_decoder(g, params, encoder_dim=SMALL_DIM,
                                 device="cpu")
    args = SimpleNamespace(encoder_lr=1e-3, decoder_lr=1e-3, use_bert=False,
                           fine_tune_embedding=False, model_name="torn",
                           model="attention", grad_clip=5.0)
    optimizer = common.make_adam(args, enc, dec, None)
    sum(p.sum() for p in dec.parameters() if p.requires_grad).backward()
    optimizer.step()
    return args, enc, dec, optimizer


@pytest.mark.parametrize("snapshot", ["device_copy", "live"])
def test_async_save_holds_the_values_at_save_time(tmp_path, monkeypatch,
                                                  snapshot):
    monkeypatch.setenv("ICD_TPU_ROOT", str(tmp_path))
    monkeypatch.setenv("ICD_TPU_CKPT_ASYNC", "1")
    args, enc, dec, optimizer = _trained()
    before = (decoder_to_jax(dec), adam_state_to_jax(optimizer, dec, enc))
    checkpoint._get_async_pool().submit(time.sleep, 0.5)  # a slow writer
    trees = common.checkpoint_snapshot(enc, dec, optimizer)
    if snapshot == "live":
        def trees():
            return (common.encoder_to_jax(enc), decoder_to_jax(dec),
                    adam_state_to_jax(optimizer, dec, enc))
    checkpoint.save_checkpoint(args, 0, None, None, None, None, {},
                               snapshot=trees)
    with torch.no_grad():  # the next step, at once, in place
        for p in dec.parameters():
            p.add_(1.0)
        for state in optimizer.state.values():
            state["exp_avg"].add_(1.0)
            state["exp_avg_sq"].add_(1.0)
    checkpoint.wait_pending_saves()
    got = checkpoint.load_checkpoint(name="torn_0.ckpt", verbose=False)
    from icd_tpu_torch.params import adam_moments

    moments = adam_moments(got["decoder_optimizer"])["mu"]["decoder"]
    held = [np.array_equal(got["decoder"]["fc"]["w"], before[0]["fc"]["w"]),
            np.array_equal(moments["fc"]["w"],
                           before[1]["mu"]["decoder"]["fc"]["w"])]
    assert held == [snapshot == "device_copy"] * 2


def test_wait_pending_saves_reraises_the_first_failure(monkeypatch, capsys):
    def fail(msg):
        raise OSError(msg)

    pool = checkpoint._get_async_pool()
    monkeypatch.setattr(checkpoint, "_async_futures", [
        pool.submit(fail, "disk full"), pool.submit(fail, "second")])
    with pytest.raises(OSError, match="disk full"):
        checkpoint.wait_pending_saves()
    assert "second" in capsys.readouterr().err
    checkpoint.wait_pending_saves()  # nothing pending


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------

def test_profile_trace_has_the_spans(small_train, tmp_path, aids_root):
    small_train("profiled", ICD_TPU_PROFILE=str(tmp_path / "traces"))
    path = tmp_path / "traces" / "train_profiled" / "trace.json"
    with open(str(path)) as f:
        events = json.load(f)["traceEvents"]
    spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert spans.count("train_step") == N_IMAGES * CAPTIONS_EACH // BATCH
    assert spans.count("checkpoint") == 1
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_profile_unset_costs_nothing(small_train, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    small_train("unprofiled")
    assert os.listdir(str(tmp_path)) == []
    assert isinstance(profiling.annotate("x"), type(
        __import__("contextlib").nullcontext()))
    with profiling.maybe_profile("nothing"):
        pass
    assert os.listdir(str(tmp_path)) == []
