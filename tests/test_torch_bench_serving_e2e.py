"""``python -m icd_tpu_torch.bench_serving_e2e`` on the CPU at a small
size (a (1, 1, 1, 1) ResNet of widths (4, 8, 8, 16), E = H = 16, V = 53,
batches of 4 images of 80x60 resized to 64x64, 6 greedy steps): it runs,
prints its lines, and the end-to-end run's captions of the first batch
equal those of the captioner fed the same images as resident tensors.
Its JPEGs are the JAX tool's recipe, byte for byte. The numbers are CPU
numbers and are not checked, only the lines' form."""

import io
import json
import os

import numpy as np
import pytest
import torch

from icd_tpu_torch import bench, bench_serving_e2e
from icd_tpu_torch.models.baseline import (BaselineDecoderParams,
                                           init_baseline_decoder)
from icd_tpu_torch.models.encoder import Encoder
from icd_tpu_torch.models.resnet import init_resnet

V = 53
SUMMARY_KEYS = {
    "h2d_GB_per_s", "host_images_per_s", "threads", "e2e_captions_per_s",
    "device_captions_per_s", "min_host_device", "threads_to_saturate",
    "decode_resize_ms_one_thread", "e2e_captions_equal_resident", "batches",
    "batch", "mfu", "mfu_peak", "card"}


def small_models():
    """``bench.models``'s encoder and decoder at a small size, <end>
    pinned."""
    gen = torch.Generator().manual_seed(0)
    resnet = init_resnet(gen, (1, 1, 1, 1), (4, 8, 8, 16), device="cpu")
    embed = torch.nn.Linear(64, 16)
    params = BaselineDecoderParams()
    params.vocab_size, params.embed_size, params.hidden_size = V, 16, 16
    decoder = init_baseline_decoder(gen, params, device="cpu")
    bench.pin_end(decoder, V - 2)
    return Encoder(resnet, embed), decoder


def shrink(monkeypatch):
    """bench_serving_e2e's constants at the test's size."""
    for name, value in dict(BATCH=4, SRC_W=80, SRC_H=60, IMAGE_SIZE=64,
                            DECODE_LEN=6, REPEATS=2, TRIALS=1,
                            SWEEP_IMAGES=8).items():
        monkeypatch.setattr(bench_serving_e2e, name, value)
    monkeypatch.setattr(bench, "models", lambda device: small_models())


def test_main_prints_its_lines_on_the_cpu(monkeypatch, capsys):
    shrink(monkeypatch)
    bench_serving_e2e.main(["--device", "cpu", "--batches", "3",
                            "--threads", "2", "--seed", "1"])
    lines = [json.loads(line)
             for line in capsys.readouterr().out.strip().splitlines()]
    sweep, summary = lines[:-1], lines[-1]
    assert [s["threads"] for s in sweep] == bench_serving_e2e.thread_counts(
        os.cpu_count())
    assert all(s["host_images_per_s"] > 0 for s in sweep)
    assert set(summary) == SUMMARY_KEYS
    assert summary["e2e_captions_equal_resident"] is True
    assert summary["threads"] == 2 and summary["batches"] == 3
    assert summary["batch"] == 4
    for key in ("host_images_per_s", "e2e_captions_per_s",
                "device_captions_per_s"):
        assert summary[key] > 0
    assert summary["min_host_device"] == min(
        summary["host_images_per_s"], summary["device_captions_per_s"])
    assert summary["card"] == "cpu" and summary["mfu"] is None
    assert summary["h2d_GB_per_s"] is None


def test_run_on_one_thread():
    encoder, decoder = small_models()
    blobs = bench_serving_e2e.make_jpegs(8, seed=3, size=(80, 60))
    sweep, summary = bench_serving_e2e.run(
        encoder, decoder, blobs, "cpu", n_batches=2, threads=1, batch=4,
        size=64, decode_len=6, repeats=2, trials=1, sweep_images=8)
    assert summary["e2e_captions_equal_resident"] is True
    assert summary["threads_to_saturate"] >= 1
    assert sweep[0]["threads"] == 1


@pytest.mark.parametrize("seed", [0, 7])
def test_make_jpegs_is_the_tools_recipe(seed):
    """bench_serving_e2e.py:49-64 with PIL: BILINEAR up, quality 90.
    (PIL is imported here: ``test_torch_no_pil.py`` imports this module
    where PIL is blocked.)"""
    from PIL import Image

    rng = np.random.default_rng(seed)
    want = []
    for _ in range(3):
        small = rng.integers(0, 255, (60 // 8, 80 // 8, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(small).resize((80, 60), Image.BILINEAR).save(
            buf, format="JPEG", quality=90)
        want.append(buf.getvalue())
    assert bench_serving_e2e.make_jpegs(3, seed, size=(80, 60)) == want
