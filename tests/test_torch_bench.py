"""``python -m icd_tpu_torch.bench``'s measuring function on the CPU, at a
small size: a (1, 1, 1, 1) ResNet of widths (4, 8, 8, 16), E = H = 16,
V = 53, batch 2 of 64x64 images, 2 repeats, 1 trial, max_len 6, in
both modes. The numbers it prints are CPU numbers and are not checked,
only the lines' form and what the bench promises of its workload."""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from icd_tpu_torch import bench
from icd_tpu_torch.models.baseline import (BaselineDecoderParams,
                                           init_baseline_decoder)
from icd_tpu_torch.models.encoder import Encoder
from icd_tpu_torch.models.resnet import init_resnet

V = 53
KEYS = {"metric", "value", "unit", "vs_baseline", "mfu", "mfu_peak", "card"}


def _small_models():
    gen = torch.Generator().manual_seed(0)
    resnet = init_resnet(gen, (1, 1, 1, 1), (4, 8, 8, 16), device="cpu")
    embed = torch.nn.Linear(64, 16)
    params = BaselineDecoderParams()
    params.vocab_size, params.embed_size, params.hidden_size = V, 16, 16
    decoder = init_baseline_decoder(gen, params, device="cpu")
    bench.pin_end(decoder, V - 2)
    return Encoder(resnet, embed), decoder


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_bench_measures_on_the_cpu(mode):
    encoder, decoder = _small_models()
    assert decoder.linear.bias[V - 2] == -1e9
    imgs = bench.images(2, 64, device="cpu")
    out = io.StringIO()
    with redirect_stdout(out):
        one, result = bench.measure(encoder, decoder, imgs, mode, repeats=2,
                                    trials=1, decode_len=6, device="cpu")
        print(json.dumps(one))
        print(json.dumps(result))
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(last) == KEYS and last == result
    assert last["value"] > 0 and last["unit"] == "captions/s"
    assert last["card"] == "cpu" and last["mfu"] is None
    assert mode in last["metric"]
    assert last["vs_baseline"] == pytest.approx(last["value"] / 246.0)
    assert one["captions_with_end"] == 0 and one["steps"] == 6
    assert one["int8_decoder"] == (mode == "int8")
    assert one["peak_memory_bytes"] is None
    assert len(one["trial_seconds"]) == 1


def test_bench_rejects_an_unknown_mode():
    """Only bench.py's two modes, each against the H100's dense peak of
    its type (NVIDIA's data sheet)."""
    encoder, decoder = _small_models()
    with pytest.raises(ValueError, match="mode"):
        bench.measure(encoder, decoder, bench.images(2, 64, "cpu"),
                      "fp8", device="cpu")
    assert bench.PEAKS["int8"][0] == 1979e12
    assert bench.PEAKS["bf16"][0] == 989e12
