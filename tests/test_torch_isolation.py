"""icd_tpu_torch stands alone: it imports neither jax nor optax nor
anything of icd_tpu, nor transformers or safetensors, nor PIL until an
image is decoded (the card machine may have none of them), and its entry
points go to the card unless the CPU is asked for."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import icd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(icd_tpu_torch.__path__,
                                               'icd_tpu_torch.')]
for name in names:
    importlib.import_module(name)
print(len(names))
print(sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'icd_tpu',
                                    'PIL', 'transformers', 'safetensors')))
"""


def test_package_imports_no_jax_and_no_icd_tpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, foreign = proc.stdout.strip().splitlines()[-2:]
    assert int(count) >= 14
    assert foreign == "[]"


@pytest.mark.parametrize("module", [
    "icd_tpu_torch.train", "icd_tpu_torch.eval", "icd_tpu_torch.init",
    "icd_tpu_torch.training.attention", "icd_tpu_torch.metric",
    "icd_tpu_torch.models.bert", "icd_tpu_torch.models.bert_tokenize",
    "icd_tpu_torch.models.bert_load", "icd_tpu_torch.models.bert_embed",
    "icd_tpu_torch.parallel.mesh", "icd_tpu_torch.parallel.vocab",
    "icd_tpu_torch.parallel.dryrun"])
def test_training_modules_import_no_jax_and_no_icd_tpu(module):
    code = ("import sys, {}; print(sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'icd_tpu', "
            "'PIL', 'transformers', 'safetensors')))".format(module))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_default_device_raises_without_a_card():
    from icd_tpu_torch.device import resolve_device

    _no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_do_not_fall_back_to_the_cpu():
    from icd_tpu_torch import bench
    from icd_tpu_torch.decoding.serve import (make_beam_captioner,
                                              make_captioner,
                                              make_int8_captioner)
    from icd_tpu_torch.models.resnet import init_resnet

    _no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_resnet(torch.Generator().manual_seed(0), (1, 1, 1, 1),
                    (4, 8, 8, 16))
    for entry in (make_beam_captioner, make_captioner, make_int8_captioner):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(None, None, 1, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.measure(None, None, None, "int8")


def test_training_entry_points_do_not_fall_back_to_the_cpu(use_coco_root):
    from helpers import make_train_args
    from icd_tpu_torch import eval as port_eval
    from icd_tpu_torch import train as port_train
    from icd_tpu_torch.training.attention import evaluate, train

    _no_card()
    args = make_train_args(model="attention")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate(args, None, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.main(["x", "--model", "attention"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_eval.main(["x.ckpt", "--model_type", "attention"])


def test_bert_embedder_does_not_fall_back_to_the_cpu():
    from icd_tpu_torch.models.bert import BERT_BASE, init_bert
    from icd_tpu_torch.models.bert_embed import BertCaptionEmbedder

    _no_card()
    bert = init_bert(torch.Generator().manual_seed(0),
                     dict(BERT_BASE, num_hidden_layers=0, vocab_size=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BertCaptionEmbedder(None, model=bert, tokenizer=object())
    assert BertCaptionEmbedder(None, model=bert, tokenizer=object(),
                               device="cpu").bert.device.type == "cpu"
