"""The port's val-split captioner (icd_tpu_torch.beam_eval and its data
modules) vs icd_tpu's (tools/beam_eval.py), f32 on the CPU.

- ``icd_tpu_torch.data.dataset.COCODataset("val")`` indexes the same
  images and decodes them bit for bit as ``icd_tpu``'s;
- ``python -m icd_tpu_torch.beam_eval`` with and without ``--fused``
  writes the same JSON as ``tools/beam_eval.py --dtype f32 --no-int8``
  from one ``.ckpt`` saved by ``icd_tpu`` (a small ResNet and a steered
  small decoder), at ``--batch_size 2`` so the last of the fixture's
  three val images is a padded batch. The port runs in a subprocess that
  never imports jax, optax or icd_tpu;
- with the int8 encoder, the default of both tools, and with
  ``--int8_grid``: the JAX tool calibrates and writes ``--act_maxes F``,
  the port loads F and writes the same JSON (with and without
  ``--fused``), and the port's own calibration, written to another
  file, agrees with F within rtol 1e-5 (the float convolutions sum in
  another order); ``--int8_grid --fused`` is refused.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from icd_tpu.data.dataset import COCODataset as JaxCOCODataset
from icd_tpu.vocabulary import END_TOKEN, load_vocab
from icd_tpu_torch.data.dataset import COCODataset
from test_torch_params import small_resnet_tree
from test_torch_serve import _decoder, _save_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dataset_matches_icd_tpu(use_coco_root):
    ours, ref = COCODataset("val"), JaxCOCODataset("val")
    assert ours.img_ids == ref.img_ids and len(ours.img_ids) == 3
    assert ours.caption_img_mappings == ref.caption_img_mappings
    batch = ours.load_image_batch(ours.img_ids)
    assert batch.dtype == np.uint8 and batch.shape == (3, 224, 224, 3)
    np.testing.assert_array_equal(batch, ref.load_image_batch(ref.img_ids))
    short = COCODataset("val", caption_max_len=25)
    assert len(short) == len(JaxCOCODataset("val", caption_max_len=25))
    assert len(short) < len(ours)


def _run(args, root, module):
    env = dict(os.environ, ICD_TPU_ROOT=root, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    if module:
        script = (
            "import sys, runpy\n"
            "sys.argv = ['beam_eval'] + {!r}\n"
            "runpy.run_module('icd_tpu_torch.beam_eval', run_name='__main__')\n"
            "print('FOREIGN', sorted(m for m in sys.modules"
            " if m.split('.')[0] in ('jax', 'optax', 'icd_tpu')))\n"
        ).format(list(args))
        cmd = [sys.executable, "-c", script]
    else:
        cmd = [sys.executable, os.path.join(REPO, "tools", "beam_eval.py"),
               *args]
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_beam_eval_cli_matches_tools_beam_eval(use_coco_root, tmp_path):
    root = use_coco_root
    vocab = load_vocab()
    dec = _decoder(len(vocab), vocab(END_TOKEN))
    name = _save_ckpt({"resnet": small_resnet_tree()}, dec)
    common = [os.path.basename(name), "--beam_size", "3", "--batch_size",
              "2", "--dtype", "f32"]
    ref_json = str(tmp_path / "ref.json")
    _run(common + ["--no-int8", "--out", ref_json], root, module=False)
    with open(ref_json) as f:
        ref = json.load(f)
    assert [r["image_id"] for r in ref] == [11, 12, 13]
    assert all(r["caption"] for r in ref)
    for extra in ([], ["--fused"]):
        out_json = str(tmp_path / "port{}.json".format(len(extra)))
        stdout = _run(common + extra + ["--no-int8", "--device", "cpu",
                                        "--out", out_json], root,
                      module=True)
        assert stdout.strip().splitlines()[-1] == "FOREIGN []"
        with open(out_json) as f:
            assert json.load(f) == ref, extra


@pytest.mark.parametrize("flag", ["--int8", "--int8_grid"])
def test_beam_eval_int8_raises(use_coco_root, tmp_path, flag):
    """The int8 flags, which raised before the int8 encoder was ported,
    now run and caption as the JAX tool does."""
    from icd_tpu_torch.beam_eval import main

    root = use_coco_root
    vocab = load_vocab()
    dec = _decoder(len(vocab), vocab(END_TOKEN))
    name = _save_ckpt({"resnet": small_resnet_tree()}, dec)
    act_maxes = str(tmp_path / "act_maxes.npy")
    common = [os.path.basename(name), "--beam_size", "3", "--batch_size",
              "2", "--dtype", "f32", flag, "--act_maxes", act_maxes]
    ref_json = str(tmp_path / "ref.json")
    stdout = _run(common + ["--out", ref_json], root, module=False)
    assert "Saved act_maxes" in stdout
    with open(ref_json) as f:
        ref = json.load(f)
    assert [r["image_id"] for r in ref] == [11, 12, 13]
    runs = [[], ["--fused"]] if flag == "--int8" else [[]]
    for extra in runs:
        out_json = str(tmp_path / "port{}.json".format(len(extra)))
        stdout = _run(common + extra + ["--device", "cpu", "--out",
                                        out_json], root, module=True)
        assert "Loaded act_maxes" in stdout
        assert stdout.strip().splitlines()[-1] == "FOREIGN []"
        with open(out_json) as f:
            assert json.load(f) == ref, extra
    if flag == "--int8":
        own = str(tmp_path / "own.npy")
        _run(common[:-1] + [own, "--device", "cpu", "--out",
                            str(tmp_path / "own.json")], root, module=True)
        np.testing.assert_allclose(np.load(own), np.load(act_maxes),
                                   rtol=1e-5)
    else:
        with pytest.raises(SystemExit):
            main(["x.ckpt", flag, "--fused", "--device", "cpu"])
