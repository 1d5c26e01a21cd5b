"""The slice as a whole: uint8 images -> caption tokens, icd_tpu_torch vs
icd_tpu (f32, CPU, a small encoder and decoder).

- ``make_beam_captioner`` == JAX ``encoder_attention_forward`` (ImageNet
  normalised) followed by ``beam_search_batched``: tokens exact, alphas
  to atol 5e-6;
- ``attention_caption_image_beam_search`` == JAX's, on the scale-only
  protocol of the reference's beam loader;
- the port's ``gen_captions`` CLI captions a fixture image from a
  ``.ckpt`` that ``icd_tpu`` saved with a real optax state, in a
  subprocess that never imports jax or optax, with the float encoder
  and with the int8 one (calibrated on the image, the default of both
  CLIs) as the JAX CLI's ``_beam_search_int8`` does; on the fixture JPEG
  (read by the port's own codec) its words equal those of the JAX
  package's ``gen_captions.py`` (PIL) run on the same file.
"""

import argparse
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icd_tpu.decoding.beam import (
    attention_caption_image_beam_search as jax_caption_image,
    beam_search_batched as jax_beam)
from icd_tpu.models.encoder import (
    encoder_attention_forward as jax_encoder_attention_forward)
from icd_tpu.vocabulary import END_TOKEN
from icd_tpu_torch.checkpoint import InertState, load_checkpoint
from icd_tpu_torch.decoding.beam import attention_caption_image_beam_search
from icd_tpu_torch.decoding.serve import make_beam_captioner
from icd_tpu_torch.gen_captions import load_img
from icd_tpu_torch.params import decoder_from_jax, encoder_from_jax
from test_torch_beam import steer_end
from test_torch_params import small_decoder_tree, small_resnet_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _decoder(vocab_size, end):
    """A small decoder tree for the 64-channel test encoder, steered so
    that captions run for many steps (see test_torch_beam.steer_end)."""
    dec = small_decoder_tree(vocab=vocab_size, att=24, dec=32, emb=16,
                             enc=64)
    dec = jax.tree_util.tree_map(np.array, dec)
    return steer_end(dec, end, rate=0.1, spread=0.05, threshold=20.0)


def test_beam_captioner_matches_jax_pipeline():
    enc = {"resnet": small_resnet_tree()}
    imgs = np.random.default_rng(0).integers(0, 256, (3, 64, 64, 3),
                                             dtype=np.uint8)
    grid, _ = jax_encoder_attention_forward(enc, jnp.asarray(imgs),
                                            train=False,
                                            compute_dtype=jnp.float32)
    v = 30
    dec = _decoder(v, v - 2)
    ref = jax_beam(dec, grid, 5, v - 3, v - 2)
    captioner = make_beam_captioner(
        encoder_from_jax(enc), decoder_from_jax(dec), v - 3, v - 2,
        beam_size=5, compute_dtype=torch.float32, device="cpu")
    out = captioner(imgs)
    np.testing.assert_array_equal(out["seq"].numpy(), np.asarray(ref["seq"]))
    np.testing.assert_array_equal(out["seq_len"].numpy(),
                                  np.asarray(ref["seq_len"]))
    np.testing.assert_array_equal(out["found"].numpy(),
                                  np.asarray(ref["found"]))
    np.testing.assert_allclose(out["alphas"].numpy(),
                               np.asarray(ref["alphas"]), rtol=0, atol=5e-6)
    assert out["found"].all() and out["seq_len"].min() > 3


def test_caption_image_matches_jax(tiny_vocab):
    enc = {"resnet": small_resnet_tree()}
    img = np.random.default_rng(1).integers(0, 256, (1, 64, 64, 3),
                                            dtype=np.uint8)
    dec = _decoder(len(tiny_vocab), tiny_vocab(END_TOKEN))
    args = argparse.Namespace(beam_size=3)
    ref_seq, ref_alphas, ref_found = jax_caption_image(
        args, img, enc, dec, tiny_vocab)
    seq, alphas, found = attention_caption_image_beam_search(
        args, img, encoder_from_jax(enc), decoder_from_jax(dec), tiny_vocab)
    assert seq == ref_seq and found == ref_found and len(seq) > 3
    assert len(alphas) == len(ref_alphas)
    for a, r in zip(alphas, ref_alphas):
        assert a.shape == (14, 14)
        np.testing.assert_allclose(a, np.asarray(r), rtol=0, atol=5e-6)


def _save_ckpt(enc, dec):
    import optax

    from icd_tpu.checkpoint import save_checkpoint

    args = argparse.Namespace(model_name="torchport", model="attention",
                              embed_size=16, decoder_dim=32,
                              attention_dim=24)
    opt_state = optax.adam(1e-4).init(dec)
    return save_checkpoint(args, 0, enc, dec, None, opt_state,
                           {"epoch_losses": []}, verbose=False)


def _gen_captions(root, image, encoder):
    """The port's CLI in a subprocess: its output lines, the last one
    naming the foreign modules it imported."""
    script = (
        "import sys, runpy\n"
        "sys.argv = ['gen_captions', 'torchport_0.ckpt', {!r},"
        " '--encoder', {!r}, '--dtype', 'f32', '--device', 'cpu']\n"
        "runpy.run_module('icd_tpu_torch.gen_captions', run_name='__main__')\n"
        "print('FOREIGN', sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'optax', 'icd_tpu')))\n").format(
            image, encoder)
    env = dict(os.environ, ICD_TPU_ROOT=root, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "FOREIGN []"
    return lines


def _fixture_image(root):
    return os.path.join(root, "cocoapi", "images", "val2014",
                        "COCO_val2014_000000000011.jpg")


def test_gen_captions_cli_on_icd_tpu_checkpoint(use_coco_root):
    from icd_tpu.vocabulary import load_vocab

    root = use_coco_root
    vocab = load_vocab()
    image = _fixture_image(root)
    enc = {"resnet": small_resnet_tree()}
    img = load_img(image)
    dec = _decoder(len(vocab), vocab(END_TOKEN))
    _save_ckpt(enc, dec)
    seq, _, found = jax_caption_image(argparse.Namespace(beam_size=5), img,
                                      enc, dec, vocab)
    expected = " ".join(vocab.i2w[t] for t in seq)
    lines = _gen_captions(root, image, "float")
    assert expected in lines
    assert found == ("(beam search did not complete a caption)" not in lines)
    jax_cli = subprocess.run(
        [sys.executable, os.path.join(REPO, "gen_captions.py"),
         "torchport_0.ckpt", image, "--encoder", "float", "--dtype", "f32"],
        cwd=REPO, env=dict(os.environ, ICD_TPU_ROOT=root,
                           JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert jax_cli.returncode == 0, jax_cli.stderr
    assert jax_cli.stdout.strip().splitlines() == lines[:-1]  # no FOREIGN


def test_checkpoint_optax_state_is_inert(use_coco_root):
    enc = {"resnet": small_resnet_tree()}
    dec = small_decoder_tree()
    _save_ckpt(enc, dec)
    ck = load_checkpoint(name="torchport_0.ckpt", verbose=False)
    np.testing.assert_array_equal(ck["decoder"]["fc"]["w"], dec["fc"]["w"])
    adam = ck["decoder_optimizer"][0]
    assert isinstance(adam, InertState)
    assert adam.source.startswith("optax.")
    np.testing.assert_array_equal(adam[1]["fc"]["w"],
                                  np.zeros_like(dec["fc"]["w"]))


def test_pth_tar_raises(use_coco_root):
    """A ``.pth.tar`` is converted now (tests/test_torch_convert.py); a
    truncated one raises the archive's own error."""
    import zipfile

    path = os.path.join(use_coco_root, "checkpoints", "ref.pth.tar")
    with open(path, "wb") as f:
        f.write(b"PK\x03\x04")
    with pytest.raises(zipfile.BadZipFile):
        load_checkpoint(name="ref.pth.tar", verbose=False)


def test_gen_captions_int8_raises(use_coco_root):
    """``--encoder int8``, which raised before the int8 encoder was
    ported, now prints the JAX CLI's caption (f32)."""
    import gen_captions as jax_cli
    from icd_tpu.vocabulary import load_vocab

    root = use_coco_root
    vocab = load_vocab()
    image = _fixture_image(root)
    enc = {"resnet": small_resnet_tree()}
    dec = _decoder(len(vocab), vocab(END_TOKEN))
    _save_ckpt(enc, dec)
    seq, _, found = jax_cli._beam_search_int8(
        argparse.Namespace(beam_size=5), load_img(image), enc, dec, vocab,
        jnp.float32)
    assert found and len(seq) > 3
    lines = _gen_captions(root, image, "int8")
    assert " ".join(vocab.i2w[t] for t in seq) in lines
