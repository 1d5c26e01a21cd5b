"""Greedy decoding and int8 serving (icd_tpu_torch decoding/
greedy_attention.py, decoding/serve.py, decoding/beam.py int8_grid) vs
icd_tpu's, f32 on the CPU.

- ``greedy_decode_attention``: tokens equal to JAX's, alphas within atol
  5e-6 (the frameworks sum the attention in different orders), alpha
  rows after ``<end>`` zero, and the loop leaves as soon as every
  caption has finished;
- ``greedy_decode_attention_int8`` on the same int8 decoder tree: tokens
  equal, alphas within atol 1e-5 (h and c also carry the sigmoid and
  tanh ulps of ``qlstm_cell``, tests/test_torch_qlinear.py);
- ``make_attention_captioner`` and ``make_int8_attention_captioner``
  (float and int8 decoder, the same ``act_maxes``) against the JAX
  package's captioners; calibrating on the same images gives
  ``act_maxes`` within rtol 1e-5;
- ``beam_search_batched(int8_grid=True)``: tokens equal to JAX's;
  ``make_beam_captioner`` over JAX's quantized tree equals JAX's int8
  encoder followed by its beam search;

Sizes: a (1, 1, 1, 1) ResNet of widths (4, 8, 8, 16), 64x64 images,
A = 24, H = 32, E = 16, V <= 97.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icd_tpu_torch.decoding.greedy_attention as greedy
from icd_tpu.decoding import greedy_attention as jax_greedy
from icd_tpu.decoding.beam import beam_search_batched as jax_beam
from icd_tpu.decoding.serve import (
    make_attention_captioner as jax_make_attention_captioner,
    make_int8_attention_captioner as jax_make_int8_captioner)
from icd_tpu.models.encoder import encoder_attention_forward_int8
from icd_tpu.models.resnet_int8 import calibrate_act_maxes, quantize_resnet
from icd_tpu.vocabulary import END_TOKEN
from icd_tpu_torch.decoding.beam import beam_search_batched
from icd_tpu_torch.decoding.serve import (make_attention_captioner,
                                          make_beam_captioner,
                                          make_int8_attention_captioner)
from icd_tpu_torch.params import (decoder_from_jax, encoder_from_jax,
                                  qdecoder_from_jax, qresnet_from_jax)
from test_torch_beam import steer_end
from test_torch_params import small_resnet_tree
from test_torch_qlinear import np_decoder_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, P, D = 61, 16, 64
START, END = V - 3, V - 2


def _decoder(rate=0.15, spread=1.0, threshold=20.0, seed=0):
    return steer_end(np_decoder_tree(V, 24, 32, 16, D, seed), END, rate,
                     spread, threshold)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _grids(b=4, seed=0):
    return np.random.default_rng(seed).standard_normal((b, P, D)).astype(
        np.float32)


def _steps(tokens, max_len):
    """Decode steps the loop ran: up to the last caption's <end>."""
    ends = [list(row).index(END) + 1 if END in row else max_len
            for row in tokens.tolist()]
    return max(ends)


@pytest.fixture
def count_steps(monkeypatch):
    """Counts the float loop's decode steps."""
    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    real = greedy.decode_step
    monkeypatch.setattr(greedy, "decode_step", counting)
    return calls


def test_greedy_matches_jax(count_steps):
    dec, grids, max_len = _decoder(0.25), _grids(), 20
    ref_toks, ref_alphas = jax_greedy.greedy_decode_attention(
        _jax(dec), jnp.asarray(grids), START, END, max_len=max_len)
    toks, alphas = greedy.greedy_decode_attention(
        decoder_from_jax(dec), torch.from_numpy(grids), START, END,
        max_len=max_len)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_allclose(alphas.numpy(), np.asarray(ref_alphas),
                               rtol=0, atol=5e-6)
    steps = _steps(toks, max_len)
    assert len(count_steps) == steps < max_len  # the all-finished exit
    lens = [list(row).index(END) + 1 for row in toks.tolist()]
    assert len(set(lens)) > 1
    for row, n in enumerate(lens):
        assert not alphas[row, n:].any()  # zero after <end>
        np.testing.assert_allclose(alphas[row, :n].sum(-1).numpy(), 1.0,
                                   rtol=1e-5)


def test_greedy_runs_to_max_len_without_end(count_steps):
    dec = _decoder()
    dec["fc"]["b"][END] = -1e9
    toks, _ = greedy.greedy_decode_attention(
        decoder_from_jax(dec), torch.from_numpy(_grids()), START, END,
        max_len=6)
    ref, _ = jax_greedy.greedy_decode_attention(
        _jax(dec), jnp.asarray(_grids()), START, END, max_len=6)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref))
    assert len(count_steps) == 6 and not (toks == END).any()


def test_greedy_int8_decoder_matches_jax():
    dec, grids, max_len = _decoder(0.2), _grids(6, seed=1), 20
    jqdec = jax_greedy.quantize_attention_decoder(dec)
    ref_toks, ref_alphas = jax_greedy.greedy_decode_attention_int8(
        _jax(dec), jqdec, jnp.asarray(grids), START, END, max_len=max_len)
    toks, alphas = greedy.greedy_decode_attention_int8(
        decoder_from_jax(dec), qdecoder_from_jax(jqdec),
        torch.from_numpy(grids), START, END, max_len=max_len)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_allclose(alphas.numpy(), np.asarray(ref_alphas),
                               rtol=0, atol=1e-5)
    assert _steps(toks, max_len) < max_len


def _serving_problem():
    enc = {"resnet": small_resnet_tree()}
    imgs = np.random.default_rng(2).integers(0, 256, (4, 64, 64, 3),
                                             dtype=np.uint8)
    return enc, _decoder(0.1, 0.5), imgs


def _assert_captions_equal(out, ref, atol):
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=0,
                               atol=atol)
    assert (out[0] == END).any(dim=1).all()


def test_attention_captioner_matches_jax():
    enc, dec, imgs = _serving_problem()
    ref = jax_make_attention_captioner(enc, dec, START, END, max_len=15,
                                       compute_dtype=jnp.float32)(
        jnp.asarray(imgs))
    out = make_attention_captioner(
        encoder_from_jax(enc), decoder_from_jax(dec), START, END,
        max_len=15, compute_dtype=torch.float32, device="cpu")(imgs)
    _assert_captions_equal(out, ref, 5e-6)


@pytest.mark.parametrize("int8_decoder", [False, True])
def test_int8_attention_captioner_matches_jax(int8_decoder):
    """The same act_maxes on both sides. The JAX captioner jits its
    forward, where XLA fuses the int8 affine into one multiply-add, so
    the grids differ by an ulp here and there; the tokens agree."""
    enc, dec, imgs = _serving_problem()
    act_maxes = calibrate_act_maxes(enc["resnet"], imgs, jnp.float32)
    ref = jax_make_int8_captioner(
        enc, dec, START, END, max_len=15, compute_dtype=jnp.float32,
        act_maxes=act_maxes, int8_decoder=int8_decoder)(jnp.asarray(imgs))
    captioner = make_int8_attention_captioner(
        encoder_from_jax(enc), decoder_from_jax(dec), START, END,
        max_len=15, compute_dtype=torch.float32, act_maxes=act_maxes,
        int8_decoder=int8_decoder, device="cpu")
    _assert_captions_equal(captioner(imgs), ref, 1e-5)
    assert captioner.act_maxes is act_maxes
    calibrated = make_int8_attention_captioner(
        encoder_from_jax(enc), decoder_from_jax(dec), START, END,
        compute_dtype=torch.float32, calib_imgs=imgs, device="cpu")
    np.testing.assert_allclose(calibrated.act_maxes, act_maxes, rtol=1e-5)


def test_beam_int8_grid_matches_jax():
    dec, grids = _decoder(0.2, 0.5), _grids(4, seed=3)
    ref = jax_beam(dec, jnp.asarray(grids), 3, START, END, max_steps=12,
                   int8_grid=True)
    out = beam_search_batched(decoder_from_jax(dec), torch.from_numpy(grids),
                              3, START, END, max_steps=12, int8_grid=True)
    for key in ("seq", "seq_len", "found"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
    np.testing.assert_allclose(out["alphas"].numpy(),
                               np.asarray(ref["alphas"]), rtol=0, atol=5e-6)
    assert out["found"].all()


def test_beam_captioner_over_jax_quantized_tree():
    enc, dec, imgs = _serving_problem()
    jq = quantize_resnet(enc["resnet"], calibrate_act_maxes(
        enc["resnet"], imgs, jnp.float32))
    grid = encoder_attention_forward_int8(jq, jnp.asarray(imgs), jnp.float32)
    ref = jax_beam(dec, grid, 3, START, END)
    out = make_beam_captioner(None, decoder_from_jax(dec), START, END,
                              beam_size=3, compute_dtype=torch.float32,
                              device="cpu", qresnet=qresnet_from_jax(jq))(
        imgs)
    for key in ("seq", "seq_len", "found"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
    assert out["found"].all()


def _greedy_eval(args, root, module):
    """tools/greedy_eval.py, or the port's module in a subprocess that
    prints the foreign modules it imported last."""
    env = dict(os.environ, ICD_TPU_ROOT=root, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    if module:
        script = (
            "import sys, runpy\n"
            "sys.argv = ['greedy_eval'] + {!r}\n"
            "runpy.run_module('icd_tpu_torch.greedy_eval',"
            " run_name='__main__')\n"
            "print('FOREIGN', sorted(m for m in sys.modules"
            " if m.split('.')[0] in ('jax', 'optax', 'icd_tpu')))\n"
        ).format(list(args))
        cmd = [sys.executable, "-c", script]
    else:
        cmd = [sys.executable, os.path.join(REPO, "tools", "greedy_eval.py"),
               *args]
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _save_baseline_ckpt(vocab_size, end):
    """A baseline .ckpt that icd_tpu saves: the 64-channel test encoder
    with its embed head, and a steered baseline decoder."""
    import argparse

    import optax

    from icd_tpu.checkpoint import save_checkpoint
    from test_torch_baseline import _encoder_tree, np_baseline_tree, \
        steer_end as steer_baseline_end

    dec = steer_baseline_end(np_baseline_tree(vocab=vocab_size), end=end)
    args = argparse.Namespace(model_name="torchbase", model="baseline",
                              embed_size=16)
    return save_checkpoint(args, 0, _encoder_tree(), dec, None,
                           optax.adam(1e-4).init(dec),
                           {"epoch_losses": []}, verbose=False)


def test_greedy_eval_cli_matches_tools_greedy_eval(use_coco_root, tmp_path):
    """``python -m icd_tpu_torch.greedy_eval`` writes the JSON of
    tools/greedy_eval.py (both bf16, the JAX tool's only dtype) from a
    ``.ckpt`` that icd_tpu saved, for both model families, with and
    without ``--int8``; with ``--int8`` the JAX tool calibrates and writes
    ``--act_maxes F`` and the port loads it. One JAX run per
    configuration."""
    from icd_tpu.vocabulary import load_vocab
    from test_torch_serve import _decoder as serve_decoder, _save_ckpt

    root = use_coco_root
    vocab = load_vocab()
    names = {
        "attention": _save_ckpt({"resnet": small_resnet_tree()},
                                serve_decoder(len(vocab), vocab(END_TOKEN))),
        "baseline": _save_baseline_ckpt(len(vocab), vocab(END_TOKEN))}
    for model_type, name in names.items():
        act_maxes = str(tmp_path / "act_maxes_{}.npy".format(model_type))
        for extra in ([], ["--int8", "--act_maxes", act_maxes]):
            common = [os.path.basename(name), "--model_type", model_type,
                      "--batch_size", "2", "--max_len", "12"] + extra
            tag = "{}{}".format(model_type, len(extra))
            ref_json = str(tmp_path / "ref{}.json".format(tag))
            _greedy_eval(common + ["--out", ref_json], root, module=False)
            with open(ref_json) as f:
                ref = json.load(f)
            assert [r["image_id"] for r in ref] == [11, 12, 13]
            assert all(r["caption"] for r in ref)
            out_json = str(tmp_path / "port{}.json".format(tag))
            stdout = _greedy_eval(common + ["--device", "cpu", "--out",
                                            out_json], root, module=True)
            assert stdout.strip().splitlines()[-1] == "FOREIGN []"
            assert ("Loaded act_maxes" in stdout) == bool(extra)
            with open(out_json) as f:
                assert json.load(f) == ref, (model_type, extra)
