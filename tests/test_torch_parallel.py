"""The multi-chip path of icd_tpu_torch (parallel/mesh.py, parallel/vocab.py,
the train steps on a mesh, the sharded captioners, resuming onto a mesh
and the dryrun) against icd_tpu on the same mesh shapes, on the CPU.

One world of four gloo ranks (``parallel.run_ranks``) is spawned once for
the module and runs every case (``testing.run_mesh_cases``), each on a
mesh over the first ranks of the world. While the ranks work, icd_tpu
runs the same cases on meshes of the suite's 8 virtual CPU devices
(``make_mesh(n_data, n_model, devices=jax.devices()[:N])``), and the
port's one-process step runs them as a third side; the dryrun runs as a
subprocess beside them.

Tolerances, and why:
- f32 steps on a mesh against icd_tpu's on the same mesh and against the
  port's one process: losses rtol 1e-5 and updated decoder parameters
  atol 1e-5 after 3 steps (the limits of tests/test_parallel.py:88-94;
  XLA, ATen and the ranks sum in other orders); Adam's moments within
  1e-4 of each tensor's largest value against the one process, the
  limit of the one-device tests (the attention products' gradients are
  small sums over many relu elements; their squares in nu reach 1.2e-5;
  a gradient n_model times too large moves mu by 100 %); BN statistics
  rtol 1e-5, atol 1e-6. The attention score bias's gradient is zero in
  exact arithmetic (the softmax ignores a shift of every score), so
  Adam turns its rounding noise into steps of up to lr: it is left out
  of the attention model's parameter comparisons, as
  ``testing.train_step_errors`` leaves it out;
- --amp: the loss within 1e-2 of icd_tpu's and at most 10 % of the
  updated parameters more than lr / 100 from icd_tpu's (the limits of
  tests/test_torch_train_baseline.py's --amp step); against the port's
  one process, whose bf16 roundings are the same operations on the
  same rows, loss rtol 1e-3 and the same 10 % share (the BN statistics'
  global sums are taken in another order and the bf16 activations they
  normalise can round the other way);
- --int8_encoder in f32: losses rtol 1e-5 (the jitted JAX trunk
  contracts the dequant affine into an FMA, an ulp away);
- synced train-mode BN: outputs rtol 1e-5, atol 1e-6 of icd_tpu's
  train-mode BN of the whole batch, running statistics rtol 1e-5,
  atol 1e-6;
- vocab-parallel gradients (embedding, fc/linear and the replicated
  parameters, whose gradient reaches them through every shard) within
  1e-6 of each tensor's largest value of the unsplit decoder's;
- sharded captioners in f32: tokens equal to icd_tpu's sharded builders
  on the same mesh shape; beam seq, seq_len and found equal, and
  ``steps`` equal to the port's one-process search of the whole batch.

Sizes: ResNet (1, 1, 1, 1) of widths (4, 8, 8, 16) (64 channels out),
64x64 images, V = 40, baseline E = 16, H = 12, attention A = 10,
batch 8 (6 for the replicated trailing batch), captions of 8 tokens.
"""

import os
import subprocess
import sys
import threading
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icd_tpu.training.attention as jax_ta
import icd_tpu.training.baseline as jax_tb
from icd_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from icd_tpu.decoding.serve import (
    make_sharded_attention_captioner as jax_sharded_attention,
    make_sharded_beam_captioner as jax_sharded_beam,
    make_sharded_captioner as jax_sharded_captioner)
from icd_tpu.models.encoder import trainable_mask as jax_trainable_mask
from icd_tpu.models.resnet import batch_norm as jax_batch_norm
from icd_tpu.parallel.mesh import (batch_sharding, make_data_mesh,
                                   param_sharding, replicated)
from icd_tpu.parallel.mesh import decoder_param_specs as jax_param_specs
from icd_tpu.parallel.mesh import make_mesh as jax_make_mesh
from icd_tpu.training.common import merge, partition
from icd_tpu_torch import parallel
from icd_tpu_torch.decoding.beam import beam_search_batched
from icd_tpu_torch.models.encoder import encoder_attention_forward
from icd_tpu_torch.models.resnet_int8 import (calibrate_act_maxes,
                                             quantize_resnet)
from icd_tpu_torch.params import (decoder_from_jax, decoder_to_jax,
                                  encoder_from_jax, qresnet_to_jax,
                                  resnet_from_jax)
from icd_tpu_torch.testing import (mesh_train, run_mesh_cases, steer_end,
                                   vocab_grads)
from test_torch_params import small_resnet_tree
from test_torch_qlinear import np_decoder_tree
from test_torch_train_baseline import (D, E, H, PAD, V, baseline_tree,
                                       encoder_tree)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
A = 10
B, T = 8, 8
LR = 1e-3
START, END = V - 3, V - 2
SCORE_BIAS = ("attention", "full_att", "b")


def _captions(b, seed):
    """(b, T) captions: <start> words <end> then <pad>, lengths 3..T, so
    that the data shards hold different counts of counted tokens."""
    rng = np.random.default_rng(seed)
    caps = np.full((b, T), PAD, np.int64)
    for i, n in enumerate(rng.integers(3, T + 1, b)):
        caps[i, 0], caps[i, n - 1] = 1, 2
        caps[i, 1:n - 1] = rng.integers(4, V, n - 2)
    return caps


def _images(b, seed):
    return np.random.default_rng(50 + seed).integers(
        0, 256, (b, 64, 64, 3), dtype=np.uint8)


def _batches(b=B, n=3, bert=False):
    out = []
    for i in range(n):
        batch = {"imgs": _images(b, 10 + i), "captions": _captions(b, 10 + i)}
        if bert:
            batch["embeddings"] = np.random.default_rng(20 + i).normal(
                size=(b, T + 1, E)).astype(np.float32)
        out.append(batch)
    return out


def _attention_trees():
    return {"resnet": small_resnet_tree()}, np_decoder_tree(V, A, H, E, D)


# The train cases: name -> (mesh shape, family, trees, batches, options).
def _train_cases():
    base = (encoder_tree(), baseline_tree())
    att = _attention_trees()
    resnet = resnet_from_jax(base[0]["resnet"])
    qtree = qresnet_to_jax(quantize_resnet(resnet, calibrate_act_maxes(
        resnet, _images(B, 0), torch.float32)))
    cases = {}
    for shape in ((2, 1), (1, 2), (2, 2)):
        cases["baseline_{}x{}".format(*shape)] = (
            shape, "baseline", base, _batches(), {})
    cases["attention_2x2"] = ((2, 2), "attention", att, _batches(), {})
    cases["attention_dropout_2x1"] = ((2, 1), "attention", att, _batches(),
                                      {"dropout": 0.5})
    cases["bert_2x2"] = ((2, 2), "attention", att, _batches(bert=True),
                         {"use_bert": True})
    cases["amp_2x2"] = ((2, 2), "baseline", base, _batches(n=1),
                        {"compute_dtype": torch.bfloat16})
    cases["int8_2x2"] = ((2, 2), "baseline", base, _batches(n=1),
                         {"qresnet": qtree})
    cases["replicated_4x1"] = ((4, 1), "baseline", base, _batches(b=6), {})
    return cases


def _rank_case(name, shape, family, trees, batches, options, kind="train"):
    options = dict(options, lr=LR)
    case = dict(kind=kind, name=name, n_data=shape[0], n_model=shape[1],
                family=family, encoder=trees[0], decoder=trees[1],
                batches=batches)
    if options.get("qresnet") is not None:
        case["qresnet"] = options.pop("qresnet")
    case["options"] = options
    return case


def _jax_steps(shape, family, trees, batches, options):
    """icd_tpu's jitted step on a (n_data, n_model) mesh of the virtual
    devices, the decoder split over ``model`` by its
    ``decoder_param_specs``, each batch split over ``data`` or
    replicated when it does not divide (training/attention.py:270-274).
    Returns (losses, the merged params as numpy)."""
    n_data, n_model = shape
    mesh = jax_make_mesh(n_data, n_model, devices=jax.devices()[:n_data
                                                                * n_model])
    enc, dec = (jax.tree_util.tree_map(jnp.asarray, t) for t in trees)
    mask = {"encoder": jax_trainable_mask(enc, fine_tune=False, head=False),
            "decoder": jax_tb._decoder_trainable_mask(dec, True)}
    if options.get("use_bert"):
        mask["decoder"]["embedding"] = False
    params = {"encoder": jax.device_put(enc, replicated(mesh)),
              "decoder": jax.tree_util.tree_map(
                  jax.device_put, dec,
                  param_sharding(jax_param_specs(dec), mesh))}
    trainable, frozen = partition(params, mask)
    args = types.SimpleNamespace(encoder_lr=LR, decoder_lr=LR, grad_clip=5.0)
    tx = jax_tb.make_optimizer_for(trainable, args)
    opt_state = tx.init(trainable)
    compute = jnp.bfloat16 if options.get("compute_dtype") else None
    qresnet = options.get("qresnet")
    if qresnet is not None:
        qresnet = jax.device_put(jax.tree_util.tree_map(jnp.asarray, qresnet),
                                 replicated(mesh))
    if family == "baseline":
        step = jax.jit(jax_tb.make_train_step(PAD, mask, tx, compute,
                                              qresnet))
    else:
        step = jax.jit(jax_ta.make_train_step(mask, tx, 1.0, 0.0, compute,
                                              qresnet))
    losses = []
    with mesh:
        for batch in batches:
            n = len(batch["captions"])

            def put(x):
                x = jnp.asarray(x)
                return jax.device_put(x, batch_sharding(mesh, x.ndim)
                                      if n % n_data == 0
                                      else replicated(mesh))

            imgs = put(batch["imgs"])
            caps = put(batch["captions"].astype(np.int32))
            if family == "baseline":
                trainable, frozen, opt_state, loss = step(
                    trainable, frozen, opt_state, imgs, caps)
            else:
                lens = put(np.full(n, T - 1, np.int32))
                embs = batch.get("embeddings")
                trainable, frozen, opt_state, loss = step(
                    trainable, frozen, opt_state, jax.random.PRNGKey(0),
                    imgs, caps, lens, None if embs is None else put(embs))
            losses.append(float(loss))
    full = merge(trainable, frozen)
    return losses, jax.tree_util.tree_map(np.asarray, full)


def _one_process(family, trees, batches, options):
    from icd_tpu_torch.params import qresnet_from_jax

    options = dict(options, lr=LR)
    if options.get("qresnet") is not None:
        options["qresnet"] = qresnet_from_jax(options["qresnet"])
    return mesh_train(None, family, encoder_from_jax(trees[0]),
                      decoder_from_jax(trees[1]), batches, **options)


def _bn_input():
    rng = np.random.default_rng(3)
    c = 8
    x = (rng.standard_normal((B, 5, 5, c)) * 3 + 1).astype(np.float32)
    bn = {"scale": rng.standard_normal(c).astype(np.float32),
          "bias": rng.standard_normal(c).astype(np.float32),
          "mean": rng.standard_normal(c).astype(np.float32),
          "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return x, bn


def _vocab_inputs(family):
    rng = np.random.default_rng(4)
    caps = _captions(B, 4)
    if family == "baseline":
        return baseline_tree(), {"feats": rng.standard_normal(
            (B, E)).astype(np.float32), "captions": caps}
    return np_decoder_tree(V, A, H, E, D), {"grid": rng.standard_normal(
        (B, 2, 2, D)).astype(np.float32), "captions": caps}


def _captioner_inputs():
    """A decoder steered (``testing.steer_end``) to finish its captions
    after 14 to 34 beam steps on these images, more on one data shard
    than on the other."""
    enc, dec = _attention_trees()
    dec = decoder_from_jax(dec)
    steer_end(dec, END, rate=0.1, spread=0.1)
    dec = decoder_to_jax(dec)
    imgs = _images(B, 7)
    base_enc = encoder_tree()
    act_maxes = calibrate_act_maxes(resnet_from_jax(base_enc["resnet"]),
                                    imgs, torch.float32)
    return dict(kind="captioners", name="captioners_2x2", n_data=2,
                n_model=2, encoder=enc, decoder=dec, imgs=imgs,
                baseline_encoder=base_enc, baseline_decoder=baseline_tree(),
                act_maxes=act_maxes, start_id=START, end_id=END,
                max_len=40)


def _jax_captioners(case):
    mesh = jax_make_mesh(2, 2, devices=jax.devices()[:4])
    imgs = jnp.asarray(case["imgs"])
    f32 = jnp.float32
    enc, dec = (jax.tree_util.tree_map(jnp.asarray, case[k])
                for k in ("encoder", "decoder"))
    benc, bdec = (jax.tree_util.tree_map(jnp.asarray, case[k])
                  for k in ("baseline_encoder", "baseline_decoder"))
    out = {"baseline": jax_sharded_captioner(
        benc, bdec, START, END, mesh, max_len=6, compute_dtype=f32)(imgs),
        "baseline_int8": jax_sharded_captioner(
            benc, bdec, START, END, mesh, max_len=6, compute_dtype=f32,
            int8=True, act_maxes=case["act_maxes"],
            int8_decoder=True)(imgs),
        "greedy": jax_sharded_attention(
            enc, dec, START, END, mesh, max_len=case["max_len"],
            compute_dtype=f32)(imgs),
        "beam": jax_sharded_beam(enc, dec, START, END, mesh, beam_size=3,
                                 compute_dtype=f32)(imgs)}
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case run once: by the four ranks (in a thread, so that JAX
    runs meanwhile), by icd_tpu and by the port's one process; and the
    dryrun's output."""
    root = str(tmp_path_factory.mktemp("mesh_ckpt"))
    env = dict(os.environ, PYTHONPATH=REPO)
    dryrun = subprocess.Popen(
        [sys.executable, "-m", "icd_tpu_torch.parallel.dryrun", "4"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    train = _train_cases()
    cases = [_rank_case(name, *spec) for name, spec in train.items()]
    x, bn = _bn_input()
    cases += [dict(kind="bn", name="bn_{}x1".format(n), n_data=n, n_model=1,
                   x=x, bn=bn) for n in (2, 4)]
    for family in ("baseline", "attention"):
        tree, inputs = _vocab_inputs(family)
        cases += [dict(kind="vocab_grads", name="vocab_{}_{}x{}".format(
            family, *shape), n_data=shape[0], n_model=shape[1],
            family=family, decoder=tree, inputs=inputs)
            for shape in ((1, 2), (2, 2))]
    captioners = _captioner_inputs()
    cases.append(captioners)
    ckpt = _rank_case("ckpt_2x2", (2, 2), "attention", _attention_trees(),
                      _batches(), {}, kind="ckpt")
    ckpt["root"] = root
    cases.append(ckpt)

    ranks = {}

    def spawn():
        try:
            ranks["out"] = parallel.run_ranks(run_mesh_cases, 4,
                                              args=(cases,), limit_s=300)
        except Exception as exc:  # re-raised in the test process below
            ranks["error"] = exc

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        # XLA compiles each case's step apart; four at a time.
        with ThreadPoolExecutor(max_workers=4) as pool:
            futures = {name: pool.submit(_jax_steps, spec[0], *spec[1:])
                       for name, spec in train.items()
                       if name != "attention_dropout_2x1"}
            futures["captioners"] = pool.submit(_jax_captioners, captioners)
            jax_out = {name: f.result() for name, f in futures.items()}
        jbn = {key: jnp.asarray(value) for key, value in bn.items()}
        y, new = jax_batch_norm(jnp.asarray(x), jbn, train=True)
        jax_out["bn"] = (np.asarray(y), np.asarray(new["mean"]),
                         np.asarray(new["var"]))
        one = {name: _one_process(*spec[1:]) for name, spec in train.items()}
        one["vocab"] = {}
        for family in ("baseline", "attention"):
            tree, inputs = _vocab_inputs(family)
            one["vocab"][family] = vocab_grads(
                decoder_from_jax(tree), family,
                {k: torch.from_numpy(v) for k, v in inputs.items()})
    finally:
        thread.join(timeout=400)
    assert not thread.is_alive(), "the ranks did not finish"
    if "error" in ranks:
        raise ranks["error"]
    try:
        dryrun_out, _ = dryrun.communicate(timeout=300)
    finally:
        dryrun.kill()
    return dict(ranks=ranks["out"], jax=jax_out, one=one, cases=cases,
                root=root, dryrun=(dryrun.returncode, dryrun_out))


def _trees_close(got, want, atol=0.0, rtol=0.0, scaled=False, skip=()):
    g_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    w_leaves = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(g_leaves) == len(w_leaves)
    for path, g in g_leaves:
        keys = tuple(getattr(p, "key", getattr(p, "idx", None))
                     for p in path)
        if skip and keys[-len(skip):] == skip:
            continue
        w = np.asarray(w_leaves[path], np.float32)
        tol = atol * max(np.abs(w).max(), 1e-30) if scaled else atol
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=rtol,
                                   atol=tol, err_msg=str(keys))


def _skip(family):
    return SCORE_BIAS if family == "attention" else ()


TRAIN_F32 = ["baseline_2x1", "baseline_1x2", "baseline_2x2",
             "attention_2x2", "bert_2x2", "replicated_4x1"]


@pytest.mark.parametrize("name", TRAIN_F32)
def test_mesh_steps_match_jax(world, name):
    """f32 steps on the mesh against icd_tpu's steps on the same mesh
    shape: losses rtol 1e-5, updated decoder parameters atol 1e-5."""
    got = world["ranks"][0][name]
    losses, full = world["jax"][name]
    family = "baseline" if "attention" not in name and "bert" not in name \
        else "attention"
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    _trees_close(got["decoder"], full["decoder"], atol=1e-5,
                 skip=_skip(family))


@pytest.mark.parametrize("name", TRAIN_F32 + ["attention_dropout_2x1"])
def test_mesh_steps_match_one_process(world, name):
    """The same steps in one process (no mesh): losses rtol 1e-5,
    decoder parameters atol 1e-5, Adam's moments within 1e-4 of their
    largest value, BN statistics rtol 1e-5. With dropout 0.5 on two data
    ranks each rank takes its rows of the global batch's mask; dropped
    units leave gradient elements near Adam's eps, where a last-bit
    difference of the gradient becomes up to 1e-2 of a step (2.6e-5 in
    one element of 3,840 after 3 steps), so its parameters are held to
    1e-2 lr a step, the limit of the one-device tests
    (tests/test_torch_train_baseline.py)."""
    got = world["ranks"][0][name]
    want = world["one"][name]
    family = "baseline" if "attention" not in name and "bert" not in name \
        else "attention"
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    atol = 1e-2 * LR * len(got["losses"]) if "dropout" in name else 1e-5
    _trees_close(got["decoder"], want["decoder"], atol=atol,
                 skip=_skip(family))
    assert int(got["adam"]["count"]) == int(want["adam"]["count"]) == len(
        got["losses"])
    for key in ("mu", "nu"):
        _trees_close(got["adam"][key], want["adam"][key], atol=1e-4,
                     scaled=True, skip=_skip(family))
    for bn_name, value in want["bn"].items():
        np.testing.assert_allclose(got["bn"][bn_name], value, rtol=1e-5,
                                   atol=1e-6, err_msg=bn_name)


def test_mesh_results_are_the_same_on_every_rank(world):
    """Every rank of a mesh ends with the same gathered decoder and the
    same global losses; the ranks outside it run nothing."""
    for case in world["cases"]:
        if case["name"] not in TRAIN_F32:
            continue
        results = [r[case["name"]] for r in world["ranks"]]
        inside = [x for x in results if x is not None]
        assert len(inside) == case["n_data"] * case["n_model"]
        for other in inside[1:]:
            assert other["losses"] == inside[0]["losses"]
            _trees_close(other["decoder"], inside[0]["decoder"])


def _share_beyond(got, want, lr):
    g = jax.tree_util.tree_leaves(got)
    w = jax.tree_util.tree_leaves(want)
    beyond = sum(int((np.abs(a - b) > lr / 100).sum()) for a, b in zip(g, w))
    return beyond / sum(a.size for a in g)


def test_amp_step_on_a_mesh(world):
    """One --amp step on a (2, 2) mesh: within the single-device --amp
    limits of icd_tpu's step on the same mesh, and close to the port's
    one process."""
    got = world["ranks"][0]["amp_2x2"]
    losses, full = world["jax"]["amp_2x2"]
    assert abs(got["losses"][0] - losses[0]) <= 1e-2 * abs(losses[0])
    assert _share_beyond(got["decoder"], full["decoder"], LR) <= 0.1
    one = world["one"]["amp_2x2"]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-3)
    assert _share_beyond(got["decoder"], one["decoder"], LR) <= 0.1


def test_int8_encoder_step_on_a_mesh(world):
    """One f32 --int8_encoder step on a (2, 2) mesh over the same int8
    tree: the loss rtol 1e-5 of icd_tpu's and of the one process, the
    decoder atol 1e-5 of the one process."""
    got = world["ranks"][0]["int8_2x2"]
    losses, _ = world["jax"]["int8_2x2"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    one = world["one"]["int8_2x2"]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
    _trees_close(got["decoder"], one["decoder"], atol=1e-5)


@pytest.mark.parametrize("n_data", [2, 4])
def test_synced_batch_norm_matches_jax_whole_batch(world, n_data):
    """Train-mode BN over n_data ranks' rows: the outputs, gathered in
    rank order, and the new running statistics (the same on every rank)
    equal icd_tpu's train-mode BN of the whole batch."""
    outs = [r["bn_{}x1".format(n_data)] for r in world["ranks"][:n_data]]
    y, mean, var = world["jax"]["bn"]
    np.testing.assert_allclose(np.concatenate([o["y"] for o in outs]), y,
                               rtol=1e-5, atol=1e-6)
    for o in outs:
        np.testing.assert_allclose(o["mean"], mean, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o["var"], var, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("family", ["baseline", "attention"])
@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_vocab_parallel_gradients_match_unsplit(world, family, shape):
    """The decoder split over two model ranks, a loss replicated on
    both: every parameter's gradient, the shards' gathered, within 1e-6
    of the unsplit decoder's largest value; not n_model times it. (The
    attention score bias's gradient is zero in exact arithmetic and
    left out.)"""
    got = world["ranks"][0]["vocab_{}_{}".format(family, shape)]
    want = world["one"]["vocab"][family]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
    _trees_close(got["grads"], want["grads"], atol=1e-6, scaled=True,
                 skip=_skip(family))


def test_sharded_captioners_match_jax(world):
    """The three sharded captioners (baseline float and static-int8 with
    the W8A8 decoder, attention greedy, per-step beam) on a (2, 2) mesh
    in f32: tokens equal to icd_tpu's sharded builders on the same mesh
    shape; beam seq, seq_len and found equal, and steps equal to the
    port's one-process search of the whole batch."""
    got = world["ranks"][0]["captioners_2x2"]
    want = world["jax"]["captioners"]
    np.testing.assert_array_equal(got["baseline"], want["baseline"])
    np.testing.assert_array_equal(got["baseline_int8"],
                                  want["baseline_int8"])
    np.testing.assert_array_equal(got["greedy"][0], want["greedy"][0])
    np.testing.assert_allclose(got["greedy"][1], want["greedy"][1],
                               atol=1e-6)
    for key in ("seq", "seq_len", "found"):
        np.testing.assert_array_equal(got["beam"][key], want["beam"][key])
    case = world["cases"][[c["name"] for c in world["cases"]].index(
        "captioners_2x2")]
    enc, dec = encoder_from_jax(case["encoder"]), decoder_from_jax(
        case["decoder"])
    with torch.no_grad():
        grid = encoder_attention_forward(enc, torch.from_numpy(case["imgs"]))
        one = beam_search_batched(dec, grid, 3, START, END)
    assert got["beam"]["steps"] == one["steps"]
    per_rank = [r["captioners_2x2"]["beam"]["steps"] for r in world["ranks"]]
    assert len(set(per_rank)) == 1
    lengths = got["beam"]["seq_len"]
    assert bool(got["beam"]["found"].all())
    assert lengths[:B // 2].max() != lengths[B // 2:].max()
    assert len(set(int(n) for n in (got["greedy"][0] == END).argmax(1))) > 1


def test_checkpoint_resumes_onto_a_mesh(world):
    """Rank 0 writes the checkpoint of the gathered shards after two
    steps on a (2, 2) mesh; resumed onto the mesh, the next step equals
    a resumed one-process step from the same file; icd_tpu reads the
    file, whose decoder is the one the ranks gathered."""
    got = world["ranks"][0]["ckpt_2x2"]
    path = os.path.join(world["root"], "checkpoints", "mesh_0.ckpt")
    os.environ["ICD_TPU_ROOT"] = world["root"]
    chkpt = jax_load_checkpoint(name="mesh_0.ckpt", verbose=False)
    _trees_close(chkpt["decoder"], got["first"]["decoder"])
    assert os.path.exists(path)
    from icd_tpu_torch.checkpoint import load_checkpoint, unpack_checkpoint

    _, enc, dec, _, opt_state, _ = unpack_checkpoint(
        load_checkpoint(name="mesh_0.ckpt", verbose=False))
    case = world["cases"][[c["name"] for c in world["cases"]].index(
        "ckpt_2x2")]
    one = mesh_train(None, "attention", encoder_from_jax(enc),
                     decoder_from_jax(dec), case["batches"][-1:], lr=LR,
                     opt_state=opt_state)
    resumed = got["resumed"]
    np.testing.assert_allclose(resumed["losses"], one["losses"], rtol=1e-5)
    _trees_close(resumed["decoder"], one["decoder"], atol=1e-5,
                 skip=SCORE_BIAS)
    assert int(resumed["adam"]["count"]) == 3


def test_dryrun_passes_every_phase(world):
    """``python -m icd_tpu_torch.parallel.dryrun 4``: exit 0 and the nine
    phase lines of __graft_entry__.dryrun_multichip."""
    code, out = world["dryrun"]
    assert code == 0, out
    for phase in ("baseline", "baseline-amp", "attention", "attention-bert",
                  "baseline-int8enc", "serving", "attention-eval",
                  "beam-serving", "ckpt-resume"):
        assert "dryrun_multichip {} ok: devices=4".format(phase) in out, out


def test_make_data_mesh_picks_the_largest_divisor():
    """The divisors of tests/test_parallel.py:106-112 over 8 ranks,
    without a process group; the same as icd_tpu's over 8 devices."""
    for batch, n in ((32, 8), (12, 6), (7, 7), (13, 1)):
        mesh = parallel.make_data_mesh(batch, ranks=range(8))
        assert mesh.shape == {"data": n, "model": 1}
        assert mesh.data_group is None and mesh.coords is None
        assert make_data_mesh(batch).shape["data"] == n


def test_mesh_layout_and_batch_rows():
    """JAX's device order: rank r at (r // n_model, r % n_model); a rank's
    rows of a batch that divides over the data ranks, the whole batch
    when it does not; shard_batch keeps what is not an array."""
    mesh = parallel.make_mesh(4, 2, ranks=range(8))
    assert mesh.ranks.tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    batch = {"imgs": np.arange(8 * 2).reshape(8, 2), "paths": ["x"] * 8}
    for rank in range(8):
        mesh.coords = (rank // 2, rank % 2)
        rows = parallel.batch_rows(mesh, 8)
        assert (rows.start, rows.stop) == (2 * (rank // 2),
                                           2 * (rank // 2) + 2)
        out = parallel.shard_batch(batch, mesh)
        np.testing.assert_array_equal(out["imgs"], batch["imgs"][rows])
        assert out["paths"] == ["x"] * 8
        assert parallel.batch_rows(mesh, 6) == slice(0, 6)
    specs = parallel.decoder_param_specs(decoder_from_jax(
        _attention_trees()[1]))
    assert {n for n, d in specs.items() if d == 0} == {
        "fc.weight", "fc.bias", "embedding.weight"}
    want = jax_param_specs(_attention_trees()[1])
    assert tuple(want["fc"]["w"]) == (None, "model")
    assert tuple(want["embedding"]) == ("model", None)


def test_torchrun_launch_that_is_not_the_divisor_raises(use_coco_root,
                                                         monkeypatch):
    """Under torchrun with 3 ranks, --batch_size 4 splits over 2: the CLI
    raises before any work (no process group), naming the count."""
    from icd_tpu_torch import train

    for key, value in (("LOCAL_RANK", "0"), ("RANK", "0"),
                       ("WORLD_SIZE", "3")):
        monkeypatch.setenv(key, value)
    with pytest.raises(ValueError, match="--nproc_per_node 2"):
        train.main(["x", "--model", "baseline", "--batch_size", "4",
                    "--device", "cpu"])
    assert not torch.distributed.is_initialized()
