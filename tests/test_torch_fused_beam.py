"""K2's plain version (icd_tpu_torch/ops/fused_beam.py) vs icd_tpu (CPU).

The same numpy decoder tree and grids go through four beam searches:
JAX ``beam_search_fused`` (the Pallas kernel in interpret mode, as
tests/test_fused_beam.py runs it), JAX ``beam_search_batched``, the
port's ``beam_search_fused`` on CPU tensors (its plain version) and the
port's ``beam_search_batched``. In f32, seq, seq_len and found must be
equal and alphas agree to atol 5e-6 (the frameworks sum in different
orders). Problems stay as small as tests/test_fused_beam.py's: b <= 6,
P = 16, V = 40, 7 steps. The decoders are steered as in
tests/test_torch_beam.py, so captions have several lengths, images
retire early beside images that run to max_steps, and some never finish.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icd_tpu.decoding.beam import beam_search_batched as jax_beam
from icd_tpu.ops.fused_beam import beam_search_fused as jax_fused
from icd_tpu_torch.decoding.beam import beam_search_batched
from icd_tpu_torch.decoding.beam import _top_k
from icd_tpu_torch.ops.fused_beam import (PHASES, _operands, _search_plain,
                                          beam_search_fused, phase_ms)
from icd_tpu_torch.params import decoder_from_jax
from icd_tpu_torch.testing import explain_splits, plain_step_record
from test_torch_beam import END, MAX_STEPS, P, START, _decoder, _grids

K = 5


def _assert_same(out, ref, atol=5e-6):
    for key in ("seq", "seq_len", "found"):
        np.testing.assert_array_equal(np.asarray(out[key]),
                                      np.asarray(ref[key]), err_msg=key)
    np.testing.assert_allclose(np.asarray(out["alphas"]),
                               np.asarray(ref["alphas"]), rtol=0, atol=atol)


def _all_four(dec, grids, k=K, max_steps=MAX_STEPS):
    """Run the four searches; check they agree; return the port's K2."""
    jgrids = jnp.asarray(grids)
    ref_fused = jax_fused(dec, jgrids, k, START, END, max_steps=max_steps,
                          interpret=True)
    ref_loop = jax_beam(dec, jgrids, k, START, END, max_steps=max_steps)
    tdec = decoder_from_jax(dec)
    tgrids = torch.from_numpy(grids)
    launches = beam_search_fused.launches
    out = beam_search_fused(tdec, tgrids, k, START, END, max_steps=max_steps)
    assert beam_search_fused.launches == launches  # CPU: no kernel
    loop = beam_search_batched(tdec, tgrids, k, START, END,
                               max_steps=max_steps)
    out_np = {key: val.numpy() for key, val in out.items() if key != "steps"}
    _assert_same(out_np, ref_fused)
    _assert_same(out_np, ref_loop)
    _assert_same(out_np, {key: val.numpy() for key, val in loop.items()
                          if key != "steps"})
    assert out["steps"] == loop["steps"]
    return out


def test_varied_lengths():
    out = _all_four(_decoder(0.2, 0.5), _grids())
    assert out["found"].all()
    assert len(set(out["seq_len"].tolist())) >= 3


def test_early_finish_beside_max_steps():
    """Images that retire every beam early beside images that run on:
    K2 does not freeze them, it masks their rows out of every later
    candidate set; the outputs must not tell the difference."""
    dec = _decoder(0.1, 1.0)
    grids = _grids()
    tdec = decoder_from_jax(dec)
    alone = [beam_search_fused(tdec, torch.from_numpy(grids[i:i + 1]), K,
                               START, END, max_steps=MAX_STEPS)["steps"]
             for i in range(grids.shape[0])]
    assert min(alone) < MAX_STEPS and max(alone) == MAX_STEPS, alone
    assert _all_four(dec, grids)["steps"] == MAX_STEPS


def test_found_and_not_found_in_one_batch():
    out = _all_four(_decoder(0.2, 1.0), _grids())
    assert out["found"].any() and not out["found"].all()


def test_no_finish_protocol():
    """<end> unreachable: [start, end], seq_len 2, and row 1 of alphas is
    the all-ones start of the per-step loop's best_last_alpha."""
    dec = _decoder(0.2, 0.5)
    dec["fc"]["b"][END] = -1e9
    out = _all_four(dec, _grids())
    assert not out["found"].any()
    np.testing.assert_array_equal(out["seq_len"].numpy(), np.full((4,), 2))
    np.testing.assert_array_equal(out["alphas"][:, 1].numpy(),
                                  np.ones((4, P), np.float32))


def test_exact_ties():
    """Duplicated fc columns: twin words tie bit for bit, and the flat
    top-k must take the lower index first, like lax.top_k."""
    _all_four(_twin_decoder(), _grids())


def _twin_decoder():
    """test_exact_ties' decoder: fc columns 20..36 copy columns 0..16."""
    dec = _decoder(0.2, 0.5)
    twins = np.arange(17)
    dec["fc"]["w"][:, twins + 20] = dec["fc"]["w"][:, twins]
    dec["fc"]["b"][twins + 20] = dec["fc"]["b"][twins]
    return dec


def test_f64_arbiter_takes_f32s_choices_without_near_ties():
    """K2's plain version with float64 sums and state (the arbiter of
    trace_k2_splits) makes every choice of the f32 default on a problem
    whose top-k holds no near tie: at every step each of the first k + 1
    candidates lies more than 1e-5 above the next in f64 (5.3e-5 at the
    least), ten f32 ulps at these scores (|score| < 64). The default is
    the f32 run, bit for bit."""
    ops = _operands(decoder_from_jax(_decoder(0.2, 0.5)),
                    torch.from_numpy(_grids()))
    f32 = _search_plain(ops, K, START, END, MAX_STEPS)
    same = _search_plain(ops, K, START, END, MAX_STEPS, acc=torch.float32,
                         top_k=_top_k)
    f64 = _search_plain(ops, K, START, END, MAX_STEPS, acc=torch.float64)
    for key in f32:
        assert (torch.equal(f32[key], same[key]) if key != "steps"
                else f32[key] == same[key]), key
    assert f64["alpha"].dtype == torch.float64
    for key in ("parent", "best_seq", "best_len", "best_step",
                "best_parent", "found"):
        assert torch.equal(f32[key], f64[key]), key
    assert f32["steps"] == f64["steps"]
    np.testing.assert_allclose(f64["alpha"].numpy(), f32["alpha"].numpy(),
                               rtol=0, atol=1e-6)
    images = list(range(4))
    cands = plain_step_record(ops, K, START, END, MAX_STEPS, images,
                              acc=torch.float64)["cands"]
    for t, cand in cands.items():
        top = torch.sort(cand, dim=1, descending=True).values[:, :K + 2]
        assert (top[top > -1e8].abs() < 64).all()
        gaps = (top[:, :-1] - top[:, 1:])[top[:, 1:] > -1e8]  # live pairs
        assert (gaps > 1e-5).all(), t


def test_tracer_reports_a_twin_tie_as_a_zero_f64_gap():
    """On the twin-column decoder, a stand-in for K2 whose score of a
    chosen word's twin is one f32 ulp higher takes the twin first: the
    tracer names the pair (the twin, the word) at that step, with an f64
    gap of 0 (twin columns give equal sums in any precision) and errors
    of rounding size (K2's the ulp it was given, within 4 ulps each: the
    sum over two candidates), so the split is explained."""
    ops = _operands(decoder_from_jax(_twin_decoder()),
                    torch.from_numpy(_grids()))
    images = list(range(4))
    plain = plain_step_record(ops, K, START, END, MAX_STEPS, images)
    arbiter = plain_step_record(ops, K, START, END, MAX_STEPS, images,
                                acc=torch.float64, replay=plain["choices"])
    v = ops["emb"].shape[0]
    # Step 1 (every slot valid): image 0's first choice whose word has a
    # twin; the stand-in raises the twin by one ulp.
    t, img = 1, 0
    first = plain["choices"][t][img]
    rank = next(r for r in range(K) if int(first[r]) % v < 17)
    word_idx = int(first[rank])
    twin_idx = word_idx + 20
    cand = plain["cands"][t].clone()
    assert cand[img, twin_idx] == cand[img, word_idx]
    cand[img, twin_idx] = torch.nextafter(cand[img, twin_idx],
                                          torch.tensor(np.inf))
    k2 = {"choices": dict(plain["choices"]), "cands": dict(plain["cands"]),
          "consistent": {u: torch.ones(4, dtype=torch.bool)
                         for u in plain["choices"]}}
    k2["choices"][t] = plain["choices"][t].clone()
    k2["choices"][t][img] = _top_k(cand[img:img + 1], K)[1][0]
    k2["cands"][t] = cand
    splits = explain_splits(k2, plain, arbiter, images, K, v, END)
    assert [s["step"] for s in splits] == [t, None, None, None]
    rec = splits[0]
    assert rec["explained"] and rec["k2_consistent"]
    pair = rec["pairs"][0]
    prev = word_idx // v
    assert pair["k2"] == [prev, twin_idx % v]
    assert pair["plain"] == [prev, word_idx % v]
    assert pair["rank"] == rank and pair["gap_f64"] == 0.0
    assert pair["f64_prefers"] == "tie" and pair["explained"]
    assert 0 < pair["err_k2"] <= 4 * pair["f32_ulp"]
    assert pair["err_plain"] <= 4 * pair["f32_ulp"]


@pytest.mark.parametrize("k", [1, 3])
def test_beam_sizes(k):
    _all_four(_decoder(0.2, 0.5, seed=k), _grids(), k=k)


def test_batch_of_six():
    """b = 6: the TPU kernel's chunk_images=4 does not divide it."""
    out = _all_four(_decoder(0.15, 1.0, seed=2), _grids(6))
    assert out["seq"].shape == (6, MAX_STEPS + 1)


def test_bf16_matches_jax_fused_kernel():
    """bf16 grid and weights: the port's K2 (plain version) against the
    JAX kernel in interpret mode, both at K2's rounding points (bf16
    operands, f32 sums and state, bf16 logits). Tokens pinned exactly,
    alphas to 2e-3.

    Not every bf16 problem agrees to the token. On ``_decoder(0.2, 0.5)``
    (seed 0) one image of four takes another caption: two beams complete
    at the same step with nearly equal scores, after the logits were
    rounded to bf16 (one unit is 2^-8 relative), so a last-bit difference
    of the f32 sums, taken in another order, can flip the rounding of one
    logit and the order of the two beams. The operands made outside the kernel add
    to it: att_enc, h0 and c0 are bf16 Linear layers, which JAX rounds
    twice (the product, then the bias add) and ``nn.Linear`` once."""
    dec = jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)),
        _decoder(0.2, 0.5, seed=1))
    grids = jnp.asarray(_grids(), jnp.bfloat16)
    ref = jax_fused(dec, grids, K, START, END, max_steps=MAX_STEPS,
                    interpret=True)
    out = beam_search_fused(
        decoder_from_jax(dec),
        torch.from_numpy(np.array(grids.astype(jnp.float32))).bfloat16(),
        K, START, END, max_steps=MAX_STEPS)
    _assert_same({key: val.numpy() for key, val in out.items()
                  if key != "steps"}, ref, atol=2e-3)
    assert out["found"].all() and len(set(out["seq_len"].tolist())) >= 3


def test_phase_ms_sums_the_steps_run():
    """K2's clock to ms per phase: a synthetic (max_steps + 1, phases + 1)
    timer of which only the first 3 of 5 steps ran; the rows after them
    hold garbage that must not be read."""
    n = len(PHASES)
    rng = np.random.default_rng(0)
    clock = np.full((6, n + 1), -7, np.int64)
    clock[0, :2] = (1_000, 41_000)
    t = 41_000
    durations = rng.integers(1_000, 90_000, size=(3, n))
    for s in range(3):
        t += 500  # the live check between two steps
        clock[s + 1, 0] = t
        for i in range(n):
            t += durations[s, i]
            clock[s + 1, i + 1] = t
    out = phase_ms(torch.from_numpy(clock), 3)
    assert list(out) == ["init", *PHASES, "total"]
    assert out["init"] == 0.04
    for i, name in enumerate(PHASES):
        assert out[name] == pytest.approx(durations[:, i].sum() / 1e6,
                                          rel=1e-12)
    assert out["total"] == pytest.approx((t - 1_000) / 1e6, rel=1e-12)
    with pytest.raises(ValueError):
        phase_ms(torch.from_numpy(clock), 6)  # more steps than rows
