"""Beam-search caption generation (port of ``icd_tpu/decoding/beam.py:35-303``;
reference: gen_captions.py:16-131).

The JAX package runs one fixed-shape ``lax.while_loop`` per image and
``vmap``s it over the batch. Here the batch is written out: every state
tensor has a leading (B,) images axis and a (k,) slots axis, and one
Python loop steps all images together. Semantics are the JAX package's,
to the token:

- every slot persists; retired slots carry NEG_INF and a packing sort
  keeps the live beams in the first ``k_active`` slots, in top-k rank
  order (beam.py:189-198);
- step 1 expands row 0 only (beam.py:149-153), and only the first
  ``k_active`` selections of a step are valid (:159-161);
- the flat top-k over (k * V) is in ``lax.top_k`` order: values
  descending, ties by ascending index (``_top_k``);
- completions fold into a running best, ties to the first maximum
  (beam.py:171-187);
- an image whose ``k_active`` reached 0 stops changing while the others
  go on. That is what the vmapped while loop does (its batched
  predicate selects between the old and the new state), and
  ``_where_running`` does the same here;
- the winner's alpha trail is backtracked after the loop from per-step
  rows and parent pointers (beam.py:222-240); the failure protocol is
  ``[start, end]`` with ``seq_len`` 2 (:242-246).
"""

import numpy as np
import torch

from ..models.attention import decode_step, init_hidden_state
from ..ops.quant import div
from ..utils.profiling import annotate

MAX_STEPS = 51  # reference: breaks when step > 50 (gen_captions.py:119)
NEG_INF = -1e9


def _quantize_sym(x):
    """Symmetric int8 per image over (P, D) (beam.py:39): (q, scale
    (B, 1, 1) f32)."""
    s = div(x.float().abs().amax(dim=(1, 2), keepdim=True),
            127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(x.float() / s), -127, 127)
    return q.to(torch.int8), s


def _top_k(flat, k):
    """Top k of each row in ``lax.top_k`` order (beam.py:156): values
    descending and, among equal values, indices ascending. A stable
    descending sort keeps equal values in index order; ``torch.topk``
    promises no order among ties."""
    values, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _rows(x, idx):
    """x[b, idx[b, j]] for x (B, k, ...) and idx (B, j)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _where_running(running, new, old):
    """Per image: the new state while the image runs, else the old one."""
    return torch.where(running.view((-1,) + (1,) * (new.dim() - 1)), new, old)


@torch.no_grad()
def beam_search_batched(decoder, encoder_grids, beam_size, start_id, end_id,
                        max_steps=MAX_STEPS, int8_grid=False):
    """Beam-search decode a batch of (B, gh, gw, D) or (B, P, D) grids
    (beam.py:50 and :251).

    The grids and the decoder are used at their own dtype and device.
    ``int8_grid`` keeps the grid and its attention projection as
    per-image symmetric int8 and dequantizes both inside each step as
    ``(q.float() * s).to(grid dtype)`` (beam.py:84-86, :132-141); h0 and
    c0 come from the float grid, as there. Under a profiler each step's
    host check is a span ``beam_sync``, the rest of the step a
    ``beam_step``, and the backtrack a ``beam_backtrack``.
    Returns a dict of tensors on that device:
        seq: (B, max_steps + 1) best complete sequence per image,
            starting with start_id, padded with end_id.
        seq_len: (B,) true length of seq (incl. start and end).
        alphas: (B, max_steps + 1, P) f32 attention maps aligned to seq
            (row 0 is the reference's all-ones map, gen_captions.py:53).
        found: (B,) bool, the reference's Caption_End.
    and ``steps``, the number of decode steps the batch ran (an int).
    """
    enc = encoder_grids.reshape(
        encoder_grids.shape[0], -1, encoder_grids.shape[-1]).contiguous()
    b, p, _ = enc.shape
    k = beam_size
    dev = enc.device
    vocab_size = decoder.vocab_size
    n_rows = max_steps + 1
    # One projection per image, never repeated per beam (beam.py:76-81).
    att_enc = decoder.attention.enc_att(enc)
    if int8_grid:
        enc_q, enc_s = _quantize_sym(enc)
        att_q, att_s = _quantize_sym(att_enc)
    h0, c0 = init_hidden_state(decoder, enc)
    h = h0[:, None].expand(b, k, h0.shape[-1]).contiguous()
    c = c0[:, None].expand(b, k, c0.shape[-1]).contiguous()

    long = dict(dtype=torch.long, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    slot_ids = torch.arange(k, **long)
    image_ids = torch.arange(b, **long)
    seqs = torch.full((b, k, n_rows), end_id, **long)
    seqs[:, :, 0] = start_id
    k_active = torch.full((b,), k, **long)
    prev_words = torch.full((b, k), start_id, **long)
    cum_scores = torch.zeros((b, k), **f32)
    # alpha_hist[s, i, j]: attention emitted at step s by the beam packed
    # into slot j of image i; parent_hist[s, i, j]: its slot at step s-1.
    alpha_hist = torch.zeros((n_rows, b, k, p), **f32)
    parent_hist = torch.zeros((n_rows, b, k), **long)
    best_score = torch.full((b,), NEG_INF, **f32)
    best_seq = seqs[:, 0].clone()
    best_step = torch.ones((b,), **long)
    best_parent = torch.zeros((b,), **long)
    best_last_alpha = torch.ones((b, p), **f32)
    best_len = torch.full((b,), 2, **long)
    found = torch.zeros((b,), dtype=torch.bool, device=dev)

    step = 1
    while step <= max_steps:
        with annotate("beam_sync"):
            running = k_active > 0
            done = not bool(running.any())
        if done:
            break
        with annotate("beam_step"):
            first = step == 1
            emb = decoder.embedding(prev_words)  # (B, k, E)
            if int8_grid:
                enc_t = (enc_q.float() * enc_s).to(enc.dtype)
                att_t = (att_q.float() * att_s).to(enc.dtype)
            else:
                enc_t, att_t = enc, att_enc
            new_h, new_c, logits, alpha = decode_step(
                decoder, enc_t, att_t, emb.reshape(b * k, -1),
                h.reshape(b * k, -1), c.reshape(b * k, -1), rows_per_image=k)
            new_h = new_h.view(b, k, -1)
            new_c = new_c.view(b, k, -1)
            alpha = alpha.view(b, k, p)
            logprobs = torch.log_softmax(logits.float(), dim=-1).view(b, k, -1)
            cand = cum_scores[:, :, None] + logprobs  # (B, k, V)
            if first:
                row_ok = (slot_ids == 0).expand(b, k)
            else:
                row_ok = slot_ids[None] < k_active[:, None]
            cand = torch.where(row_ok[:, :, None], cand, NEG_INF)

            top_scores, top_idx = _top_k(cand.view(b, k * vocab_size), k)
            prev_idx = top_idx // vocab_size
            next_words = top_idx % vocab_size
            n_valid = k if first else k_active[:, None]
            sel_valid = slot_ids[None] < n_valid

            sel_seqs = _rows(seqs, prev_idx)
            sel_seqs[:, :, step] = next_words
            sel_scores = torch.where(sel_valid, top_scores, NEG_INF)
            finishing = sel_valid & (next_words == end_id)

            # Running best (beam.py:171-187); argmax takes the first maximum.
            comp_scores = torch.where(finishing, sel_scores, NEG_INF)
            comp_best = comp_scores.argmax(dim=1)
            comp_score = comp_scores[image_ids, comp_best]
            comp_parent = prev_idx[image_ids, comp_best]
            better = running & (comp_score > best_score)
            best_score = torch.where(better, comp_score, best_score)
            best_seq = torch.where(better[:, None],
                                   sel_seqs[image_ids, comp_best], best_seq)
            best_step = torch.where(better, step, best_step)
            best_parent = torch.where(better, comp_parent, best_parent)
            best_last_alpha = torch.where(
                better[:, None], alpha[image_ids, comp_parent],
                best_last_alpha)
            best_len = torch.where(better, step + 1, best_len)
            found = found | (running & finishing.any(dim=1))

            # Pack survivors into the leading slots in top-k rank order
            # (beam.py:189-198); the keys are unique, so the sort is exact.
            survivor = sel_valid & ~finishing
            order = torch.argsort(
                torch.where(survivor, slot_ids, k + slot_ids), dim=1)
            sel_parents = prev_idx.gather(1, order)
            alpha_hist[step] = _where_running(
                running, _rows(alpha, sel_parents), alpha_hist[step])
            parent_hist[step] = _where_running(
                running, sel_parents, parent_hist[step])

            k_active = _where_running(running, survivor.sum(dim=1), k_active)
            prev_words = _where_running(running, next_words.gather(1, order),
                                        prev_words)
            cum_scores = _where_running(running, sel_scores.gather(1, order),
                                        cum_scores)
            seqs = _where_running(running, _rows(sel_seqs, order), seqs)
            h = _where_running(running, _rows(new_h, sel_parents), h)
            c = _where_running(running, _rows(new_c, sel_parents), c)
            step += 1
    with annotate("beam_backtrack"):
        return beam_outputs(alpha_hist, parent_hist, best_seq, best_len,
                            best_step, best_parent, best_last_alpha, found,
                            step - 1, start_id, end_id)


def beam_outputs(alpha_hist, parent_hist, best_seq, best_len, best_step,
                 best_parent, best_last_alpha, found, steps, start_id,
                 end_id):
    """The result dict from a beam search's history and running best.

    ``alpha_hist[s, i, j]`` is the attention emitted at step s by the beam
    packed into slot j of image i, and ``parent_hist[s, i, j]`` its slot at
    step s-1, for s = 1..steps. The winner's alpha trail is backtracked
    (beam.py:222-240): rows at or beyond ``best_step`` are replaced by
    ``best_last_alpha``, and no image's best_step exceeds the steps run,
    so the walk starts at the last step run. Then the failure protocol:
    ``[start, end]`` with seq_len 2 (:242-246; gen_captions.py:123-126).
    """
    b, p = best_last_alpha.shape
    n_rows = best_seq.shape[1]
    dev = best_seq.device
    image_ids = torch.arange(b, device=dev)
    alphas = torch.zeros((b, n_rows, p), dtype=torch.float32, device=dev)
    alphas[:, 0] = 1.0
    slot = best_parent
    for s in range(steps, 0, -1):
        use = s < best_step
        row = alpha_hist[s, image_ids, slot]
        alphas[:, s] = torch.where(use[:, None], row, 0.0)
        slot = torch.where(use, parent_hist[s, image_ids, slot], slot)
    alphas[image_ids, best_step] = best_last_alpha

    fail_seq = torch.full((n_rows,), end_id, dtype=torch.long, device=dev)
    fail_seq[0] = start_id
    seq = torch.where(found[:, None], best_seq, fail_seq)
    seq_len = torch.where(found, best_len, 2)
    return dict(seq=seq, seq_len=seq_len, alphas=alphas, found=found,
                steps=steps)


def attention_caption_image_beam_search(args, img, encoder, decoder, vocab):
    """Reference-protocol wrapper (beam.py:266; reference:
    gen_captions.py:16-131).

    Args:
        img: (1, H, W, 3) image, uint8 or float NHWC, numpy or tensor.
            uint8 input is scaled /255 WITHOUT ImageNet mean/std, the
            reference beam loader's quirk (gen_captions.py:133-143);
            float input is fed as it is. It is moved to the decoder's
            device and the encoder's dtype.

    Returns:
        (seq list, alphas list of (gh, gw) maps, Caption_End bool).
    """
    from ..models.encoder import encoder_attention_forward
    from ..ops.image import scale_only
    from ..vocabulary import END_TOKEN, START_TOKEN

    dev = decoder.fc.weight.device
    img = torch.as_tensor(np.asarray(img), device=dev)
    if img.dtype == torch.uint8:
        img = scale_only(img)
    with torch.inference_mode():
        grid = encoder_attention_forward(encoder, img)
        gh, gw = grid.shape[1], grid.shape[2]
        out = beam_search_batched(
            decoder, grid.to(decoder.fc.weight.dtype), args.beam_size,
            start_id=vocab(START_TOKEN), end_id=vocab(END_TOKEN))
    if not bool(out["found"][0]):
        return [vocab(START_TOKEN), vocab(END_TOKEN)], [], False
    n = int(out["seq_len"][0])
    seq = [int(t) for t in out["seq"][0, :n].tolist()]
    alphas = [a.reshape(gh, gw) for a in out["alphas"][0, :n].cpu().numpy()]
    return seq, alphas, True
