"""Beam-search caption generation (port of ``icd_tpu/decoding/beam.py:35-303``;
reference: gen_captions.py:16-131).

The JAX package runs one fixed-shape ``lax.while_loop`` per image and
``vmap``s it over the batch. Here the batch is written out: every state
tensor has a leading (B,) images axis and a (k,) slots axis, and one
Python loop steps all images together. A step reads no value on the
host and writes the state in place (``_step``), so that on the card it
is one replay of a CUDA graph (``_StepGraph``); the loop's check that an
image still runs stays on the host between replays. Semantics are the
JAX package's, to the token:

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

import functools
import weakref

import numpy as np
import torch

from ..models import attention as attention_model
from ..models.attention import decode_step, init_hidden_state
from ..ops.fused_attention import fused_attention
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


class _State:
    """A search's inputs and state in buffers that ``_step`` updates in
    place, so that a CUDA graph of the step reads and writes them where
    it was captured. ``inputs`` are the step's grid tensors: ``enc`` and
    ``att_enc``, or with ``int8_grid`` their int8 forms and scales
    (``enc_q``, ``enc_s``, ``att_q``, ``att_s``), here as templates of
    the buffers; ``dtype`` is the grid's."""

    def __init__(self, inputs, h0, c0, k, n_rows, dtype):
        b, dev = h0.shape[0], h0.device
        p = next(iter(inputs.values())).shape[1]
        long = dict(dtype=torch.long, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        self.inputs = {name: torch.empty_like(t) for name, t in inputs.items()}
        self.k, self.dtype = k, dtype
        self.slot_ids = torch.arange(k, **long)
        self.image_ids = torch.arange(b, **long)
        self.step = torch.empty((1,), **long)  # the step being decoded
        self.h = h0.new_empty((b, k, h0.shape[-1]))
        self.c = c0.new_empty((b, k, c0.shape[-1]))
        self.seqs = torch.empty((b, k, n_rows), **long)
        self.k_active = torch.empty((b,), **long)
        self.prev_words = torch.empty((b, k), **long)
        self.cum_scores = torch.empty((b, k), **f32)
        # alpha_hist[s, i, j]: attention emitted at step s by the beam
        # packed into slot j of image i; parent_hist[s, i, j]: its slot at
        # step s-1.
        self.alpha_hist = torch.empty((n_rows, b, k, p), **f32)
        self.parent_hist = torch.empty((n_rows, b, k), **long)
        self.best_score = torch.empty((b,), **f32)
        self.best_seq = torch.empty((b, n_rows), **long)
        self.best_step = torch.empty((b,), **long)
        self.best_parent = torch.empty((b,), **long)
        self.best_last_alpha = torch.empty((b, p), **f32)
        self.best_len = torch.empty((b,), **long)
        self.found = torch.empty((b,), dtype=torch.bool, device=dev)

    def reset(self, inputs, h0, c0, start_id, end_id):
        """The search's inputs, and the state before step 1, whatever a
        previous search left."""
        for name, t in inputs.items():
            self.inputs[name].copy_(t)
        self.step.fill_(1)
        self.h.copy_(h0[:, None].expand_as(self.h))
        self.c.copy_(c0[:, None].expand_as(self.c))
        self.seqs.fill_(end_id)
        self.seqs[:, :, 0] = start_id
        self.k_active.fill_(self.k)
        self.prev_words.fill_(start_id)
        self.cum_scores.zero_()
        self.alpha_hist.zero_()
        self.parent_hist.zero_()
        self.best_score.fill_(NEG_INF)
        self.best_seq.copy_(self.seqs[:, 0])
        self.best_step.fill_(1)
        self.best_parent.zero_()
        self.best_last_alpha.fill_(1.0)
        self.best_len.fill_(2)
        self.found.zero_()


def _step(decoder, st, end_id):
    """One decode step of every image, written into ``st`` in place. It
    reads no value on the host: the step number is the device tensor
    ``st.step``, which the step advances, and step 1 expands slot 0
    alone through a mask on it (beam.py:149-153). An image whose
    ``k_active`` is 0 keeps its state."""
    b, k = st.k_active.shape[0], st.k
    slot_ids, image_ids = st.slot_ids, st.image_ids
    vocab_size = decoder.vocab_size
    running = st.k_active > 0
    emb = decoder.embedding(st.prev_words)  # (B, k, E)
    if "enc_q" in st.inputs:
        x = st.inputs
        enc_t = (x["enc_q"].float() * x["enc_s"]).to(st.dtype)
        att_t = (x["att_q"].float() * x["att_s"]).to(st.dtype)
    else:
        enc_t, att_t = st.inputs["enc"], st.inputs["att_enc"]
    p = enc_t.shape[1]
    new_h, new_c, logits, alpha = decode_step(
        decoder, enc_t, att_t, emb.reshape(b * k, -1),
        st.h.reshape(b * k, -1), st.c.reshape(b * k, -1), rows_per_image=k)
    new_h = new_h.view(b, k, -1)
    new_c = new_c.view(b, k, -1)
    alpha = alpha.view(b, k, p)
    logprobs = torch.log_softmax(logits.float(), dim=-1).view(b, k, -1)
    cand = st.cum_scores[:, :, None] + logprobs  # (B, k, V)
    # Only the first k_active selections of a step are valid (:159-161);
    # at step 1 k_active is k.
    sel_valid = slot_ids[None] < st.k_active[:, None]
    row_ok = sel_valid & ((slot_ids == 0) | (st.step > 1))
    cand = torch.where(row_ok[:, :, None], cand, NEG_INF)

    top_scores, top_idx = _top_k(cand.view(b, k * vocab_size), k)
    prev_idx = top_idx // vocab_size
    next_words = top_idx % vocab_size

    sel_seqs = _rows(st.seqs, prev_idx)
    sel_seqs.index_copy_(2, st.step, next_words[:, :, None])
    sel_scores = torch.where(sel_valid, top_scores, NEG_INF)
    finishing = sel_valid & (next_words == end_id)

    # Running best (beam.py:171-187); argmax takes the first maximum.
    comp_scores = torch.where(finishing, sel_scores, NEG_INF)
    comp_best = comp_scores.argmax(dim=1)
    comp_score = comp_scores[image_ids, comp_best]
    comp_parent = prev_idx[image_ids, comp_best]
    better = running & (comp_score > st.best_score)
    st.best_score.copy_(torch.where(better, comp_score, st.best_score))
    st.best_seq.copy_(torch.where(better[:, None],
                                  sel_seqs[image_ids, comp_best], st.best_seq))
    st.best_step.copy_(torch.where(better, st.step, st.best_step))
    st.best_parent.copy_(torch.where(better, comp_parent, st.best_parent))
    st.best_last_alpha.copy_(torch.where(
        better[:, None], alpha[image_ids, comp_parent], st.best_last_alpha))
    st.best_len.copy_(torch.where(better, st.step + 1, st.best_len))
    st.found |= running & finishing.any(dim=1)

    # Pack survivors into the leading slots in top-k rank order
    # (beam.py:189-198); the keys are unique, so the sort is exact.
    survivor = sel_valid & ~finishing
    order = torch.argsort(
        torch.where(survivor, slot_ids, k + slot_ids), dim=1)
    sel_parents = prev_idx.gather(1, order)
    for hist, new in ((st.alpha_hist, _rows(alpha, sel_parents)),
                      (st.parent_hist, sel_parents)):
        old = hist.index_select(0, st.step)[0]
        hist.index_copy_(0, st.step, _where_running(running, new, old)[None])

    st.k_active.copy_(_where_running(running, survivor.sum(dim=1),
                                     st.k_active))
    st.prev_words.copy_(_where_running(running, next_words.gather(1, order),
                                       st.prev_words))
    st.cum_scores.copy_(_where_running(running, sel_scores.gather(1, order),
                                       st.cum_scores))
    st.seqs.copy_(_where_running(running, _rows(sel_seqs, order), st.seqs))
    st.h.copy_(_where_running(running, _rows(new_h, sel_parents), st.h))
    st.c.copy_(_where_running(running, _rows(new_c, sel_parents), st.c))
    st.step += 1


class _StepGraph:
    """``_step`` over one ``_State`` as a CUDA graph. The first call runs
    the step eagerly on a side stream, which readies that stream's cuBLAS
    state, and then captures the step into the graph's own memory pool;
    every later call replays it (a span ``beam_replay`` under a
    profiler). ``k1`` is K1's launches in one step, added to its count
    at each replay."""

    def __init__(self, state):
        self.state, self.graph, self.k1 = state, None, 0

    def __call__(self, decoder, end_id):
        if self.graph is not None:
            with annotate("beam_replay"):
                self.graph.replay()
            fused_attention.launches += self.k1
            return
        dev = self.state.step.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            _step(decoder, self.state, end_id)
            launches = fused_attention.launches
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                _step(decoder, self.state, end_id)
            finally:
                graph.capture_end()
                self.k1 = fused_attention.launches - launches
                fused_attention.launches = launches
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.graph = graph


# decoder -> {key: _StepGraph}: an entry goes with its decoder.
_GRAPHS = weakref.WeakKeyDictionary()


def _step_graph(decoder, inputs, h0, c0, k, max_steps, start_id, end_id,
                dtype):
    """The decoder's step graph for these shapes, made on first use. The
    key holds all the captured launches depend on: the shapes and ids,
    the device, the attention function ``decode_step`` calls (K1, or its
    plain version where a comparison swaps it in) and the addresses of
    the decoder's weights."""
    b, p, d = h0.shape[0], *next(iter(inputs.values())).shape[1:]
    key = (b, k, p, d, dtype, "enc_q" in inputs, max_steps, start_id,
           end_id, h0.device, attention_model.fused_attention,
           tuple(t.data_ptr() for t in decoder.parameters()))
    graphs = _GRAPHS.setdefault(decoder, {})
    if key not in graphs:
        graphs[key] = _StepGraph(
            _State(inputs, h0, c0, k, max_steps + 1, dtype))
    return graphs[key]


@torch.no_grad()
def beam_search_batched(decoder, encoder_grids, beam_size, start_id, end_id,
                        max_steps=MAX_STEPS, int8_grid=False):
    """Beam-search decode a batch of (B, gh, gw, D) or (B, P, D) grids
    (beam.py:50 and :251).

    The grids and the decoder are used at their own dtype and device.
    ``int8_grid`` keeps the grid and its attention projection as
    per-image symmetric int8 and dequantizes both inside each step as
    ``(q.float() * s).to(grid dtype)`` (beam.py:84-86, :132-141); h0 and
    c0 come from the float grid, as there. On CUDA tensors each step is
    one replay of a CUDA graph of the step (``_StepGraph``), kept beside
    the decoder for each shape and captured at its first search; the
    host check between steps stays outside it. A graph's buffers serve
    one search at a time, so threads that search at once need a decoder
    each. Under a profiler each
    step's host check is a span ``beam_sync``, the rest of the step a
    ``beam_step`` (holding a ``beam_replay`` where a graph replays), and
    the backtrack a ``beam_backtrack``.
    Returns a dict of tensors on that device:
        seq: (B, max_steps + 1) best complete sequence per image,
            starting with start_id, padded with end_id.
        seq_len: (B,) true length of seq (incl. start and end).
        alphas: (B, max_steps + 1, P) f32 attention maps aligned to seq
            (row 0 is the reference's all-ones map, gen_captions.py:53).
        found: (B,) bool, the reference's Caption_End.
    and ``steps``, the number of decode steps the batch ran (an int).
    """
    return _beam_search(decoder, encoder_grids, beam_size, start_id, end_id,
                        max_steps, int8_grid, encoder_grids.is_cuda)


def _beam_search(decoder, encoder_grids, beam_size, start_id, end_id,
                 max_steps, int8_grid, captured):
    """``beam_search_batched``, its steps replayed from a CUDA graph if
    ``captured``, else run eagerly."""
    # The state is updated in place, which an inference tensor allows only
    # in inference mode.
    with torch.inference_mode():
        enc = encoder_grids.reshape(
            encoder_grids.shape[0], -1, encoder_grids.shape[-1]).contiguous()
        # One projection per image, never repeated per beam (beam.py:76-81).
        att_enc = decoder.attention.enc_att(enc)
        if int8_grid:
            enc_q, enc_s = _quantize_sym(enc)
            att_q, att_s = _quantize_sym(att_enc)
            inputs = dict(enc_q=enc_q, enc_s=enc_s, att_q=att_q, att_s=att_s)
        else:
            inputs = dict(enc=enc, att_enc=att_enc)
        h0, c0 = init_hidden_state(decoder, enc)
        if captured:
            run = _step_graph(decoder, inputs, h0, c0, beam_size, max_steps,
                              start_id, end_id, enc.dtype)
            st = run.state
        else:
            st = _State(inputs, h0, c0, beam_size, max_steps + 1, enc.dtype)
            run = functools.partial(_step, st=st)
        st.reset(inputs, h0, c0, start_id, end_id)

        step = 1
        while step <= max_steps:
            with annotate("beam_sync"):
                done = not bool((st.k_active > 0).any())
            if done:
                break
            with annotate("beam_step"):
                run(decoder, end_id=end_id)
            step += 1
    with annotate("beam_backtrack"):
        # found is cloned: no output may alias the state a graph keeps.
        return beam_outputs(st.alpha_hist, st.parent_hist, st.best_seq,
                            st.best_len, st.best_step, st.best_parent,
                            st.best_last_alpha, st.found.clone(), step - 1,
                            start_id, end_id)


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
