"""K2: a whole beam search in one launch.

Port of the TPU kernel ``icd_tpu/ops/fused_beam.py:99`` (``_kernel``,
launched by ``beam_search_fused`` at :405, ``pallas_call`` at :467). It
runs every decode step of ``decoding.beam.beam_search_batched`` inside
one kernel: the embedding lookup, K1's attention chain, the LSTM cell,
the fc logits and log-softmax, the flat top-k, completion, packing and
the permutation of the beams' state. It returns the raw per-step alphas
and parent pointers, and the winner's alpha trail is backtracked after
the launch (fused_beam.py:533-571, here ``decoding.beam.beam_outputs``).

K2's numerics are not the per-step loop's:

- h, c and the running scores stay f32 across steps; each product takes
  h rounded to the grid's dtype and sums in f32 (:174-179, :214-221);
- the attention runs in f32 from ``att_enc`` and an unrounded f32
  ``att_dec`` (:195-204); the gated context is rounded once (:215);
- the LSTM input is three products plus ``b_sum = bias_ih + bias_hh``,
  summed in the weights' dtype (:456);
- fc logits are rounded to bf16 when the grid is bf16 (:232-235).

So in bf16 it may split near-tie beams differently from the per-step
loop; in f32 both give the same tokens. The TPU kernel's ``kp = 8``
slot padding, ``chunk_images``, one-hot-matmul gathers and
``Precision.HIGHEST`` are Mosaic workarounds (:52-61, :84-90) and have
no counterpart here.

On the card this is ``csrc/fused_beam.cu``: one cooperative launch, bound
by bytes (enc and att_enc read once a step); the source says how its
design follows. The launch also returns its own clock, ns after each
grid barrier (``phase_ns``; ``phase_ms`` sums it phase by phase). ``beam_search_fused`` launches it for CUDA tensors and
raises on what it does not take; for CPU tensors it runs the plain
version, ``beam_search_fused_reference``.
"""

import ctypes

import torch

from .. import kernels
from ..decoding.beam import MAX_STEPS, NEG_INF, _rows, _top_k, beam_outputs
from ..models.attention import init_hidden_state
from ..models.lstm import gates_to_state
from ..utils.benchmarking import BF16_FLOP_PER_S, F32_FLOP_PER_S, roofline_ms
from ..utils.profiling import annotate

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BEAMS = 8
# K2's phases a step, in order, as its clock records them.
PHASES = ("A", "B1", "B2", "C", "C2", "D", "E")


def _operands(decoder, encoder_grids):
    """K2's inputs, computed outside the kernel as the TPU wrapper does
    (fused_beam.py:416-456): the grid as (B, P, D), its attention
    projection, h0 and c0 (one row per image), the summed LSTM bias in
    f32, and the decoder's weights in ``nn.Linear`` layout."""
    if encoder_grids.dtype != decoder.fc.weight.dtype:
        raise TypeError("K2: the grid is {}, the decoder {}".format(
            encoder_grids.dtype, decoder.fc.weight.dtype))
    enc = encoder_grids.reshape(
        encoder_grids.shape[0], -1, encoder_grids.shape[-1]).contiguous()
    att = decoder.attention
    lstm = decoder.lstm
    h0, c0 = init_hidden_state(decoder, enc)
    return dict(
        enc=enc, att_enc=att.enc_att(enc), h0=h0, c0=c0,
        emb=decoder.embedding.weight,
        wd=att.dec_att.weight, bd=att.dec_att.bias,
        wf=att.full_att.weight[0], bf=att.full_att.bias,
        wg=decoder.f_beta.weight, bg=decoder.f_beta.bias,
        wi=lstm.weight_ih, wh=lstm.weight_hh,
        b_sum=(lstm.bias_ih + lstm.bias_hh).float(),
        wfc=decoder.fc.weight, bfc=decoder.fc.bias)


@torch.no_grad()
def _search_plain(ops, k, start_id, end_id, max_steps, acc=torch.float32,
                  top_k=_top_k):
    """K2's loop in plain PyTorch (fused_beam.py:141-398), at K2's numerics.

    Returns what the kernel writes: raw alphas (S, B, k, P), parents
    (S, B, k), best_seq (B, S), best_len, best_step, best_parent, found
    (B,), and the steps run. As in K2, an image whose beams are all
    retired is not frozen: its rows are masked out of every later
    candidate set, and nothing after its last live step is read.

    For diagnosis only (``testing.trace_k2_splits``): ``acc`` is the type
    of the sums and state, f32 as in K2, or float64 as an arbiter of K2's
    f32 rounding (operands are still rounded to the grid's type where K2
    rounds them: h before each product, the gated context, the logits);
    ``top_k(candidates (B, k * V), k)`` makes each step's choice.
    """
    enc, att_enc = ops["enc"], ops["att_enc"]
    cd = enc.dtype
    b, p, d = enc.shape
    v, e = ops["emb"].shape
    dev = enc.device
    n_rows = max_steps + 1
    long = dict(dtype=torch.long, device=dev)
    fa = dict(dtype=acc, device=dev)
    wa = {name: ops[name].to(acc) for name in (
        "wd", "bd", "wf", "bf", "wg", "bg", "wh", "wfc", "bfc")}
    wi_emb = ops["wi"][:, :e].to(acc)
    wi_ctx = ops["wi"][:, e:].to(acc)
    enc_a, att_enc_a = enc.to(acc), att_enc.to(acc)

    def prod(x, w):  # x rounded to the grid's dtype, sums in acc
        return x.to(cd).to(acc) @ w.t()

    h = ops["h0"].to(acc).repeat_interleave(k, 0)  # (B*k, H)
    c = ops["c0"].to(acc).repeat_interleave(k, 0)
    words = torch.full((b * k,), start_id, **long)
    cum = torch.zeros((b, k), **fa)
    seqs = torch.full((b, k, n_rows), end_id, **long)
    seqs[:, :, 0] = start_id
    k_active = torch.full((b,), k, **long)
    slot_ids = torch.arange(k, **long)
    image_ids = torch.arange(b, **long)
    best_score = torch.full((b,), NEG_INF, **fa)
    best_seq = seqs[:, 0].clone()
    best_len = torch.full((b,), 2, **long)
    best_step = torch.ones((b,), **long)
    best_parent = torch.zeros((b,), **long)
    found = torch.zeros((b,), dtype=torch.bool, device=dev)
    alpha_raw = torch.zeros((n_rows, b, k, p), **fa)
    parent_hist = torch.zeros((n_rows, b, k), **long)

    step = 1
    while step <= max_steps:
        if not bool((k_active > 0).any()):
            break
        att_dec = prod(h, wa["wd"]) + wa["bd"]
        gate = torch.sigmoid(prod(h, wa["wg"]) + wa["bg"])
        act = torch.relu(att_enc_a[:, None] + att_dec.view(b, k, 1, -1))
        scores = (act * wa["wf"]).sum(-1) + wa["bf"]
        alpha = torch.softmax(scores, dim=-1)  # (B, k, P)
        ctx = (alpha @ enc_a).view(b * k, d)
        x2 = (gate * ctx).to(cd)
        gates = (ops["emb"][words].to(acc) @ wi_emb.t()
                 + x2.to(acc) @ wi_ctx.t()
                 + prod(h, wa["wh"]) + ops["b_sum"].to(acc))
        h_new, c_new = gates_to_state(gates, c)
        logits = (prod(h_new, wa["wfc"]) + wa["bfc"]).to(cd).to(acc)
        m = logits.max(dim=-1, keepdim=True).values
        lse = m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True))
        if step == 1:
            row_ok = (slot_ids == 0).expand(b, k)
        else:
            row_ok = slot_ids < k_active[:, None]
        cand = torch.where(row_ok[:, :, None],
                           (logits - lse).view(b, k, v) + cum[:, :, None],
                           NEG_INF)

        top_scores, top_idx = top_k(cand.view(b, k * v), k)
        prev, word = top_idx // v, top_idx % v
        sel_valid = slot_ids < k_active[:, None]
        sel_scores = torch.where(sel_valid, top_scores, NEG_INF)
        finishing = sel_valid & (word == end_id)

        # Running best; argmax takes the first maximum.
        comp = torch.where(finishing, sel_scores, NEG_INF)
        comp_best = comp.argmax(dim=1)
        comp_score = comp[image_ids, comp_best]
        any_fin = finishing.any(dim=1)
        better = any_fin & (comp_score > best_score)
        parent_best = prev[image_ids, comp_best]
        seq_cand = seqs[image_ids, parent_best]
        seq_cand[:, step] = word[image_ids, comp_best]
        best_seq = torch.where(better[:, None], seq_cand, best_seq)
        best_score = torch.where(better, comp_score, best_score)
        best_len = torch.where(better, step + 1, best_len)
        best_step = torch.where(better, step, best_step)
        best_parent = torch.where(better, parent_best, best_parent)
        found = found | any_fin

        # Survivors first, each group in top-k rank order (unique keys).
        survivor = sel_valid & ~finishing
        order = torch.argsort(torch.where(survivor, slot_ids, k + slot_ids),
                              dim=1)
        prev_ord = prev.gather(1, order)
        word_ord = word.gather(1, order)
        alpha_raw[step] = alpha
        parent_hist[step] = prev_ord
        rows = (image_ids[:, None] * k + prev_ord).view(-1)
        h, c = h_new[rows], c_new[rows]
        seqs = _rows(seqs, prev_ord)
        seqs[:, :, step] = word_ord
        words = word_ord.reshape(-1)
        cum = sel_scores.gather(1, order)
        k_active = survivor.sum(dim=1)
        step += 1
    return dict(alpha=alpha_raw, parent=parent_hist, best_seq=best_seq,
                best_len=best_len, best_step=best_step,
                best_parent=best_parent, found=found, steps=step - 1)


def _outputs(raw, start_id, end_id):
    """beam_search_batched's dict from K2's raw outputs. The alpha emitted
    at step s by packed slot j is ``alpha_raw[s, parent[s, j]]``."""
    steps = raw["steps"]
    alpha_raw = raw["alpha"][:steps + 1]
    parent = raw["parent"][:steps + 1].long()
    p = alpha_raw.shape[-1]
    packed = alpha_raw.gather(2, parent[..., None].expand(-1, -1, -1, p))
    found = raw["found"]
    best_step, best_parent = raw["best_step"].long(), raw["best_parent"].long()
    image_ids = torch.arange(found.shape[0], device=found.device)
    # With no caption completed, the per-step loop's best_last_alpha
    # keeps its all-ones start (fused_beam.py:558-561).
    last = torch.where(found[:, None],
                       alpha_raw[best_step, image_ids, best_parent], 1.0)
    return beam_outputs(packed, parent, raw["best_seq"].long(),
                        raw["best_len"].long(), best_step, best_parent, last,
                        found, steps, start_id, end_id)


@torch.no_grad()
def beam_search_fused_reference(decoder, encoder_grids, beam_size, start_id,
                                end_id, max_steps=MAX_STEPS):
    """Plain PyTorch version of K2 on the grids' device: the
    ``beam_search_batched`` dict (seq, seq_len, alphas, found, steps).

    Products of bf16 operands are taken as f32 products of the rounded
    values, which is exact per product; with TF32 on, f32 products on a
    card would not be, so the port turns it off in f32 mode."""
    ops = _operands(decoder, encoder_grids)
    raw = _search_plain(ops, beam_size, start_id, end_id, max_steps)
    return _outputs(raw, start_id, end_id)


@torch.no_grad()
def beam_search_fused(decoder, encoder_grids, beam_size, start_id, end_id,
                      max_steps=MAX_STEPS):
    """Beam-search decode (B, gh, gw, D) or (B, P, D) grids through K2:
    the same arguments and dict as ``decoding.beam.beam_search_batched``.

    CPU tensors take the plain version; CUDA tensors launch K2 once or
    raise. ``beam_search_fused.launches`` counts the kernel's launches.
    """
    ops = _operands(decoder, encoder_grids)
    if ops["enc"].device.type == "cpu":
        raw = _search_plain(ops, beam_size, start_id, end_id, max_steps)
    else:
        raw = _launch(ops, beam_size, start_id, end_id, max_steps)
        del raw["scratch"]  # free the workspace before the outputs are made
    return _outputs(raw, start_id, end_id)


beam_search_fused.launches = 0
# Blocks of the last launch's cooperative grid (for the record).
beam_search_fused.grid_blocks = 0


def bound_ms(ops, k, steps):
    """Least time for one K2 search of ``steps`` steps on an H100: enc and
    att_enc read once a step (no chip memory holds them at batch 64), the
    weights, h0 and c0 read once, of the embedding only the rows gathered
    (one a beam a step, at most the whole table), the raw alphas written
    once; the step's products at the peak of the grid's dtype. ``ops``
    are ``_operands``'. Returns (ms, "bytes" or "operations")."""
    enc, att_enc, emb = ops["enc"], ops["att_enc"], ops["emb"]
    b, p, d = enc.shape
    a, hd = ops["wd"].shape
    v, e = emb.shape
    rows = b * k
    per_step = sum(t.numel() * t.element_size() for t in (enc, att_enc))
    once = sum(t.numel() * t.element_size() for name, t in ops.items()
               if name not in ("enc", "att_enc", "emb"))
    gathered = min(v, rows * steps) * e * emb.element_size()
    nbytes = steps * (per_step + rows * p * 4) + once + gathered
    flops = steps * (2 * rows * hd * (a + d)  # att_dec and gate
                     + 4 * rows * p * a  # scores
                     + 2 * rows * p * d  # context
                     + 2 * rows * (e + d + hd) * 4 * hd  # LSTM gates
                     + 2 * rows * hd * v)  # fc
    return roofline_ms(nbytes, flops, BF16_FLOP_PER_S
                       if enc.element_size() == 2 else F32_FLOP_PER_S)


def _check(ops, k, start_id, end_id, max_steps):
    enc = ops["enc"]
    for name, t in ops.items():
        if t.device != enc.device:
            raise ValueError("K2: {} is on {}, enc on {}".format(
                name, t.device, enc.device))
        want = torch.float32 if name == "b_sum" else enc.dtype
        if t.dtype != want:
            raise TypeError("K2: {} is {}, expected {}".format(
                name, t.dtype, want))
        if not t.is_contiguous():
            raise ValueError("K2: {} must be contiguous".format(name))
    if enc.device.type != "cuda":
        raise ValueError("K2 runs on CUDA tensors, got {}".format(enc.device))
    if enc.dtype not in _DTYPE_CODES:
        raise TypeError("K2 takes float32 or bfloat16, got {}".format(
            enc.dtype))
    b, p, d = enc.shape
    a, hd = ops["wd"].shape
    v, e = ops["emb"].shape
    expect = dict(att_enc=(b, p, a), h0=(b, hd), c0=(b, hd), bd=(a,),
                  wf=(a,), bf=(1,), wg=(d, hd), bg=(d,),
                  wi=(4 * hd, e + d), wh=(4 * hd, hd), b_sum=(4 * hd,),
                  wfc=(v, hd), bfc=(v,))
    for name, shape in expect.items():
        if tuple(ops[name].shape) != shape:
            raise ValueError("K2: {} has shape {}, expected {}".format(
                name, tuple(ops[name].shape), shape))
    if not 1 <= k <= min(_MAX_BEAMS, v):
        raise ValueError("K2 takes 1..{} beams (and no more than the "
                         "vocabulary), got {}".format(_MAX_BEAMS, k))
    if max_steps < 1 or not (0 <= start_id < v and 0 <= end_id < v):
        raise ValueError("K2: max_steps >= 1 and token ids in [0, V)")
    if b * k * max(v, 4 * hd, d) >= 2 ** 31 or k * v >= 2 ** 31:
        raise ValueError("K2: sizes overflow its 32-bit indices")
    return b, p, d, a, hd, e, v


def phase_ms(phase_ns, steps):
    """K2's clock as milliseconds: ``init``, then each of ``PHASES``
    summed over the ``steps`` steps run, then ``total``.

    ``phase_ns`` is a launch's (max_steps + 1, len(PHASES) + 1) int64
    clock: row 0 holds the launch's start and the end of init; row s the
    start of step s, then the end of each phase of it, in ns. Rows after
    the last step run are not read.
    """
    t = torch.as_tensor(phase_ns)[:steps + 1].cpu().double()
    if t.shape[0] != steps + 1 or t.shape[1] != len(PHASES) + 1:
        raise ValueError("K2's clock has shape {}, expected ({}+, {})".format(
            tuple(phase_ns.shape), steps + 1, len(PHASES) + 1))
    per_phase = (t[1:, 1:] - t[1:, :-1]).sum(0) / 1e6
    out = {"init": float(t[0, 1] - t[0, 0]) / 1e6}
    out.update((name, float(ms)) for name, ms in zip(PHASES, per_phase))
    out["total"] = float(t[steps, -1] - t[0, 0]) / 1e6
    return out


_ARG_ORDER = ("enc", "att_enc", "h0", "c0", "emb", "wd", "bd", "wf", "bf",
              "wg", "bg", "wi", "wh", "b_sum", "wfc", "bfc")


def _launch(ops, k, start_id, end_id, max_steps):
    """One K2 search: its raw outputs, ``steps`` read back (a host sync).
    Under a profiler the launch is a span ``k2_launch`` and the read-back
    a ``k2_sync``."""
    with annotate("k2_launch"):
        raw = _start(ops, k, start_id, end_id, max_steps)
    with annotate("k2_sync"):
        raw["steps"] = int(raw["steps"].item())
    return raw


def _start(ops, k, start_id, end_id, max_steps):
    """Launch K2 on the current stream without waiting for it: the raw
    outputs, ``steps`` still a (1,) tensor on the card, and ``scratch``:
    views of the launch's workspace (``_scratch``), for diagnosis."""
    b, p, d, a, hd, e, v = _check(ops, k, start_id, end_id, max_steps)
    enc = ops["enc"]
    lib = kernels.load("fused_beam")
    code = _DTYPE_CODES[enc.dtype]
    sizes = (b, k, p, d, a, hd, e, v, max_steps)
    ws_fn = lib.icd_fused_beam_workspace
    ws_fn.argtypes = [ctypes.c_int] * 10
    ws_fn.restype = ctypes.c_size_t
    dev = enc.device
    s_len = max_steps + 1
    i32 = dict(dtype=torch.int32, device=dev)
    alpha = torch.empty((s_len, b, k, p), dtype=torch.float32, device=dev)
    parent = torch.empty((s_len, b, k), **i32)
    best_seq = torch.empty((b, s_len), **i32)
    meta = torch.empty((b, 4), **i32)
    steps = torch.empty((1,), **i32)
    phase_ns = torch.zeros((s_len, len(PHASES) + 1), dtype=torch.int64,
                           device=dev)
    workspace = torch.empty((ws_fn(*sizes, code),), dtype=torch.uint8,
                            device=dev)
    if lib.icd_fused_beam_phases() != len(PHASES):
        raise RuntimeError("K2's library records {} phases, PHASES names {}"
                           .format(lib.icd_fused_beam_phases(), len(PHASES)))
    fn = lib.icd_fused_beam
    fn.argtypes = ([ctypes.c_void_p] * 23 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    ptrs = [ops[name].data_ptr() for name in _ARG_ORDER] + [
        t.data_ptr() for t in (alpha, parent, best_seq, meta, steps,
                               phase_ns, workspace)]
    blocks = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, *sizes, start_id, end_id, code, stream,
                 ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError("K2 launch failed: CUDA error {}".format(err))
    beam_search_fused.launches += 1
    beam_search_fused.grid_blocks = blocks.value
    return dict(alpha=alpha, parent=parent, best_seq=best_seq,
                best_len=meta[:, 0], best_step=meta[:, 1],
                best_parent=meta[:, 2], found=meta[:, 3] > 0, steps=steps,
                phase_ns=phase_ns,
                scratch=_scratch(lib, workspace, sizes, code, enc.dtype))


def _scratch(lib, workspace, sizes, code, dtype):
    """What K2's last step run leaves in its workspace, as views of it
    (offsets from the library, ``icd_fused_beam_views``): ``cum`` (R,)
    f32, the running scores after that step; ``lse`` (R,) f32, each live
    row's log-sum-exp of it; ``logits`` (R, V) in the grid's dtype;
    ``words`` (R,) int32, the words it chose; ``kact`` (B,) int32, each
    image's live beams after it. Rows are in packing order; ``lse`` of a
    row that was not live at that step holds no value of it."""
    b, k, v = sizes[0], sizes[1], sizes[7]
    fn = lib.icd_fused_beam_views
    fn.argtypes = [ctypes.c_int] * 10 + [ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = None
    offsets = (ctypes.c_size_t * 5)()
    fn(*sizes, code, offsets)

    def view(i, n, t):
        return workspace[offsets[i]:offsets[i] + n * t.itemsize].view(t)

    r = b * k
    return dict(cum=view(0, r, torch.float32), lse=view(1, r, torch.float32),
                logits=view(2, r * v, dtype).view(r, v),
                words=view(3, r, torch.int32), kact=view(4, b, torch.int32))
