"""Profiling hooks (port of ``icd_tpu/utils/profiling.py``).

``annotate(name)`` is a named span (``torch.profiler.record_function``)
whenever a ``torch.profiler`` is recording in the process, whoever
started it and on whichever thread; otherwise it is one shared context
that does nothing. A profiler records another thread's spans only when
it profiles every thread (``profile_all_threads``); one that profiles
its own thread alone drops them. The spans are on the dispatching
thread, on the clock of the profiler's device trace:

- serving: ``serve_load``, ``serve_fetch``, ``serve_detok``
  (``beam_eval.caption_images``), ``serve_upload`` (the captioners'
  ``encode``), ``beam_step`` / ``beam_sync`` / ``beam_backtrack``
  and, inside a step replayed from its CUDA graph, ``beam_replay``
  (``decoding/beam.py``), ``greedy_step`` / ``greedy_sync``
  (``decoding/greedy.py``), ``k2_launch`` / ``k2_sync``
  (``ops/fused_beam.py``);
- training: ``train_wait``, ``train_step``, ``train_drain``,
  ``checkpoint`` (``training/common.py``) and inside a step
  ``train_trunk``, ``train_decoder``, ``train_backward``,
  ``train_clip``, ``train_adam``, ``train_bn`` (both families'
  ``make_train_step``);
- BERT's caption embeddings, on the thread that calls the embedder (in
  training the one that stages the next batch): ``bert_tokenize`` (the
  host string work and the padded arrays,
  ``BertCaptionEmbedder.piece_arrays``) and ``bert_forward`` (the ids'
  upload, the forward and the piece -> word sum, ``TorchBert.aligned``).

``ICD_TPU_PROFILE=/path/to/dir`` makes ``maybe_profile`` record such a
trace of every thread (the staging thread's BERT spans too), with the
card's kernels and copies when it runs on one, and write it as a Chrome
trace under ``dir/<name>/``: each training run (``train_<model_name>``)
and each ``beam_eval`` run. Unset, it does nothing.
"""

import contextlib
import os

import torch

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def maybe_profile(name="trace"):
    """Trace into ``$ICD_TPU_PROFILE/<name>/trace.json`` when the variable
    is set; print where it went."""
    target = os.environ.get("ICD_TPU_PROFILE")
    if not target:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out_dir = os.path.join(target, name)
    os.makedirs(out_dir, exist_ok=True)
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with torch.profiler.profile(activities=activities,
                                experimental_config=every_thread) as prof:
        yield
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print("Wrote profiler trace to {}".format(out_dir), flush=True)


def annotate(name):
    """A span ``name`` in the trace while a profiler records, else the
    shared no-op context. ``_profiler_enabled`` is this thread's state;
    ``_is_profiler_enabled`` is set by every profiler the process opens,
    so another thread's spans (BERT's producer) are seen too."""
    if (torch.autograd._profiler_enabled()
            or torch.autograd.profiler._is_profiler_enabled):
        return torch.profiler.record_function(name)
    return _OFF
