"""Profiling hooks (port of ``icd_tpu/utils/profiling.py``).

Set ``ICD_TPU_PROFILE=/path/to/dir`` and each training run is traced by
``torch.profiler`` (host activity, and the card's kernels and copies
when it runs on one), written as a Chrome trace under
``dir/<name>/``; ``annotate`` adds named spans (a train step, a batch's
wait, a checkpoint save). Unset, neither does anything.
"""

import contextlib
import os


@contextlib.contextmanager
def maybe_profile(name="trace"):
    """Trace into ``$ICD_TPU_PROFILE/<name>/trace.json`` when the variable
    is set; print where it went."""
    target = os.environ.get("ICD_TPU_PROFILE")
    if not target:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out_dir = os.path.join(target, name)
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print("Wrote profiler trace to {}".format(out_dir), flush=True)


def annotate(name):
    """A named span in the trace (``torch.profiler.record_function``)
    while ``ICD_TPU_PROFILE`` is set, else a context that does nothing."""
    if not os.environ.get("ICD_TPU_PROFILE"):
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)
