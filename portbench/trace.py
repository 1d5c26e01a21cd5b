"""The traced block: spans the benchmark puts around its calls into the
program, the program's own spans, and the device's operations, read
from one ``torch.profiler`` trace of the block.

``Tracer.block()`` profiles the host and the card around a block of the
entry's calls, inside a span ``window``; ``Tracer.span(name)`` opens a
named span (``torch.profiler.record_function``, so the trace puts it on
the clock the device's operations are on). After the block the Chrome
trace is written to ``$TMPDIR``, read, and deleted; the entry returns a
``Reading`` for the per-layer metrics' readers.
"""

import contextlib
import json
import os
import tempfile

import torch

PREFIX = "pb:"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Reading:
    """What a per-layer metric reads. Times are seconds from the traced
    window's start.

    - ``spans``: [(name, start, end)] of the benchmark's spans (prefix
      taken off) and the program's own (``train_step``);
    - ``device``: [(name, start, end)] of the device's operations in the
      window;
    - ``busy_s``, ``window_s``: the union of ``device`` and the window's
      length;
    - ``counters``: what the entry counted (launches, steps, work);
    - ``config``, ``traffic``: the cell's files.
    """

    def __init__(self, spans, device, window_s, counters):
        self.spans, self.device = spans, device
        self.window_s, self.counters = window_s, counters
        self.busy = merge([(a, b) for _, a, b in device])
        self.busy_s = sum(b - a for a, b in self.busy)
        self.config = self.traffic = None

    def spans_named(self, name):
        return [(a, b) for n, a, b in self.spans if n == name]

    def busy_within(self, start, end):
        return sum(max(0.0, min(b, end) - max(a, start))
                   for a, b in self.busy)

    def device_seconds(self, match):
        """(seconds, count) of the device operations whose name
        ``match(name)`` accepts."""
        picked = [b - a for n, a, b in self.device if match(n)]
        return sum(picked), len(picked)

    def idle_gaps(self):
        """[(start, end)] of the window with no device operation."""
        gaps, t = [], 0.0
        for a, b in self.busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.window_s:
            gaps.append((t, self.window_s))
        return gaps

    def innermost(self, t):
        """The shortest span holding time ``t`` (``window`` if none)."""
        best = None
        for n, a, b in self.spans:
            if n != "window" and a <= t <= b and (
                    best is None or b - a < best[1] - best[0]):
                best = (a, b, n)
        return "window" if best is None else best[2]

    def breakdown(self):
        """The ten device operations that took most time, and the ten
        longest idle gaps, each named by the span the host was in."""
        totals = {}
        for n, a, b in self.device:
            totals[n] = totals.get(n, 0.0) + (b - a)
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[self.innermost((a + b) / 2), b - a]
                              for a, b in gaps]}


def merge(intervals):
    """The union of [(start, end)] as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Tracer:
    def __init__(self, device):
        self.device = torch.device(device)
        self.events = None

    @staticmethod
    def span(name):
        return torch.profiler.record_function(PREFIX + name)

    @contextlib.contextmanager
    def block(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            with self.span("window"):
                yield
                if self.device.type == "cuda":
                    torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(prefix="portbench_trace_",
                                    suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)

    def reading(self, counters):
        """The block's ``Reading``."""
        spans, device = [], []
        for ev in self.events:
            if ev.get("ph") != "X":
                continue
            start = float(ev["ts"]) * 1e-6
            end = start + float(ev.get("dur", 0.0)) * 1e-6
            cat = ev.get("cat", "")
            if cat == "user_annotation":
                name = ev["name"]
                spans.append((name[len(PREFIX):] if name.startswith(PREFIX)
                              else name, start, end))
            elif cat in DEVICE_CATEGORIES:
                device.append((ev["name"], start, end))
        window = [(a, b) for n, a, b in spans if n == "window"]
        t0, t1 = window[0]
        spans = [(n, a - t0, b - t0) for n, a, b in spans]
        device = [(n, max(a, t0) - t0, min(b, t1) - t0)
                  for n, a, b in device if b > t0 and a < t1]
        return Reading(spans, device, t1 - t0, counters)
