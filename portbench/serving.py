"""The serving cells' closed loop: one client sends a batch of images,
waits for its captions on the host, and sends the next, for the
window's seconds. A request is timed from the call to its captions on
the host. The window closes at the end of the first request that ends
after ``seconds``; the captions returned over the window's length give
``captions_per_s``, and the 95th percentile of all its requests'
times ``request_p95_ms``.

An entry gives ``call(state, rows)`` (one request on pool rows, through
the program's entry point; returns each row's served tokens) and the
``Proxy`` the program's captioner is wrapped in: it counts the steps
each call ran and, in the traced block, splits the call into its
public halves ``encode`` and ``decode``, each a span closed by a
synchronisation.
"""

import gc
import time

import numpy as np
import torch

from . import harness, traffic as gen


class Vocab:
    """Ids 1 .. V - 4 are words; 0 ``<pad>``, V - 3 ``<start>``, V - 2
    ``<end>``, V - 1 ``<unk>`` (as ``icd_tpu_torch/bench.py`` places
    them)."""

    def __init__(self, v):
        self.start, self.end = v - 3, v - 2
        self.i2w = (["<pad>"] + ["w{}".format(i) for i in range(1, v - 3)]
                    + ["<start>", "<end>", "<unk>"])
        self.w2i = {w: i for i, w in enumerate(self.i2w)}


class Proxy:
    """The program's captioner as the entry calls it: ``steps`` of each
    call, and ``last``, its last output; ``traced`` splits a call into
    spans ``encode`` and ``decode``."""

    def __init__(self, captioner, device, steps_of):
        self.captioner, self.device, self.steps_of = captioner, device, steps_of
        self.steps, self.traced, self.last = [], False, None

    def __call__(self, imgs):
        if not self.traced:
            out = self.captioner(imgs)
        else:
            from .trace import Tracer

            with Tracer.span("encode"):
                grid = self.captioner.encode(imgs)
                harness.sync(self.device)
            with Tracer.span("decode"):
                out = self.captioner.decode(grid)
                harness.sync(self.device)
        self.steps.append(self.steps_of(out))
        self.last = out
        return out


class Request:
    """One request: its times, pool rows, each row's served tokens, the
    steps its loop ran, and ``kept``: {row: what the entry keeps of the
    program's output for the check}."""

    def __init__(self, t0, t1, rows, tokens, steps, kept):
        self.t0, self.t1, self.rows = t0, t1, rows
        self.tokens, self.steps, self.kept = tokens, steps, kept


class Served:
    """State shared by the serving entries."""

    def __init__(self, cell, call, proxy, work_s, keep=None):
        self.cell, self.call, self.proxy = cell, call, proxy
        self.work_s = work_s  # work_s(steps): seconds at the peaks
        self.keep = keep  # keep(state, tokens), after a request's end
        self.requests, self.next = [], 0

    def request(self):
        rows = gen.request_ids(self.cell.traffic, self.cell.seed, self.next)
        self.next += 1
        t0 = time.perf_counter()
        tokens, t1 = self.call(self, rows)
        kept = self.keep(self, tokens) if self.keep else {}
        self.proxy.last = None
        return Request(t0, t1, rows, tokens, self.proxy.steps[-1], kept)


def warm_up(state):
    for _ in range(state.cell.traffic["warmup_requests"]):
        state.request()


def window(state, seconds):
    batch = state.cell.traffic["batch"]
    start = time.perf_counter()
    while not state.requests or state.requests[-1].t1 - start < seconds:
        state.requests.append(state.request())
    length = state.requests[-1].t1 - start
    times = [r.t1 - r.t0 for r in state.requests]
    n = len(state.requests)
    return {"seconds": length, "attempted": n, "failed": 0,
            "metrics": {"captions_per_s": n * batch / length,
                        "request_p95_ms": harness.percentile(times, 95) * 1e3},
            "counters": {"window_s": length,
                         "work_at_peak_s": sum(state.work_s(r.steps)
                                               for r in state.requests)}}


def traced(state, tracer, launches):
    """The traced block: ``trace_requests`` more requests under the
    profiler, each in a span ``request``. ``launches()`` reads the
    program's kernel counters (K1, K2)."""
    state.proxy.traced = True
    before = launches()
    steps0 = len(state.proxy.steps)
    with tracer.block():
        for _ in range(state.cell.traffic["trace_requests"]):
            with tracer.span("request"):
                state.request()
    after = launches()
    state.proxy.traced = False
    return tracer.reading({
        "k1_launches": after[0] - before[0],
        "k2_launches": after[1] - before[1],
        "traced_steps": state.proxy.steps[steps0:]})


def sample(state, tokens_wanted, most):
    """A sample, drawn from the seed, of the window's served captions
    (request, row, tokens): the longest, then others in a seeded order
    until ``tokens_wanted`` served tokens or ``most`` captions. Where
    the entry keeps rows of its requests, of those rows."""
    pool = [(i, j, toks) for i, r in enumerate(state.requests)
            for j, toks in enumerate(r.tokens)
            if toks and (state.keep is None or j in r.kept)]
    if not pool:
        return []
    longest = max(range(len(pool)), key=lambda k: len(pool[k][2]))
    order = gen.stream(state.cell.seed, "sample").permutation(len(pool))
    picked = [pool[longest]]
    total = len(pool[longest][2])
    for k in order:
        if total >= tokens_wanted or len(picked) >= most:
            break
        if k != longest:
            picked.append(pool[k])
            total += len(pool[k][2])
    return picked


def free(state):
    """Drop the program's captioner and its device memory."""
    state.proxy.captioner = None
    state.proxy = None
    state.call = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def pad(rows):
    """(N, max length) long array of ``rows`` padded with 0, and the bool
    array of the positions they fill."""
    width = max(len(r) for r in rows)
    out = np.zeros((len(rows), width), dtype=np.int64)
    filled = np.zeros((len(rows), width), dtype=bool)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
        filled[i, :len(r)] = True
    return out, filled
