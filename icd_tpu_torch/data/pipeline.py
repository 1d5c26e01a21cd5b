"""Batched, padded input pipeline, host side
(copy of ``icd_tpu/data/pipeline.py:24-182, 373-412``).

Replaces the reference's ``torch.utils.data.DataLoader`` with
pad-to-batch-max collate (reference: models/baseline.py:133-149,
models/attention.py:303-323). Worker parallelism uses a thread pool
(image decode is C code that releases the GIL). ``DataLoader`` shuffles
with ``np.random.default_rng(seed).permutation``, so that for the same
seed the port and ``icd_tpu`` see the same batches in the same order.
``to_device`` ships a batch's arrays to the card from pinned memory
without blocking the host. icd_tpu's ``DeviceImageCache`` and
``device_prefetch`` are not ported, nor ``snap_eval_batch`` and
``pad_batch_to``, which keep XLA's eval shapes static: eager PyTorch
runs the last batch at its own size.

Collate semantics preserved from the reference:
 - captions are padded with the vocabulary's <pad> id to the longest
   caption in the batch (pad_sequence, baseline.py:137-139)
 - attention-driver caption_lengths are computed *after* padding so they
   are uniform per batch (attention.py:311-313) -- reproduced by
   returning the padded length for every row (``padded_lengths``).
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


class Batch(dict):
    """Dict-like batch with attribute access."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def pad_captions(captions, pad_idx, max_len=None):
    """Pad a list of 1-D int arrays to (B, T) with pad_idx."""
    if max_len is None:
        max_len = max(len(c) for c in captions)
    out = np.full((len(captions), max_len), pad_idx, dtype=np.int32)
    for i, c in enumerate(captions):
        out[i, : len(c)] = c[:max_len]
    return out


class DataLoader:
    """Shuffled, batched iterator over a COCODataset.

    Args:
        dataset: COCODataset (or anything indexable returning the same
            tuple structure).
        batch_size: Batch size.
        shuffle: Reshuffle indices every epoch.
        num_workers: Thread-pool width for parallel item loading.
        pad_idx: Padding token id.
        seed: Shuffle seed.

    The trailing partial batch is kept, as the reference's DataLoader
    keeps it (attention.py:139-149), and captions are padded to the
    batch's longest: the attention model's train CE has no
    ignore_index and runs over padded_len - 1 steps, so longer padding
    would add all-pad steps to its loss. (icd_tpu's eval pads to a
    multiple of 8 to keep XLA's shapes few; eager PyTorch has no such
    need, and the per-sample eval losses are masked.)
    """

    def __init__(self, dataset, batch_size, shuffle=True, num_workers=0,
                 pad_idx=0, seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.pad_idx = pad_idx
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _collate(self, items):
        is_val = len(items[0]) == 4
        imgs = np.stack([item[0] for item in items], axis=0)
        captions = [item[1] for item in items]
        max_len = max(len(c) for c in captions)
        caption_lengths = np.asarray([len(c) for c in captions], np.int32)
        padded = pad_captions(captions, self.pad_idx, max_len)
        batch = Batch(imgs=imgs, captions=padded,
                      caption_lengths=caption_lengths,
                      # Reference attention collate measures lengths after
                      # padding -> uniform per batch (attention.py:311-313).
                      padded_lengths=np.full(len(items), max_len, np.int32))
        if is_val:
            batch["img_paths"] = [item[2] for item in items]
            batch["all_captions"] = [item[3] for item in items]
        return batch

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = self._rng.permutation(n)
        self._epoch += 1

        batches = [order[i: i + self.batch_size]
                   for i in range(0, n, self.batch_size)]

        if self.num_workers <= 1:
            for idxs in batches:
                yield self._collate([self.dataset[int(i)] for i in idxs])
            return

        with ThreadPoolExecutor(self.num_workers) as pool:
            # Pipeline: submit the next batch's item futures while the
            # current batch is being consumed downstream.
            pending = []
            DEPTH = 2
            bi = 0
            while bi < len(batches) or pending:
                while bi < len(batches) and len(pending) < DEPTH:
                    idxs = batches[bi]
                    pending.append(
                        [pool.submit(self.dataset.__getitem__, int(i))
                         for i in idxs])
                    bi += 1
                futs = pending.pop(0)
                yield self._collate([f.result() for f in futs])


def eval_workers():
    """Loader thread-pool width for the eval drivers.

    The reference evaluates at batch 1 with no loader workers
    (models/baseline.py:267-374), so there is no flag to mirror; the
    host image decode is the measured bottleneck of the batched eval
    loop on few-core hosts, so the
    width follows the core count (min 2 keeps decode overlapped with
    the device step even on a 1-core container; capped at 32 — the
    DEPTH=2 loader pipeline can only keep ~2 batches of item futures
    outstanding, so a 128-thread pool on a many-core host is pure
    overhead). ICD_TPU_EVAL_WORKERS overrides; a malformed value falls
    back to the default."""
    import os

    env = os.environ.get("ICD_TPU_EVAL_WORKERS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return min(32, max(2, os.cpu_count() or 1))


def host_prefetch(iterator, size=2):
    """Run ``iterator`` on a background thread, queueing its items.

    Generic producer/consumer overlap with the same abandonment-safe
    drain protocol as icd_tpu's device_prefetch: a consumer that stops
    early unblocks the producer and empties the queue. The eval loop
    ships images to the card on the producer thread and keeps captions
    on the host for the reference-protocol cleanup."""
    q = queue.Queue(maxsize=size)
    _SENTINEL = object()
    stop = threading.Event()

    def producer():
        try:
            for item in iterator:
                if stop.is_set():
                    break
                q.put(item)
            q.put(_SENTINEL)
        except BaseException as exc:  # propagate to the consumer
            q.put(exc)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while thread.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                thread.join(0.01)


def to_device(array, device):
    """A numpy array as a tensor on ``device``; to the card through
    pinned memory with a non-blocking copy."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
