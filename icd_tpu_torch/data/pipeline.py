"""Batched, padded input pipeline (port of ``icd_tpu/data/pipeline.py``).

Replaces the reference's ``torch.utils.data.DataLoader`` with
pad-to-batch-max collate (reference: models/baseline.py:133-149,
models/attention.py:303-323). Worker parallelism uses a thread pool
(image decode is C code that releases the GIL). ``DataLoader`` shuffles
with ``np.random.default_rng(seed).permutation``, so that for the same
seed the port and ``icd_tpu`` see the same batches in the same order.
``to_device`` ships a batch's arrays to the card from pinned memory
without blocking the host; ``device_prefetch`` does it for the next
batches on a producer thread and a side stream while the card computes.
``DeviceImageCache`` (``ICD_TPU_DEVICE_IMAGE_CACHE``) keeps each
distinct training image on the card once and gathers batches from it
by index (``cached_batches``). Not ported: ``snap_eval_batch`` and
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
        with_ids = len(items[0]) == 3  # train mode + dataset.return_ids
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
        if with_ids:
            batch["img_ids"] = [item[2] for item in items]
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


class DeviceImageCache:
    """The card-resident unique-image cache of the per-caption training
    loop (pipeline.py:183).

    One sample per caption ships every COCO image ~5 times an epoch
    (414,113 captions of 82,783 train images, reference:
    dataset.py:73-75); the cache keeps one uint8 copy of each distinct
    image in card memory and gathers the batch by index, so an image
    crosses the host -> card link once. The gathered rows are the same
    pixels in the same order, so every loss equals the direct path's.

    ``rewrite(batch)`` (a collated train batch with ``img_ids``: the
    dataset's ``return_ids``) replaces ``imgs`` by

      fresh_imgs  (k, H, W, C) uint8: the images not yet on the card
      fresh_slots (k,) int64: the buffer rows they go to
      idx         (B,) int64: each sample's buffer row

    and the step, on the compute stream and in step order, runs
    ``insert`` then ``gather``. The slots are icd_tpu's: round-robin,
    never evicting an image of the current batch; the hits and misses
    count the same. icd_tpu flattens the rows and pads the fresh rows to
    a power of two with a scratch row for XLA's tiles and static shapes;
    here the rows are (H, W, C), the fresh rows unpadded and the buffer
    ``capacity`` rows.
    """

    def __init__(self, budget_gb, img_shape, batch_size, max_images=None):
        row_bytes = int(np.prod(img_shape))
        self.capacity = max(
            int(batch_size), int(budget_gb * (1 << 30)) // row_bytes)
        if max_images is not None:
            # Never more rows than distinct images.
            self.capacity = max(int(batch_size),
                                min(self.capacity, int(max_images)))
        self.img_shape = tuple(img_shape)
        self.batch_size = int(batch_size)
        self.slot_of = {}     # img_id -> slot
        self.slot_owner = {}  # slot -> img_id (round-robin eviction)
        self.next_slot = 0
        self.hits = 0
        self.misses = 0

    def init_buffer(self, device):
        """The (capacity, H, W, C) uint8 buffer on ``device``."""
        return torch.zeros((self.capacity,) + self.img_shape,
                           dtype=torch.uint8, device=device)

    def _assign_slot(self, img_id, batch_ids):
        """Round-robin slot for a new image, skipping slots whose owner is
        in the current batch (pipeline.py:245)."""
        for _ in range(self.capacity + self.batch_size):
            slot = self.next_slot % self.capacity
            self.next_slot += 1
            owner = self.slot_owner.get(slot)
            if owner is None or owner not in batch_ids:
                if owner is not None:
                    del self.slot_of[owner]
                self.slot_of[img_id] = slot
                self.slot_owner[slot] = img_id
                return slot
        raise RuntimeError("DeviceImageCache: no evictable slot "
                           "(capacity {} < distinct images in one "
                           "batch?)".format(self.capacity))

    def rewrite(self, batch):
        """Split a collated train batch (``imgs`` + ``img_ids``) into the
        insert + gather form above."""
        ids = batch.pop("img_ids")
        imgs = batch.pop("imgs")
        batch_ids = set(ids)
        fresh_pos, fresh_slots = [], []
        for i, img_id in enumerate(ids):
            if img_id in self.slot_of:
                self.hits += 1
                continue
            fresh_pos.append(i)
            fresh_slots.append(self._assign_slot(img_id, batch_ids))
            self.misses += 1
        batch["fresh_imgs"] = np.ascontiguousarray(imgs[fresh_pos])
        batch["fresh_slots"] = np.asarray(fresh_slots, np.int64)
        batch["idx"] = np.asarray([self.slot_of[i] for i in ids], np.int64)
        return batch

    @staticmethod
    def insert(buf, fresh_slots, fresh_imgs):
        """Write the fresh rows into ``buf`` (in place)."""
        if len(fresh_slots):
            buf.index_copy_(0, fresh_slots, fresh_imgs)
        return buf

    @staticmethod
    def gather(buf, idx):
        """The batch's (B, H, W, C) images."""
        return buf.index_select(0, idx)


def device_image_cache_from_env(dataset, batch_size):
    """A ``DeviceImageCache`` from ``ICD_TPU_DEVICE_IMAGE_CACHE`` (GB; 0,
    unset or malformed: None), sized to at most the dataset's distinct
    images; it turns on the dataset's ``return_ids`` (pipeline.py:321)."""
    import os

    try:
        gb = float(os.environ.get("ICD_TPU_DEVICE_IMAGE_CACHE", "0") or 0)
    except ValueError:
        gb = 0.0
    if gb <= 0:
        return None
    dataset.return_ids = True
    shape = (dataset.img_size, dataset.img_size, 3)
    return DeviceImageCache(gb, shape, batch_size,
                            max_images=len(getattr(dataset, "img_ids",
                                                   []) or []) or None)


def cached_batches(batches, img_cache, device, rows=None, size=2):
    """The cache's counterpart of ``device_prefetch`` (pipeline.py:339):
    on the producer thread each collated batch (with ``img_ids``) is
    rewritten (``img_cache.rewrite``), ``rows(batch)`` picks the rows of
    the per-sample keys (a mesh rank's; the fresh rows stay whole, every
    rank keeps the whole buffer), and the arrays go to ``device``. Only
    the copies run ahead: the caller inserts and gathers on its stream,
    in step order, so a slot that a later batch reuses is overwritten
    after this batch's gather."""
    def gen():
        for batch in batches:
            batch = img_cache.rewrite(batch)
            if rows is not None:
                batch = rows(batch)
            yield batch

    return device_prefetch(gen(), device, size=size)


def _stage(batch, device):
    """``batch`` with its arrays and tensors on ``device``: a dict of
    the new tensors, and the list of those that were copied."""
    out, copied = Batch(), []
    for key, value in batch.items():
        if isinstance(value, np.ndarray):
            value = to_device(value, device)
            copied.append(value)
        elif isinstance(value, torch.Tensor) and value.device != device:
            value = value.to(device, non_blocking=True)
            copied.append(value)
        out[key] = value
    return out, copied


def device_prefetch(iterator, device, size=2):
    """Ship the next batches to ``device`` while the current step
    computes (pipeline.py:414): a producer thread runs ``iterator`` and
    copies each batch's numpy arrays (and tensors of another device) to
    ``device``, on the card from pinned memory on a side stream; at
    most ``size`` batches wait in the queue. Before handing a batch out,
    the consumer's current stream waits for its copies (an event), and
    each copied tensor is marked used on that stream
    (``record_stream``), so the caching allocator does not reuse its
    memory while the step still reads it. Other values pass unchanged.
    A consumer that stops early unblocks and drains the producer."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream(device) if cuda else None

    def staged():
        for batch in iterator:
            if not cuda:
                yield _stage(batch, device)[0], None, ()
                continue
            with torch.cuda.stream(side):
                out, copied = _stage(batch, device)
                event = torch.cuda.Event()
                event.record(side)
            yield out, event, copied

    for batch, event, copied in host_prefetch(staged(), size=size):
        if event is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            for t in copied:
                t.record_stream(stream)
        yield batch
