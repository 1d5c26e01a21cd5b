"""The one generator of the benchmark's inputs, driven by a traffic file
(``portbench/traffic/<name>.json``) and the run's seed.

Each use of the seed has its own stream (``stream``), so that adding a
use does not move the others. What a traffic file may say:

- ``batch``, ``pool``, ``image_size``: requests are batches of uint8
  images, cycled from a pool made once in host memory;
- ``calibration``: a separate batch of that many images (BN statistics
  and int8 calibration);
- ``words``: caption word counts for training, drawn from a discrete
  log-normal law (``median``, ``sigma``, ``min``, ``max``) at fixed
  quantiles, so that every seed trains on the same multiset of lengths
  and only their order, the words and the images change.
"""

import math

import numpy as np
import torch

# What each stream of the seed is used for.
STREAMS = ("weights", "images", "calibration", "order", "words", "dropout",
           "sample", "layout", "keep")


def stream(seed, use):
    """A numpy Generator for one ``use`` of ``seed`` (any whole number
    >= 0, wider than 32 bits too)."""
    return np.random.default_rng([STREAMS.index(use), seed % 2 ** 64])


def torch_seed(seed, use):
    """A 63-bit seed for a ``torch.Generator``, for one ``use``."""
    return int(stream(seed, use).integers(0, 2 ** 63 - 1))


def images(rng, n, size):
    """``n`` uint8 (size, size, 3) images of noise (host memory)."""
    return rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def image_pool(traffic, seed):
    return images(stream(seed, "images"), traffic["pool"],
                  traffic["image_size"])


def calibration(traffic, seed):
    return images(stream(seed, "calibration"), traffic["calibration"],
                  traffic["image_size"])


def request_ids(traffic, seed, i):
    """Pool rows of request ``i``: the pool in a seeded order, cycled."""
    n, b = traffic["pool"], traffic["batch"]
    order = stream(seed, "order").permutation(n)
    start = (i * b) % n
    return np.take(order, range(start, start + b), mode="wrap")


def word_counts(words, n):
    """``n`` word counts at the quantiles (j + 0.5) / n of a discrete
    log-normal law, clipped to [min, max]: the same multiset for every
    seed."""
    z = [math.sqrt(2.0) * _erfinv(2.0 * (j + 0.5) / n - 1.0) for j in range(n)]
    counts = [round(words["median"] * math.exp(words["sigma"] * zj))
              for zj in z]
    return np.clip(np.array(counts), words["min"], words["max"])


def _erfinv(y):
    """The inverse error function, by Newton's method on math.erf."""
    x = 0.0
    for _ in range(60):
        x -= (math.erf(x) - y) / (2.0 / math.sqrt(math.pi) * math.exp(-x * x))
    return x


def train_batches(traffic, cfg, seed):
    """The training pool: ``pool // batch`` batches, each a dict of numpy
    arrays as the program's loader yields them (``imgs`` uint8,
    ``captions`` int64 padded with ``<pad>`` = 0 to the batch's longest,
    ``caption_lengths``, ``padded_lengths``, the same for every row: the
    reference measures lengths after padding). Which counts share a
    batch is fixed by the traffic file's ``layout_seed``; the run's seed
    orders the batches and draws the words and the images."""
    b, n = traffic["batch"], traffic["pool"]
    v = cfg["vocab_size"]
    start_id, end_id = v - 3, v - 2
    counts = word_counts(traffic["words"], n)
    counts = counts[stream(traffic["layout_seed"], "layout").permutation(n)]
    groups = counts.reshape(n // b, b)
    groups = groups[stream(seed, "order").permutation(n // b)]
    words_rng = stream(seed, "words")
    imgs = image_pool(traffic, seed)
    out = []
    for j, group in enumerate(groups):
        t = int(group.max()) + 2
        caps = np.zeros((b, t), dtype=np.int64)
        caps[:, 0] = start_id
        for r, c in enumerate(group):
            caps[r, 1:1 + c] = words_rng.integers(1, v - 3, c)
            caps[r, 1 + c] = end_id
        out.append({"imgs": imgs[j * b:(j + 1) * b],
                    "captions": caps,
                    "caption_lengths": (group + 2).astype(np.int64),
                    "padded_lengths": np.full(b, t, dtype=np.int64)})
    return out


def to_torch(array, device):
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)
