"""Process groups laid out as the JAX package's device mesh (port of
``icd_tpu/parallel/mesh.py:24-90``).

The JAX package runs SPMD over a ``jax.sharding.Mesh`` with axes
``data`` (the batch is split over it; XLA sums the gradients of the
replicated parameters) and ``model`` (the decoder's embedding table and
output projection are split over it on the vocabulary dimension; XLA
gathers the logits at the loss). Here the mesh is ``torch.distributed``
process groups over the same layout: rank r of the first
n_data * n_model ranks sits at (r // n_model, r % n_model), as
``mesh.py:30-32`` reshapes the device list. Each rank holds the group of
its mesh column (``data_group``: the ranks that split the batch) and of
its mesh row (``model_group``: the ranks that split the vocabulary).
What XLA inserts by itself is written out where the port needs it:
train-mode BN statistics over the global batch
(``models/resnet.py:batch_norm_train``), loss normalisers over global
counts and one summed gradient bucket (``training/common.py``), and the
vocab-parallel modules of ``vocab.py``.

``init_distributed`` joins the group ``torchrun`` describes;
``run_ranks`` starts ranks of its own (the tests, the dryrun,
``chip_smoke.py``). Nothing here runs at import: no group is made until
a caller asks for one.
"""

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

# A hung collective fails its run after this long instead of hanging it.
TIMEOUT = datetime.timedelta(seconds=60)


def init_distributed(backend, device=None):
    """Join the process group that ``torchrun`` describes in the
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK)
    and return this rank's device.

    ``backend`` is explicit. "nccl": every rank has a card of its own
    and runs on cuda:LOCAL_RANK. "gloo": the ranks run on the CPU
    (``device="cpu"``) or share card 0 (``device="cuda"``). A failed
    initialisation raises; there is no other backend to try and no run
    without a group.
    """
    if backend == "nccl":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method="env://",
                                timeout=TIMEOUT, device_id=device)
        return device
    if backend != "gloo":
        raise ValueError("backend must be 'nccl' or 'gloo', not {!r}"
                         .format(backend))
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method="env://", timeout=TIMEOUT)
    return device


class Mesh:
    """``ranks`` laid out as (n_data, n_model) in JAX's device order.

    ``shape`` is {"data": n_data, "model": n_model}; ``ranks`` the
    (n_data, n_model) array of global ranks; ``device`` this rank's
    device. With a process group (every rank of the world must make
    the mesh, in the same order: ``new_group`` is collective) it also
    holds ``coords``, this rank's (data, model) position (None for a
    rank outside the mesh), and ``data_group`` and ``model_group``, the
    groups of its column and row. Without one it is the layout alone.
    """

    def __init__(self, n_data, n_model, ranks, device=None):
        ranks = [int(r) for r in ranks]
        if n_data < 1 or n_model < 1 or n_data * n_model > len(ranks):
            raise ValueError("a ({}, {}) mesh needs {} ranks; there are {}"
                             .format(n_data, n_model, n_data * n_model,
                                     len(ranks)))
        self.shape = {"data": n_data, "model": n_model}
        self.ranks = np.asarray(ranks[:n_data * n_model]).reshape(
            n_data, n_model)
        self.device = None if device is None else torch.device(device)
        self.coords = self.data_group = self.model_group = None
        if not dist.is_initialized():
            return
        me = dist.get_rank()
        for m in range(n_model):
            column = [int(r) for r in self.ranks[:, m]]
            group = dist.new_group(column, timeout=TIMEOUT)
            if me in column:
                self.data_group = group
        for d in range(n_data):
            row = [int(r) for r in self.ranks[d]]
            group = dist.new_group(row, timeout=TIMEOUT)
            if me in row:
                self.model_group = group
        where = np.argwhere(self.ranks == me)
        if len(where):
            self.coords = (int(where[0][0]), int(where[0][1]))

    def __repr__(self):
        return "Mesh(data={data}, model={model})".format(**self.shape)


def _world_ranks(ranks):
    if ranks is not None:
        return list(ranks)
    if not dist.is_initialized():
        raise RuntimeError("no process group: pass ranks, or join one "
                           "first (init_distributed, run_ranks)")
    return list(range(dist.get_world_size()))


def make_mesh(n_data, n_model=1, ranks=None, device=None):
    """A (data, model) mesh over ``ranks`` (default: every rank of the
    world), the first n_data * n_model of them (mesh.py:24)."""
    return Mesh(n_data, n_model, _world_ranks(ranks), device)


def data_ranks(batch_size, n_ranks):
    """The largest divisor of ``batch_size`` that is at most
    ``n_ranks`` (mesh.py:35-44)."""
    return next(d for d in range(n_ranks, 0, -1) if batch_size % d == 0)


def make_data_mesh(batch_size, ranks=None, device=None):
    """A data-parallel mesh over the most ranks that divide
    ``batch_size`` (mesh.py:35), as both JAX train functions build it."""
    ranks = _world_ranks(ranks)
    return Mesh(data_ranks(batch_size, len(ranks)), 1, ranks, device)


def batch_rows(mesh, n):
    """This rank's rows of a global batch of ``n``: its data shard, or
    the whole batch when ``n`` does not divide over the data ranks (the
    JAX train functions then replicate the trailing batch,
    training/attention.py:270-274)."""
    n_data = mesh.shape["data"]
    if n % n_data:
        return slice(0, n)
    per = n // n_data
    return slice(mesh.coords[0] * per, (mesh.coords[0] + 1) * per)


def batch_layout(mesh, n):
    """(this rank's rows of a batch of ``n``, the group its statistics,
    loss counts and gradients sum over). No mesh: all rows, no group.
    A replicated batch has no group either: each rank already holds
    the global batch, and summing n_data copies would count it n_data
    times."""
    if mesh is None or mesh.data_group is None or n % mesh.shape["data"]:
        return slice(0, n), None
    return batch_rows(mesh, n), mesh.data_group


def shard_batch(batch, mesh):
    """This rank's rows (``batch_rows``) of every array or tensor of a
    batch dict (or of one array); other values are kept (mesh.py:55)."""
    def rows(x):
        if getattr(x, "ndim", 0) >= 1:
            return x[batch_rows(mesh, len(x))]
        return x

    if isinstance(batch, dict):
        return type(batch)((k, rows(v)) for k, v in batch.items())
    return rows(batch)


def gather_batch(x, mesh):
    """The full batch from each data rank's rows, in data order: a list
    ``all_gather`` over the rank's data group (which gloo also serves
    for CUDA tensors). Without a group, ``x`` itself."""
    if mesh is None or mesh.data_group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.shape["data"])]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    return torch.cat(parts)


def decoder_param_specs(decoder):
    """{parameter name: its vocab dimension, or None} of a decoder, under
    the key rule of ``decoder_param_specs`` (mesh.py:68-84): a parameter
    under ``embedding``, ``linear`` or ``fc`` shards over ``model`` on
    the vocabulary. That is dim 0 of the (V, E) table, of the
    projection's bias, and of its weight, which ``nn.Linear`` stores
    (V, H) where the JAX tree stores (H, V). Others replicate."""
    specs = {}
    for name, _ in decoder.named_parameters():
        keys = name.split(".")
        specs[name] = (0 if {"embedding", "linear", "fc"} & set(keys)
                       else None)
    return specs


def _digest(tensors):
    """Three float64 sums of each tensor: plain, squared and weighted by
    position, so that a changed element shows."""
    out = []
    for t in tensors:
        x = t.detach().double().flatten()
        w = torch.arange(x.numel(), device=x.device, dtype=torch.float64)
        out += [x.sum(), x.square().sum(), (x * (w % 97 + 1)).sum()]
    return torch.stack(out) if out else torch.zeros(1, dtype=torch.float64)


def assert_replicated(tensors, what):
    """Raise unless ``tensors`` hold the same values on every rank of the
    world: their digests' minima and maxima over the ranks agree."""
    low = _digest(tensors)
    high = low.clone()
    dist.all_reduce(low, op=dist.ReduceOp.MIN)
    dist.all_reduce(high, op=dist.ReduceOp.MAX)
    if not torch.equal(low, high):
        raise RuntimeError("{} differs between ranks".format(what))


def _rank_main(fn, rank, world_size, backend, device, init_method, results,
               args):
    try:
        torch.set_num_threads(1)
        extra = {}
        if backend == "nccl":
            device = extra["device_id"] = torch.device("cuda", rank)
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=TIMEOUT,
                                **extra)
        value = fn(rank, world_size, *args)
        dist.barrier()
        results.put((rank, True, value))
    except BaseException:  # reported to the parent, which ends every rank
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size, args=(), backend="gloo", device="cpu",
              limit_s=600.0):
    """``fn(rank, world_size, *args)`` in ``world_size`` new processes,
    joined in one ``backend`` group through a file in a new temporary
    directory (no port to collide on), each with one CPU thread and
    ``device``: with "gloo" every rank's (the CPU, or one card that the
    ranks share); with "nccl" card ``rank``, a card for each rank.
    Returns their results (numpy or plain Python values) in rank order.

    The processes are spawned, never forked: the caller may hold CUDA
    state, which a fork breaks. A rank that raises or dies, or ranks
    that take longer than ``limit_s`` (a hung collective gives up after
    ``TIMEOUT``), fail the call after every rank is ended.
    """
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="icd_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, rank, world_size, backend, str(device), init, results,
            tuple(args))) for rank in range(world_size)]
        for p in procs:
            p.start()
        out, failure = {}, None
        deadline = time.monotonic() + limit_s
        try:
            while len(out) < world_size and failure is None:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [i for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:
                        failure = "rank {} died with exit code {}".format(
                            dead[0], procs[dead[0]].exitcode)
                    elif time.monotonic() > deadline:
                        failure = "ranks still running after {} s".format(
                            limit_s)
                    continue
                if ok:
                    out[rank] = value
                else:
                    failure = "rank {} failed:\n{}".format(rank, value)
        finally:
            for p in procs:
                p.join(timeout=30 if failure is None else 0.1)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [out[rank] for rank in range(world_size)]
