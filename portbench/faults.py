"""Faults planted under the timed path, for the tests and for the
limits' readings (``portbench.readings``): a token altered where it is
produced, half of the batch left out (the other half's answers in its
place, or the training mean over the rest), and a train step that
leaves its state
(the decoder's parameters, or the trunk's BN statistics) unchanged. A
serving fault wraps the program's captioner; a training fault wraps its
train step (``fault(step, program)``, ``program`` the entry's object
that holds the decoder and the trunk)."""

import torch


class _Wrapped:
    """A captioner whose ``decode`` output goes through ``change``."""

    def __init__(self, captioner, change):
        self.captioner, self.change = captioner, change

    def encode(self, imgs):
        return self.captioner.encode(imgs)

    def decode(self, grid):
        return self.change(self.captioner, grid)

    def __call__(self, imgs):
        return self.decode(self.encode(imgs))


def _alter(tokens, column):
    """The word in ``column`` of each caption replaced by the next word
    id (ids 1 .. 9 cycle, so a word stays a word)."""
    tokens = tokens.clone()
    tokens[:, column] = tokens[:, column] % 9 + 1
    return tokens


def alter_token(captioner):
    def change(cap, grid):
        out = cap.decode(grid)
        if isinstance(out, dict):
            return dict(out, seq=_alter(out["seq"], 1))
        return _alter(out, 0)
    return _Wrapped(captioner, change)


def half_batch(captioner):
    def change(cap, grid):
        half = grid.shape[0] // 2
        out = cap.decode(grid[:half])
        if isinstance(out, dict):
            return {k: torch.cat([v, v]) if torch.is_tensor(v) else v
                    for k, v in out.items()}
        return torch.cat([out, out])
    return _Wrapped(captioner, change)


def _restored(step, tensors):
    """``step``, after which ``tensors()`` hold what they held before."""
    def faulty(*args):
        saved = [t.detach().clone() for t in tensors()]
        loss = step(*args)
        with torch.no_grad():
            for t, s in zip(tensors(), saved):
                t.copy_(s)
        return loss
    return faulty


def unchanged_state(step, program):
    return _restored(step, program.decoder.parameters)


def stale_bn(step, program):
    """The trunk's BN running statistics left as they were."""
    return _restored(step, lambda: program.bn_stats().values())


def half_batch_step(step, program):
    def faulty(imgs, captions, lengths, generator, embeddings, n):
        h = imgs.shape[0] // 2
        return step(imgs[:h], captions[:h], lengths[:h], generator,
                    embeddings, h)
    return faulty


SERVING = {"alter_token": alter_token, "half_batch": half_batch}
TRAINING = {"unchanged_state": unchanged_state,
            "half_batch": half_batch_step, "stale_bn": stale_bn}
