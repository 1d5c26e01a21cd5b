"""bert_tokenize_host_ms: the program's ``bert_tokenize`` spans (the
embedder's host string work and padded arrays, on the thread that
stages the next batch), ms a ``train_step``."""

from ._spans import ms_per


def read(reading):
    return ms_per(reading, ("bert_tokenize",), ("train_step",))
