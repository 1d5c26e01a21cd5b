"""bert_forward_host_ms: the program's ``bert_forward`` spans (the ids'
upload, BERT's forward and the piece -> word sum issued, on the thread
that stages the next batch), ms a ``train_step``."""

from ._spans import ms_per


def read(reading):
    return ms_per(reading, ("bert_forward",), ("train_step",))
