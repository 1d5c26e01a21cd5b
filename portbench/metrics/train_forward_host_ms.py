"""train_forward_host_ms: the program's ``train_trunk`` and
``train_decoder`` spans, ms a ``train_step``: the host dispatching the
train-mode trunk and the teacher-forced decoder with its loss."""

from ._spans import ms_per


def read(reading):
    return ms_per(reading, ("train_trunk", "train_decoder"), ("train_step",))
