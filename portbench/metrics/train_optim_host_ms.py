"""train_optim_host_ms: the program's ``train_clip``, ``train_adam`` and
``train_bn`` spans (clipping, the Adam step, the trunk's BN statistics
written back), ms a ``train_step``."""

from ._spans import ms_per

OPTIM = ("train_clip", "train_adam", "train_bn")


def read(reading):
    return ms_per(reading, OPTIM, ("train_step",))
