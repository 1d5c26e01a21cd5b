"""The plain reference of the benchmark's configurations: the models
written out in plain PyTorch from their published description, in
float32, with no kernel, cache or batching trick, reading a dict of
weights by name. It imports neither JAX nor anything of the measured
program; the benchmark hands it the same weights and inputs it hands
the program, and it works out the rest (BN statistics in train mode,
dropout masks, gradients, Adam's update) again.
"""

import torch


def exact_f32(tf32=False):
    """float32 products in float32 (TF32 off), or with ``tf32`` in TF32:
    the control's lower precision."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
