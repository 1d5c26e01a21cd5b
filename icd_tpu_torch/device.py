"""Device resolution and the f32 exactness switch.

Entry points take ``device=None`` and resolve it here: ``None`` means
the card. There is no silent fallback: without a CUDA device the port
raises unless the caller asked for the CPU explicitly, so a run that
meant to measure the card can never measure the host instead.
"""

import torch


def resolve_device(device=None):
    """``None`` -> cuda; raise if cuda is asked for and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "icd_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device {}".format(device))
    return device


def use_exact_f32():
    """Turn TF32 off for f32 convolutions and matmuls.

    cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits), which would make the f32 path a reduced-precision one: the
    Hopper form of the TPU's bf16 truncation of f32 matmul operands.
    Every f32 entry point of the port calls this.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def dtype_from_name(name):
    """'bf16' | 'f32' (the CLIs' --dtype values) -> torch dtype."""
    return {"bf16": torch.bfloat16, "f32": torch.float32}[name]
