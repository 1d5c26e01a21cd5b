"""Device-side image ingest ops (port of ``icd_tpu/ops/image.py:16-40``).

The host ships uint8 NHWC images; /255 and the ImageNet normalisation
run on the device that holds them.
"""

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(imgs, dtype=torch.float32):
    """uint8/float NHWC -> normalized float NHWC.

    Matches transforms.ToTensor() + Normalize(mean, std) of the
    reference's training scripts (models/baseline.py:123-128).
    """
    x = imgs.to(dtype)
    if imgs.dtype == torch.uint8:
        x = x / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=dtype, device=imgs.device)
    std = torch.tensor(IMAGENET_STD, dtype=dtype, device=imgs.device)
    return (x - mean) / std


def scale_only(imgs, dtype=torch.float32):
    """uint8 NHWC -> [0,1] float NHWC without mean/std.

    Reproduces the reference's beam-search image loader, which divides
    by 255 but leaves the ImageNet normalization commented out
    (gen_captions.py:133-143).
    """
    x = imgs.to(dtype)
    if imgs.dtype == torch.uint8:
        x = x / 255.0
    return x
