"""Device-side image ingest ops (port of ``icd_tpu/ops/image.py``).

The host ships uint8 NHWC images; /255 and the ImageNet normalisation
run on the device that holds them.
"""

import torch
import torch.nn.functional as F

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


def resize_bilinear(imgs, out_hw):
    """Bilinear resize of uint8 or float NHWC images to ``out_hw``
    (height, width): f32 NHWC, as ``jax.image.resize(...,
    method="bilinear")`` on the images cast to f32.

    Half-pixel centres (align_corners=False), and, where an axis
    shrinks, JAX widens the triangle kernel by the scale (antialias):
    so does ``F.interpolate(antialias=True)``. Without antialias a
    shrink misses JAX on seeded uint8 noise by up to 153 grey levels
    at 480x640 -> 224x224, 52 at 256x256 -> 224x224 and 60 at 300x200
    -> 150x333, against under 1e-3 with it (f32 sums over the taps in
    another order); an upscale is the same either way. JAX runs this
    through XLA, not Pallas, so no kernel stands behind it.
    """
    x = imgs.to(torch.float32).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).contiguous()
