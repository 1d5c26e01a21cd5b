from .image import normalize_imagenet, resize_bilinear, scale_only  # noqa: F401
