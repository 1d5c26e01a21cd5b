"""icd_tpu_torch: the soft-attention captioner in PyTorch on an NVIDIA H100.

A port of ``icd_tpu`` (JAX on a TPU), which stays beside it as the
reference every module here is held against. The package imports
torch and numpy, never jax and nothing of ``icd_tpu``; the host
modules it needs (``pathconf``, ``vocabulary``, ``data``, ``metric``,
``eval_func``, ``compat``, ``native/imageio``) are its own copies.

Layout follows ``icd_tpu`` so each module's counterpart is found by
name. Public functions keep the JAX layouts: NHWC uint8 images in, a
(B, 14, 14, 2048) grid out, (B, P, D) at the decoder.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``device.resolve_device``); with no card they raise. Every TPU
kernel on the path is a hand-written CUDA kernel under ``csrc/`` with a
plain PyTorch version beside it, which runs only for CPU tensors. The
int8 products (an XLA product in ``icd_tpu``, not a kernel of its own)
are ``torch._int_mm`` on both devices (``ops/quant.py``).
"""
