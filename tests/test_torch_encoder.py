"""icd_tpu_torch encoder vs icd_tpu's, eval mode, f32 on the CPU.

A ResNet with depths (1, 1, 1, 1) and narrow widths, random BN, on
uint8 images; ``encoder_attention_forward`` includes the ImageNet
normalisation and the adaptive pool up to 14x14 (2x2 and 3x3 grids
duplicate cells). atol 1e-4: f32 convolutions summed in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icd_tpu.models.encoder import (
    encoder_attention_forward as jax_encoder_attention_forward)
from icd_tpu.models.resnet import resnet_forward as jax_resnet_forward
from icd_tpu.ops.image import normalize_imagenet as jax_normalize
from icd_tpu.ops.image import resize_bilinear as jax_resize_bilinear
from icd_tpu.ops.image import scale_only as jax_scale_only
from icd_tpu_torch.models.encoder import encoder_attention_forward
from icd_tpu_torch.models.resnet import (cast_keep_bn_stats, init_resnet,
                                         resnet_forward)
from icd_tpu_torch.ops.image import (normalize_imagenet, resize_bilinear,
                                     scale_only)
from icd_tpu_torch.params import encoder_from_jax
from test_torch_params import small_resnet_tree


def _imgs(b, size, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (b, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("size", [64, 96])
def test_encoder_attention_forward_matches_jax(size):
    tree = {"resnet": small_resnet_tree()}
    imgs = _imgs(2, size)
    ref, _ = jax_encoder_attention_forward(tree, jnp.asarray(imgs),
                                           train=False)
    with torch.no_grad():
        out = encoder_attention_forward(encoder_from_jax(tree),
                                        torch.from_numpy(imgs))
    assert out.shape == (2, 14, 14, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_image_ops_match_jax():
    imgs = _imgs(2, 8)
    np.testing.assert_allclose(
        normalize_imagenet(torch.from_numpy(imgs)).numpy(),
        np.asarray(jax_normalize(jnp.asarray(imgs))), atol=1e-6)
    np.testing.assert_allclose(
        scale_only(torch.from_numpy(imgs)).numpy(),
        np.asarray(jax_scale_only(jnp.asarray(imgs))), atol=1e-7)


def _resize_input(hw, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    if dtype == "f32":
        x = x.astype(np.float32) + rng.random(x.shape, dtype=np.float32)
    return x


RESIZES = [((480, 640), (224, 224)), ((256, 256), (224, 224)),
           ((300, 200), (150, 333)), ((37, 53), (64, 80)),
           ((40, 56), (40, 56))]


@pytest.mark.parametrize("dtype", ["uint8", "f32"])
@pytest.mark.parametrize("in_hw,out_hw", RESIZES)
def test_resize_bilinear_matches_jax(in_hw, out_hw, dtype):
    """f32 NHWC equal to jax.image.resize's bilinear (antialiased where
    it shrinks) within 2e-3 on the 0-255 scale: f32 sums over the
    antialias taps in another order (8.9e-4 at most here)."""
    x = _resize_input(in_hw, dtype)
    out = resize_bilinear(torch.from_numpy(x), out_hw)
    assert out.dtype == torch.float32 and out.shape == (2, *out_hw, 3)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_resize_bilinear(jnp.asarray(x), out_hw)),
        rtol=0, atol=2e-3)


def test_resize_bilinear_without_antialias_would_miss_jax():
    """The trap resize_bilinear's docstring names: a shrink without
    antialias is more than 50 grey levels from JAX's."""
    x = _resize_input((480, 640), "uint8")
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(x).float().permute(0, 3, 1, 2), size=(224, 224),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(x), (224, 224)))
    assert np.abs(plain.numpy() - ref).max() > 50


def test_bf16_keeps_bn_stats_at_f32():
    """compute_dtype casts weights, not BN running stats (resnet.py:187),
    and the bf16 forward tracks the JAX bf16 forward."""
    tree = small_resnet_tree()
    net = encoder_from_jax({"resnet": tree}).resnet
    cast = cast_keep_bn_stats(net, torch.bfloat16)
    assert cast.stem.conv.dtype == torch.bfloat16
    assert cast.stem.bn.scale.dtype == torch.bfloat16
    assert cast.stem.bn.mean.dtype == torch.float32
    x = np.random.default_rng(1).standard_normal((1, 64, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        out = resnet_forward(cast, torch.from_numpy(x),
                             compute_dtype=torch.bfloat16)
    ref, _ = jax_resnet_forward(tree, jnp.asarray(x), train=False,
                                compute_dtype=jnp.bfloat16)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 0.05 * np.abs(ref).max(), err


def test_init_resnet_is_seeded():
    g = lambda: torch.Generator().manual_seed(3)
    a = init_resnet(g(), (1, 1, 1, 1), (4, 8, 8, 16), device="cpu")
    b = init_resnet(g(), (1, 1, 1, 1), (4, 8, 8, 16), device="cpu")
    for (na, pa), (nb, pb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    w = a.layers[1][0].conv2  # (8, 8, 3, 3): fan_in 72
    assert 0.8 < w.std().item() / np.sqrt(2.0 / 72) < 1.2  # He normal
