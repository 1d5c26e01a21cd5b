"""The int8 encoder (icd_tpu_torch ops/quant.py, models/resnet_int8.py)
vs icd_tpu's, on the CPU.

- ``conv2d_int8`` (im2col + ``torch._int_mm``) equals a float64
  convolution of the same int8 values exactly, at every kernel size,
  stride and padding of ResNet-101, the stem's K = 7*7*3 = 147 included;
- ``quantize_resnet`` gives the JAX package's tree, bit for bit, from the
  same float weights and ``act_maxes``;
- ``calibrate_act_maxes`` agrees within rtol 1e-5 in f32: the float
  convolutions sum in another order in XLA and in MKL, so the maxes
  differ in their last bits (measured 1.0e-6);
- given the same ``act_maxes``, ``resnet_int8_forward`` is bit-equal to
  JAX's for both residual modes and both out dtypes, and the
  space-to-depth stem gives the stock stem's bits: every value before
  the last cast is an integer or one IEEE f32 operation taken in the
  same order. That is the JAX function run eagerly, as the tests call
  it; under ``jax.jit`` XLA contracts ``acc * scale + bias`` into one
  fused multiply-add, which moves some values by an ulp.

Sizes: ResNet depths (2, 2, 2), widths (4, 8, 16), 64x64 images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from icd_tpu.models import resnet_int8 as jax_int8
from icd_tpu.models.encoder import (
    encoder_attention_forward_int8 as jax_encoder_int8)
from icd_tpu.models.resnet import max_pool as jax_max_pool
from icd_tpu.models.resnet import resnet_forward as jax_resnet_forward
from icd_tpu.ops.image import normalize_imagenet as jax_normalize
from icd_tpu.ops.quant import int8_conv as jax_int8_conv
from icd_tpu_torch.models import resnet_int8
from icd_tpu_torch.models.encoder import encoder_attention_forward_int8
from icd_tpu_torch.models.resnet import (ResNet, max_pool, resnet_forward)
from icd_tpu_torch.ops.image import normalize_imagenet
from icd_tpu_torch.ops.quant import conv2d_int8, gemm_layout, int8_conv
from icd_tpu_torch.params import (qresnet_from_jax, qresnet_to_jax,
                                  resnet_from_jax)
from test_torch_params import _random_bn

DEPTHS, WIDTHS = (2, 2, 2), (4, 8, 16)


def _tree(seed=0, depths=DEPTHS, widths=WIDTHS):
    """A JAX ResNet tree (init_resnet's structure) drawn with numpy: He
    normal kernels, random BN statistics."""
    rng = np.random.default_rng(seed)

    def conv(k, cin, cout):
        w = rng.standard_normal((k, k, cin, cout)) * np.sqrt(2 / (k * k * cin))
        return w.astype(np.float32)

    def bn(c):
        return dict.fromkeys(("scale", "bias", "mean", "var"), np.zeros(c))

    tree = {"stem": {"conv": conv(7, 3, widths[0]), "bn": bn(widths[0])},
            "layers": []}
    cin = widths[0]
    for stage, (depth, width) in enumerate(zip(depths, widths)):
        blocks = []
        for b in range(depth):
            cout = 4 * width
            block = {"conv1": conv(1, cin, width), "bn1": bn(width),
                     "conv2": conv(3, width, width), "bn2": bn(width),
                     "conv3": conv(1, width, cout), "bn3": bn(cout)}
            if b == 0 and (stage > 0 or cin != cout):
                block["downsample"] = {"conv": conv(1, cin, cout),
                                       "bn": bn(cout)}
            blocks.append(block)
            cin = cout
        tree["layers"].append(blocks)
    return _random_bn(tree, rng)


def _imgs(n=2, seed=1, size=64):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                dtype=np.uint8)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + "/" + k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + "/" + str(i))
    else:
        yield prefix, tree


def _assert_trees_equal(ours, ref):
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert ours.keys() == ref.keys()
    for key, t in ours.items():
        a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        r = np.asarray(ref[key])
        assert a.dtype == r.dtype and a.shape == r.shape, key
        np.testing.assert_array_equal(a, r, err_msg=key)


@pytest.fixture(scope="module")
def calibrated():
    """The JAX tree, the port's ResNet of the same values, JAX's f32
    act_maxes on _imgs(), and both quantized trees."""
    tree = _tree()
    act_maxes = jax_int8.calibrate_act_maxes(tree, _imgs(), jnp.float32)
    net = resnet_from_jax(tree)
    return (tree, net, act_maxes, jax_int8.quantize_resnet(tree, act_maxes),
            resnet_int8.quantize_resnet(net, act_maxes))


# (B, H, W, Cin, kernel, Cout, stride, padding): the stem (K = 147), the
# 1x1 sites at stride 1, the 3x3 sites at strides 1 and 2, the 1x1
# stride-2 downsample, Cout not a multiple of 8, and a ragged image.
CONV_SHAPES = [(2, 32, 32, 3, 7, 64, 2, 3), (2, 8, 8, 64, 1, 16, 1, 0),
               (2, 8, 8, 16, 3, 16, 1, 1), (2, 15, 15, 16, 3, 16, 2, 1),
               (2, 15, 15, 64, 1, 128, 2, 0), (1, 9, 7, 8, 1, 5, 1, 0),
               (3, 5, 6, 4, 3, 12, 2, 1)]


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("layout", ["hwio", "gemm"])
def test_conv2d_int8_equals_float64_conv(shape, layout):
    b, h, w, cin, k, cout, stride, pad = shape
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin), np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (k, k, cin, cout),
                                       np.int8))
    out = conv2d_int8(x, gemm_layout(wq) if layout == "gemm" else wq,
                      stride, pad)
    ref = F.conv2d(x.double().permute(0, 3, 1, 2),
                   wq.double().permute(3, 2, 0, 1), stride=stride,
                   padding=pad).permute(0, 2, 3, 1)
    assert out.dtype == torch.int32 and out.shape == ref.shape
    assert torch.equal(out.double(), ref)


def test_int8_max_pool_matches_jax():
    x = np.random.default_rng(3).integers(-128, 128, (2, 11, 10, 5),
                                          np.int8)
    ref = np.asarray(jax_max_pool(jnp.asarray(x)))
    out = max_pool(torch.from_numpy(x))
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(), ref)


def test_dynamic_int8_conv_matches_jax():
    """resnet_forward(conv=int8_conv) against the JAX forward over
    ops.quant.int8_conv (f32). The float BN between the convolutions
    (rsqrt) rounds differently by an ulp in XLA and ATen, so the outputs
    agree to 1e-5 of their largest value; one activation quantized to
    the neighbouring int8 step would move them by ~1e-2 of it."""
    tree = _tree(1, (1, 1), (4, 8))
    x = np.array(jax_normalize(jnp.asarray(_imgs(1, size=32))))
    ref = np.asarray(jax.jit(lambda x: jax_resnet_forward(
        tree, x, conv=jax_int8_conv)[0])(jnp.asarray(x)))
    out = resnet_forward(resnet_from_jax(tree), torch.from_numpy(x),
                         conv=int8_conv)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_calibrate_act_maxes_within_rtol(calibrated):
    _, net, act_maxes, _, _ = calibrated
    ours = resnet_int8.calibrate_act_maxes(net, [_imgs()], torch.float32)
    assert ours.dtype == np.float32 and ours.shape == act_maxes.shape
    np.testing.assert_allclose(ours, act_maxes, rtol=1e-5, atol=0)


def test_quantize_resnet_tree_identical(calibrated):
    _, _, _, jax_q, ours = calibrated
    _assert_trees_equal(ours, jax_q)
    # The bridge: JAX's tree in, the port's tree out, and back.
    _assert_trees_equal(qresnet_from_jax(jax_q), jax_q)
    _assert_trees_equal(qresnet_to_jax(ours), jax_q)


def test_quantize_resnet_rejects_wrong_counts(calibrated):
    _, net, act_maxes, _, _ = calibrated
    with pytest.raises(ValueError, match="too few"):
        resnet_int8.quantize_resnet(net, act_maxes[:-1])
    with pytest.raises(ValueError, match="extra"):
        resnet_int8.quantize_resnet(net, np.append(act_maxes, 1.0))


@pytest.mark.parametrize("residual", ["int8", "bf16"])
@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
def test_resnet_int8_forward_bit_equal(calibrated, residual, out_dtype):
    _, _, _, jax_q, _ = calibrated
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[out_dtype]
    x = np.array(jax_normalize(jnp.asarray(_imgs())))
    ref = np.asarray(jax_int8.resnet_int8_forward(
        jax_q, jnp.asarray(x).astype(jdt), out_dtype=jdt,
        residual=residual)).astype(np.float32)
    # The JAX package's quantized tree fed straight into the port.
    q = qresnet_from_jax(jax_q)
    out = resnet_int8.resnet_int8_forward(
        q, torch.from_numpy(x).to(tdt), out_dtype=tdt, residual=residual)
    assert out.dtype == tdt and out.shape == (2, 4, 4, 64)
    np.testing.assert_array_equal(out.float().numpy(), ref)
    s2d = resnet_int8.resnet_int8_forward(
        q, torch.from_numpy(x).to(tdt), out_dtype=tdt, residual=residual,
        use_s2d_stem=True)
    assert torch.equal(s2d, out)


def test_int8_encoder_head_matches_jax(calibrated):
    """uint8 in, the 14x14 grid out. 32x32 images give a 2x2 map, which
    the adaptive pool copies cell by cell; larger pooling windows are
    averaged in another order in JAX (axis by axis) and ATen."""
    _, _, _, jax_q, ours = calibrated
    imgs = _imgs(2, seed=5, size=32)
    ref = jax_encoder_int8(jax_q, jnp.asarray(imgs), jnp.float32)
    out = encoder_attention_forward_int8(ours, torch.from_numpy(imgs),
                                         torch.float32)
    assert out.shape == (2, 14, 14, 64)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        normalize_imagenet(torch.from_numpy(imgs)).numpy(),
        np.asarray(jax_normalize(jnp.asarray(imgs))))


def test_resnet101_has_104_sites():
    """Every conv of a full ResNet-101 goes through ``conv=`` once, in
    the order quantize_resnet consumes: counted on the meta device."""
    with torch.device("meta"):
        net = ResNet()
        x = torch.empty(1, 224, 224, 3)
    sites = []

    def counting_conv(x, w, stride=1, padding=0):
        sites.append(tuple(w.shape))
        return F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride,
                        padding=padding).permute(0, 2, 3, 1)

    out = resnet_forward(net, x, conv=counting_conv)
    assert out.shape == (1, 7, 7, 2048)
    assert len(sites) == resnet_int8.N_SITES_RESNET101 == 104
    assert jax_int8.N_SITES_RESNET101 == 104
    assert sites[0] == (64, 3, 7, 7) and sites[-1] == (2048, 512, 1, 1)
