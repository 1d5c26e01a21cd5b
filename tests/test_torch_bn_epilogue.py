"""K3 (``ops/bn_epilogue.py``): the eval-mode BN of the float trunk with
its ReLU and residual add in one pass, equal to the bit to the eager
chain it replaces.

On the CPU: the plain version (what a CPU tensor runs) of each of the
three forms equals today's chain, written out below as the trunk has
always computed it, at bf16 activations with f32 statistics (the serving
trunk), with bf16 statistics, and in f32, at ResNet-101's channel widths
and at a width that is no multiple of the vector; ``resnet_forward`` in
eval mode returns the same tensor as the eager trunk; the wrapper raises
on what the kernel does not take; a BN's terms are prepared once per
module and compute dtype; the module imports and runs on the CPU
without a compiler; and the benchmark's reader ``bn_epilogue_ms``.

On a card (skipped without one; the file imports no jax, so on the card
``python -m pytest --noconftest -q tests/test_torch_bn_epilogue.py``):
K3 equals the plain version at every BN site of ResNet-101 at batch 64,
in every form and statistics setup, and in its scalar variant; the
bf16 and f32 encoder grids equal the eager trunk's; ``launches`` grows
by 100 an eval forward and by 0 in train mode.
"""

import os
import subprocess
import sys

import pytest
import torch

import icd_tpu_torch.models.resnet as resnet
from icd_tpu_torch.models.encoder import (EncoderAttention,
                                          encoder_attention_forward)
from icd_tpu_torch.ops import bn_epilogue as k3
from icd_tpu_torch.testing import (BN_EPILOGUE_SETUPS, bn_epilogue_case,
                                   bn_epilogue_sites, random_bn)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = (64, 128, 256, 512, 1024, 2048, 12)  # 12: not a multiple of 8
FORMS = (0, 1, 2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def eager_bn(x, bn, compute_dtype=None):
    """Eval-mode BN as ``models.resnet.batch_norm`` computed it before K3."""
    scale, bias = bn.scale, bn.bias
    if compute_dtype is not None:
        scale, bias = scale.to(compute_dtype), bias.to(compute_dtype)
    inv = torch.rsqrt(bn.var + resnet.BN_EPS) * scale
    y = (x - bn.mean) * inv + bias
    return y.to(x.dtype)


def eager_bn_relu(x, bn, compute_dtype=None, residual=None, shortcut=None):
    """The eager chain of each form, as ``_bottleneck`` ran it."""
    y = eager_bn(x, bn, compute_dtype)
    if shortcut is not None:
        s, sbn = shortcut
        residual = eager_bn(s, sbn, compute_dtype)
    if residual is not None:
        return (y + residual).relu()
    return y.relu()


def eager_resnet_forward(net, x, compute_dtype=None):
    """``resnet_forward`` in eval mode with every BN, ReLU and residual add
    the eager chain's (the trunk before K3)."""
    x = x.to(net.stem.conv.dtype if compute_dtype is None else compute_dtype)
    w = lambda p: resnet._w(p, compute_dtype)
    out = resnet.conv2d(x, w(net.stem.conv), stride=2, padding=3)
    out = eager_bn(out, net.stem.bn, compute_dtype).relu()
    out = resnet.max_pool(out)
    for blocks in net.layers:
        for b in blocks:
            h = eager_bn(resnet.conv2d(out, w(b.conv1)), b.bn1,
                         compute_dtype).relu()
            h = eager_bn(resnet.conv2d(h, w(b.conv2), stride=b.stride,
                                       padding=1), b.bn2, compute_dtype).relu()
            h = eager_bn(resnet.conv2d(h, w(b.conv3)), b.bn3, compute_dtype)
            if b.downsample is not None:
                sc = eager_bn(resnet.conv2d(out, w(b.downsample.conv),
                                            stride=b.stride),
                              b.downsample.bn, compute_dtype)
            else:
                sc = out
            out = (h + sc).relu()
    return out


def randomize_bn(net, generator):
    """Random statistics, scale and bias in every BN of ``net`` (f32)."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, resnet.BatchNorm):
                fresh, _ = random_bn(m.mean.numel(), generator, "f32")
                for name in ("mean", "var", "scale", "bias"):
                    getattr(m, name).copy_(getattr(fresh, name))
    return net


def trunk(setup, generator, depths=(2, 1, 1, 1), widths=(8, 8, 16, 16),
          device="cpu"):
    """(ResNet, compute_dtype) at a statistics ``setup`` of
    ``testing.random_bn``, its BN randomised."""
    net = randomize_bn(resnet.init_resnet(generator, depths, widths,
                                          device="cpu"),
                       generator).requires_grad_(False)
    if setup == "f32":
        return net.to(device), None
    if setup == "bf16_cast":
        return net.to(device=device, dtype=torch.bfloat16), torch.bfloat16
    return resnet.cast_keep_bn_stats(net, torch.bfloat16).to(device), \
        torch.bfloat16


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("setup", BN_EPILOGUE_SETUPS)
def test_plain_forms_equal_the_eager_chain(setup, form):
    gen = torch.Generator().manual_seed(11 + form)
    for c in WIDTHS:
        x, bn, cd, r, sc = bn_epilogue_case((2, 5, 3, c), form, gen, setup)
        got = resnet.bn_relu(x, bn, cd, residual=r, shortcut=sc)
        want = eager_bn_relu(x, bn, cd, residual=r, shortcut=sc)
        assert got.dtype == x.dtype and got.shape == x.shape
        assert torch.equal(got, want), (setup, form, c)
        terms = resnet.bn_terms(bn, cd)
        sct = None if sc is None else (sc[0], resnet.bn_terms(sc[1], cd))
        assert torch.equal(k3.bn_epilogue(x, terms, r, sct), want)


@pytest.mark.parametrize("setup", BN_EPILOGUE_SETUPS)
def test_resnet_forward_eval_equals_the_eager_trunk(setup):
    gen = torch.Generator().manual_seed(3)
    net, cd = trunk(setup, gen)
    x = torch.randn(2, 32, 32, 3, generator=gen)
    with torch.no_grad():
        got = resnet.resnet_forward(net, x, compute_dtype=cd)
        want = eager_resnet_forward(net, x, compute_dtype=cd)
    assert got.dtype == (torch.float32 if cd is None else cd)
    assert torch.equal(got, want)


def layouts(x):
    """``x`` (one image, NHWC) NCHW in memory, and as ``np_img[None]``
    makes it: contiguous, but with stride 0 on the batch."""
    nchw = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    stride0 = torch.as_tensor(x[0].cpu().numpy()[None]).to(x.device)
    assert not nchw.is_contiguous() and stride0.stride()[0] == 0
    return nchw, stride0


def test_resnet_forward_takes_an_image_in_any_layout():
    """An image whose NHWC view is not contiguous, or whose batch has
    stride 0, gives the trunk the same features: its activations are
    NHWC in memory from the input on, as K3 takes them on the card."""
    gen = torch.Generator().manual_seed(8)
    net, cd = trunk("bf16_keep", gen)
    x = torch.randn(1, 32, 32, 3, generator=gen)
    with torch.no_grad():
        want = resnet.resnet_forward(net, x, compute_dtype=cd)
        for image in layouts(x):
            got = resnet.resnet_forward(net, image, compute_dtype=cd)
            assert got.is_contiguous() and torch.equal(got, want)


def test_sites_of_resnet101():
    sites = bn_epilogue_sites(batch=1)
    forms = [f for _, f in sites]
    assert len(sites) == 100
    assert (forms.count(0), forms.count(1), forms.count(2)) == (67, 29, 4)
    assert sites[0] == ((1, 112, 112, 64), 0)
    elements = sum(torch.Size(s).numel() * (2 if f == 2 else 1)
                   for s, f in sites)
    assert elements == 16_231_936  # BN'd elements an image at 224 x 224
    assert k3.bound_ms(bn_epilogue_sites(batch=64)) == pytest.approx(
        1.4668, abs=1e-4)  # bytes over 3.35 TB/s


def test_wrapper_raises_on_what_k3_does_not_take():
    gen = torch.Generator().manual_seed(5)
    x, bn, cd, r, _ = bn_epilogue_case((2, 3, 4, 16), 1, gen, "bf16_keep")
    terms = resnet.bn_terms(bn, cd)
    with pytest.raises(ValueError, match="contiguous"):
        k3._launch(x.transpose(1, 2), terms)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k3._launch(x.half(), terms)
    with pytest.raises(TypeError, match="float32 or bfloat16 BN terms"):
        k3._launch(x, (terms[0].double(),) + terms[1:])
    with pytest.raises(ValueError, match="BN term has shape"):
        k3._launch(x, (terms[0][:8],) + terms[1:])
    with pytest.raises(ValueError, match="residual or shortcut input"):
        k3._launch(x, terms, residual=r.float())
    with pytest.raises(ValueError, match="residual or shortcut input"):
        k3._launch(x, terms, residual=r[:1])
    with pytest.raises(ValueError, match="not both"):
        k3._launch(x, terms, residual=r, shortcut=(r, terms))
    with pytest.raises(RuntimeError, match="no backward"):
        k3._launch(x, terms, residual=r.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="CUDA tensors"):
        k3._launch(x, terms, residual=r)


def test_terms_prepared_once_per_module_and_dtype():
    """``resnet.k3_terms`` checks a BN's terms once per module and compute
    dtype: the same ``Terms`` while the module's tensors stay where they
    are (values written in place included), a new one when a term moves
    or is recast, and one at each call where ``bn_terms`` casts afresh.
    A ``Terms`` is the tuple of ``bn_terms``, which the plain version
    takes as it is."""
    gen = torch.Generator().manual_seed(12)
    x, bn, cd, _, _ = bn_epilogue_case((2, 3, 4, 16), 0, gen, "bf16_keep")
    t = resnet.k3_terms(bn, cd)
    assert isinstance(t, k3.Terms) and t.channels == 16
    assert all(a is b for a, b in zip(t, resnet.bn_terms(bn, cd)))
    assert resnet.k3_terms(bn, cd) is t
    with torch.no_grad():
        bn.var.mul_(2.0)
    assert resnet.k3_terms(bn, cd) is t
    assert torch.equal(k3.bn_epilogue_reference(x, t),
                       eager_bn_relu(x, bn, cd))
    bn.scale.data = bn.scale.data.clone()
    moved = resnet.k3_terms(bn, cd)
    assert moved is not t and moved[2] is bn.scale
    assert moved.holds(*moved[:4]) and not t.holds(*moved[:4])
    assert resnet.k3_terms(bn, None) is not moved  # another compute dtype
    f32, _ = random_bn(16, gen, "f32")
    first = resnet.k3_terms(f32, torch.bfloat16)  # scale, bias cast
    assert first[2].dtype == torch.bfloat16
    assert resnet.k3_terms(f32, torch.bfloat16) is not first


def test_module_imports_and_runs_on_the_cpu_without_a_compiler():
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent",
               PYTHONPATH=ROOT)
    code = ("import torch\n"
            "from icd_tpu_torch import kernels\n"
            "import icd_tpu_torch.ops.bn_epilogue as k3\n"
            "import icd_tpu_torch.models.resnet as resnet\n"
            "from icd_tpu_torch.testing import bn_epilogue_case\n"
            "g = torch.Generator().manual_seed(0)\n"
            "x, bn, cd, r, sc = bn_epilogue_case((1, 2, 2, 8), 2, g, "
            "'bf16_keep')\n"
            "y = resnet.bn_relu(x, bn, cd, shortcut=sc)\n"
            "assert 'bn_epilogue' in kernels.KERNELS and not kernels._libs\n"
            "assert k3.bn_epilogue.launches == 0\n"
            "print(y.dtype)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "torch.bfloat16"


def test_bn_epilogue_ms_reads_k3_per_request():
    from portbench.metrics import bn_epilogue_ms
    from portbench.trace import Reading

    spans = [("window", 0.0, 1.0), ("request", 0.0, 0.4),
             ("request", 0.5, 0.9)]
    kernel = "void (anonymous namespace)::bn_epilogue<__nv_bfloat16, 0, 8>"
    device = [(kernel + "(Args)", 0.01, 0.011),
              (kernel.replace(", 0, 8", ", 2, 8") + "(Args)", 0.02, 0.023),
              ("void at::native::elementwise_kernel<128, 4>", 0.03, 0.05),
              ("bn_epilogue_like_but_not", 0.06, 0.07)]
    value = bn_epilogue_ms.read(Reading(spans, device, 1.0, {}))
    assert value == pytest.approx(2.0)  # 4 ms of K3 over 2 requests
    assert bn_epilogue_ms.read(Reading(spans, device[2:], 1.0, {})) is None
    assert bn_epilogue_ms.read(Reading(spans[:1], device, 1.0, {})) is None


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("setup", BN_EPILOGUE_SETUPS)
def test_k3_equals_plain_at_every_resnet101_site(card, setup):
    gen = torch.Generator().manual_seed(21)
    seen = set()
    with torch.inference_mode():
        for shape, form in bn_epilogue_sites(batch=64):
            if (shape, form) in seen:
                continue
            seen.add((shape, form))
            x, bn, cd, r, sc = bn_epilogue_case(shape, form, gen, setup, card)
            got = resnet.bn_relu(x, bn, cd, residual=r, shortcut=sc)
            want = eager_bn_relu(x, bn, cd, residual=r, shortcut=sc)
            assert torch.equal(got, want), (setup, shape, form)
    assert len(seen) == 16  # distinct sites (shape, form) of the 100


@pytest.mark.parametrize("setup", BN_EPILOGUE_SETUPS)
def test_k3_scalar_variant_equals_plain(card, setup):
    """A width that is no multiple of the vector, and operands off 16
    bytes, take the scalar variant."""
    gen = torch.Generator().manual_seed(22)
    with torch.inference_mode():
        for form in FORMS:
            x, bn, cd, r, sc = bn_epilogue_case((3, 7, 5, 12), form, gen,
                                                setup, card)
            want = eager_bn_relu(x, bn, cd, residual=r, shortcut=sc)
            assert torch.equal(resnet.bn_relu(x, bn, cd, r, sc), want)
            x, bn, cd, r, sc = bn_epilogue_case((2, 3, 5, 64), form, gen,
                                                setup, card)
            off = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)
            off[1:] = x.reshape(-1)
            xo = off[1:].view(x.shape)
            assert xo.data_ptr() % 16 and xo.is_contiguous()
            want = eager_bn_relu(x, bn, cd, residual=r, shortcut=sc)
            assert torch.equal(resnet.bn_relu(xo, bn, cd, r, sc), want)


@pytest.mark.parametrize("setup", BN_EPILOGUE_SETUPS)
def test_k3_inv_equals_atens(card, setup):
    """K3 computes inv = rsqrt(var + eps) * scale itself: with x = 1,
    mean = bias = 0 and f32 activations its output is inv, to the bit
    ATen's, over variances from 1e-7 to 1e7 (and at the vector width and
    the scalar variant's)."""
    gen = torch.Generator().manual_seed(23)
    with torch.inference_mode():
        for c in (2048, 12):
            _, bn, cd, _, _ = bn_epilogue_case((1, 1, 1, c), 0, gen, setup,
                                               card)
            bn.var.copy_(torch.logspace(-7, 7, c).to(bn.var.dtype))
            bn.scale.copy_(bn.scale.abs() + 0.01)
            bn.mean.zero_()
            bn.bias.zero_()
            x = torch.ones(2, 3, 1, c, device=card)
            got = resnet.bn_relu(x, bn, cd)
            scale = resnet.bn_terms(bn, cd)[2]
            inv = torch.rsqrt(bn.var + resnet.BN_EPS) * scale
            assert torch.equal(got[0, 0, 0], inv.float()), (setup, c)
            assert torch.equal(got, eager_bn_relu(x, bn, cd))


@pytest.mark.parametrize("setup", ("bf16_keep", "f32"))
def test_encoder_grid_equals_the_eager_trunk(card, setup):
    """ResNet-101's grid through K3 against the eager trunk, on the card:
    the serving trunk (bf16, f32 statistics) and the f32 one."""
    from icd_tpu_torch.device import use_exact_f32

    use_exact_f32()
    gen = torch.Generator().manual_seed(4)
    net = randomize_bn(resnet.init_resnet101(gen, device="cpu"),
                       gen).requires_grad_(False)
    cd = None if setup == "f32" else torch.bfloat16
    if cd is not None:
        net = resnet.cast_keep_bn_stats(net, cd)
    encoder = EncoderAttention(net.to(card)).eval()
    imgs = torch.randint(0, 256, (8, 224, 224, 3), generator=gen,
                         dtype=torch.uint8).to(card)
    before = k3.bn_epilogue.launches
    with torch.inference_mode():
        got = encoder_attention_forward(encoder, imgs, compute_dtype=cd)
        assert k3.bn_epilogue.launches - before == 100
        plain = resnet.bn_relu
        resnet.bn_relu = eager_bn_relu
        try:
            want = encoder_attention_forward(encoder, imgs, compute_dtype=cd)
        finally:
            resnet.bn_relu = plain
    assert k3.bn_epilogue.launches - before == 100
    assert bool(torch.isfinite(want.float()).all())
    assert torch.equal(got, want)


@pytest.mark.parametrize("setup", ("bf16_keep", "f32"))
def test_trunk_on_the_card_takes_an_image_in_any_layout(card, setup):
    """An image NCHW in memory, or with stride 0 on its batch (as
    ``gen_captions`` passes a file's image), runs the trunk through K3
    and gives the features of its contiguous copy."""
    gen = torch.Generator().manual_seed(9)
    net, cd = trunk(setup, gen, device=card)
    x = torch.rand(1, 64, 64, 3, generator=gen).to(card)
    before = k3.bn_epilogue.launches
    with torch.inference_mode():
        want = resnet.resnet_forward(net, x, compute_dtype=cd)
        for image in layouts(x):
            got = resnet.resnet_forward(net, image, compute_dtype=cd)
            assert torch.equal(got, want)
    assert k3.bn_epilogue.launches - before == 3 * 16


def test_launches_per_forward_eval_and_train(card):
    gen = torch.Generator().manual_seed(6)
    net = randomize_bn(resnet.init_resnet101(gen, device="cpu"),
                       gen).requires_grad_(False)
    net = resnet.cast_keep_bn_stats(net, torch.bfloat16).to(card)
    x = torch.randn(2, 224, 224, 3, generator=gen).to(card)
    with torch.no_grad():
        before = k3.bn_epilogue.launches
        resnet.resnet_forward(net, x, compute_dtype=torch.bfloat16)
        assert k3.bn_epilogue.launches - before == 100
        before = k3.bn_epilogue.launches
        resnet.resnet_forward(net, x, compute_dtype=torch.bfloat16,
                              train=True)
        assert k3.bn_epilogue.launches == before
