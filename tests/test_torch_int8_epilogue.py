"""K4 (``ops/int8_epilogue.py``): the static-int8 trunk's epilogue after
each int8 convolution (dequant affine, residual, ReLU, requantize) in one
pass, equal to the bit to the eager chain it replaces.

On the CPU: the plain version (what a CPU tensor runs) of each form
equals today's chain, written out below as the trunk has always
computed it, at ResNet-101's widths and at batch 1, 2 and 3, with s8,
bf16 and f32 output; ``resnet_int8_forward`` returns the same tensor as
the eager trunk; the wrapper runs the plain version on CPU and meta
tensors and counts nothing, and raises on what the kernel does not
take; a site's terms are prepared once; the module imports and runs on
the CPU without a compiler; and the benchmark's reader
``int8_epilogue_ms``.

On a card (skipped without one; the file imports no jax, so on the card
``python -m pytest --noconftest -q tests/test_torch_int8_epilogue.py``):
K4 equals the plain version at every site of ResNet-101 at batch 64 and
batch 3, in every form, with bf16 and f32 last-block output, in its
scalar variant, on rounding ties and on the shortcut's scale; the int8
encoders (``encoder_forward_int8``, ``encoder_attention_forward_int8``)
equal the eager trunk's; ``launches`` grows by 100 a forward.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import icd_tpu_torch.models.encoder as encoder_mod
import icd_tpu_torch.models.resnet as resnet
import icd_tpu_torch.models.resnet_int8 as resnet_int8
from icd_tpu_torch.models.encoder import (Encoder,
                                          encoder_attention_forward_int8,
                                          encoder_forward_int8, init_embed)
from icd_tpu_torch.ops import int8_epilogue as k4
from icd_tpu_torch.ops.quant import conv2d_int8
from icd_tpu_torch.testing import int8_epilogue_case, int8_epilogue_sites
from test_torch_bn_epilogue import randomize_bn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = (64, 128, 256, 512, 1024, 2048)
# (residual, s8 output): stem, conv1, conv2; identity conv3; downsample
# conv3; the last block, identity or downsample, writing floats.
FORMS = ((0, True), (1, True), (2, True), (1, False), (2, False))
OUT_DTYPES = (torch.bfloat16, torch.float32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def eager_requant(x, inv_in):
    return torch.clamp(torch.round(x.float() * inv_in), -127,
                       127).to(torch.int8)


def eager_chain(acc, terms, other=None, out_dtype=None):
    """Each form as ``resnet_int8_forward`` ran it before K4."""
    scale, bias, inv_next, in_inv, ds_scale, ds_bias = terms
    h = acc.float() * scale + bias
    if in_inv is not None:
        h = torch.relu(h + other.float() * (1.0 / in_inv))
    elif ds_scale is not None:
        h = torch.relu(h + (other.float() * ds_scale + ds_bias))
    else:
        h = torch.relu(h)
    return h.to(out_dtype) if inv_next is None else eager_requant(
        h, inv_next)


def eager_resnet_int8_forward(qparams, x, out_dtype=torch.bfloat16):
    """The int8-resident trunk as it ran before K4."""
    def conv_affine(xi, site, stride=1, padding=0):
        acc = conv2d_int8(xi, site["wq"], stride=stride, padding=padding)
        return acc.float() * site["scale"] + site["bias"]

    def qconv(h, site, stride=1, padding=0):
        return conv_affine(eager_requant(h, site["inv_in"]), site, stride,
                           padding)

    stem_out = torch.relu(qconv(x, qparams["stem"], stride=2, padding=3))
    all_blocks = [(qb, 2 if (stage > 0 and b == 0) else 1)
                  for stage, blocks in enumerate(qparams["layers"])
                  for b, qb in enumerate(blocks)]
    first = all_blocks[0][0]["conv1"]
    q = resnet.max_pool(eager_requant(stem_out, first["inv_in"]))
    in_scale = 1.0 / first["inv_in"]
    for i, (qb, stride) in enumerate(all_blocks):
        h = torch.relu(conv_affine(q, qb["conv1"]))
        h = torch.relu(qconv(h, qb["conv2"], stride=stride, padding=1))
        h = qconv(h, qb["conv3"])
        if "downsample" in qb:
            shortcut = conv_affine(q, qb["downsample"], stride=stride)
        else:
            shortcut = q.float() * in_scale
        out = torch.relu(h + shortcut)
        if i + 1 == len(all_blocks):
            return out.to(out_dtype)
        nxt = all_blocks[i + 1][0]["conv1"]
        q = eager_requant(out, nxt["inv_in"])
        in_scale = 1.0 / nxt["inv_in"]


def int8_trunk(generator, depths=(2, 1, 1, 1), widths=(16, 16, 32, 32),
               device="cpu", size=32):
    """(float ResNet, its int8 tree) on ``device``, calibrated in f32 on
    four seeded images."""
    net = randomize_bn(resnet.init_resnet(generator, depths, widths,
                                          device="cpu"),
                       generator).requires_grad_(False).to(device)
    calib = torch.randn(4, size, size, 3, generator=generator).to(device)
    maxes = resnet_int8.calibrate_act_maxes(net, calib, torch.float32)
    return net, resnet_int8.quantize_resnet(net, maxes)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", (1, 2, 3))
@pytest.mark.parametrize("residual,s8", FORMS)
def test_plain_forms_equal_the_eager_chain(residual, s8, batch):
    gen = torch.Generator().manual_seed(31 + 3 * residual + batch)
    for c in WIDTHS:
        shape = (batch, 3, 2, c)
        acc, terms, other = int8_epilogue_case(shape, residual, s8, gen)
        for out_dtype in (OUT_DTYPES if not s8 else (None,)):
            want = eager_chain(acc, terms, other, out_dtype)
            got = k4.int8_epilogue(acc, terms, other, out_dtype)
            assert got.dtype == (torch.int8 if s8 else out_dtype)
            assert got.shape == shape
            assert torch.equal(got, want), (residual, s8, c, out_dtype)
            prepared = k4.Terms(*terms)
            assert torch.equal(k4.int8_epilogue_reference(
                acc, prepared, other, out_dtype), want)
        if s8:  # the outputs reach past the clamp and stay inside it
            assert int(want.max()) == 127 and 0 < int(
                (want > 0).sum()) < want.numel()


@pytest.mark.parametrize("batch", (1, 2, 3))
def test_resnet_int8_forward_equals_the_eager_trunk(batch):
    gen = torch.Generator().manual_seed(40 + batch)
    _, q = int8_trunk(gen)
    x = torch.randn(batch, 32, 32, 3, generator=gen)
    for out_dtype in OUT_DTYPES:
        got = resnet_int8.resnet_int8_forward(q, x.to(out_dtype),
                                              out_dtype=out_dtype)
        want = eager_resnet_int8_forward(q, x.to(out_dtype), out_dtype)
        assert got.dtype == out_dtype and got.shape == (batch, 1, 1, 128)
        assert bool((want != 0).any())
        assert torch.equal(got, want)
        s2d = resnet_int8.resnet_int8_forward(
            q, x.to(out_dtype), out_dtype=out_dtype, use_s2d_stem=True)
        assert torch.equal(s2d, want)


def test_sites_of_resnet101():
    sites = int8_epilogue_sites(batch=1)
    kinds = [(r, s8) for _, r, s8 in sites]
    assert len(sites) == 100
    assert [kinds.count(f) for f in FORMS] == [67, 28, 4, 1, 0]
    assert sites[0] == ((1, 112, 112, 64), 0, True)
    assert sites[-1] == ((1, 7, 7, 2048), 1, False)
    assert all(s[-1] % 64 == 0 for s, _, _ in sites)
    assert [s for s, _, _ in int8_epilogue_sites(batch=3)] == [
        (3,) + s[1:] for s, _, _ in sites]
    elements = sum(torch.Size(s).numel() for s, _, _ in sites)
    assert elements == 14_726_656  # K4's outputs an image at 224 x 224
    # 5.58 GB at batch 64 over 3.35 TB/s
    assert k4.bound_ms(int8_epilogue_sites(batch=64)) == pytest.approx(
        1.6657, abs=1e-4)


def test_wrapper_takes_the_plain_version_off_the_card():
    """CPU and meta tensors run the plain version, and nothing counts as
    a launch."""
    gen = torch.Generator().manual_seed(5)
    before = k4.int8_epilogue.launches
    for residual, s8 in FORMS:
        acc, terms, other = int8_epilogue_case((2, 3, 4, 64), residual, s8,
                                               gen)
        out = k4.int8_epilogue(acc, terms, other, torch.bfloat16)
        assert out.device.type == "cpu"
        meta = [None if t is None else t.to("meta") for t in terms]
        out = k4.int8_epilogue(acc.to("meta"), meta, None if other is None
                               else other.to("meta"), torch.bfloat16)
        assert out.is_meta and out.shape == acc.shape
        assert out.dtype == (torch.int8 if s8 else torch.bfloat16)
    assert k4.int8_epilogue.launches == before


def test_wrapper_raises_on_what_k4_does_not_take():
    gen = torch.Generator().manual_seed(6)
    acc, terms, q = int8_epilogue_case((2, 3, 4, 64), 1, True, gen)
    scale, bias, inv, in_inv, _, _ = terms
    with pytest.raises(TypeError, match="int32 sums"):
        k4._launch(acc.long(), terms, q)
    with pytest.raises(ValueError, match="contiguous"):
        k4._launch(acc.transpose(1, 2), terms, q)
    with pytest.raises(TypeError, match="float32 terms"):
        k4._launch(acc, (scale.double(),) + terms[1:], q)
    with pytest.raises(ValueError, match="channel term has shape"):
        k4._launch(acc, (scale[:16],) + terms[1:], q)
    with pytest.raises(ValueError, match="single values"):
        k4._launch(acc, terms[:2] + (scale,) + terms[3:], q)
    with pytest.raises(ValueError, match="shortcut input"):
        k4._launch(acc, terms, None)
    with pytest.raises(ValueError, match="shortcut input"):
        k4._launch(acc, terms, q.int())
    with pytest.raises(ValueError, match="shortcut input"):
        k4._launch(acc, terms, q[:1])
    with pytest.raises(ValueError, match="no shortcut input"):
        k4._launch(acc, (scale, bias, inv, None, None, None), q)
    with pytest.raises(ValueError, match="not both"):
        k4._launch(acc, (scale, bias, inv, in_inv, scale, bias), q)
    with pytest.raises(ValueError, match="ds_scale and ds_bias"):
        k4._launch(acc, (scale, bias, inv, None, scale, None), acc)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k4._launch(acc, (scale, bias, None, in_inv, None, None), q,
                   torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k4._launch(acc, (scale, bias, None, in_inv, None, None), q)
    with pytest.raises(RuntimeError, match="no backward"):
        k4._launch(acc, (scale.clone().requires_grad_(True),) + terms[1:],
                   q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k4._launch(acc, terms, q)


def test_terms_prepared_once_per_site():
    """``resnet_int8.k4_terms`` checks a site's terms once: the same
    ``Terms`` while the site's tensors and its neighbours' stay where
    they are (values written in place included), a new one when one
    moves or the site's neighbours change. A ``Terms`` is the tuple of
    the plain terms, which the plain version takes as it is, and holds
    the shortcut's scale 1 / in_inv computed once."""
    gen = torch.Generator().manual_seed(12)
    _, q = int8_trunk(gen)
    block, nxt = q["layers"][0][1], q["layers"][1][0]
    c3 = block["conv3"]
    args = (c3, nxt["conv1"]["inv_in"], block["conv1"]["inv_in"])
    t = resnet_int8.k4_terms(*args)
    assert isinstance(t, k4.Terms) and t.channels == 64 and t.residual == 1
    assert t[0] is c3["scale"] and t[3] is block["conv1"]["inv_in"]
    assert torch.equal(t.in_scale, 1.0 / block["conv1"]["inv_in"])
    assert resnet_int8.k4_terms(*args) is t
    with torch.no_grad():
        c3["bias"].add_(1.0)
    assert resnet_int8.k4_terms(*args) is t
    c3["bias"] = c3["bias"].clone()
    moved = resnet_int8.k4_terms(*args)
    assert moved is not t and moved[1] is c3["bias"]
    ds = q["layers"][0][0]["downsample"]
    other = resnet_int8.k4_terms(c3, None, downsample=ds)
    assert other is not moved and other.residual == 2
    assert other[2] is None and other[4] is ds["scale"]
    first = q["layers"][0][0]["conv1"]
    assert resnet_int8.k4_terms(first, first["inv_in"]).residual == 0


def test_module_imports_and_runs_on_the_cpu_without_a_compiler():
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent",
               PYTHONPATH=ROOT)
    code = ("import torch\n"
            "from icd_tpu_torch import kernels\n"
            "import icd_tpu_torch.ops.int8_epilogue as k4\n"
            "from icd_tpu_torch.testing import int8_epilogue_case\n"
            "g = torch.Generator().manual_seed(0)\n"
            "acc, terms, ds = int8_epilogue_case((1, 2, 2, 16), 2, False, g)\n"
            "y = k4.int8_epilogue(acc, terms, ds, torch.bfloat16)\n"
            "assert 'int8_epilogue' in kernels.KERNELS and not kernels._libs\n"
            "assert k4.int8_epilogue.launches == 0\n"
            "print(y.dtype)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "torch.bfloat16"


def test_int8_epilogue_ms_reads_k4_per_request():
    from portbench.metrics import int8_epilogue_ms
    from portbench.trace import Reading

    spans = [("window", 0.0, 1.0), ("request", 0.0, 0.4),
             ("request", 0.5, 0.9)]
    kernel = "void (anonymous namespace)::int8_epilogue<0, 0, 16>(Args)"
    device = [(kernel, 0.01, 0.012),
              (kernel.replace("<0, 0, 16>", "<1, 2, 16>"), 0.02, 0.024),
              ("void at::native::elementwise_kernel<128, 4>", 0.03, 0.05),
              ("void (anonymous namespace)::bn_epilogue<float, 0, 4>(Args)",
               0.04, 0.045),
              ("int8_epilogue_like_but_not", 0.06, 0.07)]
    value = int8_epilogue_ms.read(Reading(spans, device, 1.0, {}))
    assert value == pytest.approx(3.0)  # 6 ms of K4 over 2 requests
    assert int8_epilogue_ms.read(Reading(spans, device[2:], 1.0, {})) is None
    assert int8_epilogue_ms.read(Reading(spans[:1], device, 1.0, {})) is None


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", (64, 3))
def test_k4_equals_plain_at_every_resnet101_site(card, batch):
    gen = torch.Generator().manual_seed(21 + batch)
    before = k4.int8_epilogue.launches
    seen = set()
    with torch.inference_mode():
        for shape, residual, s8 in int8_epilogue_sites(batch):
            for r in ((residual,) if s8 else (1, 2)):
                for out_dtype in ((None,) if s8 else OUT_DTYPES):
                    if (shape, r, s8, out_dtype) in seen:
                        continue
                    seen.add((shape, r, s8, out_dtype))
                    acc, terms, other = int8_epilogue_case(shape, r, s8, gen,
                                                           card)
                    got = k4.int8_epilogue(acc, terms, other, out_dtype)
                    want = k4.int8_epilogue_reference(acc, terms, other,
                                                      out_dtype)
                    assert torch.equal(got, want), (shape, r, s8, out_dtype)
                    assert torch.equal(got, eager_chain(acc, terms, other,
                                                        out_dtype))
    assert len(seen) == 20  # 16 distinct s8 sites, the last in four outputs
    assert k4.int8_epilogue.launches - before == len(seen)


def test_k4_scalar_variant_equals_plain(card):
    """A width that is no multiple of 16, and operands off 16 bytes,
    take the scalar variant."""
    gen = torch.Generator().manual_seed(22)
    with torch.inference_mode():
        for residual, s8 in FORMS:
            for out_dtype in ((None,) if s8 else OUT_DTYPES):
                acc, terms, other = int8_epilogue_case((3, 7, 5, 24),
                                                       residual, s8, gen,
                                                       card)
                want = k4.int8_epilogue_reference(acc, terms, other,
                                                  out_dtype)
                got = k4.int8_epilogue(acc, terms, other, out_dtype)
                assert torch.equal(got, want), (residual, s8, out_dtype)
                acc, terms, other = int8_epilogue_case((2, 3, 5, 64),
                                                       residual, s8, gen,
                                                       card)
                off = torch.empty(acc.numel() + 1, dtype=acc.dtype,
                                  device=card)
                off[1:] = acc.reshape(-1)
                ao = off[1:].view(acc.shape)
                assert ao.data_ptr() % 16 and ao.is_contiguous()
                want = k4.int8_epilogue_reference(acc, terms, other,
                                                  out_dtype)
                got = k4.int8_epilogue(ao, terms, other, out_dtype)
                assert torch.equal(got, want), (residual, s8, out_dtype)


def test_k4_rounds_ties_to_even_and_takes_atens_shortcut_scale(card):
    """acc * 0.5 puts every odd sum on a tie, which round() takes to
    even; and the shortcut's scale is ATen's 1 / in_inv to the bit, over
    in_inv from 1e-3 to 1e3."""
    c = 64
    acc = torch.arange(-4096, 4096, dtype=torch.int32,
                       device=card).reshape(-1, 2, c)
    half = torch.full((c,), 0.5, device=card)
    zero = torch.zeros(c, device=card)
    one = torch.ones((), device=card)
    with torch.inference_mode():
        got = k4.int8_epilogue(acc, (half, zero, one, None, None, None))
        want = eager_chain(acc, (half, zero, one, None, None, None))
        assert torch.equal(got, want)
        assert int(got.flatten()[4096 + 5]) == 2  # 2.5 -> 2
        assert int(got.flatten()[4096 + 7]) == 4  # 3.5 -> 4
        q = torch.ones(acc.shape, dtype=torch.int8, device=card)
        zeros = torch.zeros_like(acc)
        for in_inv in torch.logspace(-3, 3, 97).tolist():
            inv = torch.tensor(in_inv, device=card)
            got = k4.int8_epilogue(zeros, (half, zero, None, inv, None, None),
                                   q, torch.float32)
            assert torch.equal(got, torch.relu(zeros.float() * half + zero
                                               + q.float() * (1.0 / inv)))
            assert float(got[0, 0, 0]) == float(1.0 / inv)


@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
def test_int8_encoders_equal_the_eager_trunk(card, out_dtype):
    """ResNet-101's int8 trunk through K4 against the eager trunk, on the
    card: the attention grid and the baseline's features, 100 launches a
    forward."""
    from icd_tpu_torch.device import use_exact_f32

    use_exact_f32()
    gen = torch.Generator().manual_seed(4)
    net = randomize_bn(resnet.init_resnet101(gen, device="cpu"),
                       gen).requires_grad_(False).to(card)
    imgs = torch.randint(0, 256, (8, 224, 224, 3), generator=gen,
                         dtype=torch.uint8).to(card)
    maxes = resnet_int8.calibrate_act_maxes(net, imgs[:4], torch.float32)
    q = resnet_int8.quantize_resnet(net, maxes)
    encoder = Encoder(net, init_embed(gen, 512, device=card))
    before = k4.int8_epilogue.launches
    with torch.inference_mode():
        grid = encoder_attention_forward_int8(q, imgs, out_dtype)
        assert k4.int8_epilogue.launches - before == 100
        feats = encoder_forward_int8(encoder, q, imgs, out_dtype)
        assert k4.int8_epilogue.launches - before == 200
        plain = encoder_mod.resnet_int8_forward
        encoder_mod.resnet_int8_forward = eager_resnet_int8_forward
        try:
            want_grid = encoder_attention_forward_int8(q, imgs, out_dtype)
            want_feats = encoder_forward_int8(encoder, q, imgs, out_dtype)
        finally:
            encoder_mod.resnet_int8_forward = plain
    assert k4.int8_epilogue.launches - before == 200
    assert bool((want_grid != 0).any()) and bool(
        torch.isfinite(want_feats.float()).all())
    assert torch.equal(grid, want_grid)
    assert torch.equal(feats, want_feats)


def test_small_trunk_on_the_card_equals_the_cpu(card):
    """A trunk whose widths (8, 8, 16, 16) are no multiple of 16 at every
    site runs the scalar variant where it must, and gives the CPU's
    features to the bit."""
    gen = torch.Generator().manual_seed(9)
    _, q = int8_trunk(gen, widths=(8, 8, 16, 16))
    x = torch.randn(3, 32, 32, 3, generator=gen)
    before = k4.int8_epilogue.launches
    with torch.inference_mode():
        want = resnet_int8.resnet_int8_forward(q, x, torch.float32)
        got = resnet_int8.resnet_int8_forward(
            resnet_int8.tree_to(q, card), x.to(card), torch.float32)
    assert k4.int8_epilogue.launches - before == 16
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
