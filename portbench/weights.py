"""Random weights of a configuration, made on the device from the seed.

The benchmark makes them itself, in two large draws from one
``torch.Generator`` on the run's device (one normal, one uniform,
sliced and scaled leaf by leaf), with the distributions the models'
own initialisers use: He-normal convolutions and identity BN; PyTorch's
U(+-1/sqrt(fan_in)) linear layers and LSTM; the attention decoder's
U(+-0.1) fc weight and embedding and zero fc bias; the baseline's
N(0, 1) embedding. Names are the program's module names, so the same
tensors go to the program (``load``) and to the reference.

Each residual branch's last BN starts at the configuration's
``bn3_scale``. The traffic's adjustments are inputs too, made once
here (``adjust``): BN statistics estimated on the seed's calibration
images (``reference.resnet.estimate_bn``), the baseline's features
brought to a unit scale (``scale_features``), and ``<end>`` steered
(``steer_end``, a frozen copy of ``icd_tpu_torch/testing.py:steer_end``)
or pinned unreachable (``pin_end``, as
``icd_tpu_torch/bench.py:pin_end``).
"""

import math

import torch

from .reference import exact_f32, resnet as ref_resnet


def _resnet_leaves(cfg, prefix):
    """(name, shape, kind, scale) of the backbone. Each residual
    branch's last BN scale is ``bn3_scale`` (1 when the configuration
    does not say): near 0 the branch starts small, as in a trained
    ResNet (Goyal et al. 2017, arXiv:1706.02677, start it at 0)."""
    depths, widths = cfg["resnet_depths"], cfg["resnet_widths"]
    out = []

    def conv(name, cout, cin, k):
        out.append((name, (cout, cin, k, k), "normal",
                    math.sqrt(2.0 / (cin * k * k))))

    def bn(name, c, scale=1.0):
        out.extend([(name + ".scale", (c,), "const", scale),
                    (name + ".bias", (c,), "const", 0.0),
                    (name + ".mean", (c,), "const", 0.0),
                    (name + ".var", (c,), "const", 1.0)])

    conv(prefix + "stem.conv", widths[0], 3, 7)
    bn(prefix + "stem.bn", widths[0])
    cin = widths[0]
    for stage, (depth, width) in enumerate(zip(depths, widths)):
        for block in range(depth):
            q = "{}layers.{}.{}.".format(prefix, stage, block)
            cout = width * 4
            stride = 2 if stage > 0 and block == 0 else 1
            conv(q + "conv1", width, cin, 1)
            bn(q + "bn1", width)
            conv(q + "conv2", width, width, 3)
            bn(q + "bn2", width)
            conv(q + "conv3", cout, width, 1)
            bn(q + "bn3", cout, cfg.get("bn3_scale", 1.0))
            if stride != 1 or cin != cout:
                conv(q + "downsample.conv", cout, cin, 1)
                bn(q + "downsample.bn", cout)
            cin = cout
    return out


def encoder_dim(cfg):
    return cfg["resnet_widths"][-1] * 4


def _linear(name, cout, cin, bound=None):
    bound = 1.0 / math.sqrt(cin) if bound is None else bound
    return [(name + ".weight", (cout, cin), "uniform", bound),
            (name + ".bias", (cout,), "uniform", bound)]


def _lstm(name, cin, h):
    bound = 1.0 / math.sqrt(h)
    return [(name + ".weight_ih", (4 * h, cin), "uniform", bound),
            (name + ".weight_hh", (4 * h, h), "uniform", bound),
            (name + ".bias_ih", (4 * h,), "uniform", bound),
            (name + ".bias_hh", (4 * h,), "uniform", bound)]


def leaves(cfg):
    """Every leaf of the configuration's encoder (``resnet.*``, and the
    baseline's ``embed.*``) and decoder (``decoder.*``)."""
    d, v = encoder_dim(cfg), cfg["vocab_size"]
    e, h = cfg["embed_size"], cfg["decoder_dim"]
    out = _resnet_leaves(cfg, "resnet.")
    if cfg["model"] == "attention":
        a = cfg["attention_dim"]
        out += (_linear("decoder.attention.enc_att", a, d)
                + _linear("decoder.attention.dec_att", a, h)
                + _linear("decoder.attention.full_att", 1, a)
                + _lstm("decoder.lstm", e + d, h)
                + _linear("decoder.h_lin", h, d)
                + _linear("decoder.c_lin", h, d)
                + _linear("decoder.f_beta", d, h)
                + [("decoder.fc.weight", (v, h), "uniform", 0.1),
                   ("decoder.fc.bias", (v,), "const", 0.0),
                   ("decoder.embedding.weight", (v, e), "uniform", 0.1)])
    else:
        out += (_linear("embed", e, d)
                + [("decoder.embedding.weight", (v, e), "normal", 1.0)]
                + _lstm("decoder.lstm", e, h)
                + _linear("decoder.linear", v, h))
    return out


@torch.no_grad()
def make(cfg, seed, device):
    """{name: float32 tensor on ``device``} from ``seed``: one normal and
    one uniform draw of a generator on the device."""
    specs = leaves(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {kind: sum(math.prod(s) for _, s, k, _ in specs if k == kind)
             for kind in ("normal", "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], generator=gen,
                                   device=device),
             "uniform": torch.rand(sizes["uniform"], generator=gen,
                                   device=device) * 2 - 1}
    offsets = dict.fromkeys(pools, 0)
    out = {}
    for name, shape, kind, scale in specs:
        if kind in pools:
            n = math.prod(shape)
            flat = pools[kind][offsets[kind]:offsets[kind] + n]
            offsets[kind] += n
            out[name] = (flat * scale).view(shape)
        else:
            out[name] = torch.full(shape, scale, device=device)
    return out


@torch.no_grad()
def steer_end(w, end_id, emb, rate, spread, threshold, unit=0):
    """Make LSTM unit ``unit`` count the steps and drive ``<end>`` alone:
    its i, f and o gates open, c from 0, g = tanh(atanh(rate) + spread *
    context . u) with u a zero-mean unit vector, and the ``<end>`` logit
    40 * h_unit - threshold. Captions then end after a number of steps
    set by ``rate`` and ``threshold``, and ``spread`` lets the image move
    it a little."""
    hd = w["decoder.lstm.weight_hh"].shape[1]
    i, f, g, o = (gate * hd + unit for gate in range(4))
    wih, whh = w["decoder.lstm.weight_ih"], w["decoder.lstm.weight_hh"]
    wih[[i, f, o]] = 0.0
    whh[[i, f, g, o]] = 0.0
    w["decoder.lstm.bias_ih"][[i, f, o]] = 10.0
    w["decoder.lstm.bias_hh"][[i, f, g, o]] = 0.0
    u = wih[g, emb:]
    u = u - u.mean()
    wih[g, emb:] = spread * u / u.norm()
    wih[g, :emb] = 0.0
    w["decoder.lstm.bias_ih"][g] = math.atanh(rate)
    w["decoder.c_lin.weight"][unit] = 0.0
    w["decoder.c_lin.bias"][unit] = 0.0
    w["decoder.fc.weight"][end_id] = 0.0
    w["decoder.fc.weight"][end_id, unit] = 40.0
    w["decoder.fc.bias"][end_id] = -threshold


@torch.no_grad()
def pin_end(w, end_id):
    """``<end>`` unreachable: its f32 output bias at -1e9, so that every
    caption runs the whole loop."""
    w["decoder.linear.bias"][end_id] = -1e9


@torch.no_grad()
def scale_features(w, cfg, calib_imgs, rms):
    """Scale the baseline's ``embed`` head so that its features have
    root-mean-square ``rms`` over the calibration images, the scale of
    the word embeddings the LSTM reads after them; at U(+-1/sqrt(2048))
    the image would barely move the captions."""
    pooled = ref_resnet.pooled(w, calib_imgs, cfg["resnet_depths"])
    feats = pooled @ w["embed.weight"].t() + w["embed.bias"]
    gain = rms / feats.pow(2).mean().sqrt()
    w["embed.weight"].mul_(gain)
    w["embed.bias"].mul_(gain)


def adjust(w, cfg, traffic, calib_imgs):
    """The serving traffic's adjustments of the weights, in place: BN
    statistics estimated on ``calib_imgs``, then the traffic's feature
    scale and ``<end>``."""
    exact_f32()
    ref_resnet.estimate_bn(w, calib_imgs, cfg["resnet_depths"])
    if traffic.get("feature_rms"):
        scale_features(w, cfg, calib_imgs, traffic["feature_rms"])
    end = traffic.get("end")
    if end == "steer":
        steer_end(w, cfg["vocab_size"] - 2, cfg["embed_size"],
                  **traffic["steer"])
    elif end == "pin":
        pin_end(w, cfg["vocab_size"] - 2)


def subtree(w, prefix):
    """The leaves under ``prefix``, with it taken off their names."""
    return {k[len(prefix):]: t for k, t in w.items() if k.startswith(prefix)}


def load(module, w, prefix):
    """A copy of ``w``'s leaves under ``prefix`` in ``module`` (built on
    the meta device), on ``w``'s device."""
    tree = subtree(w, prefix)
    device = next(iter(tree.values())).device
    module = module.to_empty(device=device)
    module.load_state_dict(tree, strict=True)
    return module
