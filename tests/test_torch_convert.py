"""The reference's artifacts in the port (``icd_tpu_torch/convert.py``,
``checkpoint.load_torch_archive``) against ``icd_tpu.convert``.

- The state-dict converters give icd_tpu's trees exactly (tolerance:
  none; both transpose float32 values).
- ``load_resnet101_pth`` equals icd_tpu's on a full-size ResNet-101 file
  ``torch.save``d from ``icd_tpu.export.resnet_to_torch_state_dict``.
- Whole-module ``.pth.tar`` files, in torch's zip and legacy formats,
  pickled from the reference skeleton (``testing.write_reference_skeleton``,
  a (1, 1, 1, 1) ResNet of widths (4, 4, 8, 8)) and from
  ``test_checkpoint_compat.py``'s test-local classes, load in the port
  to the dict ``icd_tpu.checkpoint.load_checkpoint`` returns: epoch,
  metrics, config and every array equal. icd_tpu's side runs in one
  subprocess with the skeleton on its ``sys.path`` (its loader imports
  the pickled classes); the port's imports none of them.
- A pickle naming a global outside the admitted set is refused before
  anything runs.
"""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from icd_tpu import convert as jax_convert
from icd_tpu import export as jax_export
from icd_tpu_torch import convert, export
from icd_tpu_torch.checkpoint import (InertObject, load_checkpoint,
                                      load_torch_archive, save_checkpoint)
from icd_tpu_torch.models.attention import (AttentionDecoderParams,
                                            init_attention_decoder)
from icd_tpu_torch.models.baseline import (BaselineDecoderParams,
                                           init_baseline_decoder)
from icd_tpu_torch.models.resnet import init_resnet, init_resnet101
from icd_tpu_torch.params import decoder_to_jax, resnet_to_jax
from icd_tpu_torch.testing import write_reference_skeleton
from icd_tpu_torch.vocabulary import Vocabulary, save_vocab
from test_checkpoint_compat import RefEncoder
from test_convert import RefNamedAttentionDecoder, RefNamedBaselineDecoder
from test_resnet import DEPTHS, WIDTHS, TorchMiniResNet, _randomize_bn_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
ENC_DIM = WIDTHS[-1] * 4


def assert_trees_equal(got, want):
    """Same structure, every array equal to the bit (float32)."""
    g, w = jax.tree_util.tree_flatten(got), jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, want))
    assert g[1] == w[1]
    for a, b in zip(g[0], w[0]):
        a = np.asarray(a)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _mini_resnet(seed):
    torch.manual_seed(seed)
    net = TorchMiniResNet(DEPTHS, WIDTHS).eval()
    with torch.no_grad():
        _randomize_bn_stats(net, seed=seed)
    return net


@pytest.mark.parametrize("what", ["encoder_baseline", "encoder_attention",
                                  "baseline_decoder", "attention_decoder"])
def test_state_dict_converters_equal_icd_tpu(what):
    torch.manual_seed(1)
    if what.startswith("encoder"):
        module = RefEncoder(_mini_resnet(2), embed_out=16)
        sd = module.state_dict()
        if what == "encoder_attention":
            sd = {k: v for k, v in sd.items() if not k.startswith("embed.")}
        got, want = (f(sd) for f in (convert.convert_encoder_state_dict,
                                     jax_convert.convert_encoder_state_dict))
    elif what == "baseline_decoder":
        sd = RefNamedBaselineDecoder(15, 6, 8).state_dict()
        got = convert.convert_baseline_decoder_state_dict(sd)
        want = jax_convert.convert_baseline_decoder_state_dict(sd)
    else:
        sd = RefNamedAttentionDecoder(ENC_DIM, 10, 12, 8, 19).state_dict()
        got = convert.convert_attention_decoder_state_dict(sd)
        want = jax_convert.convert_attention_decoder_state_dict(sd)
    assert_trees_equal(got, want)


def _seeded_trees(seed=0):
    """{family: (encoder tree, decoder tree)} of small seeded models, as
    the port's checkpoints hold them."""
    g = torch.Generator().manual_seed(seed)
    resnet = resnet_to_jax(init_resnet(g, DEPTHS, WIDTHS, device="cpu"))
    for blocks in resnet["layers"]:  # BN statistics away from identity
        for block in blocks:
            block["bn1"]["mean"] += 0.1
            block["bn3"]["var"] *= 1.5
    vocab = range(19)
    att = AttentionDecoderParams()
    att.attention_dim, att.decoder_dim, att.embed_size = 10, 12, 16
    att.vocab = vocab
    base = BaselineDecoderParams()
    base.vocab_size, base.embed_size, base.hidden_size = 19, 16, 12
    head = {"w": torch.randn(ENC_DIM, 16, generator=g).numpy(),
            "b": torch.randn(16, generator=g).numpy()}
    return {
        "attention": ({"resnet": resnet}, decoder_to_jax(
            init_attention_decoder(g, att, encoder_dim=ENC_DIM,
                                   device="cpu"))),
        "baseline": ({"resnet": resnet, "embed": head}, decoder_to_jax(
            init_baseline_decoder(g, base, device="cpu"))),
    }


@pytest.mark.parametrize("family", ["attention", "baseline"])
def test_inverse_maps_equal_icd_tpu(family):
    enc, dec = _seeded_trees()[family]
    pairs = [(export.encoder_to_torch_state_dict(enc),
              jax_export.encoder_to_torch_state_dict(enc))]
    if family == "attention":
        pairs.append((export.attention_decoder_to_torch_state_dict(dec),
                      jax_export.attention_decoder_to_torch_state_dict(dec)))
        back = convert.convert_attention_decoder_state_dict(pairs[1][0])
    else:
        pairs.append((export.baseline_decoder_to_torch_state_dict(dec),
                      jax_export.baseline_decoder_to_torch_state_dict(dec)))
        back = convert.convert_baseline_decoder_state_dict(pairs[1][0])
    for got, want in pairs:
        assert list(got) == list(want)
        for key in got:
            assert got[key].dtype == want[key].dtype == torch.float32
            assert torch.equal(got[key], want[key]), key
    assert_trees_equal(convert.convert_encoder_state_dict(pairs[0][0]), enc)
    assert_trees_equal(back, dec)


def test_load_resnet101_pth_equals_icd_tpu(tmp_path):
    """Full size: icd_tpu's loader reads ResNet-101's depths only."""
    tree = resnet_to_jax(init_resnet101(torch.Generator().manual_seed(3),
                                        device="cpu"))
    path = str(tmp_path / "resnet101.pth")
    torch.save(jax_export.resnet_to_torch_state_dict(tree), path)
    got = convert.load_resnet101_pth(path)
    assert_trees_equal(got, jax_convert.load_resnet101_pth(path))
    assert_trees_equal(got, tree)


# ---------------------------------------------------------------------------
# Whole-module .pth.tar files
# ---------------------------------------------------------------------------

_RESAVE_LEGACY = """
import sys, torch
sys.path.insert(0, {repo!r})
from icd_tpu_torch.compat import install_reference_shims
install_reference_shims({ref!r})
for src, dst in {pairs!r}:
    obj = torch.load(src, map_location="cpu", weights_only=False)
    torch.save(obj, dst, _use_new_zipfile_serialization=False)
"""

_JAX_LOAD = """
import os, pickle, sys
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.append({ref!r})
import jax, numpy as np
from icd_tpu.checkpoint import load_checkpoint
out = {{}}
for name in {names!r}:
    ck = load_checkpoint(name=name, verbose=False)
    out[name] = dict(ck, encoder=jax.tree_util.tree_map(np.asarray,
                                                        ck["encoder"]),
                     decoder=jax.tree_util.tree_map(np.asarray,
                                                    ck["decoder"]))
with open({out!r}, "wb") as f:
    pickle.dump(out, f)
"""


def _run(code, env):
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _test_local_state(kind):
    """A reference-format dict pickled from test_checkpoint_compat.py's
    classes (the JAX package's own fixtures)."""
    torch.manual_seed(4)
    encoder = RefEncoder(_mini_resnet(5), embed_out=16)
    if kind == "baseline":
        decoder = RefNamedBaselineDecoder(15, 16, 12)
    else:
        decoder = RefNamedAttentionDecoder(ENC_DIM, 10, 12, 8, 19)
        decoder.use_bert = True  # the flag the reference's decoder carries
    optimizer = torch.optim.Adam(decoder.parameters(), lr=4e-4)
    sum(p.sum() for p in decoder.parameters()).backward()
    optimizer.step()
    return {"epoch": 3, "metrics": {"epoch_losses": [[1.0, 0.9]],
                                    "best": np.float32(0.5)},
            "encoder": encoder, "decoder": decoder,
            "encoder_optimizer": None, "decoder_optimizer": optimizer}


@pytest.fixture(scope="module")
def pth_files(tmp_path_factory):
    """Reference .pth.tar files in both formats under a checkpoints dir,
    and icd_tpu's load of each (subprocess)."""
    root = tmp_path_factory.mktemp("pth_root")
    ref = write_reference_skeleton(str(root / "reference"), DEPTHS, WIDTHS)
    ckpts = root / "checkpoints"
    ckpts.mkdir()
    (root / "pkldata").mkdir()
    mp = pytest.MonkeyPatch()
    mp.setenv("ICD_TPU_ROOT", str(root))
    try:
        vocab = Vocabulary()
        for word in ["<pad>"] + ["w{}".format(i) for i in range(15)] + [
                "<start>", "<end>", "<unk>"]:
            vocab.add_word(word)
        save_vocab(vocab)
        trees = _seeded_trees()
        zips = []
        for family, (enc, dec) in trees.items():
            name = "skel_{}".format(family)
            chkpt = {"epoch": 2, "metrics": {"epoch_losses": [[2.0, 1.5]]},
                     "encoder": enc, "decoder": dec,
                     "config": {"model": family}}
            export.export_reference_checkpoint(
                chkpt, str(ckpts / (name + "_2.pth.tar")), reference_root=ref)
            zips.append(name + "_2.pth.tar")
        for kind in ("baseline", "attention"):
            name = "local_{}_3.pth.tar".format(kind)
            torch.save(_test_local_state(kind), str(ckpts / name))
            zips.append(name)
        pairs = [(str(ckpts / z), str(ckpts / ("legacy_" + z))) for z in zips]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]))
        _run(_RESAVE_LEGACY.format(repo=REPO, ref=ref, pairs=pairs), env)
        names = zips + ["legacy_" + z for z in zips]
        out = str(root / "jax.pkl")
        _run(_JAX_LOAD.format(ref=ref, names=names, out=out), env)
        with open(out, "rb") as f:
            jax_loaded = pickle.load(f)
        yield dict(root=str(root), ref=ref, names=names, jax=jax_loaded,
                   trees=trees)
    finally:
        mp.undo()


_FILES = ["skel_attention_2.pth.tar", "skel_baseline_2.pth.tar",
          "local_baseline_3.pth.tar", "local_attention_3.pth.tar"]


@pytest.mark.parametrize("fmt", ["zip", "legacy"])
@pytest.mark.parametrize("name", _FILES)
def test_whole_module_pth_tar_loads_as_icd_tpu(pth_files, monkeypatch,
                                               name, fmt):
    monkeypatch.setenv("ICD_TPU_ROOT", pth_files["root"])
    if fmt == "legacy":
        name = "legacy_" + name
    with open(os.path.join(pth_files["root"], "checkpoints", name),
              "rb") as f:
        assert (f.read(2) == b"PK") == (fmt == "zip")
    got = load_checkpoint(name=name, verbose=False)
    want = pth_files["jax"][name]
    assert set(got) == set(want)
    for key in ("epoch", "metrics", "config", "encoder_optimizer",
                "decoder_optimizer"):
        assert got[key] == want[key], key
    assert_trees_equal(got["encoder"], want["encoder"])
    assert_trees_equal(got["decoder"], want["decoder"])
    if name.endswith(("skel_attention_2.pth.tar", "skel_baseline_2.pth.tar")):
        family = got["config"]["model"]
        assert_trees_equal(got["encoder"], pth_files["trees"][family][0])
        assert_trees_equal(got["decoder"], pth_files["trees"][family][1])
    assert got["config"]["use_bert"] == ("local_attention" in name)


def test_stand_ins_keep_state_and_import_nothing(pth_files):
    """The reference's classes come back as inert stand-ins named after
    them, holding their state (the skeleton's Vocabulary inside the
    decoder); no module of the skeleton is imported."""
    path = os.path.join(pth_files["root"], "checkpoints",
                        "skel_attention_2.pth.tar")
    before = set(sys.modules)
    obj = load_torch_archive(path)
    dec = obj["decoder"]
    assert isinstance(dec, torch.nn.Module)
    assert type(dec).__name__ == "AttentionDecoder"
    assert dec.source == "models.attention.AttentionDecoder"
    assert isinstance(dec.vocab, InertObject)
    assert dec.vocab.source == "vocabulary.Vocabulary"
    assert dec.vocab.w2i["<end>"] == 17 and len(dec.vocab.i2w) == 19
    assert isinstance(obj["decoder_optimizer"], torch.optim.Adam)
    assert not any(m.split(".")[0] in ("models", "vocabulary",
                                       "torchvision")
                   for m in set(sys.modules) - before)


class _Payload:
    def __init__(self, fn, args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


def _refusal_cases(marker):
    import builtins
    import subprocess as sp

    return {
        "os.system": (os.system, ("touch {}".format(marker),)),
        "builtins.eval": (builtins.eval, (
            "__import__('os').system('touch {}')".format(marker),)),
        "subprocess.Popen": (sp.Popen, (["touch", marker],)),
        "torch.load": (torch.load, (marker,)),
    }


@pytest.mark.parametrize("fmt", ["zip", "legacy"])
@pytest.mark.parametrize("case", ["os.system", "builtins.eval",
                                  "subprocess.Popen", "torch.load"])
def test_foreign_global_is_refused(tmp_path, case, fmt):
    marker = str(tmp_path / "ran")
    fn, args = _refusal_cases(marker)[case]
    path = str(tmp_path / "evil.pth.tar")
    torch.save({"epoch": 0, "encoder": _Payload(fn, args)}, path,
               _use_new_zipfile_serialization=(fmt == "zip"))
    with pytest.raises(pickle.UnpicklingError, match="refusing global"):
        load_torch_archive(path)
    assert not os.path.exists(marker)
