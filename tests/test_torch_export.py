"""The reference's artifacts through the CLIs, the port's against
icd_tpu's on the same files, f32 on the CPU (``coco_root``'s 8 train and
4 val captions; a (1, 1, 1, 1) ResNet of widths (4, 4, 8, 8), A = 10,
H = 12, E = 16, batch 4, dropout 0; the reference skeleton of
``testing.write_reference_skeleton`` over the same small trunk).

One module fixture writes seeded ``.ckpt``s of both families, exports
them with ``python -m icd_tpu_torch.export_reference`` to ``.pth.tar``s
and writes a ``models/resnet101.pth``; then one icd_tpu subprocess (the
skeleton on its ``sys.path``: its loader imports the pickled classes)
loads the ``.pth.tar``s, evaluates them, captions an image from one
(``gen_captions.py --encoder float --dtype f32``), resumes training from
one (``--checkpoint x.pth.tar``), trains from scratch with the
``resnet101.pth`` present and exports the ``.ckpt``s with
``icd_tpu.export``, while the port runs its own CLIs on the same files.

Tolerances, and why (as in tests/test_torch_train_cli.py): the two
packages sum in other orders, so losses agree to rtol 1e-5 and their
printed lines (4 decimals) are equal, and the trained decoders to
1e-2 lr a step (the score bias, zero gradient in exact arithmetic, to lr
a step); the loaded trees, the exported state dicts, the eval's argmax
hypotheses (so every score) and the caption's tokens are equal.
"""

import contextlib
import functools
import io
import json
import os
import pickle
import shutil
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

import icd_tpu_torch.training.attention as ta
from icd_tpu_torch import eval as port_eval
from icd_tpu_torch import export_reference
from icd_tpu_torch import gen_captions as port_gen_captions
from icd_tpu_torch import train as port_train
from icd_tpu_torch.checkpoint import (load_checkpoint, load_torch_archive,
                                      save_checkpoint)
from icd_tpu_torch.export import resnet_to_torch_state_dict
from icd_tpu_torch.models.attention import (AttentionDecoderParams,
                                            init_attention_decoder)
from icd_tpu_torch.models.baseline import (BaselineDecoderParams,
                                           init_baseline_decoder)
from icd_tpu_torch.models.encoder import EncoderAttention
from icd_tpu_torch.models.resnet import init_resnet
from icd_tpu_torch.params import (decoder_from_jax, decoder_to_jax,
                                  resnet_from_jax, resnet_to_jax)
from icd_tpu_torch.testing import steer_end, write_reference_skeleton
from icd_tpu_torch.vocabulary import END_TOKEN, load_vocab
from helpers import SMALL_DEPTHS, SMALL_DIM, SMALL_WIDTHS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
LR = 1e-4
SIZES = dict(batch_size=4, embed_size=16, decoder_dim=12, attention_dim=10,
             workers=0, decoder_dropout=0.0)

_JAX_SIDE = """
import contextlib, functools, io, os, pickle, sys
sys.path.append({ref!r})
import jax, jax.numpy as jnp, numpy as np
import gen_captions as jax_gen_captions
import icd_tpu.convert as jax_convert
import icd_tpu.training.attention as jax_ta
import icd_tpu.training.baseline as jax_tb
from icd_tpu.checkpoint import load_checkpoint
from icd_tpu.export import export_reference_checkpoint
from helpers import SMALL_DEPTHS, make_train_args

def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)

out = {{}}
with open({init!r}, "rb") as f:
    init = pickle.load(f)
for fam, evaluate in (("attention", jax_ta.evaluate),
                      ("baseline", jax_tb.evaluate)):
    name = "ref_{{}}_0.pth.tar".format(fam)
    ck = load_checkpoint(name=name, verbose=False)
    out["load_" + fam] = dict(ck, encoder=np_tree(ck["encoder"]),
                              decoder=np_tree(ck["decoder"]))
    args = make_train_args(model_name=fam, checkpoint=name, print_freq=100)
    out["eval_" + fam] = evaluate(args, ck["encoder"], ck["decoder"])
    src = load_checkpoint(name="src_{{}}_0.ckpt".format(fam), verbose=False)
    export_reference_checkpoint(
        src, os.path.join({root!r}, "checkpoints",
                          "jx_{{}}_0.pth.tar".format(fam)),
        reference_root={ref!r})
buf = io.StringIO()
sys.argv = ["gen_captions.py", "ref_attention_0.pth.tar", {image!r},
            "--encoder", "float", "--dtype", "f32"]
with contextlib.redirect_stdout(buf):
    jax_gen_captions.main()
out["gen_captions"] = buf.getvalue().splitlines()
sizes = {sizes!r}
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    jax_ta.train(make_train_args(model="attention", model_name="jx_resume",
                                 epochs=2, checkpoint="ref_attention_0.pth.tar",
                                 **sizes))
out["resume_lines"] = buf.getvalue().splitlines()
jax_convert.resnet_from_torch = functools.partial(jax_convert.resnet_from_torch,
                                                  depths=SMALL_DEPTHS)
jax_ta.init_encoder_attention = lambda key, dtype=None: {{
    "resnet": jax.tree_util.tree_map(jnp.asarray, init["resnet"])}}
jax_ta.init_attention_decoder = lambda key, params: jax.tree_util.tree_map(
    jnp.asarray, init["decoder"])
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    jax_ta.train(make_train_args(model="attention", model_name="jx_scratch",
                                 **sizes))
out["scratch_lines"] = buf.getvalue().splitlines()
with open({out!r}, "wb") as f:
    pickle.dump(out, f)
"""


# python -m icd_tpu_torch.export_reference in a fresh process, which
# looks at sys.modules just before the reference's modules are evicted.
_EXPORT_ALONE = """
import json, runpy, sys
import icd_tpu_torch.compat as compat

seen = {{}}
uninstall = compat.uninstall_reference_shims


def uninstall_after_looking(state):
    import icd_tpu_torch.data.coco as port_coco
    coco = sys.modules.get("pycocotools.coco")
    seen["vocabulary_imported"] = "vocabulary" in sys.modules
    seen["coco_is_the_ports"] = getattr(coco, "COCO", None) is port_coco.COCO
    uninstall(state)


compat.uninstall_reference_shims = uninstall_after_looking
sys.argv = ["export_reference", "src_attention_0.ckpt", {out!r},
            "--reference_root", {ref!r}]
runpy.run_module("icd_tpu_torch.export_reference", run_name="__main__")
seen["foreign"] = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "icd_tpu"))
seen["pycocotools_left"] = sorted(m for m in sys.modules
                                  if m.split(".")[0] == "pycocotools")
print(json.dumps(seen))
"""


def _run(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue().splitlines()


def _loss_lines(lines):
    return [line.split(", Time:")[0] for line in lines
            if line.startswith("Epoch ")]


def _flags(**kw):
    out = ["--model", "attention", "--device", "cpu"]
    for key, value in dict(SIZES, **kw).items():
        out += ["--" + key, str(value)]
    return out


def _trees(vocab):
    """Seeded trees of both families at the small sizes, the attention
    decoder steered to finish its captions."""
    g = torch.Generator().manual_seed(0)
    resnet = resnet_to_jax(init_resnet(g, SMALL_DEPTHS, SMALL_WIDTHS,
                                       device="cpu"))
    att = AttentionDecoderParams()
    att.attention_dim, att.decoder_dim, att.embed_size = 10, 12, 16
    att.vocab = vocab
    dec = init_attention_decoder(g, att, encoder_dim=SMALL_DIM, device="cpu")
    steer_end(dec, vocab(END_TOKEN), threshold=4.0)
    base = BaselineDecoderParams()
    base.vocab_size, base.embed_size, base.hidden_size = len(vocab), 16, 12
    head = {"w": torch.randn(SMALL_DIM, 16, generator=g).numpy() * 0.1,
            "b": torch.randn(16, generator=g).numpy() * 0.1}
    return {
        "attention": ({"resnet": resnet}, decoder_to_jax(dec)),
        "baseline": ({"resnet": resnet, "embed": head}, decoder_to_jax(
            init_baseline_decoder(g, base, device="cpu"))),
    }


@pytest.fixture(scope="module")
def runs(coco_root, tmp_path_factory):
    root = tmp_path_factory.mktemp("export_root")
    for part in (("cocoapi",), ("pkldata",)):
        shutil.copytree(os.path.join(coco_root, *part), root.joinpath(*part))
    for part in ("checkpoints", "eval_data", "models"):
        (root / part).mkdir()
    root = str(root)
    ref = write_reference_skeleton(os.path.join(root, "reference"),
                                   SMALL_DEPTHS, SMALL_WIDTHS)
    mp = pytest.MonkeyPatch()
    mp.setenv("ICD_TPU_ROOT", root)
    mp.setenv("ICD_TPU_METEOR_PY", "1")
    try:
        vocab = load_vocab()
        trees = _trees(vocab)
        for fam, (enc, dec) in trees.items():
            save_checkpoint(port_train.build_parser().parse_args(
                ["src_" + fam, "--model", fam, "--embed_size", "16",
                 "--decoder_dim", "12", "--attention_dim", "10"]), 0, enc,
                dec, None, None, {"epoch_losses": [[3.0, 2.0]]})
            _run(export_reference.main, [
                "src_{}_0.ckpt".format(fam),
                os.path.join(root, "checkpoints",
                             "ref_{}_0.pth.tar".format(fam)),
                "--reference_root", ref])
        g = torch.Generator().manual_seed(9)
        pretrained = resnet_to_jax(init_resnet(g, SMALL_DEPTHS, SMALL_WIDTHS,
                                               device="cpu"))
        torch.save(resnet_to_torch_state_dict(pretrained),
                   os.path.join(root, "models", "resnet101.pth"))
        # The from-scratch run's random init, shared by both packages.
        init = {"resnet": resnet_to_jax(init_resnet(g, SMALL_DEPTHS,
                                                    SMALL_WIDTHS,
                                                    device="cpu")),
                "decoder": trees["attention"][1]}
        init_path = os.path.join(root, "init.pkl")
        with open(init_path, "wb") as f:
            pickle.dump(init, f)
        image = os.path.join(root, "cocoapi", "images", "val2014",
                             sorted(os.listdir(os.path.join(
                                 root, "cocoapi", "images", "val2014")))[0])
        out = os.path.join(root, "jax.pkl")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]),
                   JAX_PLATFORMS="cpu")
        jax_side = subprocess.Popen(
            [sys.executable, "-c", _JAX_SIDE.format(
                ref=ref, init=init_path, root=root, image=image,
                sizes=SIZES, out=out)],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            port = {}
            for fam in trees:
                port["eval_" + fam] = _run(port_eval.main, [
                    "ref_{}_0.pth.tar".format(fam), "--model_type", fam,
                    "--device", "cpu", "--print_freq", "100"])
            port["gen_captions"] = _run(port_gen_captions.main, [
                "ref_attention_0.pth.tar", image, "--encoder", "float",
                "--dtype", "f32", "--device", "cpu"])
            port["resume_lines"] = _run(port_train.main, ["pt_resume"] + _flags(
                epochs=2, checkpoint="ref_attention_0.pth.tar"))
            with mp.context() as m:
                m.setattr(ta, "init_encoder_attention",
                          lambda generator, dtype=None, device=None:
                          EncoderAttention(resnet_from_jax(init["resnet"])))
                m.setattr(ta, "init_attention_decoder",
                          lambda generator, params, device=None:
                          decoder_from_jax(init["decoder"]))
                port["scratch_lines"] = _run(port_train.main,
                                             ["pt_scratch"] + _flags())
            log, _ = jax_side.communicate(timeout=600)
        finally:
            jax_side.kill()
        assert jax_side.returncode == 0, log[-3000:]
        with open(out, "rb") as f:
            jax_out = pickle.load(f)
        yield dict(root=root, ref=ref, trees=trees, pretrained=pretrained,
                   jax=jax_out, port=port)
    finally:
        mp.undo()


@pytest.fixture()
def at_root(runs, monkeypatch):
    monkeypatch.setenv("ICD_TPU_ROOT", runs["root"])
    return runs


def _assert_trees_equal(got, want):
    g, w = (jax.tree_util.tree_flatten(t) for t in (got, want))
    assert g[1] == w[1]
    for a, b in zip(g[0], w[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("family", ["attention", "baseline"])
def test_port_export_loads_in_both_packages(at_root, family):
    """The port's export of a ``.ckpt``: both loaders give back its trees
    (the port's own ``.pth.tar`` round trip), and the same dict."""
    got = load_checkpoint(name="ref_{}_0.pth.tar".format(family),
                          verbose=False)
    want = at_root["jax"]["load_" + family]
    enc, dec = at_root["trees"][family]
    _assert_trees_equal(got["encoder"], enc)
    _assert_trees_equal(got["decoder"], dec)
    _assert_trees_equal(want["encoder"], enc)
    _assert_trees_equal(want["decoder"], dec)
    for key in ("epoch", "metrics", "config"):
        assert got[key] == want[key]
    assert got["config"] == {"model": family, "use_bert": False}


@pytest.mark.parametrize("family", ["attention", "baseline"])
def test_export_reference_equals_icd_tpus(at_root, family):
    """The same ``.ckpt`` exported by each package against the same
    reference root: equal state dicts, epochs and metrics, and a fresh
    decoder Adam at the same rate."""
    ck = os.path.join(at_root["root"], "checkpoints")
    ours = load_torch_archive(os.path.join(ck, "ref_{}_0.pth.tar".format(
        family)))
    theirs = load_torch_archive(os.path.join(ck, "jx_{}_0.pth.tar".format(
        family)))
    for key in ("encoder", "decoder"):
        a, b = ours[key].state_dict(), theirs[key].state_dict()
        assert list(a) == list(b)
        for name in a:
            assert torch.equal(a[name], b[name]), (key, name)
        assert type(ours[key]).__name__ == type(theirs[key]).__name__
    assert ours["epoch"] == theirs["epoch"] == 0
    assert ours["metrics"] == theirs["metrics"]
    assert ours["encoder_optimizer"] is theirs["encoder_optimizer"] is None
    for opt in (ours["decoder_optimizer"], theirs["decoder_optimizer"]):
        assert opt.state_dict()["state"] == {}
        assert opt.param_groups[0]["lr"] == 4e-4


@pytest.mark.parametrize("family", ["attention", "baseline"])
def test_eval_on_a_pth_tar_matches_icd_tpu(at_root, family):
    with open(os.path.join(at_root["root"], "eval_data",
                           "ref_{}_0.json".format(family))) as f:
        got = json.load(f)
    want = dict(at_root["jax"]["eval_" + family])
    np.testing.assert_allclose(got.pop("losses"), want.pop("losses"),
                               rtol=1e-5)
    assert got == {k: float(v) for k, v in want.items()}
    assert "Detected reference torch checkpoint; converting." in at_root[
        "port"]["eval_" + family]


def test_gen_captions_on_a_pth_tar_matches_icd_tpu(at_root):
    got = [line for line in at_root["port"]["gen_captions"]
           if not line.startswith(("Loading", "Detected"))]
    want = [line for line in at_root["jax"]["gen_captions"]
            if not line.startswith(("Loading", "Detected"))]
    assert got == want and got[0].startswith("<start>")


def test_train_resumes_from_a_pth_tar_as_icd_tpu(at_root):
    assert (_loss_lines(at_root["port"]["resume_lines"])
            == _loss_lines(at_root["jax"]["resume_lines"]))
    got = load_checkpoint(name="pt_resume_1.ckpt", verbose=False)
    want = load_checkpoint(name="jx_resume_1.ckpt", verbose=False)
    assert got["epoch"] == want["epoch"] == 1
    g_losses, w_losses = (c["metrics"]["epoch_losses"] for c in (got, want))
    assert g_losses[0] == w_losses[0] == [3.0, 2.0]
    np.testing.assert_allclose(g_losses[1], w_losses[1], rtol=1e-5)
    _decoders_close(got["decoder"], want["decoder"], steps=2)


def test_train_with_resnet101_pth_matches_icd_tpu(at_root):
    """From scratch with ``models/resnet101.pth`` present: both start
    from the file's trunk and the same decoder, and train alike."""
    path = os.path.join(at_root["root"], "models", "resnet101.pth")
    line = "Loading pretrained ResNet-101 from {}".format(path)
    assert line in at_root["port"]["scratch_lines"]
    assert (_loss_lines(at_root["port"]["scratch_lines"])
            == _loss_lines(at_root["jax"]["scratch_lines"]))
    got = load_checkpoint(name="pt_scratch_0.ckpt", verbose=False)
    want = load_checkpoint(name="jx_scratch_0.ckpt", verbose=False)
    np.testing.assert_allclose(got["metrics"]["epoch_losses"],
                               want["metrics"]["epoch_losses"], rtol=1e-5)
    for ck in (got, want):
        resnet = ck["encoder"]["resnet"]
        np.testing.assert_array_equal(resnet["stem"]["conv"],
                                      at_root["pretrained"]["stem"]["conv"])
        np.testing.assert_array_equal(
            resnet["layers"][3][0]["conv3"],
            at_root["pretrained"]["layers"][3][0]["conv3"])
    _decoders_close(got["decoder"], want["decoder"], steps=2)


def _decoders_close(got, want, steps):
    got, want = (jax.tree_util.tree_map(np.asarray, t) for t in (got, want))
    np.testing.assert_allclose(got["attention"]["full_att"].pop("b"),
                               want["attention"]["full_att"].pop("b"),
                               atol=LR * steps)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, w, atol=1e-2 * LR * steps)


def test_export_reference_imports_no_jax_with_the_references_pycocotools(
        at_root, tmp_path):
    """The reference's vocabulary.py imports ``pycocotools.coco``
    (the skeleton's does too): ``python -m icd_tpu_torch.export_reference``
    with JAX_PLATFORMS set must give it the port's COCO and import
    neither icd_tpu nor jax (the repository's ``cocoapi/PythonAPI``
    shim would import both), and leave no pycocotools behind."""
    out = str(tmp_path / "alone.pth.tar")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               ICD_TPU_ROOT=at_root["root"])
    proc = subprocess.run(
        [sys.executable, "-c", _EXPORT_ALONE.format(out=out,
                                                    ref=at_root["ref"])],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert seen == {"vocabulary_imported": True, "coco_is_the_ports": True,
                    "foreign": [], "pycocotools_left": []}
    assert os.path.exists(out)


def test_reference_shims_displace_and_restore_pycocotools(tmp_path,
                                                          monkeypatch):
    """Where ``sys.modules`` holds the repository's ``cocoapi/PythonAPI``
    shim (icd_tpu's), the port's stand-ins take its place for the call
    and it is back, alone, after it."""
    from icd_tpu_torch.compat import (install_reference_shims,
                                      uninstall_reference_shims)
    from icd_tpu_torch.data import coco, cocoeval
    from icd_tpu_torch.native import mask

    shim = types.ModuleType("pycocotools")
    shim.__file__ = os.path.join(REPO, "cocoapi", "PythonAPI", "pycocotools",
                                 "__init__.py")
    monkeypatch.setitem(sys.modules, "pycocotools", shim)
    for name in ("pycocotools.coco", "pycocotools.mask",
                 "pycocotools.cocoeval"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    state = install_reference_shims(str(tmp_path))
    import pycocotools.coco
    import pycocotools.cocoeval
    import pycocotools.mask

    assert pycocotools.coco.COCO is coco.COCO
    assert pycocotools.mask.encode is mask.encode
    assert pycocotools.cocoeval.COCOeval is cocoeval.COCOeval
    assert sys.modules["pycocotools"] is not shim
    uninstall_reference_shims(state)
    assert sys.modules["pycocotools"] is shim
    assert not {"pycocotools.coco", "pycocotools.mask",
                "pycocotools.cocoeval"} & set(sys.modules)
