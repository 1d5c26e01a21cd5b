"""``python -m icd_tpu_torch.make_synthetic_coco`` against
``tools/make_synthetic_coco.py`` (run in a subprocess), and the shapes of
``icd_tpu_torch.draw`` against Pillow's ``ImageDraw``:

- with ``--train 12 --val 6`` and with ``--realistic --captions_per_image
  5 --img_size 64x48`` the two write byte-equal annotation JSON, the same
  file names and byte-equal JPEG files (the canvases are Pillow's and the
  encoder writes Pillow's bytes, so nothing may differ);
- rectangles, ellipses and the tool's triangles equal Pillow's pixel for
  pixel over seeded sizes and positions, clipped ones included;
- ``COCODataset.load_image_batch`` of icd_tpu (PIL) and of the port (its
  own codec) give equal arrays on the same files.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image, ImageDraw

from icd_tpu_torch import make_synthetic_coco
from icd_tpu_torch.draw import Canvas

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {"default": ["--train", "12", "--val", "6"],
        "realistic": ["--train", "12", "--val", "6", "--realistic",
                      "--captions_per_image", "5", "--img_size", "64x48"]}


def _tree(root):
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """{run: (tool root, port root)}; the JAX tool in subprocesses
    started together, the port in this process."""
    base = tmp_path_factory.mktemp("synthetic")
    procs = {}
    for run, argv in RUNS.items():
        procs[run] = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tools",
                                          "make_synthetic_coco.py"),
             str(base / ("tool_" + run)), *argv],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for run, argv in RUNS.items():
        make_synthetic_coco.main([str(base / ("port_" + run)), *argv])
    for run, proc in procs.items():
        _, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
    return {run: (str(base / ("tool_" + run)), str(base / ("port_" + run)))
            for run in RUNS}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_annotations_are_byte_equal(corpora, run):
    tool, port = (_tree(r) for r in corpora[run])
    jsons = [k for k in tool if k.endswith(".json")]
    assert len(jsons) == 2
    for name in jsons:
        assert port[name] == tool[name]
    anns = json.loads(port[os.path.join("cocoapi", "annotations",
                                        "captions_train2014.json")])
    per_image = 5 if run == "realistic" else 1
    assert len(anns["images"]) == 12
    assert len(anns["annotations"]) == 12 * per_image


@pytest.mark.parametrize("run", sorted(RUNS))
def test_image_files_are_equal(corpora, run):
    tool, port = (_tree(r) for r in corpora[run])
    assert sorted(port) == sorted(tool)
    images = [k for k in tool if k.endswith(".jpg")]
    assert len(images) == 18
    for name in images:
        assert port[name] == tool[name], name


def _pil_canvas(size, bg, draw):
    img = Image.new("RGB", size, bg)
    draw(ImageDraw.Draw(img))
    return np.asarray(img)


def _shapes(seed, n=400):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        w, h = (int(v) for v in rng.integers(8, 160, 2))
        cx = int(rng.integers(-12, w + 12))
        cy = int(rng.integers(-12, h + 12))
        rx, ry = (int(v) for v in rng.integers(0, 70, 2))
        bg = tuple(int(v) for v in rng.integers(0, 256, 3))
        fill = tuple(int(v) for v in rng.integers(0, 256, 3))
        yield (w, h), bg, fill, cx, cy, rx, ry


@pytest.mark.parametrize("kind", ["rectangle", "ellipse", "triangle"])
def test_shapes_equal_pillows(kind):
    for size, bg, fill, cx, cy, rx, ry in _shapes(seed=len(kind)):
        canvas = Canvas(size, bg)
        if kind == "rectangle":
            box = [cx - rx, cy - ry, cx + rx, cy + ry]
            canvas.rectangle(box, fill)
            want = _pil_canvas(size, bg, lambda d: d.rectangle(box, fill=fill))
        elif kind == "ellipse":
            box = [cx - rx, cy - ry, cx + rx, cy + ry]
            canvas.ellipse(box, fill)
            want = _pil_canvas(size, bg, lambda d: d.ellipse(box, fill=fill))
        else:  # make_synthetic_coco's triangle
            pts = [(cx, cy - rx), (cx - rx, cy + rx), (cx + rx, cy + rx)]
            canvas.polygon(pts, fill)
            want = _pil_canvas(size, bg, lambda d: d.polygon(pts, fill=fill))
        np.testing.assert_array_equal(canvas.pixels, want)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_load_image_batch_equals_icd_tpus(corpora, run, monkeypatch):
    from icd_tpu.data.dataset import COCODataset as JaxDataset
    from icd_tpu_torch.data.dataset import COCODataset

    monkeypatch.setenv("ICD_TPU_ROOT", corpora[run][1])
    monkeypatch.delenv("ICD_TPU_NATIVE_LOADER", raising=False)
    for mode in ("train", "val"):
        port = COCODataset(mode, vocab=object())
        jax_ds = JaxDataset(mode, vocab=object())
        ids = port.img_ids
        assert ids == jax_ds.img_ids
        got = port.load_image_batch(ids)
        assert got.shape == (len(ids), 224, 224, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_ds.load_image_batch(ids))
