"""The card machine's condition: no PIL. In a subprocess where
``sys.modules["PIL"] = None`` (so ``import PIL`` raises), the port reads
JPEGs (``data.dataset.decode_image``), loads a JPEG for captioning
(``gen_captions.load_img``), writes a synthetic corpus whose annotation
JSON is byte-equal to the JAX tool's, and runs ``bench_serving_e2e
--device cpu`` (at the small size of its own test); a PNG raises an
``ImportError`` that names the format. The same pixels come out here
with PIL importable."""

import os
import subprocess
import sys

import numpy as np
from PIL import Image

from icd_tpu_torch.data.dataset import decode_image
from icd_tpu_torch.gen_captions import load_img

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import json, os, sys
sys.modules["PIL"] = None
sys.path.insert(0, os.path.join({repo!r}, "tests"))
import numpy as np
from icd_tpu_torch.data.dataset import decode_image
from icd_tpu_torch.gen_captions import load_img
from icd_tpu_torch import make_synthetic_coco, bench_serving_e2e, bench

tmp = {tmp!r}
np.save(os.path.join(tmp, "decoded.npy"),
        decode_image(os.path.join(tmp, "img.jpg"), 224))
np.save(os.path.join(tmp, "loaded.npy"),
        load_img(os.path.join(tmp, "img.jpg")))
try:
    decode_image(os.path.join(tmp, "img.png"), 224)
    print("PNG DECODED")
except ImportError as e:
    print("PNG", e)
make_synthetic_coco.main([os.path.join(tmp, "port"), "--train", "12",
                          "--val", "6"])

class Patch:
    def setattr(self, obj, name, value):
        setattr(obj, name, value)

import test_torch_bench_serving_e2e as t
t.shrink(Patch())
bench_serving_e2e.main(["--device", "cpu", "--batches", "2",
                        "--threads", "2"])
print("PIL", sys.modules["PIL"])
"""


def test_the_port_reads_and_writes_jpegs_without_pil(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (61, 97, 3), dtype=np.uint8)
    Image.fromarray(arr).save(tmp_path / "img.jpg", quality=85)
    Image.fromarray(arr).save(tmp_path / "img.png")
    tool = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "make_synthetic_coco.py"),
         str(tmp_path / "tool"), "--train", "12", "--val", "6"],
        capture_output=True, text=True, timeout=120)
    assert tool.returncode == 0, tool.stderr
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(repo=REPO, tmp=str(tmp_path))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.strip().splitlines()
    assert out[-1] == "PIL None"
    assert any(line.startswith("PNG ") and "PNG file" in line
               and "only JPEG is read without PIL" in line for line in out)
    summary = [line for line in out if "e2e_captions_equal_resident" in line]
    assert len(summary) == 1 and '"e2e_captions_equal_resident": true' in (
        summary[0])
    np.testing.assert_array_equal(np.load(tmp_path / "decoded.npy"),
                                  decode_image(str(tmp_path / "img.jpg")))
    np.testing.assert_array_equal(np.load(tmp_path / "loaded.npy"),
                                  load_img(str(tmp_path / "img.jpg")))
    want = np.asarray(Image.open(tmp_path / "img.jpg").convert("RGB").resize(
        (224, 224), Image.BILINEAR))
    np.testing.assert_array_equal(np.load(tmp_path / "decoded.npy"), want)
    for split in ("train", "val"):
        name = os.path.join("cocoapi", "annotations",
                            "captions_{}2014.json".format(split))
        with open(tmp_path / "port" / name, "rb") as f:
            port = f.read()
        with open(tmp_path / "tool" / name, "rb") as f:
            assert port == f.read()
