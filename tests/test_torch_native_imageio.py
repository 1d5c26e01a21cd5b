"""The port's native JPEG loader (``icd_tpu_torch/native/imageio.py``, a
copy of icd_tpu's libjpeg decode + resize, built at first use) against
icd_tpu's, pixel for pixel (tolerance: none; the same source and flags
give the same bytes), on JPEGs whose sizes take libjpeg's 1/1, 1/2, 1/4
and 1/8 DCT scaling, a grayscale one and a progressive one; failures
give None; the dataset decodes with it only under
``ICD_TPU_NATIVE_LOADER`` and falls back to ``decode_image`` (the
port's own codec, PIL's pixels), and importing the dataset builds
nothing. Skips only where ``g++`` or ``jpeglib.h`` is
absent."""

import io
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from icd_tpu.native.imageio import decode_resize_jpeg as jax_decode


def _toolchain():
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no g++ to build the native loader")
    if not any(os.path.exists(os.path.join(d, "jpeglib.h"))
               for d in ("/usr/include", "/usr/local/include",
                         "/usr/include/x86_64-linux-gnu")):
        pytest.skip("no jpeglib.h to build the native loader")
    from icd_tpu_torch.native import imageio

    return imageio


def _jpeg(h, w, seed=0, mode="RGB", **save):
    rng = np.random.default_rng(seed)
    shape = (h // 16 + 1, w // 16 + 1) + ((3,) if mode == "RGB" else ())
    base = Image.fromarray(rng.integers(0, 255, shape).astype(np.uint8),
                           mode=mode)
    buf = io.BytesIO()
    base.resize((w, h), Image.BILINEAR).save(buf, "JPEG", quality=90,
                                             **save)
    return buf.getvalue()


# (h, w): no DCT scaling, then sources about 2x, 4x and 8x the target.
@pytest.mark.parametrize("hw", [(224, 224), (100, 150), (480, 640),
                                (1024, 768), (1800, 1900), (2000, 1500)])
@pytest.mark.parametrize("out_hw", [(224, 224), (56, 40)])
def test_pixels_equal_icd_tpu(hw, out_hw):
    imageio = _toolchain()
    data = _jpeg(*hw, seed=hw[0])
    got = imageio.decode_resize_jpeg(data, *out_hw)
    want = jax_decode(data, *out_hw)
    assert got.shape == out_hw + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("save", [dict(mode="L"), dict(progressive=True)])
def test_grayscale_and_progressive_equal_icd_tpu(save):
    imageio = _toolchain()
    mode = save.pop("mode", "RGB")
    data = _jpeg(333, 517, seed=3, mode=mode, **save)
    got = imageio.decode_resize_jpeg(data, 224, 224)
    np.testing.assert_array_equal(got, jax_decode(data, 224, 224))
    if mode == "L":
        np.testing.assert_array_equal(got[..., 0], got[..., 2])


def test_bad_input_returns_none():
    imageio = _toolchain()
    assert imageio.decode_resize_jpeg(b"not a jpeg", 224, 224) is None
    assert imageio.decode_resize_jpeg(b"", 224, 224) is None
    assert imageio.library_path().startswith(imageio.BUILD_DIR)
    assert os.path.dirname(imageio.library_path()) != os.path.dirname(
        imageio.SOURCE)


def test_dataset_uses_the_native_loader_only_when_asked(use_coco_root,
                                                        monkeypatch):
    """Under ICD_TPU_NATIVE_LOADER the dataset's pixels are the native
    loader's (equal to icd_tpu's dataset under the same variable); else
    ``decode_image``'s. A file that is not a JPEG is decoded by
    ``decode_image`` either way."""
    _toolchain()
    import icd_tpu.data.dataset as jax_dataset
    from icd_tpu_torch.data import dataset

    monkeypatch.delenv("ICD_TPU_NATIVE_LOADER", raising=False)
    plain = dataset.COCODataset("train")
    assert plain._native_decode is None
    monkeypatch.setenv("ICD_TPU_NATIVE_LOADER", "1")
    native = dataset.COCODataset("train")
    assert native._native_decode is not None
    monkeypatch.setattr(jax_dataset, "_native_decode", jax_decode)
    jax_native = jax_dataset.COCODataset("train")
    for i in range(len(native)):
        np.testing.assert_array_equal(native[i][0], jax_native[i][0])
        np.testing.assert_array_equal(plain[i][0], dataset.decode_image(
            native._img_path(native.caption_img_mappings[i]["img_id"])))

    img_id = native.img_ids[0]
    png = os.path.join(use_coco_root, "not_a_jpeg.png")
    Image.fromarray(np.zeros((10, 12, 3), np.uint8) + 7).save(png)
    monkeypatch.setattr(native, "_img_path", lambda i: png)
    np.testing.assert_array_equal(native._decode_img(img_id),
                                  np.full((224, 224, 3), 7, np.uint8))


def test_importing_the_dataset_builds_nothing(tmp_path):
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import icd_tpu_torch.data.dataset, icd_tpu_torch.native.imageio "
            "as m, sys; print(m._LIBRARY._lib is None)")
    env = dict(os.environ, PYTHONPATH=repo)
    env.pop("ICD_TPU_NATIVE_LOADER", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["True"]
