"""The port's JPEG codec (``icd_tpu_torch/native/jpeg.py``) against
Pillow over libjpeg-turbo, on the CPU:

- the decoder equals ``Image.open(f).convert("RGB")`` with tolerance 0 on
  files that Pillow writes (each subsampling, qualities 5 to 100,
  progressive, optimized tables, restart markers, grey, CMYK, an EXIF
  orientation, sizes from 1x1 to 481x641) and on files of the port's
  encoder that Pillow cannot write (vertical-only subsampling);
- the resize equals ``resize((w, h), Image.BILINEAR)`` exactly, down, up
  and at identity;
- the encoder writes the same bytes as Pillow's ``save`` (whole files,
  so the scan bytes too) for the same uint8 array;
- truncated, corrupt and unsupported files raise ``ValueError``;
- two threads decode at once to the serial result;
- PIL decodes ``testing.codec_corpus()`` to ``CODEC_CORPUS_DIGEST``, the
  constant ``chip_smoke.py`` holds the card machine's build to.
"""

import io
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from icd_tpu_torch import testing
from icd_tpu_torch.native import jpeg


def _content(w, h, seed, noise=24):
    """Low-frequency content plus noise, (h, w, 3) uint8."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (max(1, h // 8), max(1, w // 8), 3),
                         dtype=np.uint8)
    img = np.asarray(Image.fromarray(small).resize((w, h), Image.BILINEAR),
                     np.int16)
    img = img + rng.integers(-noise, noise + 1, img.shape, dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_save(arr, mode=None, **kwargs):
    img = Image.fromarray(arr)
    if mode is not None:
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kwargs)
    return buf.getvalue()


def _pil_decode(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _exif_rotated(arr):
    exif = Image.Exif()
    exif[0x0112] = 6  # orientation: rotate 90 CW on display
    return _pil_save(arr, exif=exif.tobytes())


DECODE_CASES = {
    "444": lambda: _pil_save(_content(64, 48, 1), subsampling="4:4:4"),
    "422": lambda: _pil_save(_content(64, 48, 2), subsampling="4:2:2"),
    "420": lambda: _pil_save(_content(64, 48, 3), subsampling="4:2:0"),
    "q5": lambda: _pil_save(_content(64, 48, 4), quality=5),
    "q50": lambda: _pil_save(_content(64, 48, 5), quality=50),
    "q75": lambda: _pil_save(_content(64, 48, 6), quality=75),
    "q95": lambda: _pil_save(_content(64, 48, 7), quality=95),
    "q100_444": lambda: _pil_save(_content(64, 48, 8), quality=100,
                                  subsampling="4:4:4"),
    "progressive_420": lambda: _pil_save(_content(97, 61, 9),
                                         progressive=True),
    "progressive_444_q95": lambda: _pil_save(
        _content(97, 61, 10), progressive=True, subsampling="4:4:4",
        quality=95),
    "progressive_422_q5": lambda: _pil_save(
        _content(97, 61, 11), progressive=True, subsampling="4:2:2",
        quality=5),
    "optimize": lambda: _pil_save(_content(97, 61, 12), optimize=True),
    "restart_marker_blocks": lambda: _pil_save(_content(97, 61, 13),
                                               restart_marker_blocks=3),
    "restart_marker_rows": lambda: _pil_save(_content(97, 61, 14),
                                             restart_marker_rows=1),
    "progressive_restart": lambda: _pil_save(
        _content(97, 61, 15), progressive=True, restart_marker_blocks=5),
    "L": lambda: _pil_save(_content(97, 61, 16), mode="L"),
    "L_progressive": lambda: _pil_save(_content(97, 61, 17), mode="L",
                                       progressive=True),
    "CMYK": lambda: _pil_save(_content(97, 61, 18), mode="CMYK"),
    "CMYK_progressive": lambda: _pil_save(_content(97, 61, 19), mode="CMYK",
                                          progressive=True, quality=90),
    "exif_orientation": lambda: _exif_rotated(_content(64, 48, 20)),
    "1x1": lambda: _pil_save(_content(1, 1, 21)),
    "8x8": lambda: _pil_save(_content(8, 8, 22)),
    "17x9": lambda: _pil_save(_content(17, 9, 23)),
    "17x9_422": lambda: _pil_save(_content(17, 9, 24), subsampling="4:2:2"),
    "3x5_420": lambda: _pil_save(_content(3, 5, 25)),  # box upsampling
    "481x641": lambda: _pil_save(_content(481, 641, 26)),
    "640x480": lambda: _pil_save(_content(640, 480, 27)),
    "640x480_progressive": lambda: _pil_save(_content(640, 480, 28),
                                             progressive=True, quality=90),
    "h1v2_port_encoder": lambda: jpeg.encode(_content(97, 61, 29),
                                             subsampling="4:4:0"),
    "h1v2_17x9_port_encoder": lambda: jpeg.encode(
        _content(17, 9, 30), subsampling="4:4:0", progressive=True),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_equals_pil(case):
    data = DECODE_CASES[case]()
    want = _pil_decode(data)
    got = jpeg.decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)  # tolerance 0
    assert jpeg.size(data) == (want.shape[1], want.shape[0])


@pytest.mark.parametrize("src,dst", [
    ((640, 480), (224, 224)),   # down
    ((100, 60), (224, 224)),    # up
    ((224, 224), (224, 224)),   # identity
    ((481, 641), (224, 224)),
    ((17, 9), (5, 3)),
    ((1, 1), (224, 224)),
    ((60, 100), (37, 301)),     # down one way, up the other
])
def test_resize_equals_pil_bilinear(src, dst):
    arr = _content(*src, seed=src[0] * 7 + dst[0])
    want = np.asarray(Image.fromarray(arr).resize(dst, Image.BILINEAR))
    np.testing.assert_array_equal(jpeg.resize_bilinear(arr, *dst), want)


def test_decode_resize_equals_pil():
    data = _pil_save(_content(640, 480, 31))
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB").resize(
        (224, 224), Image.BILINEAR))
    np.testing.assert_array_equal(jpeg.decode_resize(data, 224, 224), want)


ENCODE_CASES = {
    "default": {},
    "q5": dict(quality=5),
    "q50": dict(quality=50),
    "q95": dict(quality=95),
    "q100": dict(quality=100),
    "444": dict(subsampling="4:4:4"),
    "422": dict(subsampling="4:2:2"),
    "optimize": dict(optimize=True),
    "progressive": dict(progressive=True),
    "progressive_444_q90": dict(progressive=True, subsampling="4:4:4",
                                quality=90),
    "restart_marker_blocks": dict(restart_marker_blocks=2),
    "restart_marker_rows": dict(restart_marker_rows=1),
    "progressive_restart": dict(progressive=True, restart_marker_blocks=5),
}


@pytest.mark.parametrize("size", [(1, 1), (17, 9), (640, 480)])
@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_encode_writes_pils_bytes(case, size):
    """Whole files equal, headers and scans: what Pillow's save writes."""
    arr = _content(*size, seed=size[0] + len(case))
    kwargs = ENCODE_CASES[case]
    assert jpeg.encode(arr, **kwargs) == _pil_save(arr, **kwargs)


@pytest.mark.parametrize("kwargs", [{}, dict(progressive=True),
                                    dict(optimize=True)])
def test_encode_grey_writes_pils_bytes(kwargs):
    grey = _content(97, 61, 32)[..., 1]
    assert jpeg.encode(grey, **kwargs) == _pil_save(grey, **kwargs)


def _file():
    return _pil_save(_content(64, 48, 33), progressive=True)


def _with_sof(data, byte_at, value):
    sof = data.index(b"\xff\xc2")
    return data[:sof + byte_at] + bytes([value]) + data[sof + byte_at + 1:]


BAD_FILES = {
    "truncated_half": (lambda d: d[:len(d) // 2], "truncated"),
    "no_eoi": (lambda d: d[:-2], "truncated"),
    "scan_cut_by_eoi": (lambda d: d[:d.index(b"\xff\xda") + 40] + b"\xff\xd9",
                        "ends early"),
    "12_bit": (lambda d: _with_sof(d, 4, 12), "12-bit"),
    "arithmetic": (lambda d: _with_sof(d, 1, 0xCA), "arithmetic"),
    "lossless": (lambda d: _with_sof(d, 1, 0xC3), "lossless"),
    "not_a_jpeg": (lambda d: b"\x89PNG\r\n\x1a\n" + d[2:], "not a JPEG"),
    "empty": (lambda d: b"", "not a JPEG"),
}


@pytest.mark.parametrize("case", sorted(BAD_FILES))
def test_bad_files_raise(case):
    corrupt, match = BAD_FILES[case]
    data = corrupt(_file())
    with pytest.raises(ValueError, match=match):
        jpeg.decode(data)
    with pytest.raises(ValueError, match=match):
        jpeg.decode_resize(data, 8, 8)


def test_two_threads_decode_at_once():
    files = [_pil_save(_content(160, 120, 40 + i), progressive=i % 2 == 0)
             for i in range(16)]
    serial = [jpeg.decode_resize(f, 64, 64) for f in files]
    with ThreadPoolExecutor(2) as pool:
        threaded = list(pool.map(lambda f: jpeg.decode_resize(f, 64, 64),
                                 files * 4))
    for i, arr in enumerate(threaded):
        np.testing.assert_array_equal(arr, serial[i % len(files)])


def test_codec_corpus_digest_is_pils():
    corpus = testing.codec_corpus()
    assert len(corpus) == len(testing.CODEC_CORPUS) >= 24
    pil = [_pil_decode(data) for _, data in corpus]
    assert testing.pixel_digest(pil) == testing.CODEC_CORPUS_DIGEST
    ours = [jpeg.decode(data) for _, data in corpus]
    assert testing.pixel_digest(ours) == testing.CODEC_CORPUS_DIGEST
