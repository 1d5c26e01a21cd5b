"""COCO captioning dataset (copy of ``icd_tpu/data/dataset.py``).

``COCODataset(mode)`` indexes the split's annotations and keeps the
reference's caption filter: a caption joins the caption <-> image
mapping when its *character* length is at most ``caption_max_len``
(reference: dataset.py:33-34; -1 disables it). An item is one caption:
``(img, caption ids)`` in train mode, and in val mode also the image
path and every caption of the image (dataset.py:66-71); a caption is
``word_tokenize(caption.lower())`` wrapped in ``<start>`` / ``<end>``.
Images are decoded and resized to 224 x 224 BILINEAR as uint8 NHWC with
the pixels of the JAX package's default loader (PIL): a file that starts
with JPEG's SOI marker is read by the port's own codec
(``native/jpeg.py``), whose decode and resize equal PIL's to the bit, so
JPEGs need no PIL and no libjpeg; any other format goes to PIL, imported
in the call.

The JAX package's host-side speed aids, each leaving the pixels (and so
the losses) as they were:
 - ``ICD_TPU_IMAGE_CACHE`` (GB; 0 or unset: off): decoded images kept
   in host memory by id up to that budget, read-only arrays shared
   across samples (one sample per caption reads each COCO image ~5
   times an epoch, dataset.py:44-57);
 - ``ICD_TPU_NATIVE_LOADER=1``: JPEGs decoded by the native libjpeg
   loader (``native/imageio.py``, built at first use) instead; its
   pixels differ from PIL's by less than one level on average, so it is
   opt-in; where it cannot be built or a decode fails, ``decode_image``
   decodes;
 - ``return_ids``: train items carry their image id, which the
   loader's collate puts in ``img_ids`` (``pipeline.DeviceImageCache``).
"""

import os

import numpy as np

from ..native import jpeg
from ..pathconf import PathConfig
from ..vocabulary import END_TOKEN, START_TOKEN, load_vocab
from .coco import COCO
from .tokenize import word_tokenize

IMG_SIZE = 224  # transforms.Resize((224, 224)) in every reference entry point.


_MAGIC = ((b"\x89PNG", "PNG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))


def _format_name(data):
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    for magic, name in _MAGIC:
        if data.startswith(magic):
            return name
    return "unknown"


def decode_image(path, size=IMG_SIZE):
    """(size, size, 3) uint8 RGB equal to PIL's
    ``Image.open(path).convert("RGB").resize((size, size), BILINEAR)``: a
    JPEG (the bytes start with FF D8) through the port's codec, any other
    format through PIL."""
    with open(path, "rb") as f:
        data = f.read()
    if jpeg.is_jpeg(data):
        return jpeg.decode_resize(data, size, size)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "{} is a {} file, and only JPEG is read without PIL".format(
                path, _format_name(data))) from e
    img = Image.open(path).convert("RGB")
    img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def native_decoder():
    """The native loader's ``decode_resize_jpeg`` when
    ``ICD_TPU_NATIVE_LOADER`` is set and its library builds, else None
    (dataset.py:30-41)."""
    if not os.environ.get("ICD_TPU_NATIVE_LOADER"):
        return None
    from ..native import imageio

    return imageio.decode_resize_jpeg if imageio.available() else None


def image_cache_budget():
    """Bytes of decoded images to keep in host memory, from
    ``ICD_TPU_IMAGE_CACHE`` (GB; 0 or unset: off) (dataset.py:44)."""
    return int(float(os.environ.get("ICD_TPU_IMAGE_CACHE", "0") or 0)
               * (1 << 30))


class COCODataset:
    """The caption <-> image index of one split (reference: dataset.py:14)."""

    def __init__(self, mode, caption_max_len=50, vocab=None,
                 img_size=IMG_SIZE):
        if mode not in ("train", "val"):
            raise ValueError("mode is 'train' or 'val', got {!r}".format(mode))
        self.mode = mode
        # Train items carry their img_id as a third element when set
        # (the device image cache's protocol; the reference yields
        # (img, caption), dataset.py:66-67).
        self.return_ids = False
        self.vocab = vocab if vocab is not None else load_vocab()
        self.caption_max_len = (caption_max_len if caption_max_len != -1
                                else float("inf"))
        self.img_size = img_size
        self.anno_file = get_anno_file(mode)
        self.img_dir = get_img_dir(mode)
        self.coco = COCO(self.anno_file)
        self.img_ids = list(sorted(self.coco.imgs.keys()))
        self.caption_img_mappings = self._build_caption_img_mappings()
        self._caption_cache = {}
        self._img_cache = {}
        self._img_cache_budget = image_cache_budget()
        self._img_cache_bytes = 0
        self._native_decode = native_decoder()

    def _build_caption_img_mappings(self):
        mappings = []
        for img_id in self.img_ids:
            anns = self._annotations(img_id)
            mappings.extend(
                {"caption": ann["caption"], "img_id": img_id}
                for ann in anns
                if len(ann["caption"]) <= self.caption_max_len)
        return mappings

    def _annotations(self, img_id):
        return self.coco.loadAnns(self.coco.getAnnIds(imgIds=img_id))

    def _numericalize_caption(self, caption):
        """int32 ids of ``<start>`` + the caption's tokens + ``<end>``,
        memoised (val items re-read every caption of their image)."""
        caption = str(caption)
        ids = self._caption_cache.get(caption)
        if ids is None:
            ids = [self.vocab(START_TOKEN)]
            ids.extend(self.vocab(token)
                       for token in word_tokenize(caption.lower()))
            ids.append(self.vocab(END_TOKEN))
            ids = np.asarray(ids, dtype=np.int32)
            ids.flags.writeable = False  # shared across samples
            self._caption_cache[caption] = ids
        return ids

    def _img_path(self, img_id):
        return os.path.join(
            self.img_dir, self.coco.loadImgs(img_id)[0]["file_name"])

    def _decode_img(self, img_id):
        path = self._img_path(img_id)
        arr = None
        if self._native_decode is not None and path.lower().endswith(
                (".jpg", ".jpeg")):
            with open(path, "rb") as f:
                arr = self._native_decode(f.read(), self.img_size,
                                          self.img_size)
        if arr is None:  # not a JPEG, or the decode failed
            arr = decode_image(path, self.img_size)
        return arr

    def _load_img(self, img_id):
        """The image's (H, W, 3) uint8 pixels, from the host cache when it
        holds them (dataset.py:126)."""
        arr = self._img_cache.get(img_id)
        if arr is None:
            arr = self._decode_img(img_id)
            if self._img_cache_bytes + arr.nbytes <= self._img_cache_budget:
                arr.flags.writeable = False  # shared across samples
                # dict operations hold the GIL; a racing duplicate decode
                # of the loader's threads stores an equal array.
                self._img_cache[img_id] = arr
                self._img_cache_bytes += arr.nbytes
        return arr

    def load_image_batch(self, img_ids):
        """Decoded images for the given ids: (N, H, W, 3) uint8."""
        return np.stack([self._load_img(i) for i in img_ids])

    def __getitem__(self, idx):
        mapping = self.caption_img_mappings[idx]
        img_id = mapping["img_id"]
        img = self._load_img(img_id)
        caption = self._numericalize_caption(mapping["caption"])
        if self.mode == "train":
            if self.return_ids:
                return img, caption, img_id
            return img, caption
        all_captions = [self._numericalize_caption(ann["caption"])
                        for ann in self._annotations(img_id)]
        return img, caption, self._img_path(img_id), all_captions

    def __len__(self):
        # Number of captions; an image can have several.
        return len(self.caption_img_mappings)


def get_anno_file(mode):
    if mode == "train":
        return PathConfig.train_anno_file
    return PathConfig.val_anno_file


def get_img_dir(mode):
    if mode == "train":
        return PathConfig.train_img_dir
    return PathConfig.val_img_dir
