"""Generate a learnable synthetic COCO-2014 layout without PIL (the
port of ``tools/make_synthetic_coco.py``)::

    python -m icd_tpu_torch.make_synthetic_coco <root> [--train 300]
        [--val 40] [--seed 0] [--captions_per_image 1] [--img_size 224]
        [--train_captions N] [--val_captions N] [--realistic]
        [--acceptance_scale]

Each image shows one colored shape at a quadrant; the caption describes
it ("a red circle in the top left of the image ."). The flags, the numpy
random stream, the annotation JSON (byte for byte) and the file names are
the JAX tool's; the shapes are drawn by ``draw.Canvas`` (Pillow's
rasterisation) and written by the port's JPEG encoder at Pillow's
``save(path)`` defaults (quality 75, 4:2:0, JFIF), so a machine with no
PIL writes the same corpus. ``--acceptance_scale`` is the full
BASELINE.json protocol corpus (82,783 / 40,504 images at 640x480,
414,113 / 202,654 realistic captions).
"""


import argparse
import json
import os

import numpy as np

from .draw import Canvas
from .native import jpeg

COLORS = {"red": (220, 40, 40), "green": (40, 180, 60),
          "blue": (50, 80, 220), "yellow": (230, 210, 40)}
SHAPES = ["circle", "square", "triangle"]
POSITIONS = {"top left": (0.25, 0.25), "top right": (0.75, 0.25),
             "bottom left": (0.25, 0.75), "bottom right": (0.75, 0.75)}

# Pseudo-word surface forms: deterministic syllable spellings so filler
# words look/tokenize like English tokens (4-8 chars), not like ids.
_SYLLABLES = ["ba", "de", "ki", "lo", "mu", "na", "po", "ri", "su",
              "ta", "vel", "wor", "zan", "fen", "gol", "him"]


def pseudo_word(rank):
    """Deterministic pseudo-word for a vocabulary rank (base-16
    syllable digits, prefixed so no rank collides with a real word)."""
    syl = []
    r = rank
    while True:
        syl.append(_SYLLABLES[r % len(_SYLLABLES)])
        r //= len(_SYLLABLES)
        if r == 0:
            break
    return "".join(reversed(syl))


class FillerVocab:
    """Zipf 'common' pool (kept by the threshold-6 vocab build) plus a
    huge uniform 'rare' pool (dropped by it) — mimics real caption
    corpora where ~10k of ~30k+ observed types clear the threshold."""

    def __init__(self, rng, common=9500, rare=300000, rare_frac=0.02):
        self.rng = rng
        ranks = np.arange(1, common + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.common_p = p / p.sum()
        self.common = common
        self.rare = rare
        self.rare_frac = rare_frac

    def words(self, k):
        out = []
        commons = self.rng.choice(
            self.common, size=k, p=self.common_p)
        rare_mask = self.rng.random(k) < self.rare_frac
        rares = self.rng.integers(0, self.rare, size=k)
        for c, is_rare, r in zip(commons, rare_mask, rares):
            idx = (self.common + int(r)) if is_rare else int(c)
            out.append(pseudo_word(idx))
        return out


def draw_sample(rng, size=224, filler=None, n_captions=1):
    if isinstance(size, int):
        w = h = size
    else:
        w, h = size
    scale = min(w, h) / 224.0
    color = rng.choice(list(COLORS))
    shape = rng.choice(SHAPES)
    pos = rng.choice(list(POSITIONS))
    img = Canvas((w, h), tuple(int(v) for v in rng.integers(180, 240, 3)))
    jit = int(round(15 * scale))
    cx, cy = (int(POSITIONS[pos][0] * w + rng.integers(-jit, jit + 1)),
              int(POSITIONS[pos][1] * h + rng.integers(-jit, jit + 1)))
    r = int(rng.integers(int(25 * scale), int(45 * scale)))
    rgb = COLORS[color]
    if shape == "circle":
        img.ellipse([cx - r, cy - r, cx + r, cy + r], rgb)
    elif shape == "square":
        img.rectangle([cx - r, cy - r, cx + r, cy + r], rgb)
    else:
        img.polygon([(cx, cy - r), (cx - r, cy + r), (cx + r, cy + r)], rgb)
    if filler is None:
        caption = "a {} {} in the {} of the image .".format(
            color, shape, pos)
        return img, [caption] * n_captions
    # Realistic-statistics captions: the learnable shape description
    # with Zipf/rare filler words woven in (first caption stays clean).
    captions = ["a {} {} in the {} of the image .".format(
        color, shape, pos)]
    for _ in range(n_captions - 1):
        f = filler.words(3)
        captions.append(
            "a {} {} {} {} in the {} of the {} image .".format(
                f[0], f[1], color, shape, pos, f[2]))
    return img, captions[:n_captions]


def make_split(root, split, n, seed, captions_per_image=1,
               img_size=224, total_captions=None, realistic=False,
               quiet=False):
    rng = np.random.default_rng(seed)
    filler = FillerVocab(rng) if realistic else None
    img_dir = os.path.join(root, "cocoapi", "images",
                           "{}2014".format(split))
    os.makedirs(img_dir, exist_ok=True)
    if total_captions is not None:
        base = captions_per_image
        extra = total_captions - n * base
        assert 0 <= extra <= n, (total_captions, n, base)
    else:
        extra = 0
    images, annotations = [], []
    if isinstance(img_size, int):
        w, h = img_size, img_size
    else:
        w, h = img_size
    for i in range(n):
        img_id = i + (1 if split == "train" else 100000)
        n_caps = captions_per_image + (1 if i < extra else 0)
        img, captions = draw_sample(rng, size=(w, h), filler=filler,
                                    n_captions=n_caps)
        file_name = "COCO_{}2014_{:012d}.jpg".format(split, img_id)
        with open(os.path.join(img_dir, file_name), "wb") as f:
            f.write(jpeg.encode(img.pixels))  # Pillow's save() defaults
        images.append({"id": img_id, "file_name": file_name,
                       "height": h, "width": w})
        for k, caption in enumerate(captions):
            annotations.append({"id": img_id * 10 + k,
                                "image_id": img_id,
                                "caption": caption})
        if not quiet and n >= 20000 and (i + 1) % 20000 == 0:
            print("{}: {}/{} images".format(split, i + 1, n),
                  flush=True)
    anno_dir = os.path.join(root, "cocoapi", "annotations")
    os.makedirs(anno_dir, exist_ok=True)
    with open(os.path.join(
            anno_dir, "captions_{}2014.json".format(split)), "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    print("{}: {} images, {} captions".format(
        split, n, len(annotations)))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("root")
    parser.add_argument("--train", type=int, default=300)
    parser.add_argument("--val", type=int, default=40)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--captions_per_image", type=int, default=1)
    parser.add_argument("--img_size", default="224",
                        help="square size or WxH (e.g. 640x480)")
    parser.add_argument("--train_captions", type=int, default=None)
    parser.add_argument("--val_captions", type=int, default=None)
    parser.add_argument("--realistic", action="store_true",
                        help="Zipf+rare filler words for real vocab "
                             "statistics")
    parser.add_argument("--acceptance_scale", action="store_true",
                        help="the full BASELINE.json protocol corpus: "
                             "82,783/40,504 images at 640x480, "
                             "414,113/202,654 realistic captions")
    args = parser.parse_args(argv)
    if args.acceptance_scale:
        args.train, args.val = 82783, 40504
        args.train_captions, args.val_captions = 414113, 202654
        args.captions_per_image = 5
        args.img_size = "640x480"
        args.realistic = True
    if "x" in args.img_size:
        size = tuple(int(v) for v in args.img_size.split("x"))
    else:
        size = int(args.img_size)
    make_split(args.root, "train", args.train, args.seed,
               captions_per_image=args.captions_per_image,
               img_size=size, total_captions=args.train_captions,
               realistic=args.realistic)
    make_split(args.root, "val", args.val, args.seed + 1,
               captions_per_image=args.captions_per_image,
               img_size=size, total_captions=args.val_captions,
               realistic=args.realistic)
    for sub in ("pkldata", "checkpoints", "eval_data"):
        os.makedirs(os.path.join(args.root, sub), exist_ok=True)


if __name__ == "__main__":
    main()
