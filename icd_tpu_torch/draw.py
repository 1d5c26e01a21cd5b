"""Filled shapes on an RGB canvas, rasterised as Pillow 12 rasterises
them (``Image.new("RGB", ...)`` + ``ImageDraw.Draw(img).rectangle /
ellipse / polygon(..., fill=...)``), in numpy and without PIL.

The rules are those of Pillow's ``libImaging/Draw.c``: a rectangle covers
its corners inclusively; an ellipse is the filled quarter-ellipse walk of
``ellipse_new`` (points (2x + x0, 2y + y0) that stay closest to the curve,
mirrored into four quarters, one horizontal span per row); a polygon is
filled by ``polygon_generic``'s scanline rule (edge crossings at each row
in float, spans from ROUND_UP of the left crossing to ROUND_DOWN of the
right one, horizontal edges drawn as lines). Every span is clipped to the
canvas. Rectangles, ellipses and the triangles that ``make_synthetic_coco``
draws are equal to Pillow's pixel for pixel (``tests/test_torch_draw.py``);
Pillow's extra rules for other polygon corners ("connect discontiguous
corners" in ``polygon_generic``) are not reproduced, so rows through such
a corner may differ.
"""

import math

import numpy as np


class Canvas:
    """An (H, W, 3) uint8 RGB image of one colour (``Image.new``) with
    Pillow's filled shapes; ``pixels`` is the array."""

    def __init__(self, size, color):
        w, h = size
        self.pixels = np.empty((h, w, 3), np.uint8)
        self.pixels[...] = np.asarray(color, np.uint8)

    def _hline(self, x0, y, x1, fill):
        h, w = self.pixels.shape[:2]
        if y < 0 or y >= h:
            return
        if x0 < 0:
            x0 = 0
        elif x0 >= w:
            return
        if x1 < 0:
            return
        if x1 >= w:
            x1 = w - 1
        if x0 <= x1:
            self.pixels[y, x0:x1 + 1] = fill

    def rectangle(self, xy, fill):
        """Filled rectangle [x0, y0, x1, y1], corners included."""
        x0, y0, x1, y1 = (int(v) for v in xy)
        if x1 < x0 or y1 < y0:
            raise ValueError("x1 must be >= x0 and y1 >= y0")
        h = self.pixels.shape[0]
        if y0 >= h or y1 < 0:
            return
        for y in range(max(y0, 0), min(y1, h) + 1):
            self._hline(x0, y, x1, fill)

    def ellipse(self, xy, fill):
        """Filled ellipse inside the box [x0, y0, x1, y1]."""
        x0, y0, x1, y1 = (int(v) for v in xy)
        if x1 < x0 or y1 < y0:
            raise ValueError("x1 must be >= x0 and y1 >= y0")
        a, b = x1 - x0, y1 - y0
        for lx, y, rx in _ellipse_spans(a, b, a + b):
            self._hline(x0 + (lx + a) // 2, y0 + (y + b) // 2,
                        x0 + (rx + a) // 2, fill)

    def polygon(self, xy, fill):
        """Filled polygon through the points [(x, y), ...]."""
        pts = [(int(x), int(y)) for x, y in xy]
        edges = [_Edge(*pts[i], *pts[i + 1]) for i in range(len(pts) - 1)]
        if pts[-1] != pts[0]:
            edges.append(_Edge(*pts[-1], *pts[0]))
        self._polygon_fill(edges, fill)

    def _polygon_fill(self, edges, fill):
        h = self.pixels.shape[0]
        ymin, ymax = h - 1, 0
        table = []
        for e in edges:
            ymin = min(ymin, e.ymin)
            ymax = max(ymax, e.ymax)
            if e.ymin == e.ymax:
                self._hline(e.xmin, e.ymin, e.xmax, fill)
                continue
            table.append(e)
        ymin = max(ymin, 0)
        ymax = min(ymax, h)
        for y in range(ymin, ymax + 1):
            xx = []
            for e in table:
                if not e.ymin <= y <= e.ymax:
                    continue
                xx.append(_f32(_f32((y - e.y0) * e.dx) + e.x0))
                if y == e.ymax and y < ymax:
                    xx.append(xx[-1])
            xx.sort()
            for i in range(1, len(xx), 2):
                x_start, x_end = _round_up(xx[i - 1]), _round_down(xx[i])
                if x_end >= x_start:
                    self._hline(x_start, y, x_end, fill)


def _f32(v):
    return float(np.float32(v))


def _round_up(f):  # Draw.c ROUND_UP
    return int(math.floor(f + 0.5) if f >= 0.0 else -math.floor(abs(f) + 0.5))


def _round_down(f):  # Draw.c ROUND_DOWN
    return int(math.ceil(f - 0.5) if f >= 0.0 else -math.ceil(abs(f) - 0.5))


class _Edge:  # Draw.c add_edge
    def __init__(self, x0, y0, x1, y1):
        self.xmin, self.xmax = min(x0, x1), max(x0, x1)
        self.ymin, self.ymax = min(y0, y1), max(y0, y1)
        self.dx = 0.0 if y0 == y1 else _f32(_f32(x1 - x0) / _f32(y1 - y0))
        self.x0, self.y0 = x0, y0


def _quarter(a, b):
    """Points of ellipse_new's top-right quarter walk (quarter_next)."""
    if a < 0 or b < 0:
        return
    a2, b2 = a * a, b * b
    a2b2 = a2 * b2

    def delta(x, y):
        return abs(a2 * y * y + b2 * x * x - a2b2)

    cx, cy, ex, ey = a, b % 2, a % 2, b
    while True:
        yield cx, cy
        if cx == ex and cy == ey:
            return
        nx, ny = cx, cy + 2
        nd = delta(nx, ny)
        if nx > 1:
            d2 = delta(cx - 2, cy + 2)
            if nd > d2:
                nx, ny, nd = cx - 2, cy + 2, d2
            d2 = delta(cx - 2, cy)
            if nd > d2:
                nx, ny = cx - 2, cy
        cx, cy = nx, ny


def _ellipse_spans(a, b, width):
    """(x0, y, x1) spans of ellipse_next, in doubled coordinates."""
    outer = _quarter(a, b)
    first = next(outer, None)
    if width < 1 or first is None:
        return
    leftmost = a % 2
    pr, py = first
    inner = _quarter(a - 2 * (width - 1), b - 2 * (width - 1))
    pl = leftmost
    finished = False
    while not finished:
        y, l, r = py, pl, pr
        nxt = None
        for cx, cy in outer:
            if cy > y:
                nxt = (cx, cy)
                break
        if nxt is None:
            finished = True
        else:
            pr, py = nxt
        nxt = None
        for cx, cy in inner:
            if cy > y:
                nxt = (cx, cy)
                break
            l = cx
        pl = leftmost if nxt is None else nxt[0]
        spans = []
        if (l > 0 or l < r) and y > 0:
            spans.append((2 if l == 0 else l, y, r))
        if y > 0:
            spans.append((-r, y, -l))
        if l > 0 or l < r:
            spans.append((2 if l == 0 else l, -y, r))
        spans.append((-r, -y, -l))
        yield from reversed(spans)
