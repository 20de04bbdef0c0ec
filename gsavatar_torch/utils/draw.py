"""OpenCV's integer rasterizers for 8-bit images, on numpy arrays.

The JAX package's tooling draws with `cv2.line`, `cv2.circle` and
`cv2.drawContours(..., cv2.FILLED)`. The port has no OpenCV, so this module
computes the same pixels, following imgproc/src/drawing.cpp step for step
with Python's integers:

- `line`: `cv::line` with `LINE_8` and no sub-pixel shift. Thickness 1 is
  the 8-connected `LineIterator` walk (end points clipped to the image,
  drawn left to right). A thicker line has its ends clipped to the image
  grown by the thickness on every side, as OpenCV 4.10 and later clip
  them, then is a quadrilateral in 16-bit fixed point (`XY_SHIFT`) filled
  by `FillConvexPoly`, whose edges are drawn by `Line2`, plus a filled
  disc of radius (thickness + 1) // 2 at each end.
- `circle`: the filled `cv::circle`, the midpoint `Circle` of horizontal
  spans.
- `fill_poly`: `cv::fillPoly` (which `drawContours` with `FILLED` calls):
  each polygon's outline drawn by `Line`, its edges collected in fixed
  point (x at the vertex, the slope truncated), then the edge-table scan
  of `FillEdgeCollection` with its bubble sort of the active edges. A
  row's span runs from the left
  edge's x rounded up to the right edge's rounded down, as OpenCV 4.10 and
  later fill. For polygons whose vertices lie in the image this is
  OpenCV's result pixel for pixel (tests/test_torch_contours.py); an edge
  that leaves the image may differ from it at the image's border.

Images are (H, W) or (H, W, C) uint8 arrays, drawn on in place. A colour is
an int or a sequence of ints, one per channel (missing channels are 0)."""
from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _color(img: np.ndarray, color) -> np.ndarray:
    """`scalarToRawData` for an 8-bit image: one value per channel."""
    c = [color] if np.isscalar(color) else list(color)
    n = 1 if img.ndim == 2 else img.shape[2]
    c = (c + [0] * n)[:n]
    return np.asarray([min(max(int(round(v)), 0), 255) for v in c],
                      np.uint8)


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    """`ICV_HLINE`: pixels x1..x2 of row y."""
    if x1 <= x2:
        img[y, x1:x2 + 1] = color


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """`cv::clipLine` for a w x h rectangle: (inside, x1, y1, x2, y2)."""
    if w <= 0 or h <= 0:
        return False, x1, y1, x2, y2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return ((x < 0) + (x > right) * 2 + (y < 0) * 4
                + (y > bottom) * 8)

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line_pixels(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """The pixels `LineIterator(img, pt1, pt2, 8, leftToRight=true)` walks,
    as (xs, ys) lists."""
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return [], []
    dx, dy = x2 - x1, y2 - y1
    delta_x = delta_y = 1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    if dy < 0:
        dy, delta_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
        delta_x, delta_y = delta_y, delta_x
    err = dx - (dy + dy)
    plus_delta, minus_delta = dx + dx, -(dy + dy)
    minus_shift, plus_shift, minus_step, plus_step = delta_x, 0, 0, delta_y
    if vert:
        plus_step, plus_shift = plus_shift, plus_step
        minus_step, minus_shift = minus_shift, minus_step
    xs, ys = [], []
    x, y = x1, y1
    for _ in range(dx + 1):
        xs.append(x)
        ys.append(y)
        if err < 0:
            err += minus_delta + plus_delta
            x += minus_shift + plus_shift
            y += minus_step + plus_step
        else:
            err += minus_delta
            x += minus_shift
            y += minus_step
    return xs, ys


def _line(img, x1, y1, x2, y2, color) -> None:
    """drawing.cpp's `Line` (8-connected)."""
    xs, ys = _line_pixels(img.shape[1], img.shape[0], x1, y1, x2, y2)
    if xs:
        img[ys, xs] = color


def _line2(img, x1, y1, x2, y2, color) -> None:
    """drawing.cpp's `Line2`: a line between 16-bit fixed-point ends."""
    h, w = img.shape[:2]
    inside, x1, y1, x2, y2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT,
                                       x1, y1, x2, y2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    j = -1 if dx < 0 else 0
    ax = (dx ^ j) - j
    i = -1 if dy < 0 else 0
    ay = (dy ^ i) - i
    if ax > ay:
        dy = (dy ^ j) - j
        if j:
            x1, y1, x2, y2 = x2, y2, x1, y1
        y_step = _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        dx = (dx ^ i) - i
        if i:
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step = _tdiv(dx << XY_SHIFT, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    xs = [(x2 + (XY_ONE >> 1)) >> XY_SHIFT]
    ys = [(y2 + (XY_ONE >> 1)) >> XY_SHIFT]
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            xs.append(x1)
            ys.append(y1 >> XY_SHIFT)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            xs.append(x1 >> XY_SHIFT)
            ys.append(y1)
            x1 += x_step
            y1 += 1
            ecount -= 1
    xs, ys = np.asarray(xs), np.asarray(ys)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def _circle(img, cx: int, cy: int, radius: int, color) -> None:
    """drawing.cpp's filled `Circle`: horizontal spans by the midpoint
    recurrence."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = (cx >= radius and cx < w - radius and cy >= radius
              and cy < h - radius)
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            _hline(img, y11, x11, x12, color)
            _hline(img, y12, x11, x12, color)
            _hline(img, y21, x21, x22, color)
            _hline(img, y22, x21, x22, color)
        elif x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            if 0 <= y11 < h:
                _hline(img, y11, x11, x12, color)
            if 0 <= y12 < h:
                _hline(img, y12, x11, x12, color)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                if 0 <= y21 < h:
                    _hline(img, y21, x21, x22, color)
                if 0 <= y22 < h:
                    _hline(img, y22, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _fill_convex_poly(img, v: Sequence[tuple], color, shift: int) -> None:
    """drawing.cpp's `FillConvexPoly` for `LINE_8`."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = 1 << shift >> 1
    delta1 = delta2 = XY_ONE >> 1
    p0 = (v[-1][0] << (XY_SHIFT - shift), v[-1][1] << (XY_SHIFT - shift))
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i in range(npts):
        px, py = v[i]
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = (px << (XY_SHIFT - shift), py << (XY_SHIFT - shift))
        if shift == 0:
            _line(img, p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT,
                  p[0] >> XY_SHIFT, p[1] >> XY_SHIFT, color)
        else:
            _line2(img, p0[0], p0[1], p[0], p[1], color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per side: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << (XY_SHIFT - shift)
                        xe = v[idx][0] << (XY_SHIFT - shift)
                        e[4] = ty
                        e[3] = _tdiv((xe - xs) * 2 + (ty - y),
                                     2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            xx1 = (edge[left][2] + delta1) >> XY_SHIFT
            xx2 = (edge[right][2] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """`cv2.line(img, pt1, pt2, color, thickness)` (`LINE_8`), in place."""
    if not 0 < thickness <= 32767:
        raise ValueError(f"thickness {thickness} is not in [1, 32767]")
    c = _color(img, color)
    x0, y0, x1, y1 = int(pt1[0]), int(pt1[1]), int(pt2[0]), int(pt2[1])
    if thickness > 1:
        # the ends clipped to the image grown by the thickness on each side
        h, w = img.shape[:2]
        t = thickness
        inside, x0, y0, x1, y1 = _clip_line(w + 2 * t, h + 2 * t, x0 + t,
                                           y0 + t, x1 + t, y1 + t)
        if not inside:
            return img
        x0, y0, x1, y1 = x0 - t, y0 - t, x1 - t, y1 - t
    x0, y0, x1, y1 = (v << XY_SHIFT for v in (x0, y0, x1, y1))
    if thickness <= 1:
        r = XY_ONE >> 1
        _line(img, (x0 + r) >> XY_SHIFT, (y0 + r) >> XY_SHIFT,
              (x1 + r) >> XY_SHIFT, (y1 + r) >> XY_SHIFT, c)
        return img
    dx = (x0 - x1) * (1.0 / XY_ONE)
    dy = (y1 - y0) * (1.0 / XY_ONE)
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if math.fabs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = round(dy * r), round(dx * r)
        _fill_convex_poly(img, [(x0 + dpx, y0 + dpy), (x0 - dpx, y0 - dpy),
                                (x1 - dpx, y1 - dpy), (x1 + dpx, y1 + dpy)],
                          c, XY_SHIFT)
    rad = (thickness + (XY_ONE >> 1)) >> XY_SHIFT
    for px, py in ((x0, y0), (x1, y1)):
        _circle(img, (px + (XY_ONE >> 1)) >> XY_SHIFT,
                (py + (XY_ONE >> 1)) >> XY_SHIFT, rad, c)
    return img


def circle(img: np.ndarray, center, radius: int, color) -> np.ndarray:
    """`cv2.circle(img, center, radius, color, -1)`: a filled disc, in
    place."""
    if radius < 0:
        raise ValueError(f"radius {radius} < 0")
    _circle(img, int(center[0]), int(center[1]), int(radius),
            _color(img, color))
    return img


def _collect_poly_edges(img, poly, color, edges: list) -> None:
    """drawing.cpp's `CollectPolyEdges` (`LINE_8`, no shift or offset):
    draws the outline and appends [y0, y1, x, dx] per non-horizontal
    edge, x in 16-bit fixed point; an edge that leaves the image starts
    from its end points clipped to it."""
    h, w = img.shape[:2]
    pts = [(int(x) << XY_SHIFT, int(y)) for x, y in poly]
    pt0 = pts[-1]
    for pt1 in pts:
        t0x = (pt0[0] + (XY_ONE >> 1)) >> XY_SHIFT
        t1x = (pt1[0] + (XY_ONE >> 1)) >> XY_SHIFT
        t0y, t1y = pt0[1], pt1[1]
        _line(img, t0x, t0y, t1x, t1y, color)
        c0, c1 = list(pt0), list(pt1)
        if not (0 <= t0x < w and 0 <= t1x < w and 0 <= t0y < h
                and 0 <= t1y < h):
            _, t0x, t0y, t1x, t1y = _clip_line(w, h, t0x, t0y, t1x, t1y)
            if t0y != t1y:
                c0 = [t0x << XY_SHIFT, t0y]
                c1 = [t1x << XY_SHIFT, t1y]
        if pt0[1] != pt1[1]:
            dx = _tdiv(c1[0] - c0[0], c1[1] - c0[1])
            if pt0[1] < pt1[1]:
                edges.append([pt0[1], pt1[1],
                              c0[0] + (pt0[1] - c0[1]) * dx, dx])
            else:
                edges.append([pt1[1], pt0[1],
                              c1[0] + (pt1[1] - c1[1]) * dx, dx])
        pt0 = pt1


def _fill_edge_collection(img, edges: list, color) -> None:
    """drawing.cpp's `FillEdgeCollection` (`LINE_8`)."""
    h, w = img.shape[:2]
    total = len(edges)
    if total < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    x_ends = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3]
                                      for e in edges]
    if y_max < 0 or y_min >= h or max(x_ends) < 0 \
            or min(x_ends) >= (w << XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e[0], e[2], e[3]))
    sentinel = [2 ** 31 - 1, 0, 0, 0]
    i = 0
    e = edges[0]
    y_max = min(y_max, h)
    active: list = []
    for y in range(e[0], y_max):
        draw = False
        k = 0
        prelast = None
        while k < len(active) or e[0] == y:
            last = active[k] if k < len(active) else None
            if last is not None and last[1] == y:
                del active[k]
                continue
            keep_prelast = prelast
            if last is not None and (e[0] > y or last[2] < e[2]):
                prelast = last
                k += 1
            elif i < total:
                active.insert(k, e)
                prelast = e
                k += 1
                i += 1
                e = edges[i] if i < total else sentinel
            else:
                break
            if draw:
                if y >= 0:
                    if keep_prelast[2] > prelast[2]:
                        x1 = (prelast[2] + XY_ONE - 1) >> XY_SHIFT
                        x2 = keep_prelast[2] >> XY_SHIFT
                    else:
                        x1 = (keep_prelast[2] + XY_ONE - 1) >> XY_SHIFT
                        x2 = prelast[2] >> XY_SHIFT
                    if x1 < w and x2 >= 0:
                        _hline(img, y, max(x1, 0), min(x2, w - 1), color)
                keep_prelast[2] += keep_prelast[3]
                prelast[2] += prelast[3]
            draw = not draw
        # the active list's bubble sort: each pass stops at the edge the
        # pass before moved last
        keep = None
        while True:
            j = 0
            last_exchange = None
            while j + 1 < len(active) and active[j] is not keep:
                a, b = active[j], active[j + 1]
                if a[2] > b[2]:
                    active[j], active[j + 1] = b, a
                    last_exchange = b
                j += 1
            if last_exchange is None:
                break
            keep = last_exchange
            if keep is active[0]:
                break


def fill_poly(img: np.ndarray, polys: Iterable, color) -> np.ndarray:
    """`cv2.fillPoly(img, polys, color)` (`LINE_8`), which is what
    `cv2.drawContours(img, polys, -1, color, cv2.FILLED)` draws: every
    polygon's outline, then one even-odd fill over all their edges; in
    place. `polys` is a sequence of (N, 2) integer point arrays."""
    c = _color(img, color)
    edges: list = []
    for poly in polys:
        poly = np.asarray(poly).reshape(-1, 2)
        if len(poly):
            _collect_poly_edges(img, poly.tolist(), c, edges)
    _fill_edge_collection(img, edges, c)
    return img
