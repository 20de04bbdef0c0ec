"""OpenCV's contour functions for binary masks, on numpy arrays.

The JAX package turns a mask into polygons with `cv2.findContours`
(`RETR_EXTERNAL`, `CHAIN_APPROX_SIMPLE`), `cv2.contourArea`,
`cv2.arcLength` and `cv2.approxPolyDP`. The port has no OpenCV; these
functions give the same points and the same floats, following
imgproc/src/contours.cpp, shapedescr.cpp and approx.cpp:

- `find_contours`: Suzuki and Abe's border following on the mask padded by
  one zero pixel, nonzero pixels as 1. The raster scan starts an outer
  border at a 0 -> 1 step unless the last border pixel met on the row
  is one that is not a right edge (the step is then inside a hole of a
  traced component, and `RETR_EXTERNAL` skips it); holes are never
  traced. Each border is followed counter-clockwise from its first pixel,
  marking its pixels 2, or 130 (OpenCV's -126) where the border's right
  edge is, and keeps a point where the chain code turns. The contours
  come out in reverse order of discovery, as OpenCV lists them.
- `contour_area`: the shoelace sum in float64, halved, absolute.
- `arc_length`: the closed polygon's float32 edge lengths added in
  float64, in order.
- `approx_poly_dp`: OpenCV's closed-curve Douglas-Peucker: the split
  point from three passes of "farthest point from the current start",
  an explicit stack of ranges split at the point farthest from the
  range's segment (the distance to the segment, not to its line, as
  OpenCV 4.10 and later measure it; in exact integers here), then the
  pass that drops a vertex nearly on the line through its neighbours.

Points are (N, 2) int32 arrays of (x, y)."""
from __future__ import annotations

import math

import numpy as np

# chain code s -> (dx, dy): right, up-right, up, up-left, left, down-left,
# down, down-right
_CODE_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_CODE_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_NBD = 2
_NBD_RIGHT = 130          # (nbd | -128) as an unsigned byte


def _follow(img: bytearray, deltas, i0: int, x: int, y: int,
            is_hole: bool) -> list:
    """`icvFetchContour` with `CHAIN_APPROX_SIMPLE`: follow the border that
    starts at flat index i0 (pixel (x, y) of the mask), mark it, and
    return its turning points."""
    s_end = s = 0 if is_hole else 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if img[i1] != 0 or s == s_end:
            break
    if s == s_end:                       # a single pixel
        img[i0] = _NBD_RIGHT
        return [(x, y)]
    pts = []
    i3 = i0
    prev_s = s ^ 4
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:              # the border's right edge
            img[i3] = _NBD_RIGHT
        elif img[i3] == 1:
            img[i3] = _NBD
        if s != prev_s:
            pts.append((x, y))
            prev_s = s
        x += _CODE_DX[s]
        y += _CODE_DY[s]
        if i4 == i0 and i3 == i1:
            return pts
        i3 = i4
        s = (s + 4) & 7


def find_contours(mask: np.ndarray) -> list:
    """`cv2.findContours(mask, cv2.RETR_EXTERNAL,
    cv2.CHAIN_APPROX_SIMPLE)[0]` of a 2-D array (nonzero = inside), each
    contour as an (N, 2) int32 array."""
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"find_contours takes a 2-D mask, got "
                         f"{mask.shape}")
    h, w = mask.shape
    step = w + 2
    padded = np.zeros((h + 2, step), np.uint8)
    padded[1:-1, 1:-1] = mask != 0
    img = bytearray(padded.tobytes())
    view = np.frombuffer(img, np.uint8).reshape(h + 2, step)
    d = (1, -step + 1, -step, -step - 1, -1, step - 1, step, step + 1)
    deltas = d + d
    width = step - 1
    found = []
    for y in range(1, h + 1):
        row = y * step
        rowv = view[y]
        lnbd = row                       # (0, y): the padding
        prev = 0
        x = 1
        while True:
            nz = np.flatnonzero(rowv[x:width] != prev)
            if not len(nz):
                break
            x += int(nz[0])
            p = img[row + x]
            if prev == 0 and p == 1:
                # an outer border, unless the last border met is inside
                # a traced component
                if not 1 <= img[lnbd] <= 127:
                    lnbd = row + x
                    found.append(_follow(img, deltas, row + x, x - 1,
                                         y - 1, False))
                    prev = img[row + x]
                    x += 1
                    continue
            prev = p
            if prev > 1:
                lnbd = row + x
            x += 1
    return [np.asarray(c, np.int32).reshape(-1, 2) for c in reversed(found)]


def contour_area(contour: np.ndarray) -> float:
    """`cv2.contourArea(contour)` of integer points."""
    pts = np.asarray(contour, np.int64).reshape(-1, 2)
    if len(pts) == 0:
        return 0.0
    x, y = pts[:, 0].tolist(), pts[:, 1].tolist()
    a = 0
    px, py = x[-1], y[-1]
    for cx, cy in zip(x, y):
        a += px * cy - py * cx
        px, py = cx, cy
    return math.fabs(float(a) * 0.5)


def arc_length(contour: np.ndarray, closed: bool = True) -> float:
    """`cv2.arcLength(contour, closed)` of integer points: each edge's
    length in float32, the lengths added in float64 in order."""
    pts = np.asarray(contour).reshape(-1, 2).astype(np.float32)
    n = len(pts)
    if n <= 1:
        return 0.0
    prev = np.concatenate([pts[-1:] if closed else pts[:1], pts[:-1]])
    dx = pts[:, 0] - prev[:, 0]
    dy = pts[:, 1] - prev[:, 1]
    seg = np.sqrt(dx * dx + dy * dy).astype(np.float64)
    return float(np.cumsum(seg)[-1])


def _segment_d2(pt, a, b, dx, dy, len2):
    """The squared distance of `pt` from the segment a-b, times the
    segment's squared length `len2` (1 where a = b), in exact integers."""
    px, py = pt[0] - a[0], pt[1] - a[1]
    dot = px * dx + py * dy
    if len2 == 0 or dot <= 0:
        return (px * px + py * py) * max(len2, 1)
    if dot >= len2:
        qx, qy = pt[0] - b[0], pt[1] - b[1]
        return (qx * qx + qy * qy) * len2
    cross = py * dx - px * dy
    return cross * cross


def approx_poly_dp(contour: np.ndarray, epsilon: float,
                   closed: bool = True) -> np.ndarray:
    """`cv2.approxPolyDP(contour, epsilon, closed)` of integer points, as
    an (M, 2) int32 array."""
    if epsilon < 0.0 or not epsilon < 1e30:
        raise ValueError("Epsilon not valid.")
    src = [tuple(p) for p in np.asarray(contour).reshape(-1, 2).tolist()]
    count = len(src)
    if count == 0:
        return np.zeros((0, 2), np.int32)
    dst = [None] * count
    new_count = 0
    eps = epsilon * epsilon
    is_closed = closed
    init_iters = 3
    stack = []
    start_pt = end_pt = None
    pos = 0
    rs_start = rs_end = 0           # right_slice
    sl_start = sl_end = 0           # slice

    if not is_closed:
        rs_start = count
        end_pt, start_pt = src[0], src[count - 1]
        if start_pt != end_pt:
            stack.append((0, count - 1))
        else:
            is_closed = True
            init_iters = 1
    if is_closed:
        # 1. two roughly farthest points of the contour
        rs_start = 0
        le_eps = False
        for _ in range(init_iters):
            max_dist = 0.0
            pos = (pos + rs_start) % count
            start_pt = src[pos]
            pos = pos + 1 if pos + 1 < count else 0
            for j in range(1, count):
                pt = src[pos]
                pos = pos + 1 if pos + 1 < count else 0
                dx = float(pt[0] - start_pt[0])
                dy = float(pt[1] - start_pt[1])
                dist = dx * dx + dy * dy
                if dist > max_dist:
                    max_dist = dist
                    rs_start = j
            le_eps = max_dist <= eps
        # 2. the stack's first two ranges
        if not le_eps:
            rs_end = sl_start = pos % count
            sl_end = rs_start = (rs_start + sl_start) % count
            stack.append((rs_start, rs_end))
            stack.append((sl_start, sl_end))
        else:
            dst[new_count] = start_pt
            new_count += 1

    # 3. the recursion, by the stack
    while stack:
        sl_start, sl_end = stack.pop()
        end_pt = src[sl_end]
        pos = sl_start
        start_pt = src[pos]
        pos = pos + 1 if pos + 1 < count else 0
        if pos != sl_end:
            # squared distances to the segment, times its squared length
            max_d2 = 0
            dx, dy = end_pt[0] - start_pt[0], end_pt[1] - start_pt[1]
            len2 = dx * dx + dy * dy
            while pos != sl_end:
                pt = src[pos]
                pos = pos + 1 if pos + 1 < count else 0
                d2 = _segment_d2(pt, start_pt, end_pt, dx, dy, len2)
                if d2 > max_d2:
                    max_d2 = d2
                    rs_start = (pos + count - 1) % count
            le_eps = max_d2 <= eps * max(len2, 1)
        else:
            le_eps = True
            start_pt = src[sl_start]
        if le_eps:
            dst[new_count] = start_pt
            new_count += 1
        else:
            stack.append((rs_start, sl_end))
            stack.append((sl_start, rs_start))

    if not is_closed:
        dst[new_count] = src[count - 1]
        new_count += 1

    # 4. drop the vertices that lie nearly on their neighbours' line
    is_closed = closed
    count = new_count
    pos = count - 1 if is_closed else 0
    start_pt = dst[pos]
    pos = pos + 1 if pos + 1 < count else 0
    wpos = pos
    pt = dst[pos]
    pos = pos + 1 if pos + 1 < count else 0
    i = 0 if is_closed else 1
    while i < count - (0 if is_closed else 1) and new_count > 2:
        end_pt = dst[pos]
        pos = pos + 1 if pos + 1 < count else 0
        dx = float(end_pt[0] - start_pt[0])
        dy = float(end_pt[1] - start_pt[1])
        dist = math.fabs((pt[0] - start_pt[0]) * dy
                         - (pt[1] - start_pt[1]) * dx)
        inner = ((pt[0] - start_pt[0]) * (end_pt[0] - pt[0])
                 + (pt[1] - start_pt[1]) * (end_pt[1] - pt[1]))
        if (dist * dist <= 0.5 * eps * (dx * dx + dy * dy) and dx != 0
                and dy != 0 and inner >= 0):
            new_count -= 1
            dst[wpos] = start_pt = end_pt
            wpos = wpos + 1 if wpos + 1 < count else 0
            pt = dst[pos]
            pos = pos + 1 if pos + 1 < count else 0
            i += 2
            continue
        dst[wpos] = start_pt = pt
        wpos = wpos + 1 if wpos + 1 < count else 0
        pt = end_pt
        i += 1
    if not is_closed:
        dst[wpos] = pt
    return np.asarray(dst[:new_count], np.int32).reshape(-1, 2)
