"""The port's OpenCV contour and polygon-fill functions against OpenCV on
the CPU: `utils/contours.py` (`find_contours` = `cv2.findContours` with
`RETR_EXTERNAL` and `CHAIN_APPROX_SIMPLE`, `contour_area`, `arc_length`,
`approx_poly_dp`) and `utils/draw.fill_poly` (`cv2.fillPoly`, which
`cv2.drawContours(..., cv2.FILLED)` draws).

Tolerances: none. Contours equal point for point and in OpenCV's order,
areas and lengths equal as floats, simplified polygons and filled masks
equal pixel for pixel. The masks are seeded: random fields, blobs with
holes, nested and touching components, masks that touch the border,
one-pixel and one-row components, and a body-sized blob at 1080x1920."""
import numpy as np
import pytest

import torch_dist_workers  # noqa: F401  (torch on one thread)

from gsavatar_torch.utils import contours as C
from gsavatar_torch.utils import draw

cv2 = pytest.importorskip("cv2")

EPS_FRACS = (0.0003, 0.01, 0.05, 0.2)


def _ellipse(h, w, cx, cy, a, b, theta=0.0):
    yy, xx = np.mgrid[:h, :w]
    u = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
    v = -(xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)
    return (u / a) ** 2 + (v / b) ** 2 < 1


def _random_field(rng):
    h, w = rng.integers(1, 40, 2)
    return rng.random((h, w)) < rng.uniform(0.2, 0.8)


def _blobs_with_holes(rng):
    h, w = rng.integers(20, 90, 2)
    m = np.zeros((h, w), bool)
    for _ in range(int(rng.integers(1, 6))):
        cx, cy = rng.integers(0, w), rng.integers(0, h)
        a, b = rng.integers(3, 30, 2)
        e = _ellipse(h, w, cx, cy, a, b, rng.uniform(0, np.pi))
        m |= e
        if rng.random() < 0.6:
            m &= ~_ellipse(h, w, cx, cy, a / 2.5, b / 2.5)
    return m


def _nested(rng):
    """Rings inside rings (each an island in the hole of the last) and
    components touching at a corner."""
    h, w = rng.integers(30, 90, 2)
    m = np.zeros((h, w), bool)
    cx, cy = w / 2 + rng.uniform(-3, 3), h / 2 + rng.uniform(-3, 3)
    r = min(h, w) / 2
    for k in range(int(rng.integers(1, 4))):
        outer, inner = r * (1 - 0.3 * k), r * (0.85 - 0.3 * k)
        if inner <= 1:
            break
        m |= _ellipse(h, w, cx, cy, outer, outer) \
            & ~_ellipse(h, w, cx, cy, inner, inner)
    y, x = rng.integers(0, h - 2), rng.integers(0, w - 2)
    m[y, x] = m[y + 1, x + 1] = True
    m[y + 1, x] = m[y, x + 1] = False
    return m


def _border(rng):
    h, w = rng.integers(2, 40, 2)
    m = np.ones((h, w), bool)
    m[1:-1, 1:-1] = rng.random((h - 2, w - 2)) < 0.5
    return m


def _thin(rng):
    h, w = rng.integers(1, 40, 2)
    m = np.zeros((h, w), bool)
    m[rng.integers(0, h), :] = True
    if rng.random() < 0.5:
        m[:, rng.integers(0, w)] = True
    for _ in range(int(rng.integers(1, 6))):
        m[rng.integers(0, h), rng.integers(0, w)] = True
    return m


KINDS = {'random': _random_field, 'holes': _blobs_with_holes,
         'nested': _nested, 'border': _border, 'thin': _thin}


def _reference(mask):
    ref, _ = cv2.findContours(mask.astype(np.uint8) * 255,
                              cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    return [r.reshape(-1, 2) for r in ref]


def _assert_same_contours(mask):
    ref = _reference(mask)
    got = C.find_contours(mask.astype(np.uint8) * 255)
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
        assert C.contour_area(g) == cv2.contourArea(r)
        assert C.arc_length(g, True) == cv2.arcLength(r, True)
        for frac in EPS_FRACS:
            eps = frac * cv2.arcLength(r, True)
            np.testing.assert_array_equal(
                C.approx_poly_dp(g, eps, True),
                cv2.approxPolyDP(r, eps, True).reshape(-1, 2))
    return ref


@pytest.mark.parametrize('kind', sorted(KINDS))
def test_contours_match_opencv(kind):
    rng = np.random.default_rng(sorted(KINDS).index(kind))
    for _ in range(60):
        _assert_same_contours(KINDS[kind](rng))


def test_contours_of_a_body_blob_at_1080p():
    """One body-sized blob with a hole and a limb touching the border at
    the custom-video size, and its recovered mask."""
    h, w = 1080, 1920
    m = _ellipse(h, w, 960, 560, 260, 470)
    m |= _ellipse(h, w, 960, 300, 520, 45)
    m |= _ellipse(h, w, 1500, 1050, 60, 200, 0.4)
    m &= ~_ellipse(h, w, 960, 620, 60, 95)
    ref = _assert_same_contours(m)
    a = np.zeros((h, w), np.uint8)
    b = np.zeros((h, w), np.uint8)
    for r in ref:
        poly = cv2.approxPolyDP(r, 0.0003 * cv2.arcLength(r, True), True)
        cv2.drawContours(a, [poly], -1, 255, cv2.FILLED)
        draw.fill_poly(b, [poly.reshape(-1, 2)], 255)
    np.testing.assert_array_equal(b, a)


def test_contour_scalars_on_points():
    rng = np.random.default_rng(11)
    for n in (0, 1, 2, 3, 17):
        pts = rng.integers(-50, 50, (n, 2)).astype(np.int32)
        assert C.contour_area(pts) == cv2.contourArea(pts)
        for closed in (True, False):
            assert C.arc_length(pts, closed) == cv2.arcLength(pts, closed)
    with pytest.raises(ValueError):
        C.approx_poly_dp(np.zeros((3, 2), np.int32), -1.0)


@pytest.mark.parametrize('n_points', [3, 4, 6, 9])
def test_fill_poly_matches_opencv(n_points):
    """Polygons with vertices in the image, convex or self-intersecting,
    alone and several in one call, 1 and 3 channels."""
    rng = np.random.default_rng(n_points)
    for t in range(150):
        polys = [rng.integers(0, 48, (n_points, 2)).astype(np.int32)
                 for _ in range(1 + t % 3)]
        color = (255,) if t % 2 else (10, 200, 30)
        shape = (48, 48) if t % 2 else (48, 48, 3)
        a = np.zeros(shape, np.uint8)
        b = np.zeros(shape, np.uint8)
        cv2.fillPoly(a, polys, color)
        draw.fill_poly(b, polys, color)
        np.testing.assert_array_equal(b, a)
        a[:] = 0
        b[:] = 0
        cv2.drawContours(a, polys, -1, color, cv2.FILLED)
        draw.fill_poly(b, polys, color)
        np.testing.assert_array_equal(b, a)


def test_fill_poly_off_the_image_delta():
    """The one delta left against OpenCV: a polygon with a vertex off the
    image may differ from `cv2.fillPoly` at the image's border. Over 3000
    seeded polygons of 3-11 vertices, half inside a 64^2 image and half
    reaching 30 pixels beyond it, none inside differs, 55 outside do, by
    at most 63 pixels (held here so that a change shows)."""
    rng = np.random.default_rng(7)
    off, worst = 0, 0
    for t in range(3000):
        n = int(rng.integers(3, 12))
        inside = t % 2 == 0
        P = (rng.integers(0, 64, (n, 2)) if inside
             else rng.integers(-30, 94, (n, 2))).astype(np.int32)
        a = np.zeros((64, 64, 3), np.uint8)
        b = np.zeros((64, 64, 3), np.uint8)
        cv2.fillPoly(a, [P], (1, 2, 3))
        draw.fill_poly(b, [P], (1, 2, 3))
        d = int((a != b).any(2).sum())
        assert not (inside and d), t
        off += d > 0
        worst = max(worst, d)
    assert (off, worst) == (55, 63)
