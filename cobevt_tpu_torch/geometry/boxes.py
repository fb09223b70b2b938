"""3D/2D bounding-box utilities: corner math, projection, IoU, NMS.

Counterpart of ``cobevt_tpu/geometry/boxes.py`` (reference
``opv2v/opencood/utils/box_utils.py`` and the Cython ``box_overlaps.pyx``),
numpy on the host:

  * center <-> corner conversions (``boxes_to_corners_3d``,
    ``boxes_to_corners2d``, ``boxes2d_to_corners2d``, ``corner_to_center``)
    in lwh or hwl order;
  * SE(3) projection of points and box corners, range masks;
  * axis-aligned IoU with the legacy +1 convention (``bbox_overlaps``,
    ``bbox_intersections``; ``utils/native_ops.py`` has the C++ twins);
  * rotated-rectangle IoU by Sutherland-Hodgman clipping and greedy rotated
    NMS (``rotated_iou``, ``nms_rotated``: the numpy route of
    ``utils/native_ops.py``).

``convex_clip_area`` clips every pair at once over a padded vertex buffer
(the JAX package walks the pairs in a Python loop); each vertex and area is
the same arithmetic in the same order.  ``nms_rotated`` keeps only the
``top`` best-scored candidates, as the JAX package's numpy route does; the
native route takes all of them.
"""

from __future__ import annotations

import numpy as np

_CORNER_TEMPLATE_3D = np.array(
    [[1, -1, -1], [1, 1, -1], [-1, 1, -1], [-1, -1, -1],
     [1, -1, 1], [1, 1, 1], [-1, 1, 1], [-1, -1, 1]], np.float32) / 2
_CORNER_TEMPLATE_2D = np.array(
    [[1, -1], [1, 1], [-1, 1], [-1, -1]], np.float32) / 2

# pairs clipped at once by rotated_iou (bounds its scratch to ~100 MB)
_CLIP_CHUNK = 1 << 16


def _rotz(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    zeros = np.zeros_like(c)
    ones = np.ones_like(c)
    return np.stack([
        np.stack([c, -s, zeros], -1),
        np.stack([s, c, zeros], -1),
        np.stack([zeros, zeros, ones], -1)], -2)


def boxes_to_corners_3d(boxes, order: str = "lwh"):
    """(N, 7) [x y z dx dy dz yaw] -> (N, 8, 3) corners (bottom 0-3, top
    4-7)."""
    boxes = np.asarray(boxes, np.float64)
    dims = boxes[:, 3:6]
    if order == "hwl":
        dims = dims[:, ::-1]
    corners = dims[:, None, :] * _CORNER_TEMPLATE_3D[None]
    corners = np.einsum("nij,nkj->nki", _rotz(boxes[:, 6]), corners)
    return corners + boxes[:, None, 0:3]


def boxes_to_corners2d(boxes, order: str = "lwh"):
    return boxes_to_corners_3d(boxes, order)[:, :4, :]


def boxes2d_to_corners2d(boxes2d):
    """(..., 5) [x y dx dy yaw] -> (..., 4, 2)."""
    b = np.asarray(boxes2d, np.float64).reshape(-1, 5)
    corners = b[:, None, 2:4] * _CORNER_TEMPLATE_2D[None]
    c, s = np.cos(b[:, 4]), np.sin(b[:, 4])
    R = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    corners = np.einsum("nij,nkj->nki", R, corners) + b[:, None, :2]
    return corners.reshape(*np.shape(boxes2d)[:-1], 4, 2)


def corner_to_center(corners, order: str = "lwh"):
    """(N, 8, 3) corners -> (N, 7) [x y z d1 d2 d3 yaw], each size and the
    yaw averaged over the box's four parallel edges."""
    c = np.asarray(corners, np.float64)
    xyz = c[:, [0, 3, 5, 6]].mean(axis=1)
    h = np.abs((c[:, 4:, 2] - c[:, :4, 2]).mean(axis=1))

    def edge(i, j):
        return np.linalg.norm(c[:, i, :2] - c[:, j, :2], axis=1)

    l = (edge(0, 3) + edge(2, 1) + edge(4, 7) + edge(5, 6)) / 4
    w = (edge(0, 1) + edge(2, 3) + edge(4, 5) + edge(6, 7)) / 4

    def ang(i, j):
        return np.arctan2(c[:, i, 1] - c[:, j, 1], c[:, i, 0] - c[:, j, 0])

    yaw = (ang(1, 2) + ang(0, 3) + ang(5, 6) + ang(4, 7)) / 4
    if order == "lwh":
        dims = np.stack([l, w, h], -1)
    elif order == "hwl":
        dims = np.stack([h, w, l], -1)
    else:
        raise ValueError(order)
    return np.concatenate([xyz, dims, yaw[:, None]], axis=1)


def project_points(points, transform):
    """(N, 3) points through a (4, 4) SE(3)."""
    p = np.asarray(points, np.float64)
    T = np.asarray(transform, np.float64)
    return p @ T[:3, :3].T + T[:3, 3]


def project_box3d(corners, transform):
    """(N, 8, 3) corners through a (4, 4) SE(3)."""
    c = np.asarray(corners, np.float64)
    T = np.asarray(transform, np.float64)
    return np.einsum("ij,nkj->nki", T[:3, :3], c) + T[:3, 3]


def mask_boxes_outside_range(boxes, limit_range, order: str = "lwh",
                             min_num_corners: int = 8):
    """Keep boxes with >= min_num_corners corners inside [x1 y1 z1 x2 y2
    z2]."""
    corners = boxes_to_corners_3d(boxes, order)
    lr = np.asarray(limit_range)
    inside = np.all((corners >= lr[:3]) & (corners <= lr[3:]), axis=2)
    return inside.sum(axis=1) >= min_num_corners


# ---------------------------------------------------------------------------
# axis-aligned IoU (the +1 convention of the Cython module)
# ---------------------------------------------------------------------------

def bbox_overlaps(boxes, query_boxes):
    """(N, 4) x (K, 4) -> (N, K) IoU with the Fast-RCNN +1 convention, in
    f32."""
    b = np.asarray(boxes, np.float32)
    q = np.asarray(query_boxes, np.float32)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    area_q = (q[:, 2] - q[:, 0] + 1) * (q[:, 3] - q[:, 1] + 1)
    iw = (np.minimum(b[:, None, 2], q[None, :, 2]) -
          np.maximum(b[:, None, 0], q[None, :, 0]) + 1).clip(min=0)
    ih = (np.minimum(b[:, None, 3], q[None, :, 3]) -
          np.maximum(b[:, None, 1], q[None, :, 1]) + 1).clip(min=0)
    inter = iw * ih
    union = area_b[:, None] + area_q[None] - inter
    out = np.where(inter > 0, inter / np.maximum(union, 1e-12), 0.0)
    return out.astype(np.float32)


def bbox_intersections(boxes, query_boxes):
    """(N, K) intersection / query area."""
    b = np.asarray(boxes, np.float32)
    q = np.asarray(query_boxes, np.float32)
    area_q = (q[:, 2] - q[:, 0] + 1) * (q[:, 3] - q[:, 1] + 1)
    iw = (np.minimum(b[:, None, 2], q[None, :, 2]) -
          np.maximum(b[:, None, 0], q[None, :, 0]) + 1).clip(min=0)
    ih = (np.minimum(b[:, None, 3], q[None, :, 3]) -
          np.maximum(b[:, None, 1], q[None, :, 1]) + 1).clip(min=0)
    return ((iw * ih > 0) * (iw * ih) / area_q[None]).astype(np.float32)


# ---------------------------------------------------------------------------
# rotated polygon IoU
# ---------------------------------------------------------------------------

def _polygon_area(poly, n_valid):
    """Shoelace area of padded polygons (B, V, 2) with n_valid (B,)."""
    B, V, _ = poly.shape
    idx = np.arange(V)
    nxt = (idx + 1) % np.maximum(n_valid[:, None], 1)
    x, y = poly[..., 0], poly[..., 1]
    x2 = np.take_along_axis(x, nxt, 1)
    y2 = np.take_along_axis(y, nxt, 1)
    valid = idx[None, :] < n_valid[:, None]
    cross = (x * y2 - x2 * y) * valid
    return np.abs(cross.sum(1)) / 2


def convex_clip_area(subject, clip):
    """Intersection area of convex quads.

    subject, clip: (B, 4, 2).  Sutherland-Hodgman over all B pairs at once
    with a padded vertex buffer (at most 8 vertices after clipping a quad
    by a quad): against each clip edge, every vertex on the inner side is
    kept, then the crossing of its outgoing edge, if any, and the kept
    points are packed to the front.  Returns (B,)."""
    subject = np.asarray(subject, np.float64)
    clip = np.asarray(clip, np.float64)
    B = subject.shape[0]
    MAXV = 9
    poly = np.zeros((B, MAXV, 2))
    poly[:, :4] = subject
    n_valid = np.full(B, 4)
    slots = np.arange(MAXV)
    # polygons wound either way: orient by the clip polygon's signed area
    clip_ccw = np.sign(
        (clip[:, 1, 0] - clip[:, 0, 0]) * (clip[:, 2, 1] - clip[:, 1, 1]) -
        (clip[:, 1, 1] - clip[:, 0, 1]) * (clip[:, 2, 0] - clip[:, 1, 0]))
    clip_ccw = np.where(clip_ccw == 0, 1.0, clip_ccw)

    for e in range(4):
        a = clip[:, e]
        edge = clip[:, (e + 1) % 4] - a
        rel = poly - a[:, None]
        side = (edge[:, None, 0] * rel[..., 1] -
                edge[:, None, 1] * rel[..., 0]) * clip_ccw[:, None]
        live = n_valid >= 3
        valid = (slots[None] < n_valid[:, None]) & live[:, None]
        nxt_idx = (slots[None] + 1) % np.maximum(n_valid[:, None], 1)
        nxt = np.take_along_axis(poly, nxt_idx[..., None], 1)
        s_nxt = np.take_along_axis(side, nxt_idx, 1)
        inner = side >= 0
        keep = valid & inner
        cross = valid & (inner != (s_nxt >= 0))
        t = side / np.where(cross, side - s_nxt, 1.0)
        crossing = poly + t[..., None] * (nxt - poly)
        # each vertex's output in order: itself, then its edge's crossing
        cand = np.stack([poly, crossing], 2).reshape(B, 2 * MAXV, 2)
        flag = np.stack([keep, cross], 2).reshape(B, 2 * MAXV)
        pos = np.cumsum(flag, 1) - 1
        new_poly = np.zeros_like(poly)
        bi, ci = np.nonzero(flag & (pos < MAXV))
        new_poly[bi, pos[bi, ci]] = cand[bi, ci]
        poly = new_poly
        n_valid = np.minimum(np.where(live, flag.sum(1), 0), MAXV)

    return _polygon_area(poly, n_valid)


def _circles(corners):
    """(centers (N, 2), radii (N,)) of the circles around the corners."""
    center = corners.mean(axis=1)
    return center, np.linalg.norm(corners - center[:, None],
                                  axis=2).max(axis=1)


def rotated_iou(corners_a, corners_b):
    """Pairwise IoU of rotated rectangles given as (N, 4, 2) / (K, 4, 2)
    corner sets -> (N, K).  Only the pairs whose bounding circles meet are
    clipped: the others are apart by more than rounding, so their clip
    leaves no vertex and their intersection is 0."""
    a = np.asarray(corners_a, np.float64)
    bq = np.asarray(corners_b, np.float64)
    N, K = len(a), len(bq)
    if N == 0 or K == 0:
        return np.zeros((N, K))
    ca, ra = _circles(a)
    cb, rb = _circles(bq)
    reach = (ra[:, None] + rb[None]) * (1 + 1e-6) + 1e-6
    ia, ib = np.nonzero(np.linalg.norm(ca[:, None] - cb[None], axis=2)
                        <= reach)
    inter = np.zeros((N, K))
    for i in range(0, len(ia), _CLIP_CHUNK):
        pa, pb = ia[i:i + _CLIP_CHUNK], ib[i:i + _CLIP_CHUNK]
        inter[pa, pb] = convex_clip_area(a[pa], bq[pb])
    area_a = _polygon_area(a, np.full(N, 4))
    area_b = _polygon_area(bq, np.full(K, 4))
    union = area_a[:, None] + area_b[None] - inter
    return inter / np.maximum(union, 1e-12)


def nms_rotated(corners, scores, threshold: float, top: int = 1000):
    """Greedy rotated NMS on (N, 4, 2) corner boxes over the ``top``
    best-scored candidates; returns kept indices sorted by descending
    score."""
    corners = np.asarray(corners, np.float64)
    scores = np.asarray(scores, np.float64)
    if corners.shape[0] == 0:
        return np.array([], np.int32)
    order = scores.argsort()[::-1][:top]
    ious = rotated_iou(corners[order], corners[order])
    keep = []
    alive = np.ones(len(order), bool)
    for i in range(len(order)):
        if not alive[i]:
            continue
        keep.append(order[i])
        alive[i + 1:] &= ious[i, i + 1:] <= threshold
    return np.array(keep, np.int32)
