"""Edge-case operands for the rotated-IoU kernels and the max-IoU assigner,
made with numpy from a seed. The CPU tests hold the port against jdet_tpu
on them, and `chip_smoke.py` holds the kernels against their plain
versions on them."""
import numpy as np


def edge_case_boxes(K=10, N=300, seed=3):
    """Identical, crossed and touching anchors beside random ones: gts
    (2, K, 5), the second image the first reversed, and anchors (N, 5)."""
    rng = np.random.RandomState(seed)

    def boxes(n):
        return np.stack([rng.uniform(0, 500, n), rng.uniform(0, 500, n),
                         rng.uniform(8, 200, n), rng.uniform(8, 120, n),
                         rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)

    gts, an = boxes(K), boxes(N)
    an[:K] = gts
    an[K:2 * K] = gts
    an[K:2 * K, 4] += np.pi / 2
    an[2 * K:3 * K] = gts
    an[2 * K:3 * K, 0] += gts[:, 2]
    return np.stack([gts, gts[::-1]]), an


def degenerate_boxes(N=256, seed=5):
    """Operands where the generic IoU's degenerate cases live: gts (2, K,
    5), the second image the first reversed, anchors (N, 5), and a (2, K, N)
    bool mask of the pairs whose values are compared.

    A pair with a sub-pixel box (zero-size, needle, thin) has an IoU that
    the Green sums compute as a ratio of areas from cross products of size
    (|d| + r_g + r_a)^2, d the offset of the centers, r = w/2 + h/2; fp32
    gives it to about 1e-7 * (|d| + r_g + r_a)^2 / max(area_g, area_a),
    which reaches 0.16 for a zero-size gt against a needle 360 px away.
    Such pairs whose estimate exceeds 2e-5 are left out of the value
    comparison, the gt parked at FAR_CENTER (-1e6) among them: their values
    are rounding noise in every implementation.

    gts: a zero-size box inside the image (its generic IoU is ~1 against
    every anchor), two needles (1e-4 x 50), thin boxes (40 x 0.5), boxes at
    exact multiples of pi/2, boxes near 1e4, the parked gt, and random
    boxes. Anchors: each gt itself, the thin boxes' neighbours along their
    common line (10 px apart and end to end), neighbours 1e-3 apart, the
    same boxes turned by pi/2, boxes near 1e4, then random ones."""
    rng = np.random.RandomState(seed)
    h2 = np.float32(np.pi / 2)
    special = np.array([
        [500, 500, 0, 0, 0.3],  # zero-size
        [300, 200, 1e-4, 50, 0.7],  # needles
        [350, 400, 50, 1e-4, 0.0],
        [100, 100, 40, 0.5, 0.0],  # thin, along x
        [700, 300, 40, 0.5, np.pi / 4],  # thin, along the diagonal
        [600, 600, 30, 20, 0.0],
        [200, 700, 60, 24, h2],  # multiples of pi/2
        [800, 800, 36, 36, 2 * h2],
        [450, 900, 48, 16, -h2],
        [9000, 9500, 120, 40, 1.0],  # near 1e4
        [9999, 9998, 64, 32, 4 * h2],
        [-1e6, -1e6, 0, 0, 0],  # parked padding
    ], np.float32)
    rand = np.stack([rng.uniform(0, 1000, 4), rng.uniform(0, 1000, 4),
                     rng.uniform(8, 200, 4), rng.uniform(8, 120, 4),
                     rng.uniform(-np.pi, np.pi, 4)], 1).astype(np.float32)
    gts = np.concatenate([special, rand])
    diag = np.float32([np.cos(np.pi / 4), np.sin(np.pi / 4)])
    near = [
        gts[3] + [50, 0, 0, 0, 0],  # 10 px beyond the thin box's end
        gts[3] + [40, 0, 0, 0, 0],  # end to end
        np.r_[gts[4][:2] + 50 * diag, gts[4][2:]],  # the same, on the diagonal
        np.r_[gts[4][:2] + 40 * diag, gts[4][2:]],
        gts[5] + [30.001, 0, 0, 0, 0],  # 1e-3 apart
        gts[5] + [0, 20.001, 0, 0, 0],
        gts[6] + [0, 0, 0, 0, h2],  # turned by pi/2
        gts[7] + [0, 0, 0, 0, h2],
        np.r_[gts[6][:2], gts[6][3], gts[6][2], 0],  # the same box, w and h swapped
        gts[9] + [60, 0, 0, 0, 0],  # near 1e4
        gts[9] + [300, 0, 0, 0, 0],
        [10000, 10000, 50, 50, 0],
        gts[1] + [0, 0, 10, 0, 0],  # a needle widened to 10
        gts[2] + [0, 10, 0, 0, 0],
    ]
    an = np.concatenate([gts[:11], np.asarray(near, np.float32)])
    n_rand = N - len(an)
    rand = np.stack([rng.uniform(0, 1000, n_rand), rng.uniform(0, 1000, n_rand),
                     rng.uniform(8, 200, n_rand), rng.uniform(8, 120, n_rand),
                     rng.uniform(-np.pi, np.pi, n_rand)], 1).astype(np.float32)
    an = np.concatenate([an, rand]).astype(np.float32)
    gts = np.stack([gts, gts[::-1]])
    g, a = gts.astype(np.float64)[:, :, None], an.astype(np.float64)
    reach = (np.hypot(a[:, 0] - g[..., 0], a[:, 1] - g[..., 1])
             + (g[..., 2] + g[..., 3] + a[:, 2] + a[:, 3]) / 2)
    area = np.maximum(g[..., 2] * g[..., 3], a[:, 2] * a[:, 3])
    sub_pixel = (np.minimum(g[..., 2], g[..., 3]) < 1) | (np.minimum(a[:, 2], a[:, 3]) < 1)
    checked = ~sub_pixel | (1e-7 * reach ** 2 <= 2e-5 * area)
    return gts, an, checked


# the assigner's edge cases (jdet_tpu/models/boxes/assigner.py:76-125)
ASSIGN_CASES = (
    "gt_outside_all_anchors",  # a real gt with gt_max 0 claims every anchor
    "all_gts_padding",  # an image without a real gt: all negative
    "anchor_mask_partly_false",  # masked anchors end at -1, max -inf
    "gt_max_tied_on_several_anchors",  # the gt claims all of them
    "two_gts_claim_one_anchor",  # the later gt wins
    "argmax_tie_above_pos_thr",  # the first gt wins the argmax
)


def assign_edge_case(name, K=8, N=600, seed=11):
    """Two images of K padded gts (the last two slots padding) against N
    shared anchors, image 0 showing the case `name`, image 1 random. Half
    the real gts sit on an anchor, shifted and scaled a little, so that
    some IoUs pass 0.5. Returns numpy gts (2, K, 5), mask (2, K), labels
    (2, K), anchors (N, 5), anchor_mask (N,) or None, and the anchor
    indices the case is about."""
    rng = np.random.RandomState(seed)

    def boxes(shape):
        return np.stack([rng.uniform(0, 500, shape), rng.uniform(0, 500, shape),
                         rng.uniform(16, 120, shape), rng.uniform(16, 80, shape),
                         rng.uniform(-np.pi / 2, np.pi / 2, shape)], -1).astype(np.float32)

    anchors = boxes(N)
    gts = boxes((2, K))
    on = rng.choice(N - 2, (2, K // 2), replace=False)  # the anchors gts sit on
    gts[:, :K // 2] = anchors[on]
    gts[:, :K // 2, :2] += rng.uniform(-2, 2, (2, K // 2, 2))
    gts[:, :K // 2, 2:4] *= 1.05
    mask = np.ones((2, K), bool)
    mask[:, -2:] = False
    labels = rng.randint(1, 16, (2, K)).astype(np.int64)
    anchor_mask = None
    j = on[0, 1]  # gt 1 of image 0 sits on anchor j
    about = [j]
    if name == "gt_outside_all_anchors":
        gts[0, 2, :2] = 5000.0
    elif name == "all_gts_padding":
        mask[1] = False
    elif name == "anchor_mask_partly_false":
        anchor_mask = rng.rand(N) < 0.7
        anchor_mask[on[:, :2].ravel()] = False
    elif name == "gt_max_tied_on_several_anchors":
        anchors[[N - 2, N - 1]] = anchors[j]
        about += [N - 2, N - 1]
    elif name == "two_gts_claim_one_anchor":
        gts[0, 3] = gts[0, 1]
        gts[0, 3, :2] += 1.5
    elif name == "argmax_tie_above_pos_thr":
        gts[0, 3] = gts[0, 1]
        # IoU 1/1.3^2 = 0.59 with both copies, below their IoU with anchor j
        anchors[N - 1] = gts[0, 1]
        anchors[N - 1, 2:4] *= 1.3
        about.append(N - 1)
    else:
        raise ValueError(name)
    return gts, mask, labels, anchors, anchor_mask, about


def refined_anchors(anchors, seed=13, extreme=4):
    """Anchors (N, 5) decoded as S2ANet's FAM decodes its init anchors
    into refined ones (`delta2rbox` with wh_ratio_clip=1e-6), in numpy:
    centres moved by up to half a side, w and h stretched apart by
    e^[-1, 2.5] (up to 33:1), angles turned by up to pi/2 and wrapped into
    [-pi/4, 3pi/4). The first `extreme` anchors are stretched by e^8 and
    e^13.8 (the clip), far beyond any init anchor. Returns (N, 5) float32."""
    rng = np.random.RandomState(seed)
    a = anchors.astype(np.float64)
    n = len(a)
    dx, dy = rng.uniform(-0.5, 0.5, (2, n))
    dw, dh = rng.uniform(-1.0, 2.5, (2, n))
    dw[:extreme] = np.where(np.arange(extreme) % 2, 13.8, 8.0)
    dh[:extreme] = -1.0
    da = rng.uniform(-0.5, 0.5, n)
    cos, sin = np.cos(a[:, 4]), np.sin(a[:, 4])
    out = np.stack([
        dx * a[:, 2] * cos - dy * a[:, 3] * sin + a[:, 0],
        dx * a[:, 2] * sin + dy * a[:, 3] * cos + a[:, 1],
        a[:, 2] * np.exp(dw), a[:, 3] * np.exp(dh),
        (np.pi * da + a[:, 4] + np.pi / 4) % np.pi - np.pi / 4,
    ], 1)
    return out.astype(np.float32)


def per_image_assign_edge_case(name, K=8, N=600, seed=11):
    """`assign_edge_case(name)` with per-image anchors (2, N, 5), as the
    ODM of S2ANet assigns: image 0 keeps the case's anchors (the indices
    it returns are about image 0), image 1 takes `refined_anchors` of
    them. anchor_mask stays (N,), one for both images."""
    gts, mask, labels, anchors, anchor_mask, about = assign_edge_case(name, K, N, seed)
    return gts, mask, labels, np.stack([anchors, refined_anchors(anchors)]), anchor_mask, about


# the RoI head's assignment (jdet_tpu/models/heads/oriented_head.py:120-131):
# per image, the gts prepended to the proposals, with per-image masks; each
# of ASSIGN_CASES in that form, and these
ROI_ASSIGN_CASES = (
    "all_proposals_masked",  # image 0 keeps only its gts as candidates
    "no_real_gt",  # image 0 has no real gt: all negative
    "image_fully_masked",  # image 0: no real gt and every proposal masked
    "masked_proposals_at_zero",  # a real gt at the origin, where they sit
)


def roi_assign_edge_case(name, K=8, P=600, seed=11):
    """The RoI head's operands for case `name` (of ASSIGN_CASES or
    ROI_ASSIGN_CASES, in image 0; image 1 random): gts (2, K, 5), mask
    (2, K), labels (2, K), and per-image candidates (2, K + P, 5), each
    image's gts followed by its P proposals (image 0's the case's anchors,
    image 1's refined from them), with their per-image mask (2, K + P):
    the gts' mask, then the proposals', about a fifth of them masked (and
    the case's own anchor mask) and, as the RPN leaves them, set to
    (0, 0, 0, 0, 0)."""
    rng = np.random.RandomState(seed + 1)
    base = name if name in ASSIGN_CASES else "gt_max_tied_on_several_anchors"
    gts, mask, labels, props, anchor_mask, _ = per_image_assign_edge_case(base, K, P, seed)
    pmask = rng.rand(2, P) < 0.8
    if anchor_mask is not None:
        pmask &= anchor_mask
    if base in ("gt_max_tied_on_several_anchors", "argmax_tie_above_pos_thr"):
        pmask[:, -2:] = True  # the anchors the case is about
    if name == "all_proposals_masked":
        pmask[0] = False
    elif name == "no_real_gt":
        mask[0] = False
    elif name == "image_fully_masked":
        mask[0] = False
        pmask[0] = False
    elif name == "masked_proposals_at_zero":
        gts[1, 0] = (3.0, 2.0, 24.0, 12.0, 0.3)
        props[1, :3] = (2.0, 1.0, 24.0, 12.0, 0.35)
        pmask[1, :3] = True
    elif name not in ASSIGN_CASES:
        raise ValueError(name)
    props[~pmask] = 0.0
    return (gts, mask, labels, np.concatenate([gts, props], 1),
            np.concatenate([mask, pmask], 1))


def point_sets(n=64, seed=7, lo=50.0, hi=200.0):
    """(n, 18) float32 sets of 9 points scattered about random centres in
    [lo, hi)², the first eight degenerate: one point nine times, nine
    points on a horizontal line, seven copies of one point, a triangle
    with six points inside, four points twice over, a triangle three
    times, and (row 7) nine points on the diagonal y = x. The collinear
    sets lie on integers, where every implementation's angles about
    their centre are the same: a slanted line's rounding noise decides
    the reference's own hull."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(lo, hi, (n, 1, 2))
    p = c + rng.uniform(2, 40, (n, 1, 2)) * rng.normal(size=(n, 9, 2))
    p[0] = p[0, :1]
    base = np.round(c[1, 0])
    p[1] = np.stack([base[0] + 3 * rng.permutation(9), np.full(9, base[1])], -1)
    p[2, 2:] = p[2, 1]
    tri = np.array([[0.0, 0.0], [30.0, 0.0], [0.0, 30.0]]) + c[3]
    p[3, :3] = tri
    p[3, 3:] = tri.mean(0) + rng.uniform(-3, 3, (6, 2))
    p[4, 4:8] = p[4, :4]
    p[4, 8] = p[4, 0]
    p[5] = np.concatenate([tri + 20] * 3)
    diag = np.round(c[7, 0, 0]) + 2 * rng.permutation(9)
    p[7] = np.stack([diag, diag], -1)
    return p.reshape(n, 18).astype(np.float32)


def gt_quads(m, seed=8, lo=50.0, hi=200.0, size=(5.0, 80.0)):
    """(m, 8) float32 rotated rectangles as quads, every third clockwise."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(lo, hi, (m, 2))
    w, h = rng.uniform(*size, m), rng.uniform(*size, m)
    a = rng.uniform(-3, 3, m)
    dx = np.stack([w, -w, -w, w], 1) / 2
    dy = np.stack([h, h, -h, -h], 1) / 2
    x = c[:, :1] + np.cos(a)[:, None] * dx - np.sin(a)[:, None] * dy
    y = c[:, 1:] + np.sin(a)[:, None] * dx + np.cos(a)[:, None] * dy
    q = np.stack([x, y], -1)
    q[::3] = q[::3, ::-1]
    return q.reshape(m, 8).astype(np.float32)


def refine_margin(overlaps, gt_mask, pos_iou_thr=0.4, neg_iou_thr=0.3):
    """Of a (B, K, N) convex-IoU matrix (RepPoints' refine assignment,
    `min_pos_iou` 0 with every gt claiming all the points at its max):
    the smallest change of one value, relative where the values are
    small, that could move an assignment. That is the least of: a
    point's best IoU from both thresholds; a positive point's best from
    its second best gt; and, over the gt's max, a gt's positive max from
    the next smaller value of its row (an untrained head's hulls are
    sub-pixel, its IoUs ~1e-6, and two implementations agree on them to
    a few ulps of each). A gt whose max is 0 claims every point where its
    IoU is exactly 0: the zero pattern, which is compared apart, decides
    those."""
    ov = np.where(np.asarray(gt_mask)[..., None], np.asarray(overlaps, np.float64), -np.inf)
    ov = ov[np.asarray(gt_mask).any(-1)]
    if ov.size == 0:
        return np.inf
    srt = np.sort(np.concatenate([ov, np.full_like(ov[:, :1], -np.inf)], 1), axis=1)
    best, second = srt[:, -1], srt[:, -2]
    margin = min(np.abs(best - neg_iou_thr).min(), np.abs(best - pos_iou_thr).min())
    pos = best >= pos_iou_thr - 1e-5
    if pos.any():
        margin = min(margin, (best - second)[pos].min())
    rows = ov.transpose(1, 0, 2)[np.isfinite(ov.max(-1)).T & (ov.max(-1).T > 0)]
    if len(rows):
        rmax = rows.max(-1, keepdims=True)
        below = np.where(rows >= rmax, -np.inf, rows).max(-1)
        margin = min(margin, ((rmax[:, 0] - below) / rmax[:, 0]).min())
    return float(margin)
