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
