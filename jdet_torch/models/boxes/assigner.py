"""Max-IoU assignment in masked, fixed-shape form.

Port of `jdet_tpu/models/boxes/assigner.py` (`hbb_overlaps` :25,
`assign_wrt_overlaps` :45, `max_iou_assign_rotated` :135 with its
`fake_rbb` branch :156-168, `max_iou_assign_hbb` :197,
`atss_assign_rotated` :237, RepPoints' `convex_assign_init` :312 and
`max_convex_iou_assign` :382). Every function takes a leading batch
dimension (the reference's vmap over images, written out), so the IoU
kernel is launched once for the batch.

Per anchor the outputs are:
  gt_inds:      -1 ignore, 0 negative, i+1 positive for gt i
  max_overlaps: float
  labels:       0 background, 1-based class for positives
Padding gt rows never match: their IoU rows are masked to -inf.

`max_iou_assign_rotated` is the wrapper of the fused CUDA assigner
(`ops/rotated_iou_kernel.py::launch_max_iou_assign_rect`), which never
writes the IoU matrix: every CUDA call with the rotated IoU launches it,
its first-claim branch with `gt_max_assign_all=False`
(`iou_calculator="fake_rbb"` assigns on the circumscribed hbbs through
`max_iou_assign_hbb` on either device, and launches nothing). Its plain
version,
for CPU tensors, is the composition here, `assign_wrt_overlaps` on
`box_iou_rotated`'s matrix; it lives here and not in `ops/`, because
`ops/` does not depend on `models/`.

`max_iou_assign_hbb` (the RPN's, plain PyTorch on either device) takes
the gts `iou_chunk` rows at a time and never holds the whole (B, K, N)
matrix of `hbb_overlaps` (the reference's formula, which is also the hbb
NMS's `ops/nms.py::hbb_iou_matrix`): the maxima and the argmax run over the chunks, and the
low-quality claim is per gt row, so the chunks compose exactly.

Both take the reference's ignore regions (`gt_bboxes_ignore`,
`gt_ignore_mask`, `ignore_iof_thr`, :145-193 and :207-233): an anchor
whose IoF with a real ignore box exceeds the threshold ends at -1, its
IoU column set to -1 as the reference sets it. The IoF is plain PyTorch
on either device, as in the reference, where `mode="iof"` never reaches
Pallas (`box_iou_rotated.py:176-184`).
"""
from __future__ import annotations

import torch

from ...ops.box_convert import points_in_rbox, rbox_to_hbox
from ...ops.box_iou_rotated import box_iou_rotated
from ...ops.convex import convex_iou_batched
from ...ops.nms import hbb_iou_matrix as hbb_overlaps
from ...ops.rotated_iou_kernel import (box_iou_rotated_rect, launch_max_iou_assign_rect,
                                       park_masked_boxes)
from ...ops.topk import stable_topk


def _assign(chunks, gt_mask, gt_labels, pos_iou_thr, neg_iou_thr, min_pos_iou,
            anchor_mask, match_low_quality, gt_max_assign_all, ignore_mask=None):
    """The assignment from `chunks`, an iterable of (k0, overlaps of gt
    rows k0..k0+c, (..., c, n)) in ascending k0."""
    k = gt_mask.shape[-1]
    max_ov = arg = claim = None
    for k0, overlaps in chunks:
        c = overlaps.shape[-2]
        ov = torch.where(gt_mask[..., k0:k0 + c, None], overlaps, float("-inf"))
        if anchor_mask is not None:
            ov = torch.where(anchor_mask[..., None, :], ov, float("-inf"))
        if ignore_mask is not None:
            ov = torch.where(ignore_mask[..., None, :], -1.0, ov)
        cmax, carg = ov.max(dim=-2)
        if max_ov is None:
            max_ov, arg = cmax, carg
            claim = torch.full_like(carg, -1)
        else:
            # ties keep the earlier gt, as the argmax over all rows does
            better = cmax > max_ov
            max_ov = torch.where(better, cmax, max_ov)
            arg = torch.where(better, carg + k0, arg)
        if not match_low_quality:
            continue
        eligible_gt = gt_mask[..., k0:k0 + c]
        if gt_max_assign_all:
            gt_max = ov.amax(dim=-1)  # (..., c)
            eligible_gt = eligible_gt & (gt_max >= min_pos_iou) & torch.isfinite(gt_max)
            hits = ov == gt_max[..., None]
        else:
            gt_max, best = ov.max(dim=-1)
            eligible_gt = eligible_gt & (gt_max >= min_pos_iou) & torch.isfinite(gt_max)
            n_idx = torch.arange(ov.shape[-1], device=ov.device)
            hits = best[..., None] == n_idx
        # the reference loops gts in order and later gts override: the
        # largest gt index claiming each anchor wins
        gt_index = torch.arange(k0, k0 + c, device=ov.device)[:, None]
        hits = hits & eligible_gt[..., None]
        claim = torch.maximum(claim, torch.where(hits, gt_index, -1).amax(dim=-2))

    # with zero real gts, every anchor is negative
    any_gt = gt_mask.any(dim=-1, keepdim=True)
    max_overlaps = torch.where(any_gt, max_ov, 0.0)
    neg = (max_overlaps >= 0) & (max_overlaps < neg_iou_thr)
    assigned = torch.where(neg, 0, -1)
    assigned = torch.where(max_overlaps >= pos_iou_thr, arg + 1, assigned)
    assigned = torch.where(claim >= 0, claim + 1, assigned)
    if ignore_mask is not None:
        assigned = torch.where(ignore_mask, -1, assigned)
    if anchor_mask is not None:
        assigned = torch.where(anchor_mask, assigned, -1)

    safe = (assigned - 1).clamp(0, k - 1)
    picked = torch.gather(gt_labels.long(), -1, safe)
    labels = torch.where(assigned > 0, picked, 0)
    return {
        "gt_inds": assigned,
        "max_overlaps": max_overlaps,
        "labels": labels,
    }


def assign_wrt_overlaps(
    overlaps,
    gt_mask,
    gt_labels,
    pos_iou_thr=0.5,
    neg_iou_thr=0.4,
    min_pos_iou=0.0,
    anchor_mask=None,
    match_low_quality=True,
    gt_max_assign_all=True,
    ignore_mask=None,
):
    """Masked MaxIoU assignment from a (..., k, n) overlap matrix.

      1. default -1 (ignore)
      2. max_overlap < neg_iou_thr -> 0 (negative)
      3. max_overlap >= pos_iou_thr -> argmax gt + 1
      4. with match_low_quality, each gt claims every anchor at its max
         IoU (only its first, without gt_max_assign_all) if that max >=
         min_pos_iou (later gts override earlier ones).

    gt_mask (..., k) bool marks real gt rows, gt_labels (..., k) their
    1-based classes; anchor_mask (n,) bool, one for every image, or
    (..., n), one per image, marks anchors eligible at all: a masked
    anchor is neither an argmax target nor claimed, and ends at -1.
    ignore_mask (n,) or (..., n) bool marks anchors in ignore regions: their
    IoU column reads -1 and they end at -1.
    """
    return _assign([(0, overlaps)], gt_mask, gt_labels, pos_iou_thr, neg_iou_thr,
                   min_pos_iou, anchor_mask, match_low_quality, gt_max_assign_all,
                   ignore_mask)


def hbb_iof(boxes, regions):
    """IoF of horizontal boxes (..., n, 4) against regions (..., m, 4):
    the intersection over each box's own area (the reference's
    `hbb_overlaps(..., mode="iof")`, :25)."""
    a = boxes[..., :, None, :]
    b = regions[..., None, :, :]
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    iw = (torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])).clamp(min=0)
    ih = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])).clamp(min=0)
    union = area[..., :, None].expand_as(iw)
    return torch.where(union > 1e-9, iw * ih / union.clamp(min=1e-9), 0.0)


def ignore_anchors(iof, gt_ignore_mask, ignore_iof_thr):
    """(..., n) bool: anchors whose IoF (..., n, m) with a real ignore box
    (gt_ignore_mask (..., m)) exceeds ignore_iof_thr."""
    if iof.shape[-1] == 0:
        return iof.new_zeros(iof.shape[:-1], dtype=torch.bool)
    iof = torch.where(gt_ignore_mask[..., None, :], iof, float("-inf"))
    return iof.amax(-1) > ignore_iof_thr


def fold_ignore(anchor_mask, ignore_mask):
    """The anchor mask with the ignored anchors masked too: what the fused
    kernel takes for ignore regions."""
    if ignore_mask is None:
        return anchor_mask
    return ~ignore_mask if anchor_mask is None else anchor_mask & ~ignore_mask


def unfold_ignore(out, ignore_mask, gt_mask):
    """An assignment made on `fold_ignore`'s mask, made the reference's:
    the ignored anchors' max_overlaps reads -1 where the image has a real
    gt (their IoU column is -1 there), 0 where it has none."""
    if ignore_mask is not None:
        ignored = ignore_mask & gt_mask.any(-1, keepdim=True)
        out["max_overlaps"] = torch.where(ignored, -1.0, out["max_overlaps"])
    return out


def _uses_ignore(ignore_iof_thr, gt_bboxes_ignore, gt_ignore_mask):
    return ignore_iof_thr > 0 and gt_bboxes_ignore is not None and gt_ignore_mask is not None


def max_iou_assign_hbb(
    anchors,
    gt_bboxes,
    gt_mask,
    gt_labels,
    pos_iou_thr=0.5,
    neg_iou_thr=0.4,
    min_pos_iou=0.0,
    anchor_mask=None,
    match_low_quality=True,
    gt_max_assign_all=True,
    iou_chunk=None,
    gt_bboxes_ignore=None,
    gt_ignore_mask=None,
    ignore_iof_thr=-1,
    ignore_mask=None,
):
    """MaxIoU assignment of horizontal (x1, y1, x2, y2) boxes: anchors
    (n, 4) shared by the batch, gt_bboxes (..., k, 4) padded, gt_mask and
    gt_labels of their leading shape. Returns `assign_wrt_overlaps`' dict.
    With ignore_iof_thr > 0, gt_bboxes_ignore (..., m, 4) and
    gt_ignore_mask (..., m), anchors in ignore regions end at -1;
    `ignore_mask` (..., n) gives them directly (the rotated assigner's
    `fake_rbb` route, whose IoF is rotated).

    The gts are taken `iou_chunk` rows at a time (by default as many as
    keep a chunk's (..., rows, n) overlaps at 2^25 values), and only up
    to the last real gt of the batch: the padding rows after it cannot
    change the result. Finding it reads one number back to the host."""
    k = gt_bboxes.shape[-2]
    lead = gt_bboxes.shape[:-2].numel()
    n = anchors.shape[-2]
    if iou_chunk is None:
        iou_chunk = max(1, (1 << 25) // max(lead * n, 1))
    index = torch.arange(1, k + 1, device=gt_mask.device)
    last = int(torch.where(gt_mask, index, 0).amax().item()) if gt_mask.numel() else 0
    chunks = ((k0, hbb_overlaps(gt_bboxes[..., k0:min(k0 + iou_chunk, last), :], anchors))
              for k0 in range(0, last, iou_chunk))
    if last == 0:
        # no real gt: one chunk of -inf rows gives the empty-gt result
        chunks = [(0, gt_bboxes.new_zeros(*gt_bboxes.shape[:-2], 1, n))]
    if ignore_mask is None and _uses_ignore(ignore_iof_thr, gt_bboxes_ignore, gt_ignore_mask):
        ignore_mask = ignore_anchors(hbb_iof(anchors, gt_bboxes_ignore), gt_ignore_mask,
                                     ignore_iof_thr)
    return _assign(chunks, gt_mask, gt_labels, pos_iou_thr, neg_iou_thr, min_pos_iou,
                   anchor_mask, match_low_quality, gt_max_assign_all, ignore_mask)


def max_iou_assign_rotated(
    anchors,
    gt_bboxes,
    gt_mask,
    gt_labels,
    pos_iou_thr=0.5,
    neg_iou_thr=0.4,
    min_pos_iou=0.0,
    anchor_mask=None,
    match_low_quality=True,
    gt_max_assign_all=True,
    iou_chunk=512,
    iou_calculator="rotated",
    gt_bboxes_ignore=None,
    gt_ignore_mask=None,
    ignore_iof_thr=-1,
):
    """Rotated MaxIoU assignment. anchors (n, 5) shared, or (B, n, 5) per
    image with (B, k, 5) gts (the reference's vmap over images and anchors,
    `anchor_target.py:163-176`, and the RoI head's per-image proposals);
    gt_bboxes (k, 5) or (B, k, 5) padded; gt_mask and gt_labels of
    gt_bboxes' leading shape, bool and integer; anchor_mask (n,) bool, one
    for every image, (B, n) bool, one per image (with per-image anchors
    only), or None. Returns `assign_wrt_overlaps`' dict.

    A CUDA tensor launches the fused kernel (one launch for the batch;
    with gt_max_assign_all=False its first-claim branch) or raises; a CPU
    tensor is assigned on `box_iou_rotated`'s matrix, which broadcasts over
    per-image anchors, `iou_chunk` gt rows at a time (the plain version).

    Ignore regions (ignore_iof_thr > 0, gt_bboxes_ignore (m, 5) or
    (B, m, 5), gt_ignore_mask of its leading shape): the anchors' rotated
    IoF with them is plain PyTorch on either device. On the card the
    ignored anchors join the anchor mask of the fused launch and their
    max_overlaps is set to -1 afterwards (kept at 0 in an image without a
    real gt). That is the reference's result wherever min_pos_iou > -1:
    an ignored anchor's IoU column of -1 then never reaches an eligible
    gt's max, nor does a masked anchor's -inf.

    iou_calculator="fake_rbb" assigns on the circumscribed hbbs of the
    parked gts and of the anchors (the reference's
    FakeBboxOverlaps2D_rotated), through the exact chunked
    `max_iou_assign_hbb` on either device: no kernel is launched."""
    ignore_mask = None
    if _uses_ignore(ignore_iof_thr, gt_bboxes_ignore, gt_ignore_mask):
        rows = max(iou_chunk, (1 << 22) // max(gt_bboxes_ignore.shape[-2], 1))
        ignore_mask = ignore_anchors(
            box_iou_rotated(anchors, gt_bboxes_ignore, mode="iof", chunk=rows),
            gt_ignore_mask, ignore_iof_thr)
    if iou_calculator == "fake_rbb":
        return max_iou_assign_hbb(
            rbox_to_hbox(anchors), rbox_to_hbox(park_masked_boxes(gt_bboxes, gt_mask)),
            gt_mask, gt_labels, pos_iou_thr, neg_iou_thr, min_pos_iou, anchor_mask,
            match_low_quality, gt_max_assign_all, ignore_mask=ignore_mask)
    if iou_calculator != "rotated":
        raise NotImplementedError(f"iou_calculator {iou_calculator!r} is not ported")
    if gt_bboxes.is_cuda:
        # the kernel takes float32 boxes (a float64-policy model's too)
        out = launch_max_iou_assign_rect(
            gt_bboxes.float().contiguous(), gt_mask, gt_labels,
            anchors.float().contiguous(), fold_ignore(anchor_mask, ignore_mask), pos_iou_thr,
            neg_iou_thr, min_pos_iou, match_low_quality, gt_max_assign_all,
        )
        return unfold_ignore(out, ignore_mask, gt_mask)
    overlaps = box_iou_rotated(
        park_masked_boxes(gt_bboxes, gt_mask), anchors, chunk=iou_chunk
    )
    return assign_wrt_overlaps(
        overlaps, gt_mask, gt_labels, pos_iou_thr, neg_iou_thr,
        min_pos_iou, anchor_mask, match_low_quality, gt_max_assign_all, ignore_mask,
    )


def atss_candidates(anchors, gt_bboxes, num_level_anchors=None, topk=9, anchor_mask=None):
    """ATSS's candidates: for each gt of gt_bboxes (..., k, 5), the indices
    (..., k, c) of the `topk` anchors (n, 5) of each level nearest its
    center, ties to the lower index: rank < topk within a level is the
    first topk of a stable sort (the reference's argsort of the argsort).
    Masked anchors are the farthest."""
    d = anchors[:, :2] - gt_bboxes[..., :, None, :2]
    dist = torch.sqrt((d * d).sum(-1))  # (..., k, n)
    if anchor_mask is not None:
        dist = torch.where(anchor_mask[..., None, :], dist, float("inf"))
    cand = []
    start = 0
    for n_l in num_level_anchors or [anchors.shape[0]]:
        order = torch.sort(dist[..., start:start + n_l], dim=-1, stable=True).indices
        cand.append(order[..., :min(topk, n_l)] + start)
        start += n_l
    return torch.cat(cand, -1)


def atss_assign_rotated(
    anchors,
    gt_bboxes,
    gt_mask,
    gt_labels,
    num_level_anchors=None,
    topk=9,
    anchor_mask=None,
    iou_chunk=512,
):
    """ATSS adaptive assignment of rotated boxes: anchors (n, 5) shared,
    gt_bboxes (..., k, 5) padded, gt_mask and gt_labels of their leading
    shape. Per gt, its `atss_candidates` (the `topk` anchors of each
    level nearest its center); its threshold is the mean plus the
    population std of their IoUs; candidates at or above it whose center
    lies inside the gt are its positives; an anchor claimed by several gts goes to the one
    of highest IoU (the first on a tie). Returns `assign_wrt_overlaps`'
    dict: gt_inds 0 for every anchor not positive, -1 where anchor_mask
    is False.

    The IoU matrix is `box_iou_rotated_rect`'s: on a CUDA tensor K1's
    matrix kernel, one launch for the batch; on a CPU tensor its plain
    version, `iou_chunk` gt rows at a time."""
    k = gt_bboxes.shape[-2]
    parked = park_masked_boxes(gt_bboxes, gt_mask).contiguous()
    anchors = anchors.contiguous()
    if parked.is_cuda:
        ious = box_iou_rotated_rect(parked, anchors)
    else:
        ious = torch.cat([box_iou_rotated_rect(parked[..., i:i + iou_chunk, :], anchors)
                          for i in range(0, k, iou_chunk)], -2)
    ious = torch.where(gt_mask[..., None], ious, 0.0)
    if anchor_mask is not None:
        ious = torch.where(anchor_mask[..., None, :], ious, 0.0)

    cand = atss_candidates(anchors, gt_bboxes, num_level_anchors, topk, anchor_mask)
    cand_ious = torch.gather(ious, -1, cand)
    mean = cand_ious.mean(-1, keepdim=True)
    std = torch.sqrt(((cand_ious - mean) ** 2).mean(-1, keepdim=True))
    # each candidate's center against its own gt: (..., k, c, 1, 1)
    inside = points_in_rbox(anchors[cand, :2][..., None, :], gt_bboxes[..., :, None, None, :])
    pos = (cand_ious >= mean + std) & inside[..., 0, 0] & gt_mask[..., None]
    pos_cand = torch.zeros_like(ious, dtype=torch.bool).scatter_(-1, cand, pos)

    claimed_iou = torch.where(pos_cand, ious, float("-inf"))
    best_iou, best_gt = claimed_iou.max(dim=-2)
    any_pos = pos_cand.any(-2)
    assigned = torch.where(any_pos, best_gt + 1, 0)
    if anchor_mask is not None:
        assigned = torch.where(anchor_mask, assigned, -1)
    max_overlaps = torch.where(any_pos, best_iou, ious.amax(-2))
    picked = torch.gather(gt_labels.long(), -1, (assigned - 1).clamp(0, k - 1))
    return {
        "gt_inds": assigned,
        "max_overlaps": max_overlaps,
        "labels": torch.where(assigned > 0, picked, 0),
    }


def convex_assign_init(centers, pt_lvls, gt_polys, gt_mask, pos_num=1, scale=4.0):
    """RepPoints' init assignment (the reference's `convex_assign_init`
    :312, JDet's ConvexAssigner) over a batch: per gt, a pyramid level
    from the log2 size of its horizontal box (truncated toward zero,
    clipped to the points' levels), and the `pos_num` centres of that
    level nearest the gt's centre (distances normalised by the gt's w
    and h, ties to the lower index); each candidate goes to its gt unless
    an earlier gt claims it at a strictly smaller distance (the first
    gt wins a tie).

    centers (N, 2), pt_lvls (N,) log2 of each point's stride, gt_polys
    (B, K, 8), gt_mask (B, K). Returns gt_inds (B, N) (0 or 1-based),
    pos_mask (B, N), cand_idx (B, K, pos_num) and cand_win (B, K,
    pos_num): the candidate went to this gt.
    """
    B, K = gt_mask.shape
    xs, ys = gt_polys[..., 0::2], gt_polys[..., 1::2]
    gx = (xs.amin(-1) + xs.amax(-1)) * 0.5
    gy = (ys.amin(-1) + ys.amax(-1)) * 0.5
    gw = (xs.amax(-1) - xs.amin(-1)).clamp(min=1e-6)
    gh = (ys.amax(-1) - ys.amin(-1)).clamp(min=1e-6)
    gt_lvl = torch.trunc((torch.log2(gw / scale) + torch.log2(gh / scale)) / 2.0)
    gt_lvl = torch.maximum(torch.minimum(gt_lvl, pt_lvls.max()), pt_lvls.min())
    d = torch.sqrt(((centers[:, 0] - gx[..., None]) / gw[..., None]) ** 2
                   + ((centers[:, 1] - gy[..., None]) / gh[..., None]) ** 2)  # (B, K, N)
    d = torch.where((pt_lvls == gt_lvl[..., None]) & gt_mask[..., None], d, float("inf"))
    neg_d, cand_idx = stable_topk(-d, pos_num)
    cand_d = -neg_d
    cand_ok = torch.isfinite(cand_d)
    sparse = torch.full_like(d, float("inf")).scatter_(
        -1, cand_idx, torch.where(cand_ok, cand_d, float("inf")))
    dmin, owner = sparse.min(1)  # (B, N); the first gt on ties
    pos_mask = torch.isfinite(dmin)
    gt_inds = torch.where(pos_mask, owner + 1, 0)
    cand_win = cand_ok & (torch.gather(owner, 1, cand_idx.reshape(B, -1)).reshape(cand_idx.shape)
                          == torch.arange(K, device=owner.device)[:, None])
    return {"gt_inds": gt_inds, "pos_mask": pos_mask, "cand_idx": cand_idx,
            "cand_win": cand_win}


def max_convex_iou_assign(pointsets, gt_polys, gt_mask, gt_labels, pos_iou_thr=0.4,
                          neg_iou_thr=0.3, min_pos_iou=0.0):
    """RepPoints' refine assignment (the reference's
    `max_convex_iou_assign` :382, JDet's MaxConvexIoUAssigner): MaxIoU
    thresholds on the convex IoU of each detached point-set hull
    (B, N, 2P) with each gt quad (B, K, 8), real gts only
    (`ops/convex.py::convex_iou_batched`)."""
    overlaps = convex_iou_batched(pointsets.detach(), gt_polys, gt_mask)
    return assign_wrt_overlaps(overlaps, gt_mask, gt_labels, pos_iou_thr=pos_iou_thr,
                               neg_iou_thr=neg_iou_thr, min_pos_iou=min_pos_iou)
