"""The max-IoU assigner fused onto the rect IoU kernel, and the rect IoU
with per-image anchors (the NMS's per-class self-IoU), against jdet_tpu.

On the CPU, `max_iou_assign_rotated` takes its plain version: the
assigner composed on the IoU matrix. It is held against jdet_tpu's
`max_iou_assign_rotated` on the edge cases of
`jdet_torch.utils.edge_cases.ASSIGN_CASES`:
gt_inds and labels equal, max_overlaps within atol 2e-4 (the IoU's
tolerance) with -inf in the same slots. The ties in those cases come from
duplicated boxes, so they are exact in both frameworks; no other IoU lies
within 1e-5 of a threshold or of its gt's max.

Tests marked `cuda` hold the kernels against the unfused route and the
plain versions on the card, and skip without one. JAX and jdet_tpu are
imported only inside the tests that compare against them, so that on a
machine without JAX the `cuda` tests run with
`python -m pytest --noconftest tests/test_torch_assign.py -m cuda`."""
import numpy as np
import pytest
import torch

from jdet_torch.models.boxes.assigner import assign_wrt_overlaps, max_iou_assign_rotated
from jdet_torch.ops import box_iou_rotated, multiclass_nms_rotated
from jdet_torch.ops import rotated_iou_kernel as rik
from jdet_torch.utils.edge_cases import (ASSIGN_CASES, ROI_ASSIGN_CASES, assign_edge_case,
                                         edge_case_boxes, per_image_assign_edge_case,
                                         refined_anchors, roi_assign_edge_case)

THR = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)
# the Oriented R-CNN RoI head's assigner (oriented_head.py:35-39)
ROI_THR = dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5, match_low_quality=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's thread pool on a busy machine made the plain IoU several times
    slower than on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_case(name):
    gts, mask, labels, anchors, am, about = assign_edge_case(name)
    am = None if am is None else torch.from_numpy(am)
    return (*map(torch.from_numpy, (gts, mask, labels, anchors)), am, about)


def _assign(gts, mask, labels, anchors, am):
    """The port's assigner: the fused kernel on the card, the plain
    version on the CPU."""
    return max_iou_assign_rotated(anchors, gts, mask, labels, anchor_mask=am, **THR)


def _reference_assign(gts, mask, labels, anchors, am):
    """jdet_tpu's assigner, image by image (it takes one image), on shared
    (N, 5) or per-image (B, N, 5) anchors: the reference's vmap of
    `anchor_target.py:163-176`."""
    import jax.numpy as jnp
    from jdet_tpu.models.boxes.assigner import max_iou_assign_rotated as j_assign

    out = [j_assign(jnp.asarray(anchors if anchors.ndim == 2 else anchors[b]),
                    jnp.asarray(gts[b]), jnp.asarray(mask[b]),
                    gt_labels=jnp.asarray(labels[b]),
                    anchor_mask=None if am is None else jnp.asarray(am), **THR)
           for b in range(len(gts))]
    return {k: np.stack([np.asarray(o[k]) for o in out]) for k in out[0]}


@pytest.mark.parametrize("case", ASSIGN_CASES)
def test_assigner_matches_reference_on_edge_cases(case):
    gts, mask, labels, anchors, am, about = _torch_case(case)
    got = _assign(gts, mask, labels, anchors, am)
    want = _reference_assign(*(t.numpy() if t is not None else None
                               for t in (gts, mask, labels, anchors, am)))
    np.testing.assert_array_equal(got["gt_inds"].numpy(), want["gt_inds"])
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    mo, want_mo = got["max_overlaps"].numpy(), want["max_overlaps"]
    np.testing.assert_array_equal(np.isfinite(mo), np.isfinite(want_mo))
    fin = np.isfinite(want_mo)
    np.testing.assert_allclose(mo[fin], want_mo[fin], atol=2e-4, rtol=0)
    assert (got["gt_inds"][1] > 0).any() or case == "all_gts_padding"

    # what each case is about, in image 0 (gt i is gt_inds i + 1)
    inds = got["gt_inds"][0]
    active = torch.ones_like(inds, dtype=torch.bool) if am is None else am
    if case == "gt_outside_all_anchors":
        # gt 2 (IoU 0 everywhere) claims every anchor; only gts 3-5 claim over it
        assert (inds >= 3).all() and (inds == 3).sum() > 500
    elif case == "all_gts_padding":
        assert (got["gt_inds"][1] == 0).all() and not got["max_overlaps"][1].any()
    elif case == "anchor_mask_partly_false":
        assert (inds[~active] == -1).all()
        assert torch.isneginf(got["max_overlaps"][0][~active]).all()
        assert (inds[active] > 0).any()
    elif case == "gt_max_tied_on_several_anchors":
        assert inds[about].tolist() == [2, 2, 2]
    elif case == "two_gts_claim_one_anchor":
        assert inds[about].tolist() == [4]
    else:  # argmax_tie_above_pos_thr: gts 1 and 3 are one box
        assert inds[about].tolist() == [4, 2]


@pytest.mark.parametrize("case", ASSIGN_CASES)
def test_assigner_per_image_anchors_matches_reference_on_edge_cases(case):
    """The plain version on per-image anchors (image 1's refined like the
    ODM's, some stretched to the decoder's clip) against the reference's
    per-image vmap: gt_inds and labels equal, max_overlaps within 2e-4."""
    gts, mask, labels, anchors, am, about = per_image_assign_edge_case(case)
    t = [torch.from_numpy(x) for x in (gts, mask, labels, anchors)]
    before = rik.ASSIGN_LAUNCHES, rik.ASSIGN_PER_IMAGE_LAUNCHES
    got = _assign(*t, None if am is None else torch.from_numpy(am))
    assert (rik.ASSIGN_LAUNCHES, rik.ASSIGN_PER_IMAGE_LAUNCHES) == before
    want = _reference_assign(gts, mask, labels, anchors, am)
    np.testing.assert_array_equal(got["gt_inds"].numpy(), want["gt_inds"])
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    mo, want_mo = got["max_overlaps"].numpy(), want["max_overlaps"]
    np.testing.assert_array_equal(np.isfinite(mo), np.isfinite(want_mo))
    fin = np.isfinite(want_mo)
    np.testing.assert_allclose(mo[fin], want_mo[fin], atol=2e-4, rtol=0)
    # image 0 keeps the case's anchors, so it assigns as the shared route
    shared = _assign(*t[:3], t[3][0], None if am is None else torch.from_numpy(am))
    for k in got:
        assert torch.equal(got[k][0], shared[k][0]), k
    assert (got["gt_inds"][1] > 0).any() or case == "all_gts_padding"


def _untied(gts, mask, anchors):
    """Smallest gap between a gt's best IoU and its second best, and
    between an anchor's best IoU and 0.4 / 0.5, over per-image anchors."""
    margin = np.inf
    for b in range(len(gts)):
        iou = box_iou_rotated(torch.from_numpy(gts[b][mask[b]]),
                              torch.from_numpy(anchors[b])).double()
        top2 = iou.topk(2, dim=1).values
        best = iou.max(0).values
        margin = min(margin, (top2[:, 0] - top2[:, 1]).min().item(),
                     (best - 0.5).abs().min().item(), (best - 0.4).abs().min().item())
    return margin


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_per_image_route_matches_reference_vmapped(seed):
    """S2ANet-like refined anchors, per image, over a 512² grid of square
    init anchors (5,456 per image), against 12 gts per image (4 padding
    slots), some sitting on a refined anchor; the batch is the first from
    `seed` upwards with no near tie (1e-5)."""
    sizes = [(512 // s, 512 // s) for s in (8, 16, 32, 64, 128)]
    init = np.concatenate([
        np.stack(np.meshgrid(np.arange(w) * s + (4 * s - 1) / 2,
                             np.arange(h) * s + (4 * s - 1) / 2), -1).reshape(-1, 2)
        for s, (h, w) in zip((8, 16, 32, 64, 128), sizes)])
    side = np.concatenate([np.full(h * w, 4.0 * s) for s, (h, w) in zip((8, 16, 32, 64, 128), sizes)])
    init = np.c_[init, side, side, np.zeros_like(side)].astype(np.float32)
    for s in range(seed * 100, seed * 100 + 50):
        rng = np.random.RandomState(s)
        anchors = np.stack([refined_anchors(init, seed=s + b, extreme=2) for b in range(2)])
        gts = np.stack([np.stack([rng.uniform(20, 490, 16), rng.uniform(20, 490, 16),
                                  rng.uniform(12, 160, 16), rng.uniform(8, 80, 16),
                                  rng.uniform(-np.pi / 4, 3 * np.pi / 4, 16)], 1)
                        for _ in range(2)]).astype(np.float32)
        on = rng.choice(len(init), (2, 6), replace=False)
        for b in range(2):
            gts[b, :6] = anchors[b, on[b]] * [1, 1, 1.05, 1.05, 1] + [1.5, -1.0, 0, 0, 0.02]
        mask = np.ones((2, 16), bool)
        mask[:, -4:] = False
        labels = rng.randint(1, 16, (2, 16)).astype(np.int64)
        if _untied(gts, mask, anchors) > 1e-5:
            break
    else:
        raise AssertionError("no tie-free batch")
    got = _assign(*(torch.from_numpy(x) for x in (gts, mask, labels, anchors)), None)
    want = _reference_assign(gts, mask, labels, anchors, None)
    np.testing.assert_array_equal(got["gt_inds"].numpy(), want["gt_inds"])
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    np.testing.assert_allclose(got["max_overlaps"].numpy(), want["max_overlaps"],
                               atol=2e-4, rtol=0)
    assert ((got["gt_inds"] > 0).sum(1) >= 6).all()


def test_fused_wrapper_takes_per_image_anchors():
    gts, mask, labels, anchors, am, _ = per_image_assign_edge_case("anchor_mask_partly_false")
    g, m, lab, a = (torch.from_numpy(x) for x in (gts, mask, labels, anchors))
    am = torch.from_numpy(am)
    assert rik.check_assign_operands(g, m, lab, a, am)
    # a per-image (B, N) mask goes with per-image anchors, and with shared
    # ones (the ignore regions' per-image masks) when the gts are (B, K, 5)
    assert rik.check_assign_operands(g, m, lab, a, am.expand(2, -1))
    assert rik.check_assign_operands(g, m, lab, a[0], am.expand(2, -1))
    for bad in (dict(a=a[:1]), dict(g=g[0], m=m[0], lab=lab[0]),
                dict(am=am.expand(3, -1)), dict(g=g[0], m=m[0], lab=lab[0], a=a[0],
                                                 am=am.expand(2, -1)),
                dict(am=am.expand(2, -1)[:, 1:]), dict(a=a[..., :4])):
        args = {**dict(g=g, m=m, lab=lab, a=a, am=am), **bad}
        with pytest.raises(ValueError):
            rik.check_assign_operands(args["g"], args["m"], args["lab"], args["a"], args["am"])


def test_rect_reference_per_image_anchors_matches_pallas_vmapped():
    import jax
    import jax.numpy as jnp
    from jdet_tpu.ops.pallas_iou import box_iou_rotated_pallas

    gts, an = edge_case_boxes(K=10, N=300, seed=5)
    an_b = np.stack([an, an[::-1]]).astype(np.float32)
    want = np.asarray(jax.vmap(
        lambda g, a: box_iou_rotated_pallas(g, a, interpret=True)
    )(jnp.asarray(gts), jnp.asarray(an_b)))
    got = rik.box_iou_rotated_rect_reference(torch.from_numpy(gts), torch.from_numpy(an_b))
    assert got.shape == want.shape == (2, 10, 300)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    # each image as its own shared-anchor call
    for b in range(2):
        one = rik.box_iou_rotated_rect_reference(torch.from_numpy(gts[b]),
                                                 torch.from_numpy(an_b[b]))
        torch.testing.assert_close(got[b], one, rtol=0, atol=0)


@pytest.mark.parametrize("gt_shape,anchor_shape,ok", [
    ((2, 10, 5), (2, 30, 5), True),
    ((2, 10, 5), (30, 5), True),
    ((10, 5), (1, 30, 5), False),
    ((2, 10, 5), (3, 30, 5), False),
    ((2, 10, 5), (2, 30, 4), False),
    ((2, 10, 5), (2, 1, 30, 5), False),
])
def test_rect_wrapper_anchor_shapes(gt_shape, anchor_shape, ok):
    rng = np.random.RandomState(0)
    g = torch.from_numpy(rng.uniform(10, 50, gt_shape).astype(np.float32))
    a = torch.from_numpy(rng.uniform(10, 50, anchor_shape).astype(np.float32))
    before = rik.LAUNCHES
    if not ok:
        with pytest.raises(ValueError):
            rik.box_iou_rotated_rect(g, a)
        return
    got = rik.box_iou_rotated_rect(g, a)
    assert rik.LAUNCHES == before and got.shape == (2, 10, 30)
    torch.testing.assert_close(got, rik.box_iou_rotated_rect_reference(g, a), rtol=0, atol=0)
    # K2 keeps to shared anchors
    if a.dim() == 3:
        with pytest.raises(ValueError):
            rik.box_iou_rotated_generic(g, a)


@pytest.mark.parametrize("bad", ["box_dtype", "no_gts", "mask_dtype", "mask_shape",
                                 "float_labels", "batched_anchors", "anchor_mask_shape",
                                 "strided_anchors", "devices"])
def test_fused_wrapper_rejects_bad_inputs(bad):
    gts, mask, labels, anchors, _, _ = _torch_case("anchor_mask_partly_false")
    am = None
    if bad == "box_dtype":
        gts = gts.double()
    elif bad == "no_gts":
        gts, mask, labels = gts[:, :0], mask[:, :0], labels[:, :0]
    elif bad == "mask_dtype":
        mask = mask.to(torch.uint8)
    elif bad == "mask_shape":
        mask = mask[:, :-1]
    elif bad == "float_labels":
        labels = labels.float()
    elif bad == "batched_anchors":
        anchors = anchors[None]
    elif bad == "anchor_mask_shape":
        am = torch.ones(anchors.shape[0] + 1, dtype=torch.bool)
    elif bad == "strided_anchors":
        anchors = torch.cat([anchors, anchors], 1)[:, ::2]
    else:
        mask = mask.to("meta")
    # the fused kernel's operand check; good operands pass it (on the CPU)
    assert rik.check_assign_operands(*_torch_case("anchor_mask_partly_false")[:4])
    with pytest.raises((TypeError, ValueError)):
        rik.check_assign_operands(gts, mask, labels, anchors, am)


def test_fused_wrapper_on_cpu_is_the_plain_version():
    gts, mask, labels, anchors, am, _ = _torch_case("gt_max_tied_on_several_anchors")
    before = rik.ASSIGN_LAUNCHES, rik.LAUNCHES
    got = _assign(gts, mask, labels, anchors, am)
    # the plain version: the assigner on box_iou_rotated's matrix
    iou = box_iou_rotated(rik.park_masked_boxes(gts, mask), anchors)
    plain = assign_wrt_overlaps(iou, mask, labels, anchor_mask=am, **THR)
    overlaps = rik.box_iou_rotated_rect(rik.park_masked_boxes(gts, mask), anchors)
    unfused = assign_wrt_overlaps(overlaps, mask, labels, anchor_mask=am, **THR)
    for k in ("gt_inds", "labels"):
        torch.testing.assert_close(got[k], plain[k], rtol=0, atol=0)
        torch.testing.assert_close(got[k], unfused[k], rtol=0, atol=0)
    torch.testing.assert_close(got["max_overlaps"], plain["max_overlaps"], rtol=0, atol=0)
    # one image without a batch dimension
    one = _assign(gts[0], mask[0], labels[0], anchors, am)
    assert all(torch.equal(one[k], got[k][0]) for k in one)
    # the launcher takes CUDA tensors only; above the pair bar, the CPU
    # stays on the plain version
    with pytest.raises(ValueError, match="CUDA"):
        rik.launch_max_iou_assign_rect(gts, mask, labels, anchors, am, 0.5, 0.4, 0.0)
    big = anchors.repeat(440, 1)  # 4 * 264,000 pairs >= 2^20
    out = max_iou_assign_rotated(big, gts[:, :4], mask[:, :4], labels[:, :4], **THR)
    assert out["gt_inds"].shape == (2, big.shape[0])
    assert (rik.ASSIGN_LAUNCHES, rik.LAUNCHES) == before


# On the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ASSIGN_CASES)
def test_fused_kernel_identical_to_unfused_route_on_card(case):
    dev = _card()
    gts, mask, labels, anchors, am, _ = _torch_case(case)
    gts, mask, labels, anchors = (t.to(dev) for t in (gts, mask, labels, anchors))
    am = None if am is None else am.to(dev)
    before = rik.ASSIGN_LAUNCHES
    got = _assign(gts, mask, labels, anchors, am)
    torch.cuda.synchronize()
    assert rik.ASSIGN_LAUNCHES == before + 1
    ov = rik.box_iou_rotated_rect(rik.park_masked_boxes(gts, mask), anchors)
    unfused = assign_wrt_overlaps(ov, mask, labels, anchor_mask=am, **THR)
    for k in got:
        assert got[k].dtype == unfused[k].dtype
        assert torch.equal(got[k], unfused[k]), k
    plain = _assign(*(None if t is None else t.cpu()
                      for t in (gts, mask, labels, anchors, am)))
    for k in ("gt_inds", "labels"):
        torch.testing.assert_close(got[k].cpu(), plain[k], rtol=0, atol=0)
    torch.testing.assert_close(got["max_overlaps"].cpu(), plain["max_overlaps"],
                               rtol=0, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ASSIGN_CASES)
def test_fused_kernel_per_image_identical_to_unfused_route_on_card(case):
    """The fused assigner on per-image anchors against K1's matrix on the
    same anchors plus the PyTorch assigner (identical, max_overlaps to the
    bit), and against the CPU plain version (gt_inds and labels equal)."""
    dev = _card()
    gts, mask, labels, anchors, am, _ = per_image_assign_edge_case(case)
    gts, mask, labels, anchors = (torch.from_numpy(x).to(dev)
                                  for x in (gts, mask, labels, anchors))
    am = None if am is None else torch.from_numpy(am).to(dev)
    before = (rik.ASSIGN_LAUNCHES, rik.ASSIGN_PER_IMAGE_LAUNCHES,
              rik.ASSIGN_PER_IMAGE_MASK_LAUNCHES)
    got = _assign(gts, mask, labels, anchors, am)
    torch.cuda.synchronize()
    assert (rik.ASSIGN_LAUNCHES, rik.ASSIGN_PER_IMAGE_LAUNCHES,
            rik.ASSIGN_PER_IMAGE_MASK_LAUNCHES) == (before[0], before[1] + 1, before[2])
    ov = rik.box_iou_rotated_rect(rik.park_masked_boxes(gts, mask), anchors)
    unfused = assign_wrt_overlaps(ov, mask, labels, anchor_mask=am, **THR)
    for k in got:
        assert got[k].dtype == unfused[k].dtype
        assert torch.equal(got[k], unfused[k]), k
    plain = _assign(*(None if t is None else t.cpu()
                      for t in (gts, mask, labels, anchors, am)))
    for k in ("gt_inds", "labels"):
        torch.testing.assert_close(got[k].cpu(), plain[k], rtol=0, atol=0)
    torch.testing.assert_close(got["max_overlaps"].cpu(), plain["max_overlaps"],
                               rtol=0, atol=2e-4)


@pytest.mark.cuda
def test_rect_kernel_per_image_anchors_on_card():
    dev = _card()
    gts, an = edge_case_boxes(K=10, N=300, seed=5)
    g = torch.from_numpy(gts).to(dev)
    a = torch.from_numpy(np.stack([an, an[::-1]]).astype(np.float32)).to(dev)
    before = rik.LAUNCHES
    got = rik.box_iou_rotated_rect(g, a)
    torch.cuda.synchronize()
    assert rik.LAUNCHES == before + 1
    torch.testing.assert_close(got, rik.box_iou_rotated_rect_reference(g, a),
                               rtol=0, atol=2e-4)
    for b in range(2):
        assert torch.equal(got[b], rik.box_iou_rotated_rect(g[b], a[b].contiguous()))


@pytest.mark.cuda
def test_multiclass_nms_on_card_matches_cpu():
    dev = _card()
    # 30 clusters of 8 jittered boxes, 3 classes, distinct scores
    rng = np.random.RandomState(2)
    centers = rng.uniform(0, 600, (30, 1, 2))
    boxes = np.concatenate([
        centers + rng.normal(0, 6, (30, 8, 2)),
        np.abs(rng.uniform(20, 80, (30, 1, 2)) + rng.normal(0, 4, (30, 8, 2))) + 2,
        rng.uniform(-np.pi / 4, 3 * np.pi / 4, (30, 1, 1)) + rng.normal(0, 0.2, (30, 8, 1)),
    ], -1).reshape(240, 5).astype(np.float32)
    scores = ((rng.permutation(720) + 1) / 721).reshape(240, 3).astype(np.float32)
    kw = dict(score_thr=0.05, nms_iou_thr=0.1, max_per_img=100)
    before = rik.LAUNCHES
    got = multiclass_nms_rotated(torch.from_numpy(boxes)[None].to(dev),
                                 torch.from_numpy(scores)[None].to(dev), **kw)
    assert rik.LAUNCHES == before + 1
    want = multiclass_nms_rotated(torch.from_numpy(boxes)[None],
                                  torch.from_numpy(scores)[None], **kw)
    v = want["valid"]
    assert torch.equal(got["valid"].cpu(), v) and v.any()
    for k in ("boxes", "scores", "labels"):
        assert torch.equal(got[k].cpu()[v], want[k][v]), k


# The RoI head's route: per-image proposals with per-image masks ----------

def _reference_roi_assign(gts, mask, labels, props, pmask, **thr):
    """jdet_tpu's assigner vmapped over images as `oriented_head.py:168`
    runs it: per image its candidates and their mask."""
    import jax
    import jax.numpy as jnp
    from jdet_tpu.models.boxes.assigner import max_iou_assign_rotated as j_assign

    out = jax.vmap(lambda p, g, m, lab, pm: j_assign(p, g, m, lab, anchor_mask=pm, **thr))(
        *map(jnp.asarray, (props, gts, mask, labels, pmask)))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("low_quality", [False, True])
@pytest.mark.parametrize("case", ASSIGN_CASES + ROI_ASSIGN_CASES)
def test_plain_roi_route_matches_reference_vmapped(case, low_quality):
    """The plain version with per-image masks, with and without the
    low-quality match, against the reference vmapped over images:
    gt_inds and labels equal, max_overlaps within 2e-4, -inf alike; and
    image 1 assigned alone equals image 1 of the batch, whatever image 0
    holds."""
    gts, mask, labels, props, pmask = roi_assign_edge_case(case)
    thr = dict(ROI_THR, match_low_quality=low_quality)
    t = [torch.from_numpy(x) for x in (gts, mask, labels, props, pmask)]
    got = max_iou_assign_rotated(t[3], *t[:3], anchor_mask=t[4], **thr)
    want = _reference_roi_assign(gts, mask, labels, props, pmask, **thr)
    np.testing.assert_array_equal(got["gt_inds"].numpy(), want["gt_inds"])
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    mo, want_mo = got["max_overlaps"].numpy(), want["max_overlaps"]
    np.testing.assert_array_equal(np.isfinite(mo), np.isfinite(want_mo))
    fin = np.isfinite(want_mo)
    np.testing.assert_allclose(mo[fin], want_mo[fin], atol=2e-4, rtol=0)
    inds = got["gt_inds"]
    assert (inds[~t[4]] == -1).all()
    assert (inds[1] > 0).any() or case == "all_gts_padding"
    # every real gt, prepended, is its own positive
    real = torch.nonzero(t[1][1])[:, 0]
    assert (inds[1, real] > 0).all()
    one = max_iou_assign_rotated(t[3][1:], *(x[1:] for x in t[:3]), anchor_mask=t[4][1:],
                                 **thr)
    assert all(torch.equal(one[k][0], got[k][1]) for k in one)
    if case in ("no_real_gt", "image_fully_masked"):
        assert (inds[0] <= 0).all() and not got["max_overlaps"][0].any()
    elif case == "all_proposals_masked":
        assert (inds[0, 8:] == -1).all() and (inds[0, :6] > 0).all()
    elif case == "masked_proposals_at_zero":
        assert inds[1, 8:11].tolist() == [1, 1, 1]


def test_wrapper_refuses_what_the_kernel_does_not_do():
    """gt_max_assign_all=False is done (the kernel's first-claim branch):
    its plain version equals the reference vmapped over images on tied
    per-image candidates. What the kernel does not take raises: a mask
    of another shape, a mask of bytes, CPU tensors at the launcher."""
    case = roi_assign_edge_case("gt_max_tied_on_several_anchors")
    gts, mask, labels, props, pmask = (torch.from_numpy(x) for x in case)
    thr = dict(THR, gt_max_assign_all=False)
    got = max_iou_assign_rotated(props, gts, mask, labels, anchor_mask=pmask, **thr)
    want = _reference_roi_assign(*case, **thr)
    for k in ("gt_inds", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    with pytest.raises(ValueError, match="anchor_mask"):
        rik.check_assign_operands(gts, mask, labels, props[0].contiguous(), pmask[:, :-1])
    with pytest.raises(TypeError):
        rik.check_assign_operands(gts, mask, labels, props, pmask.to(torch.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        rik.launch_max_iou_assign_rect(gts, mask, labels, props, pmask, 0.5, 0.5, 0.5, False)


@pytest.mark.cuda
@pytest.mark.parametrize("low_quality", [False, True])
@pytest.mark.parametrize("case", ASSIGN_CASES + ROI_ASSIGN_CASES)
def test_fused_kernel_roi_route_identical_to_unfused_route_on_card(case, low_quality):
    """The fused assigner on per-image proposals with per-image masks:
    identical to K1's matrix + the PyTorch assigner, and equal to the CPU
    plain version's gt_inds and labels; one per-image launch."""
    dev = _card()
    thr = dict(ROI_THR, match_low_quality=low_quality)
    gts, mask, labels, props, pmask = (torch.from_numpy(x).to(dev)
                                       for x in roi_assign_edge_case(case))
    before = (rik.ASSIGN_LAUNCHES, rik.ASSIGN_PER_IMAGE_LAUNCHES,
              rik.ASSIGN_PER_IMAGE_MASK_LAUNCHES)
    got = max_iou_assign_rotated(props, gts, mask, labels, anchor_mask=pmask, **thr)
    torch.cuda.synchronize()
    assert (rik.ASSIGN_LAUNCHES, rik.ASSIGN_PER_IMAGE_LAUNCHES,
            rik.ASSIGN_PER_IMAGE_MASK_LAUNCHES) == (before[0], before[1] + 1, before[2] + 1)
    ov = rik.box_iou_rotated_rect(rik.park_masked_boxes(gts, mask), props)
    unfused = assign_wrt_overlaps(ov, mask, labels, anchor_mask=pmask, **thr)
    for k in got:
        assert got[k].dtype == unfused[k].dtype
        assert torch.equal(got[k], unfused[k]), k
    plain = max_iou_assign_rotated(props.cpu(), gts.cpu(), mask.cpu(), labels.cpu(),
                                   anchor_mask=pmask.cpu(), **thr)
    for k in ("gt_inds", "labels"):
        torch.testing.assert_close(got[k].cpu(), plain[k], rtol=0, atol=0)
    torch.testing.assert_close(got["max_overlaps"].cpu(), plain["max_overlaps"],
                               rtol=0, atol=2e-4)
