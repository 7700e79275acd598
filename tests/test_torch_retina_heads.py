"""The Rotated RetinaNet family's heads in jdet_torch against jdet_tpu,
float32 on the CPU: GWD, KLD, KFIoU, RSDet, ATSS, CSL and the hbb
(`fake_rbb`) assigner config.

Each head runs on random 5-level feature maps of a 128² image at width
32, B=2 with 3 real gts of 8 slots per image, as
tests/test_head_variants.py builds its batch, the port's head carrying
the reference's weights through `params_from_jax`. Tolerances: head
outputs atol 1e-4; the losses rtol 1e-4 and the gradients of the total
loss with respect to the head outputs rtol 1e-4, atol 1e-6, both on the
JAX head's outputs, so that conv rounding stays out. CSL's `predict`,
which decodes its angle from the angle logits, is fed the JAX head
outputs; the other heads predict through `RotatedRetinaHead.predict`,
which tests/test_torch_retinanet.py holds so."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import jdet_torch.models.heads  # noqa: F401  (registers the port's heads)
import jdet_tpu.models.heads  # noqa: F401  (registers the reference's heads)
from jdet_tpu.models.pretrained import flat_paths
from jdet_tpu.utils.registry import HEADS as JHEADS
from jdet_torch.models.convert import load_from_jax
from jdet_torch.utils.registry import HEADS, build_from_cfg
from test_torch_retina_variants import _gts, unfused_jit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATSS_ANCHORS = dict(octave_base_scale=4, scales_per_octave=1, anchor_ratios=[1.0])
HEAD_CASES = {
    "gwd": ("GWDRetinaHead", {}),
    "kld": ("KLDRetinaHead", {}),
    "kfiou": ("KFIoURRetinaHead", {}),
    "rsdet": ("RSDetHead", {}),
    "atss": ("RotatedATSSHead", ATSS_ANCHORS),
    "csl": ("CSLRRetinaHead", {}),
    "hbb": ("RotatedRetinaHead", dict(train_cfg=dict(assigner=dict(
        pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0, iou_calculator="fake_rbb")))),
}


def _head_cfg(case):
    head_type, kw = HEAD_CASES[case]
    return dict(type=head_type, num_classes=16, in_channels=32, feat_channels=32,
                stacked_convs=1, test_cfg=dict(nms_pre=64, max_per_img=24, score_thr=0.0), **kw)


@functools.cache
def _head_pair(case):
    """The reference's head, the port's with its weights, and the
    reference's outputs on `_head_batch`'s feature maps."""
    jcfg = _head_cfg(case)
    head_cls = JHEADS.get(jcfg.pop("type"))
    # built under nnx.jit: one compile instead of one per initializer shape
    jhead = nnx.jit(lambda: head_cls(rngs=nnx.Rngs(1), **jcfg))()
    thead = build_from_cfg(_head_cfg(case), HEADS, generator=torch.Generator().manual_seed(0))
    _, flat = flat_paths(jhead)
    load_from_jax(thead, {k: np.asarray(v.get_value()) for k, v in flat.items()})
    feats, _ = _head_batch()
    return jhead, thead, nnx.jit(lambda h, f: h(f))(jhead, [jnp.asarray(f) for f in feats])


def _head_batch(seed=21):
    rng = np.random.RandomState(seed)
    feats = [rng.normal(0, 1, (2, 128 // s, 128 // s, 32)).astype(np.float32)
             for s in (8, 16, 32, 64, 128)]
    gt, mask, labels = _gts(seed)
    return feats, {"gt_bboxes": gt, "gt_labels": labels.astype(np.int32), "gt_mask": mask}


def _to_torch_outs(jouts, requires_grad=False):
    return [tuple(torch.from_numpy(np.array(o)).permute(0, 3, 1, 2).contiguous()
                  .requires_grad_(requires_grad) for o in lvl) for lvl in jouts]


@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_head_outputs_losses_and_gradients_match(case):
    jhead, thead, jouts = _head_pair(case)
    feats, targets = _head_batch()
    with torch.no_grad():
        touts = thead([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    for jl, tl in zip(jouts, touts):
        for j, t in zip(jl, tl):
            np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), np.asarray(j), atol=1e-4)

    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    graphdef, state = nnx.split(jhead)

    def total_and_grad(state, o):
        def total(o):
            losses = nnx.merge(graphdef, state).loss(o, jt)
            return sum(losses.values()), losses
        return jax.value_and_grad(total, has_aux=True)(o)

    (_, want), want_grads = unfused_jit(total_and_grad, state, jouts)
    touts = _to_torch_outs(jouts, requires_grad=True)
    got = thead.loss(touts, {k: torch.from_numpy(v) for k, v in targets.items()})
    assert set(got) == set(want)
    for k in want:
        assert np.isfinite(float(want[k])), k
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, err_msg=k)
    assert float(want["loss_bbox"]) > 0
    sum(got.values()).backward()
    for jl, tl in zip(want_grads, touts):
        for j, t in zip(jl, tl):
            np.testing.assert_allclose(t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(j),
                                       rtol=1e-4, atol=1e-6)


def test_csl_predict_matches_on_jax_head_outputs():
    jhead, thead, jouts = _head_pair("csl")
    # jitted: the reference's NMS runs several times faster so than eagerly
    want = {k: np.asarray(v) for k, v in jax.jit(jhead.predict)(jouts).items()}
    got = {k: v.numpy() for k, v in thead.predict(_to_torch_outs(jouts)).items()}
    v = want["valid"]
    assert v.sum() > 0
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], rtol=1e-6)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], atol=1e-4)
    np.testing.assert_allclose(got["polys"][v], want["polys"][v], atol=1e-4)


def _thead(case):
    return build_from_cfg(_head_cfg(case), HEADS)


def test_head_shapes_and_unported_losses():
    csl = _thead("csl")
    assert tuple(csl.retina_angle_cls.weight.shape) == (9 * 45, 32, 1, 1)
    atss = _thead("atss")
    assert atss.num_anchors == 1 and atss.train_cfg["assigner"] == dict(type="atss", topk=9)
    for kind, item in (("poly_iou", "item 11"), ("poly_giou", "item 11")):
        cfg = dict(_head_cfg("gwd"), type="RotatedRetinaHead", loss_bbox=dict(type=kind))
        with pytest.raises(NotImplementedError, match=item):
            build_from_cfg(cfg, HEADS)
    # ridet is ported (tests/test_torch_ridet.py holds it to the reference)
    cfg = dict(_head_cfg("gwd"), type="RotatedRetinaHead", loss_bbox=dict(type="ridet"))
    assert build_from_cfg(cfg, HEADS).loss_bbox_cfg["type"] == "ridet"
