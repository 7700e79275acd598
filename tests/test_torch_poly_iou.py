"""The polygon IoU losses (`PolyIoULoss`, `PolyGIoULoss`) and the
RetinaNet head's `poly_iou` / `poly_giou` in jdet_torch against jdet_tpu,
float32 on the CPU.

- `poly_iou_loss` (log and linear) and `poly_giou_loss` on rboxes and on
  their quads, with per-pair and per-coordinate weights (zeros among
  them), on pairs that are identical, turned by pi/2, squares, disjoint
  (the IoU clipped at eps) and random: the reductions' values rtol 1e-5
  and the gradients with respect to the predictions within 1e-5 of the
  largest (`jax.grad`); on rboxes also the per-pair losses, a sum under
  per-coordinate weights and the unweighted mean, rtol 1e-5; the port
  evaluates only the pairs of nonzero weight;
- the RetinaNet head (width 32, one tower conv, 128², B=2) with each
  loss, on the reference's head outputs: the losses rtol 1e-4 and their
  gradients with respect to the outputs rtol 1e-4, atol 1e-6, as
  tests/test_torch_retina_heads.py holds the other heads.

Each reference function is compiled once.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import jdet_torch.models.heads  # noqa: F401  (registers the port's heads)
import jdet_tpu.models.heads  # noqa: F401  (registers the reference's heads)
from jdet_tpu.models.losses import poly_giou_loss as j_poly_giou
from jdet_tpu.models.losses import poly_iou_loss as j_poly_iou
from jdet_tpu.models.pretrained import flat_paths
from jdet_tpu.ops.box_convert import rbox_to_poly as j_rbox_to_poly
from jdet_tpu.utils.registry import HEADS as JHEADS
from jdet_torch.models.convert import load_from_jax
from jdet_torch.models.losses import poly_giou_loss, poly_iou_loss
from jdet_torch.utils.registry import HEADS, LOSSES, build_from_cfg
from test_torch_retina_heads import _head_batch, _to_torch_outs
from test_torch_retina_variants import unfused_jit

LOSS_CASES = {"iou_log": dict(linear=False), "iou_linear": dict(linear=True), "giou": {}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(n=48, seed=0):
    rng = np.random.RandomState(seed)
    target = np.stack([rng.uniform(20, 200, n), rng.uniform(20, 200, n), rng.uniform(4, 80, n),
                       rng.uniform(4, 60, n), rng.uniform(-np.pi, np.pi, n)], 1)
    pred = target + rng.normal(0, [4, 4, 5, 5, 0.3], (n, 5))
    pred[:, 2:4] = np.abs(pred[:, 2:4]) + 1
    pred[0] = target[0]  # identical
    pred[1] = target[1, [0, 1, 3, 2, 4]] + [0, 0, 0, 0, np.pi / 2]  # the same box turned
    target[2, 3] = target[2, 2]
    pred[2] = target[2] + [1, -1, 0, 0, np.pi / 4]  # squares
    pred[3] = target[3] + [300, 0, 0, 0, 0]  # disjoint
    weight = rng.uniform(0.5, 2.0, n)
    weight[4:12] = 0.0
    weight[3] = 1.0
    weight5 = np.repeat(weight[:, None], 5, 1) * rng.uniform(0.5, 1.5, (n, 5))
    weight5[4:12] = 0.0
    f = np.float32
    return dict(pred=pred.astype(f), target=target.astype(f), weight=weight.astype(f),
                weight5=weight5.astype(f))


def _loss_fns(jax_side):
    iou, giou = (j_poly_iou, j_poly_giou) if jax_side else (poly_iou_loss, poly_giou_loss)
    return {k: functools.partial(giou if k == "giou" else iou, **kw)
            for k, kw in LOSS_CASES.items()}


def _reference_losses(x):
    """Per loss and input form, the weighted mean and its gradient; on
    rboxes also the per-pair losses, a sum under per-coordinate weights
    and the unweighted mean."""
    out = {}
    t8 = j_rbox_to_poly(x["target"])
    for name, fn in _loss_fns(True).items():
        for form in ("rbox", "poly"):
            def mean(p, form=form, fn=fn):
                if form == "poly":
                    return fn(j_rbox_to_poly(p), t8, weight=x["weight"], avg_factor=11.0)
                return fn(p, x["target"], weight=x["weight"], avg_factor=11.0)

            value, grad = jax.value_and_grad(mean)(x["pred"])
            out[f"{name}_{form}"] = dict(mean=value, grad=grad)
        out[f"{name}_rbox"].update(
            none=fn(x["pred"], x["target"], weight=x["weight"], reduction="none"),
            sum5=fn(x["pred"], x["target"], weight=x["weight5"], reduction="sum"),
            plain=fn(x["pred"], x["target"]))
    return out


@functools.cache
def _reference():
    x = {k: jnp.asarray(v) for k, v in _pairs().items()}
    return _pairs(), jax.tree.map(np.asarray, unfused_jit(_reference_losses, x))


@pytest.mark.parametrize("form", ["rbox", "poly"])
@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_poly_losses_and_gradients_match(name, form):
    x, want = _reference()
    w = want[f"{name}_{form}"]
    fn = _loss_fns(False)[name]
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    from jdet_torch.ops.box_convert import rbox_to_poly

    def as_form(b):
        return b if form == "rbox" else rbox_to_poly(b)

    pred = t["pred"].clone().requires_grad_()
    mean = fn(as_form(pred), as_form(t["target"]), weight=t["weight"], avg_factor=11.0)
    mean.backward()
    np.testing.assert_allclose(mean.item(), w["mean"], rtol=1e-5)
    g = pred.grad.numpy()
    assert np.isfinite(g).all() and (g[4:12] == 0).all() and np.abs(w["grad"]).max() > 0
    np.testing.assert_allclose(g, w["grad"], rtol=0, atol=1e-5 * np.abs(w["grad"]).max())
    if form == "poly":
        return
    none = fn(t["pred"], t["target"], weight=t["weight"], reduction="none")
    np.testing.assert_allclose(none.numpy(), w["none"], rtol=1e-5, atol=1e-7)
    got = fn(t["pred"], t["target"], weight=t["weight5"], reduction="sum")
    np.testing.assert_allclose(got.item(), w["sum5"], rtol=1e-5)
    np.testing.assert_allclose(fn(t["pred"], t["target"]).item(), w["plain"], rtol=1e-5)


def test_registry_builds_the_polygon_losses():
    for name in ("PolyIoULoss", "PolyGIoULoss", "ConvexGIoULoss"):
        assert callable(build_from_cfg(dict(type=name), LOSSES)), name
    fn = build_from_cfg(dict(type="PolyIoULoss", linear=True), LOSSES)
    x = _pairs(8)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    np.testing.assert_allclose(fn(t["pred"], t["target"]).item(),
                               poly_iou_loss(t["pred"], t["target"], linear=True).item())


# the RetinaNet head ----------------------------------------------------------------

HEAD_KINDS = ("poly_iou", "poly_giou")


def _head_cfg(kind):
    return dict(type="RotatedRetinaHead", num_classes=16, in_channels=32, feat_channels=32,
                stacked_convs=1, loss_bbox=dict(type=kind),
                test_cfg=dict(nms_pre=64, max_per_img=24, score_thr=0.0))


@functools.cache
def _heads():
    """The port's heads (one per loss) with the reference head's weights,
    and the reference's outputs, losses of each kind and their gradients
    with respect to the outputs, compiled once."""
    feats, targets = _head_batch()
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    jcfg = _head_cfg(HEAD_KINDS[0])
    head_cls = JHEADS.get(jcfg.pop("type"))
    jhead = nnx.jit(lambda: head_cls(rngs=nnx.Rngs(1), **jcfg))()
    _, flat = flat_paths(jhead)
    theads = [load_from_jax(build_from_cfg(_head_cfg(kind), HEADS),
                            {k: np.asarray(v.get_value()) for k, v in flat.items()})
              for kind in HEAD_KINDS]
    graphdef, state = nnx.split(jhead)
    jfeats = [jnp.asarray(f) for f in feats]

    def run(state):
        head = nnx.merge(graphdef, state)
        outs = head(jfeats)
        out = []
        for kind in HEAD_KINDS:
            head.loss_bbox_cfg = dict(type=kind)

            def total(o):
                losses = head.loss(o, jt)
                return sum(losses.values()), losses

            (_, losses), grads = jax.value_and_grad(total, has_aux=True)(outs)
            out.append((outs, losses, grads))
        return out

    return theads, jax.tree.map(np.asarray, unfused_jit(run, state)), targets


@pytest.mark.parametrize("kind", HEAD_KINDS)
def test_retina_head_with_polygon_loss_matches(kind):
    theads, runs, targets = _heads()
    i = HEAD_KINDS.index(kind)
    thead, (jouts, want, want_grads) = theads[i], runs[i]
    assert thead.loss_bbox_cfg["type"] == kind
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
            assert torch.isfinite(t.grad).all()
            np.testing.assert_allclose(t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(j),
                                       rtol=1e-4, atol=1e-6)
