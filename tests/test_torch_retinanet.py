"""The Rotated RetinaNet slice of jdet_torch against jdet_tpu, float32 on CPU.

The JAX model is the one of tests/test_retinanet_e2e.py (ResNet-18, FPN
64, stacked_convs=2, 128², B=2), with random BN statistics; its weights
are carried into the port through `params_from_jax`. Tolerances: head
outputs atol 1e-4 and stage outputs rtol 1e-4 (with an atol of 1e-4 of
the stage's largest value) — convolutions sum in another order; losses
rtol 1e-4. Predict is fed the JAX head outputs, so that conv rounding
stays out of the NMS comparison. The reference is built under `nnx.jit`
and its calls are compiled once each with XLA's fusion passes off
(`_jitted`), which computes each primitive as eager JAX does: eagerly,
JAX compiles every one of a model's hundreds of primitives apart."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

from jdet_tpu.models.backbones import ResNet as JResNet
from jdet_tpu.models.detectors import RotatedRetinaNet as JRotatedRetinaNet
from jdet_tpu.models.heads import RotatedRetinaHead as JRotatedRetinaHead
from jdet_tpu.models.necks import FPN as JFPN
from jdet_tpu.models.pretrained import flat_paths
from jdet_torch.models.backbones import ResNet
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import load_from_jax, params_from_jax
from test_retinanet_e2e import synthetic_batch
from test_torch_retina_variants import unfused_jit

CFG = dict(
    type="RotatedRetinaNet",
    backbone=dict(type="ResNet", depth=18, frozen_stages=1),
    neck=dict(type="FPN", out_channels=64, num_outs=5, start_level=1,
              add_extra_convs="on_input"),
    bbox_head=dict(type="RotatedRetinaHead", num_classes=16, in_channels=64,
                   feat_channels=64, stacked_convs=2,
                   anchor_strides=(8, 16, 32, 64, 128),
                   test_cfg=dict(nms_pre=256, max_per_img=50)),
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's thread pool on a busy machine made these small models several
    times slower than on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize_bn(module, seed):
    """Give every BN non-trivial statistics so the weight bridge's BN
    mapping is exercised."""
    rng = np.random.RandomState(seed)
    _, flat = flat_paths(module)
    draw = {
        "scale": lambda n: rng.uniform(0.5, 1.5, n),
        "bias": lambda n: rng.normal(0.0, 0.1, n),
        "mean": lambda n: rng.normal(0.0, 0.1, n),
        "var": lambda n: rng.uniform(0.5, 1.5, n),
    }
    bn_prefixes = {p.rsplit(".", 1)[0] for p in flat if p.endswith(".scale")}
    for path, var in flat.items():
        prefix, leaf = path.rsplit(".", 1)
        if prefix in bn_prefixes:
            var.set_value(jnp.asarray(draw[leaf](var.get_value().shape[0]), jnp.float32))


def _numpy_params(module):
    _, flat = flat_paths(module)
    return {k: np.asarray(v.get_value()) for k, v in flat.items()}


def _jitted(module, fn, *args):
    """fn(module, *args), compiled once with XLA's fusion passes off."""
    graphdef, state = nnx.split(module)
    return unfused_jit(lambda s, *a: fn(nnx.merge(graphdef, s), *a), state,
                       *(jax.tree.map(jnp.asarray, a) for a in args))


def _jax_model():
    rngs = nnx.Rngs(0)
    backbone = JResNet(depth=18, frozen_stages=1, rngs=rngs)
    neck = JFPN(backbone.out_channels, 64, num_outs=5, start_level=1,
                add_extra_convs="on_input", rngs=rngs)
    head = JRotatedRetinaHead(
        num_classes=16, in_channels=64, feat_channels=64, stacked_convs=2,
        anchor_strides=(8, 16, 32, 64, 128),
        test_cfg=dict(nms_pre=256, max_per_img=50), rngs=rngs,
    )
    return JRotatedRetinaNet(backbone, neck, head)


@pytest.fixture(scope="module")
def pair():
    # built under nnx.jit: one compile instead of one per initializer
    jmodel = nnx.jit(_jax_model)()
    _randomize_bn(jmodel, seed=1)
    tmodel = build_detector(CFG, device="cpu", load_pretrained=False)
    load_from_jax(tmodel, _numpy_params(jmodel))
    images, targets = synthetic_batch()
    return jmodel, tmodel, np.array(images), {k: np.array(v) for k, v in targets.items()}


def test_params_from_jax_is_strict(pair):
    jmodel, tmodel, _, _ = pair
    flat = _numpy_params(jmodel)
    sd = params_from_jax(flat, tmodel)
    assert sd["backbone.conv1.weight"].shape == (64, 3, 7, 7)
    assert "backbone.bn1.running_var" in sd
    flat.pop("neck.fpn_convs.0.bias")
    with pytest.raises(RuntimeError, match="Missing"):
        load_from_jax(tmodel, flat)
    flat = _numpy_params(jmodel)
    flat["neck.extra.kernel"] = np.zeros((1, 1, 1, 1), np.float32)
    with pytest.raises(RuntimeError, match="Unexpected"):
        load_from_jax(tmodel, flat)
    load_from_jax(tmodel, _numpy_params(jmodel))


_JAX_OUTS = {}


def _jax_outs(jmodel, images):
    """The reference's head outputs on `images`, computed once per model."""
    if id(jmodel) not in _JAX_OUTS:
        _JAX_OUTS[id(jmodel)] = _jitted(jmodel, lambda m, x: m.bbox_head(m.extract_feat(x)),
                                        images)
    return _JAX_OUTS[id(jmodel)]


def test_head_outputs_match(pair):
    jmodel, tmodel, images, _ = pair
    want = _jax_outs(jmodel, images)
    tmodel.eval()
    with torch.no_grad():
        got = tmodel.bbox_head(tmodel.extract_feat(torch.from_numpy(images)))
    assert len(got) == len(want) == 5
    for (gc, gr), (wc, wr) in zip(got, want):
        np.testing.assert_allclose(gc.permute(0, 2, 3, 1).numpy(), np.asarray(wc), atol=1e-4)
        np.testing.assert_allclose(gr.permute(0, 2, 3, 1).numpy(), np.asarray(wr), atol=1e-4)


def test_losses_match(pair):
    jmodel, tmodel, images, targets = pair
    want = _jitted(jmodel, lambda m, x, t: m.loss(x, t), images, targets)
    tmodel.train()
    got = tmodel.loss(torch.from_numpy(images),
                      {k: torch.from_numpy(v) for k, v in targets.items()})
    tmodel.eval()
    for k in ("loss_cls", "loss_bbox"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, err_msg=k)
    assert got["loss_cls"].item() > 0
    # norm_eval: the loss forward used running statistics, and the frozen
    # stem takes no gradient
    assert not tmodel.backbone.conv1.weight.requires_grad
    got["loss_cls"].backward()
    assert tmodel.bbox_head.retina_cls.weight.grad is not None


def test_predict_matches_on_jax_head_outputs(pair):
    jmodel, tmodel, images, _ = pair
    outs = _jax_outs(jmodel, images)
    jmodel.bbox_head.test_cfg = dict(jmodel.bbox_head.test_cfg, score_thr=0.0)
    tmodel.bbox_head.test_cfg = dict(tmodel.bbox_head.test_cfg, score_thr=0.0)
    want = {k: np.asarray(v) for k, v in
            _jitted(jmodel, lambda m, o: m.bbox_head.predict(o), outs).items()}
    touts = [(torch.from_numpy(np.array(c)).permute(0, 3, 1, 2),
              torch.from_numpy(np.array(r)).permute(0, 3, 1, 2)) for c, r in outs]
    got = {k: v.numpy() for k, v in tmodel.bbox_head.predict(touts).items()}
    for k in ("boxes", "polys", "scores", "labels", "valid"):
        assert got[k].shape == want[k].shape, k
    v = want["valid"]
    assert v.sum() > 0
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], rtol=1e-6)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], atol=1e-4)
    np.testing.assert_allclose(got["polys"][v], want["polys"][v], atol=1e-4)

    # a uniform rescale keeps every IoU, so the same boxes come back, each
    # divided by its image's scale_factor
    sf = torch.tensor([2.0, 0.5])
    scaled = {k: v.numpy() for k, v in
              tmodel.bbox_head.predict(touts, {"scale_factor": sf}).items()}
    np.testing.assert_array_equal(scaled["valid"], v)
    np.testing.assert_array_equal(scaled["labels"], got["labels"])
    want_boxes = got["boxes"].copy()
    want_boxes[..., :4] /= sf.numpy()[:, None, None]
    np.testing.assert_allclose(scaled["boxes"][v], want_boxes[v], rtol=1e-6, atol=1e-5)


def test_build_detector_loads_a_converted_backbone(tmp_path):
    """The file format `tools/convert_weights.py` writes: a pickle of
    {"meta", "model": {'/'-separated path: array}}."""
    import pickle

    jb = JResNet(depth=18, frozen_stages=1, rngs=nnx.Rngs(5))
    _randomize_bn(jb, seed=6)
    flat = _numpy_params(jb)
    path = tmp_path / "resnet18.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"meta": {}, "model": {k.replace(".", "/"): v
                                           for k, v in flat.items()}}, f)
    cfg = dict(CFG, backbone=dict(CFG["backbone"], pretrained=str(path)))
    model = build_detector(cfg, device="cpu")
    sd = model.backbone.state_dict()
    np.testing.assert_array_equal(sd["layer2.0.conv1.weight"].numpy(),
                                  flat["layer2.0.conv1.kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["bn1.running_var"].numpy(), flat["bn1.var"])
    cfg = dict(CFG, backbone=dict(CFG["backbone"], pretrained=str(tmp_path / "no.ckpt")))
    with pytest.raises(FileNotFoundError):
        build_detector(cfg, device="cpu")
    build_detector(cfg, device="cpu", load_pretrained=False)


def test_resnet50_backbone_matches():
    jb = nnx.jit(lambda: JResNet(depth=50, frozen_stages=1, rngs=nnx.Rngs(2)))()
    _randomize_bn(jb, seed=3)
    tb = ResNet(depth=50, frozen_stages=1)
    load_from_jax(tb, _numpy_params(jb))
    tb.eval()
    x = np.random.RandomState(4).rand(1, 64, 64, 3).astype(np.float32)
    want = _jitted(jb, lambda m, x: m(x), x)
    with torch.no_grad():
        got = tb(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(g.shape[-2:]) for g in got] == [(16, 16), (8, 8), (4, 4), (2, 2)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
