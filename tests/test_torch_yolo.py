"""YOLOv5s (`configs/yolov5s_coco.py`) against jdet_tpu, on the CPU: the
model, its loss and `predict`, the model EMA, the Runner and checkpoints.

- The full-width YOLOv5s builds with the reference's parameter names and
  shapes (7,276,605 parameters), strides 8 / 16 / 32 and 25,200
  predictions at 640².
- A narrow YOLOv5s (width 0.125, depth 0.33, 6 classes) with the
  reference's weights and random BN statistics, at 96x128, B=2:
  - the eval-mode maps within 1e-5 of each level's largest value;
  - the three losses (train-mode BN) within 1e-5 relative;
  - the running statistics after 3 train-mode loss forwards within 1e-5
    of each tensor's largest;
  - every gradient under both packages' float64 policy within 1e-5 of
    each tensor's largest. In float32 they spread to ~2e-4: the
    train-mode BNs' backward (eps 1e-3, 12 samples a channel at the
    deepest level) cancels, and the two packages sum in other orders
    (under float64 the network's part agrees to ~1e-7);
  - bf16, the reference compiled with XLA's excess precision off (with
    it on, XLA drops the rounding of each conv's output to bf16 where a
    train-mode BN converts it straight back to float32 for its
    statistics): the eval-mode maps within 0.5 of the reference's own
    bf16 - f32 gap (measured: equal); a train-mode ConvBnAct within one
    bf16 ulp (2^-16 near 0), in at most 1e-3 of its outputs (measured
    3.6e-4: the batch statistics are float32 sums in two orders); and so the whole model's
    three train-mode losses only within 1.5 of the gap (root mean
    square; 0.45 on this draw, 0.49 and 1.34 on two others), since ~60
    train-mode BNs carry those one-ulp flips on;
  - `predict` on the same Detect outputs: identical detection sets
    (the `nms_pre` cut, the per-class offsets, the batched NMS);
  - `fuse()`: the fused model's maps within 1e-5 of the unfused ones.
- `ModelEMA` after 50 updates within 1 ulp of the reference's, per
  element.
- The Runner with `ema`: train, `val` on the EMA weights, save, resume
  with `updates` carried; `run_net` on the committed config at 64² with
  the dataset paths overridden (train with EMA, val, test); the config's
  `nesterov=True` runs plain momentum, as in the reference.
- A reference checkpoint with an `ema` payload loads in a process where
  flax and JAX cannot be imported.

The reference is built abstract and filled with the port's weights; each
of its functions compiles once with XLA's fusion off (`unfused_jit`).
"""
import inspect
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jdet_tpu.models.detectors.yolo import YOLO as JYOLO
from jdet_tpu.models.detectors.yolo import ConvBnAct as JConvBnAct
from jdet_tpu.models.detectors.yolo import YOLOV5S
from jdet_tpu.models.nn import compute_dtype_scope as j_compute_dtype_scope
from jdet_tpu.runner import runner as j_runner_module
from jdet_tpu.runner.checkpoint import numpy_to_state, state_to_numpy
from jdet_tpu.runner.checkpoint import save_checkpoint as j_save_checkpoint
from jdet_tpu.utils.ema import ModelEMA as JModelEMA
from jdet_torch.config import load_cfg_file
from jdet_torch.data.synthetic import make_yolo_tree
from jdet_torch.models import nn as tnn
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import load_from_jax, params_from_jax
from jdet_torch.models.detectors.yolo import YOLO, ConvBnAct
from jdet_torch.runner import Runner, load_checkpoint
from jdet_torch.tools import run_net
from jdet_torch.utils.ema import ModelEMA
from make_codec_fixtures import OUT as FIXTURES
from test_torch_pretrained import _abstract
from test_torch_retina_variants import UNFUSED_OPTIONS, unfused_jit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "yolov5s_coco.py")
SPEC = dict(YOLOV5S, width_multiple=0.125)
NC = 6
B, H, W, K = 2, 96, 128, 8
_JAX_NAMES = {"running_mean": "mean", "running_var": "var"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """TensorBoard's import takes ~20 s where TensorFlow is installed."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def jax_flat(model):
    """The port's state dict under the reference's dotted paths and layouts
    (HWIO kernels, BN scale / mean / var)."""
    out = {}
    for k, v in model.state_dict().items():
        pre, _, leaf = k.rpartition(".")
        v = v.detach().numpy().copy()
        if leaf == "num_batches_tracked":
            continue
        if leaf == "weight" and v.ndim == 4:
            out[f"{pre}.kernel"] = v.transpose(2, 3, 1, 0).copy()
        elif leaf == "weight":
            out[f"{pre}.scale"] = v
        else:
            out[f"{pre}.{_JAX_NAMES.get(leaf, leaf)}"] = v
    return out


def fill_reference(jm, flat):
    nnx.update(jm, numpy_to_state(jm, {k.replace(".", "/"): v for k, v in flat.items()}))
    jm.detect.anchors_px = flat["detect.anchors_px"]
    return jm


def reference(flat, dtype=None):
    """The narrow reference YOLO, abstract, filled with `flat`."""
    def build(rngs):
        return JYOLO(cfg=SPEC, nc=NC, imgsz=128, rngs=rngs)

    if dtype is None:
        return fill_reference(_abstract(build), flat)
    with j_compute_dtype_scope(dtype):
        return fill_reference(_abstract(build), flat)


def weights(seed=0):
    """The narrow port model's weights with BN statistics, scales and
    biases drawn from a seed, under the reference's paths."""
    tm = YOLO(cfg=SPEC, nc=NC, imgsz=128, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    flat = jax_flat(tm)
    draws = {"bn.mean": lambda s: rng.normal(0, 0.2, s), "bn.var": lambda s: rng.uniform(0.5, 2, s),
             "bn.scale": lambda s: rng.uniform(0.5, 1.5, s), "bn.bias": lambda s: rng.normal(0, 0.2, s)}
    for k in flat:
        for end, draw in draws.items():
            if k.endswith(end):
                flat[k] = draw(flat[k].shape).astype(np.float32)
    return flat


def port(flat, dtype=None):
    if dtype is None:
        tm = YOLO(cfg=SPEC, nc=NC, imgsz=128)
    else:
        with tnn.compute_dtype_scope(dtype):
            tm = YOLO(cfg=SPEC, nc=NC, imgsz=128)
    return load_from_jax(tm, flat)


def batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    cxy = rng.uniform(4, [W - 4, H - 4], (B, K, 2))
    wh = rng.uniform(4, 60, (B, K, 2))
    hb = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    mask = np.zeros((B, K), bool)
    mask[0, :6] = True
    mask[1, :3] = True
    return x, {"gt_hboxes": hb, "gt_labels": rng.integers(1, NC + 1, (B, K)).astype(np.int32),
               "gt_mask": mask}


def jt(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


def tt(t):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in t.items()}


def flat_of(state, kind):
    return {".".join(map(str, p)): np.asarray(v.get_value()) for p, v in state.flat_state()
            if type(v).__name__ == kind}


def reference_maps_and_losses(jm):
    """fn(state, x, t) -> (eval-mode maps, train-mode losses, the state
    after them), compiled once."""
    graphdef, state = nnx.split(jm)

    def run(state, x, t):
        m = nnx.merge(graphdef, state)
        maps = m.forward(x, train=False)
        losses = m.loss(x, t)
        return maps, losses, nnx.state(m)

    return run, state


def close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{what}: {err:.3g} of the largest value"


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


# the model --------------------------------------------------------------------------

def test_yolov5s_at_full_width_has_the_reference_structure():
    tm = build_detector(load_cfg_file(CONFIG)["model"], device="cpu")
    jm = _abstract(lambda rngs: JYOLO(nc=80, imgsz=640, rngs=rngs))
    want = {".".join(map(str, p)): (v.get_value() if hasattr(v, "get_value") else v).shape
            for p, v in nnx.state(jm).flat_state()}
    want.pop("detect.anchors_px", None)  # a numpy leaf, absent from the abstract state
    np.testing.assert_array_equal(tm.detect.anchors_px.numpy().reshape(3, 6),
                                  np.float32(YOLOV5S["anchors"]))
    got = params_from_jax(jax_flat(tm), tm)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert {k: tuple(v) for k, v in want.items()} == {
        k: tuple(v.shape) for k, v in jax_flat(tm).items() if k != "detect.anchors_px"}
    assert sum(p.numel() for p in tm.parameters()) == 7_276_605
    assert tm.detect.stride == [8, 16, 32] and tm.detect.nl == 3 and tm.detect.na == 3
    assert sum(3 * s * s for s in tm._feature_sizes(640)) == 25_200
    for conv, s in zip(tm.detect.m, (8, 16, 32)):  # the prior biases
        b = conv.bias.detach().numpy().reshape(3, 85)
        np.testing.assert_array_equal(b[:, 4], np.float32(np.log(8 / (640 / s) ** 2)))
        np.testing.assert_array_equal(b[:, 5:], np.float32(np.log(0.6 / (80 - 0.99))))


# XLA's fusion and LLVM's optimizer off (`UNFUSED_OPTIONS`), and its excess
# precision off: with it on, XLA drops the rounding of each bf16 conv's
# output where a train-mode BN converts it straight back to float32 (a
# no-op in float32)
REFERENCE_OPTIONS = {**UNFUSED_OPTIONS, "xla_allow_excess_precision": False}


def compile_reference(jm, x, t):
    """`reference_maps_and_losses` of `jm` compiled once; (fn, state)."""
    run, state = reference_maps_and_losses(jm)
    args = (state, jnp.asarray(x), jt(t))
    return jax.jit(run).lower(*args).compile(compiler_options=REFERENCE_OPTIONS), state


@pytest.fixture(scope="module")
def f32_reference():
    """The weights, the float32 reference compiled once, its state and its
    outputs on batch(0): the float32 and bf16 tests share them."""
    flat = weights()
    x, t = batch(0)
    compiled, state = compile_reference(reference(flat), x, t)
    return flat, compiled, state, compiled(state, jnp.asarray(x), jt(t))


def test_maps_losses_bn_statistics_and_gradients_match_the_reference(f32_reference):
    flat, compiled, state, first = f32_reference
    tm = port(flat)
    tm.train()
    for step in range(3):
        x, t = batch(step)
        if step == 0:
            maps, losses, state = first
            tm.eval()
            for i, (g, w) in enumerate(zip(tm(torch.from_numpy(x)), maps)):
                close(g.detach().numpy(), w, what=f"level {i}")
            tm.train()
        else:
            maps, losses, state = compiled(state, jnp.asarray(x), jt(t))
        with torch.no_grad():
            got = tm.loss(torch.from_numpy(x), tt(t))
        for k, v in got.items():
            np.testing.assert_allclose(v.item(), float(losses[k]), rtol=1e-5, err_msg=k)
    sd = tm.state_dict()
    for name, v in params_from_jax(flat_of(state, "BatchStat"), tm).items():
        close(sd[name].numpy(), v.numpy(), what=name)

    # the gradients under the float64 policy
    x, t = batch(7)
    x64 = x.astype(np.float64)
    with jax.enable_x64(True):
        jm64 = reference(flat, jnp.float64)
        graphdef, state64 = nnx.split(jm64)

        def loss(state, x, t):
            m = nnx.merge(graphdef, state)
            return sum(m.loss(x, t).values())

        grads = unfused_jit(jax.grad(loss), state64, jnp.asarray(x64), jt(t))
        want = params_from_jax(flat_of(grads, "Param"), tm)
    tm64 = port(flat, torch.float64)
    tm64.train()
    sum(tm64.loss(torch.from_numpy(x64), tt(t)).values()).backward()
    for name, p in tm64.named_parameters():
        close(p.grad.numpy(), want[name].numpy(), what=name)


def test_bf16_within_the_reference_gap(f32_reference):
    flat, _, _, (f_maps, f_losses, _) = f32_reference
    x, t = batch(0)
    compiled, state = compile_reference(reference(flat, jnp.bfloat16), x, t)
    b_maps, b_losses, _ = compiled(state, jnp.asarray(x), jt(t))
    tm = port(flat, torch.bfloat16)
    tm.eval()
    with torch.no_grad():
        maps = [m.float().numpy() for m in tm(torch.from_numpy(x))]
        tm.train()
        losses = {k: v.item() for k, v in tm.loss(torch.from_numpy(x), tt(t)).items()}
    for i, (g, f, b) in enumerate(zip(maps, f_maps, b_maps)):
        f, b = np.asarray(f, np.float32), np.asarray(b, np.float32)
        frac = _rms(g - b) / _rms(b - f)
        assert frac <= 0.5, f"level {i}: {frac:.3f} of the gap"
    g, b, f = (np.array([float(v[k]) for k in sorted(losses)]) for v in (losses, b_losses,
                                                                          f_losses))
    frac = _rms(g - b) / _rms(b - f)
    assert frac <= 1.5, f"losses: {frac:.3f} of the gap"


def test_bf16_train_mode_block_within_one_ulp_of_the_reference():
    """One ConvBnAct in train mode under bf16: the batch statistics are
    float32 sums in two orders, so an output whose float32 value lies
    within their last bits of a bf16 rounding boundary rounds the other
    way; no more than that."""
    rng = np.random.default_rng(12)
    with j_compute_dtype_scope(jnp.bfloat16):
        jb = _abstract(lambda rngs: JConvBnAct(16, 32, 3, 2, rngs=rngs))
    with tnn.compute_dtype_scope(torch.bfloat16):
        tb = ConvBnAct(16, 32, 3, 2)
    flat = {k: rng.normal(0, 0.3, v.shape).astype(np.float32) if k.endswith("kernel") else v
            for k, v in jax_flat(tb).items()}
    nnx.update(jb, numpy_to_state(jb, {k.replace(".", "/"): v for k, v in flat.items()}))
    load_from_jax(tb, flat)
    x = rng.normal(0, 1, (2, 40, 48, 16)).astype(np.float32)
    graphdef, state = nnx.split(jb)

    def run(state, x):
        return nnx.merge(graphdef, state)(x, train=True)

    args = (state, jnp.asarray(x))
    want = np.asarray(jax.jit(run).lower(*args).compile(
        compiler_options=REFERENCE_OPTIONS)(*args), np.float32)
    tb.train()
    with torch.no_grad():
        got = tb(torch.from_numpy(x).permute(0, 3, 1, 2)).float().permute(0, 2, 3, 1).numpy()
    # one bf16 ulp of the larger, or 2^-16 near 0, where the BN's
    # (x - mean) * scale + bias cancels and its float32 error of ~1e-6
    # spans several of bf16's small ulps
    top = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1e-30)
    ulp = np.maximum(np.float32(2.0 ** -7) * 2.0 ** np.floor(np.log2(top)), 2.0 ** -16)
    assert (np.abs(got - want) <= ulp).all()
    assert (got != want).mean() <= 1e-3


def test_predict_on_the_same_outputs_equals_the_reference():
    flat = weights(4)
    jm = reference(flat)
    tm = port(flat)
    for m in (jm, tm):
        m.nms_pre = 512  # below the 1,008 predictions at 96x128: the cut decides
    rng = np.random.default_rng(5)
    outs = []
    for s in (8, 16, 32):
        o = rng.normal(0, 1.5, (B, H // s, W // s, 3, NC + 5))
        o[..., 4] = rng.normal(-1, 3, o.shape[:-1])
        outs.append(o.reshape(B, H // s, W // s, -1).astype(np.float32))
    object.__setattr__(jm, "forward", lambda images, train=False: [jnp.asarray(o) for o in outs])
    want = {k: np.asarray(v) for k, v in jax.jit(jm.predict)(jnp.zeros((B, 1, 1, 3))).items()}
    got = {k: v.numpy() for k, v in tm.predict_from_outputs(
        [torch.from_numpy(o) for o in outs]).items()}
    assert got["valid"].sum(1).min() > 20
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-6, atol=1e-4)


def test_fused_model_matches_the_unfused_one():
    tm = port(weights(6)).eval()
    x = torch.from_numpy(batch(8)[0])
    with torch.no_grad():
        want = [m.numpy() for m in tm(x)]
        got = [m.numpy() for m in tm.fuse()(x)]
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, what=f"level {i}")


# EMA --------------------------------------------------------------------------------

class _States:
    """A stand-in model whose `state_dict()` is the one it is given."""

    def __init__(self, state):
        self.state = state

    def state_dict(self):
        return self.state


def test_ema_after_50_updates_within_one_ulp_of_the_reference():
    """Both EMAs fed the same 50 states (the model's plus noise), the
    reference's as pytrees of its nnx state, the port's as state dicts."""
    jm = reference(weights(9))
    tm = YOLO(cfg=SPEC, nc=NC, imgsz=128)
    base = nnx.state(jm)
    paths, treedef = jax.tree_util.tree_flatten_with_path(base)
    # a leaf's path: dict keys and list indices, then the variable's `value`
    names = [".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in p
                      if not hasattr(k, "name")) for p, _ in paths]
    leaves = [np.asarray(v) for _, v in paths]
    jema = JModelEMA(base, decay=0.9999)
    tema = ModelEMA(state=params_from_jax(dict(zip(names, leaves)), tm), decay=0.9999)
    rng = np.random.default_rng(10)
    for _ in range(50):
        cur = [v + rng.normal(0, 0.05, v.shape).astype(np.float32) for v in leaves]
        jema.update(jax.tree_util.tree_unflatten(treedef, cur))
        tema.update(_States(params_from_jax(dict(zip(names, cur)), tm)))
    assert tema.updates == jema.updates == 50
    want = params_from_jax({k.replace("/", "."): v for k, v in
                            state_to_numpy(jema.ema).items()}, tm)
    assert sorted(want) == sorted(tema.ema) == sorted(tm.state_dict())
    for name, w in want.items():
        g, w = tema.ema[name].numpy(), w.numpy()
        if not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        assert (np.abs(g - w) <= np.spacing(np.abs(w))).all(), name


# the Runner and checkpoints ---------------------------------------------------------

def _tree(root, copies=1):
    jpegs = sorted(os.path.join(FIXTURES, n) for n in os.listdir(FIXTURES)
                   if n.endswith(".jpg"))
    return make_yolo_tree(str(root), jpegs * copies, n_classes=NC, seed=0)


def test_runner_trains_with_ema_evaluates_it_saves_and_resumes(tmp_path):
    img_dir, lab_dir = _tree(tmp_path / "tree")
    split = dict(type="YoloDataset", images_dir=img_dir, labels_dir=lab_dir, img_size=64,
                 batch_size=2, num_workers=0, max_gt=16)
    cfg = dict(model=dict(type="YOLO", cfg=SPEC, nc=NC, imgsz=64), ema=dict(decay=0.9999),
               dataset=dict(train=dict(split, shuffle=True),
                            val=dict(split, augment=False, mosaic=False, drop_last=False)),
               optimizer=dict(type="SGD", lr=0.01, momentum=0.937, weight_decay=5e-4),
               scheduler=dict(type="CosineAnnealingLR", warmup="linear", warmup_iters=2,
                              warmup_ratio=0.1),
               max_epoch=1, eval_interval=1, checkpoint_interval=1, log_interval=1,
               work_dir=str(tmp_path / "work"))
    runner = Runner(cfg, device="cpu")
    runner.train_epoch()
    iters = runner.iter
    assert iters == 3 and runner.ema.updates == iters
    raw = {k: v.clone() for k, v in runner.model.state_dict().items()}
    ema = {k: v.clone() for k, v in runner.ema.ema.items()}
    assert any(not torch.equal(raw[k], ema[k]) for k in raw)
    metrics = runner.val()
    assert set(metrics) == {"eval/coco_mAP", "eval/coco_mAP50", "eval/0_meanAP"}
    for k, v in runner.model.state_dict().items():  # the raw weights are back
        assert torch.equal(v, raw[k]), k
    # val ran on the EMA weights: its detections are the EMA model's
    results = runner._run_inference(runner.val_dataset)
    probe = YOLO(cfg=SPEC, nc=NC, imgsz=64)
    probe.load_state_dict(ema)
    probe.eval()
    b, _ = next(iter(runner.val_dataset.batches()))
    det = probe.predict(b["images"])
    np.testing.assert_array_equal(results[0][0]["scores"], det["scores"][0].numpy())
    path = runner.save()
    with open(path, "rb") as f:
        payload = pickle.load(f)
    assert payload["ema"]["updates"] == iters and payload["ema"]["decay"] == 0.9999
    for k, v in payload["model"].items():
        np.testing.assert_array_equal(v, raw[k].numpy(), err_msg=k)
    resumed = Runner(dict(cfg, resume_path=path), device="cpu")
    assert resumed.iter == iters and resumed.ema.updates == iters
    for k, v in resumed.ema.ema.items():
        assert torch.equal(v, ema[k]), k
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, raw[k]), k
    runner.close()
    resumed.close()


def test_run_net_trains_the_committed_config_with_ema(tmp_path):
    """The committed config at 64² on a tree of 21 JPEGs (one train batch
    of 16): train with EMA, val and test; its `nesterov=True` is not
    passed to the optimizer, as the reference's Runner does not pass it."""
    img_dir, lab_dir = _tree(tmp_path / "tree", copies=3)
    paths = f"images_dir={img_dir!r}, labels_dir={lab_dir!r}, img_size=64, num_workers=0"
    cfg = tmp_path / "yolo.py"
    cfg.write_text(
        f"_base_ = [{CONFIG!r}]\n"
        f"dataset = dict(train=dict({paths}), val=dict({paths}),\n"
        f"               test=dict(type='YoloDataset', {paths}, augment=False, mosaic=False,\n"
        f"                         batch_size=16, drop_last=False))\n"
        f"max_epoch = 1\neval_interval = 1\nwork_dir = {str(tmp_path / 'work')!r}\n")
    seen = {}
    real = Runner.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        seen["runner"] = self

    Runner.__init__ = spy
    try:
        run_net.main(["--config-file", str(cfg), "--cpu"])
    finally:
        Runner.__init__ = real
    runner = seen["runner"]
    group = runner.optimizer.sgd.param_groups[0]
    assert group["nesterov"] is False and group["momentum"] == 0.937
    assert "nesterov" not in inspect.getsource(j_runner_module.Runner.__init__)
    assert runner.iter == 1 and runner.ema.updates == 1
    assert os.path.exists(tmp_path / "work" / "test" / "test_1.pkl")
    with open(tmp_path / "work" / "checkpoints" / "ckpt_1.pkl", "rb") as f:
        assert pickle.load(f)["ema"]["updates"] == 1


LOAD_WITHOUT_FLAX = """
import sys
sys.modules["flax"] = None
sys.modules["jax"] = None
import numpy as np, torch
from jdet_torch.models.detectors.yolo import YOLO, ConvBnAct
from jdet_torch.models.detectors.yolo import YOLOV5S
from jdet_torch.runner import load_checkpoint
want = np.load(sys.argv[2])
model = YOLO(cfg=dict(YOLOV5S, width_multiple=0.125), nc=6, imgsz=128)
meta = load_checkpoint(sys.argv[1], model)
ema = meta["_ema_payload"]
assert ema["updates"] == 3 and ema["decay"] == 0.9999, ema
assert sorted(ema["state"]) == sorted(model.state_dict()), "names"
for k, v in ema["state"].items():
    assert np.array_equal(v.numpy(), want["ema." + k]), k
for k, v in model.state_dict().items():
    assert np.array_equal(v.numpy(), want["model." + k]), k
assert "flax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
print("ok")
"""


def test_reference_ema_checkpoint_loads_without_flax_or_jax(tmp_path):
    flat = weights(11)
    jm = reference(flat)
    jema = JModelEMA(nnx.state(jm), decay=0.9999)
    for _ in range(3):
        jema.update(nnx.state(jm))
    path = str(tmp_path / "ref_ema.pkl")
    j_save_checkpoint(path, jm, meta={"epoch": 1, "iter": 3}, ema=jema)
    tm = port(flat)
    want = {f"model.{k}": v.numpy() for k, v in tm.state_dict().items()}
    want.update({f"ema.{k}": v.numpy() for k, v in params_from_jax(
        {k.replace("/", "."): v for k, v in state_to_numpy(jema.ema).items()}, tm).items()})
    np.savez(tmp_path / "want.npz", **want)
    proc = subprocess.run([sys.executable, "-c", LOAD_WITHOUT_FLAX, path,
                           str(tmp_path / "want.npz")], capture_output=True, text=True,
                          cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-2000:]
    # here, with flax importable, the same reader
    meta = load_checkpoint(path, port(flat))
    assert meta["_ema_payload"]["updates"] == 3
