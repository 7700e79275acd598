"""Weight import in jdet_torch (`models/pretrained.py`, `runner/
checkpoint.py`, `python -m jdet_torch.tools.convert_weights`) against
jdet_tpu's, on the CPU.

Every source file is synthetic: a state dict drawn from a numpy seed
under the names torchvision, jittor, mmcls, e2cnn or JDet write, as
tests/test_pretrained.py draws them. Each case imports the same dict
into the reference's model (`jdet_tpu.models.pretrained`) and into the
port's, and takes the reference's whole state through `params_from_jax`:
the two must be equal tensor for tensor (exactly: the converters only
rename and slice; a ReResNet filter rebuilt from basis coefficients
rounds from float64 once in each package). The C8 basis expansion is
held to the reference's exactly, and the AdamW tests hold the port's
`Optimizer` to the reference's optax chain on the same given gradients:
each parameter's change within 1e-6 of its tensor's largest change.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jdet_tpu.models import builder as _jbuilder  # noqa: F401 (registration)
from jdet_tpu.models.builder import build_detector as j_build_detector
from jdet_tpu.models.equivariant.c8_basis import c8_sampled_basis as j_basis
from jdet_tpu.models.equivariant.c8_basis import expand_filter as j_expand_filter
from jdet_tpu.models.pretrained import assign_flat as j_assign_flat
from jdet_tpu.models.pretrained import backbone_to_flat as j_backbone_to_flat
from jdet_tpu.models.pretrained import flat_paths
from jdet_tpu.models.pretrained import import_jdet_checkpoint as j_import_jdet_checkpoint
from jdet_tpu.models.pretrained import load_pretrained_backbone as j_load_pretrained_backbone
from jdet_tpu.optim.lr_scheduler import build_lr_schedule as j_build_lr_schedule
from jdet_tpu.optim.optimizer import build_optimizer as j_build_optimizer
from jdet_tpu.runner.checkpoint import save_checkpoint as j_save_checkpoint
from jdet_tpu.runner.checkpoint import state_to_numpy
from jdet_tpu.utils.registry import BACKBONES as JBACKBONES
from jdet_torch.models import pretrained
from jdet_torch.models.backbones import LSKNet
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import load_from_jax, params_from_jax
from jdet_torch.models.equivariant.c8_basis import c8_sampled_basis, expand_filter
from jdet_torch.optim import build_lr_schedule, build_optimizer
from jdet_torch.runner.checkpoint import load_checkpoint, save_checkpoint
from jdet_torch.tools import convert_weights
from jdet_torch.utils.registry import BACKBONES

RETINA = dict(
    type="RotatedRetinaNet",
    backbone=dict(type="ResNet", depth=18),
    neck=dict(type="FPN", out_channels=16, num_outs=5, start_level=1,
              add_extra_convs="on_input"),
    bbox_head=dict(type="RotatedRetinaHead", num_classes=4, in_channels=16,
                   feat_channels=16, stacked_convs=1),
)
NARROW_LSK = dict(arch="t", embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_state(jmodel, tmodel):
    """The reference model's whole state, in the port's names."""
    _, flat = flat_paths(jmodel)
    return params_from_jax({k: np.asarray(v.get_value() if hasattr(v, "get_value") else v)
                            for k, v in flat.items()}, tmodel)


def _assert_same_state(jmodel, tmodel):
    want = _reference_state(jmodel, tmodel)
    got = tmodel.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)


def _draw(rng, name, shape):
    """A value for a state-dict entry: BN statistics and scales that a
    real file could hold, any other tensor N(0, 1)."""
    if name.endswith("num_batches_tracked"):
        return np.array(100)
    if name.endswith("running_var"):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _source_sd(tmodel, rename, seed, torch_tensors=False):
    """A source state dict for every entry of the port's `tmodel`, under
    the names `rename(port name)` gives (None: left out)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in tmodel.state_dict().items():
        src = rename(k)
        if src is not None:
            sd[src] = _draw(rng, k, tuple(v.shape))
    if torch_tensors:
        sd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    return sd


def _torchvision_name(k, v1d=False):
    """The port's ResNet names -> torchvision's (plain) or jittor's (v1d)."""
    stem = {"conv1a": "C1.0", "bn1a": "C1.1", "conv1b": "C1.3", "bn1b": "C1.4",
            "conv1c": "C1.6", "bn1c": "C1.7"}
    head, rest = k.split(".", 1)
    if head in stem:
        return f"{stem[head]}.{rest}"
    ds = (".downsample.1.", ".downsample.2.") if v1d else (".downsample.0.", ".downsample.1.")
    return k.replace(".downsample.conv.", ds[0]).replace(".downsample.bn.", ds[1])


def _abstract(build):
    """The reference module `build(rngs)` makes, with abstract leaves
    (`nnx.eval_shape`): the imports fill every leaf, and an eager build
    of ReResNet or LSKNet takes tens of seconds. Constants that the
    constructor reads as Python numbers (LSKNet's drop-path rates) are
    computed at trace time."""
    def traced(rngs):
        with jax.ensure_compile_time_eval():
            return build(rngs)

    return nnx.eval_shape(traced, nnx.Rngs(0))


def _backbones(family, **kw):
    """The reference's backbone (abstract) and the port's."""
    cls = {"resnet": "ResNet", "resnet_v1d": "ResNet_v1d", "reresnet": "ReResNet",
           "lsknet": "LSKNet", "stripnet": "StripNet"}[family]
    jm = _abstract(lambda rngs: JBACKBONES.get(cls)(rngs=rngs, **kw))
    tm = BACKBONES.get(cls)(generator=torch.Generator().manual_seed(1), **kw)
    return jm, tm


# the converters ----------------------------------------------------------------

@pytest.mark.parametrize("v1d", [False, True], ids=["plain", "v1d"])
def test_resnet_import_equals_the_reference(v1d):
    jm, tm = _backbones("resnet_v1d" if v1d else "resnet", depth=18)
    sd = _source_sd(tm, lambda k: _torchvision_name(k, v1d), seed=1)
    sd["fc.weight"], sd["fc.bias"] = np.ones((10, 512), np.float32), np.ones(10, np.float32)
    _, missing, unexpected = j_assign_flat(jm, j_backbone_to_flat(jm, sd), strict=True)
    assert not missing and not unexpected
    loaded, missing, unexpected = pretrained.assign_state(
        tm, pretrained.backbone_to_flat(tm, sd), strict=True)
    assert not missing and not unexpected
    assert len(loaded) == len([k for k in sd if not k.endswith("num_batches_tracked")]) - 2
    _assert_same_state(jm, tm)
    stem = "C1.3.weight" if v1d else "conv1.weight"
    np.testing.assert_array_equal(
        (tm.conv1b if v1d else tm.conv1).weight.detach().numpy(), sd[stem])


def _e2cnn_name(k):
    """The port's ReResNet names -> e2cnn's: a conv's base weight is its
    `filter`, an InnerBatchNorm's `bn` its `batch_norm_[8]`, a downsample
    (conv, bn) Sequential's {0, 1}."""
    k = k.replace(".downsample.conv.", ".downsample.0.").replace(".downsample.bn.",
                                                                   ".downsample.1.")
    return k.replace(".bn.", ".batch_norm_[8].")


def _reresnet_sd(tm, coefficients, seed=2):
    """e2cnn ReResNet state dict for the port's `tm`: each conv's expanded
    filter (O*8, I*8 or in_channels, k, k), or with `coefficients` its
    R2Conv basis coefficients (and an all-zero filter, as a train-mode
    checkpoint holds)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in tm.state_dict().items():
        name = _e2cnn_name(k)
        shape = tuple(v.shape)
        if k.endswith(".weight") and len(shape) in (4, 5):
            base = name[: -len(".weight")]
            if len(shape) == 5:
                of, inf_, _, ks, _ = shape
                kind, in_size = "regular", inf_ * 8
            else:
                of, in_size, ks, _ = shape
                inf_, kind = in_size, "trivial"
            filt_shape = (of * 8, in_size, ks, ks)
            if coefficients:
                n = of * inf_ * c8_sampled_basis(ks, kind).shape[0]
                sd[f"{base}.weights"] = rng.standard_normal(n).astype(np.float32)
                sd[f"{base}.filter"] = np.zeros(filt_shape, np.float32)
            else:
                sd[f"{base}.filter"] = rng.standard_normal(filt_shape).astype(np.float32)
        else:
            sd[name] = _draw(rng, k, shape)
    return sd


@pytest.mark.parametrize("coefficients", [False, True], ids=["filters", "basis_coefficients"])
def test_reresnet_import_equals_the_reference(coefficients):
    jm, tm = _backbones("reresnet", depth=18, base_fields=2)
    sd = _reresnet_sd(tm, coefficients)
    _, missing, unexpected = j_assign_flat(jm, j_backbone_to_flat(jm, sd), strict=True)
    assert not unexpected
    _, missing_t, unexpected = pretrained.assign_state(
        tm, pretrained.backbone_to_flat(tm, sd), strict=True)
    assert not unexpected and not missing_t and len(missing) == 0
    _assert_same_state(jm, tm)


def test_reresnet_refuses_a_zero_filter_without_coefficients():
    with pytest.raises(ValueError, match="all-zero"):
        pretrained.reresnet_to_flat({"conv1.filter": np.zeros((16, 3, 7, 7), np.float32)})


@pytest.mark.parametrize("k,kind,fields", [(1, "regular", (3, 2)), (3, "regular", (2, 3)),
                                           (7, "trivial", (2, 3))])
def test_expand_filter_equals_the_reference(k, kind, fields):
    of, inf_ = fields
    assert np.array_equal(c8_sampled_basis(k, kind), j_basis(k, kind))
    n = of * inf_ * c8_sampled_basis(k, kind).shape[0]
    coeff = np.random.RandomState(k).standard_normal(n)
    np.testing.assert_array_equal(
        expand_filter(coeff, k, of, inf_, kind), j_expand_filter(coeff, k, of, inf_, kind))


def _mmcls_name(k):
    """The port's LSKNet/StripNet names -> mmcls's."""
    for ours, theirs in (("patch_embeds.", "patch_embed"), ("stages.", "block"),
                         ("stage_norms.", "norm")):
        if k.startswith(ours):
            i, rest = k[len(ours):].split(".", 1)
            k = f"{theirs}{int(i) + 1}.{rest}"
    k = k.replace(".gate.", ".spatial_gating_unit.").replace(".mlp.dwconv.", ".mlp.dwconv.dwconv.")
    return k.replace(".ls1", ".layer_scale_1").replace(".ls2", ".layer_scale_2")


@pytest.mark.parametrize("family", ["lsknet", "stripnet"])
def test_lsknet_import_equals_the_reference(family):
    kw = dict(NARROW_LSK, arch="t" if family == "lsknet" else "s")
    jm, tm = _backbones(family, **kw)
    sd = _source_sd(tm, _mmcls_name, seed=3)
    sd["head.weight"] = np.ones((10, 32), np.float32)
    j_assign_flat(jm, j_backbone_to_flat(jm, sd), strict=True)
    _, missing, unexpected = pretrained.assign_state(tm, pretrained.backbone_to_flat(tm, sd),
                                                     strict=True)
    assert not missing and not unexpected
    _assert_same_state(jm, tm)
    np.testing.assert_array_equal(tm.stages[0][0].ls1.detach().numpy(),
                                  sd["block1.0.layer_scale_1"])


def test_vgg16_waits_for_ssdvgg(tmp_path):
    """SSDVGG's import, which waited for the port of SSD: a
    torchvision vgg16 state dict (`features.N`, with mmdet SSDVGG's fc6 and
    fc7 at features.31 and .33) gives the reference's import tensor for
    tensor, through `backbone_to_flat` and through `python -m
    jdet_torch.tools.convert_weights --family vgg16`; L2Norm's scale, which
    the file lacks, stays at its init in both."""
    from jdet_tpu.models.backbones.ssd_vgg import SSDVGG as JSSDVGG

    tm = BACKBONES.get("SSDVGG")()
    jm = _abstract(lambda rngs: JSSDVGG(rngs=rngs))
    # both start from the port's initial values
    init = {(k.rsplit(".", 1)[0] + ".kernel" if v.dim() == 4 else k):
            (v.numpy().transpose(2, 3, 1, 0) if v.dim() == 4 else v.numpy())
            for k, v in tm.state_dict().items()}
    j_assign_flat(jm, init, strict=True)
    rng = np.random.default_rng(7)
    sd = {}
    for i, b, j in pretrained.VGG16_CONV_IDX:
        w = tm.blocks[b][j].weight
        sd[f"features.{i}.weight"] = rng.standard_normal(tuple(w.shape)).astype(np.float32)
        sd[f"features.{i}.bias"] = rng.standard_normal(w.shape[0]).astype(np.float32)
    for i, name in ((31, "fc6"), (33, "fc7")):
        w = getattr(tm, name).weight
        sd[f"features.{i}.weight"] = rng.standard_normal(tuple(w.shape)).astype(np.float32)
        sd[f"features.{i}.bias"] = rng.standard_normal(w.shape[0]).astype(np.float32)
    sd["classifier.0.weight"] = np.zeros((4, 4), np.float32)  # unused by both
    j_assign_flat(jm, j_backbone_to_flat(jm, sd), strict=False)
    loaded, missing, unexpected = pretrained.assign_state(
        tm, pretrained.backbone_to_flat(tm, sd), strict=False)
    assert missing == ["l2norm.weight"] and not unexpected and len(loaded) == 30
    _assert_same_state(jm, tm)

    src, out = str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg16.jtorch.pkl")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, src)
    assert convert_weights.main(["--src", src, "--family", "vgg16", "--out", out]) == 0
    fresh = BACKBONES.get("SSDVGG")()
    fresh.l2norm.weight.data.copy_(tm.l2norm.weight)
    _, missing, _ = pretrained.load_pretrained_backbone(fresh, out)
    assert not missing
    _assert_same_state(jm, fresh)


def _jdet_detector_sd(tmodel, seed=4, torch_tensors=False):
    """A JDet RetinaNet state dict for the port's `tmodel`: torchvision
    names in the backbone, the FPN's convs wrapped in ConvModules
    (`.conv.`) with its extra convs appended to `fpn_convs`."""
    n_fpn = len(tmodel.neck.fpn_convs)

    def rename(k):
        head, rest = k.split(".", 1)
        if head == "backbone":
            return f"backbone.{_torchvision_name(rest)}"
        if head == "neck":
            kind, i, leaf = rest.split(".")
            if kind == "extra_convs":
                kind, i = "fpn_convs", int(i) + n_fpn
            return f"neck.{kind}.{i}.conv.{leaf}"
        return k

    return _source_sd(tmodel, rename, seed, torch_tensors)


def _retina_pair():
    """The reference's detector (abstract: the imports fill every leaf)
    and the port's."""
    return (nnx.eval_shape(lambda: j_build_detector(RETINA, seed=0)),
            build_detector(RETINA, device="cpu", seed=1, load_pretrained=False))


def test_detector_import_equals_the_reference():
    jm, tm = _retina_pair()
    sd = _jdet_detector_sd(tm)
    assert "neck.fpn_convs.3.conv.weight" in sd and len(tm.neck.extra_convs) == 2
    _, missing, unexpected = j_import_jdet_checkpoint(jm, {"meta": {}, "model": sd})
    assert not missing and not unexpected
    loaded, missing, unexpected = pretrained.import_jdet_checkpoint(tm, {"meta": {}, "model": sd})
    assert not missing and not unexpected and len(loaded) == len(
        [k for k in sd if not k.endswith("num_batches_tracked")])
    _assert_same_state(jm, tm)
    np.testing.assert_array_equal(tm.neck.extra_convs[0].weight.detach().numpy(),
                                  sd["neck.fpn_convs.3.conv.weight"])


# files: checkpoints, backbone.pretrained, the CLI ------------------------------

@pytest.mark.parametrize("raw", [False, True], ids=["payload", "raw_state_dict"])
def test_load_checkpoint_takes_a_jdet_payload(tmp_path, raw):
    """`load_checkpoint` (as `Runner.load` calls it) imports a JDet payload
    ({"meta": {"jdet_version"}, "model"}) or a raw state dict, as the
    reference's does."""
    from jdet_tpu.runner.checkpoint import load_checkpoint as j_load_checkpoint

    jm, tm = _retina_pair()
    sd = _jdet_detector_sd(tm)
    payload = sd if raw else {"meta": {"jdet_version": "0.2", "epoch": 12}, "model": sd}
    path = str(tmp_path / "ckpt_12.pkl")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    assert j_load_checkpoint(path, jm).get("epoch") == (None if raw else 12)
    opt = build_optimizer(tm, lr_schedule=lambda c: 0.01)
    meta = load_checkpoint(path, tm, opt)
    assert meta.get("epoch") == (None if raw else 12) and opt.count == 0
    _assert_same_state(jm, tm)


@pytest.mark.parametrize("ext", [".pth", ".pkl"])
def test_backbone_pretrained_takes_a_raw_file(tmp_path, ext):
    """`backbone.pretrained` converts a torchvision `.pth` (torch.save of
    tensors) or a jittor `.pkl` (pickle of numpy arrays) on the fly, as
    the reference's does."""
    _, probe = _retina_pair()
    sd = _source_sd(probe.backbone, _torchvision_name, seed=5, torch_tensors=ext == ".pth")
    path = str(tmp_path / f"resnet18{ext}")
    if ext == ".pth":
        torch.save(sd, path)
    else:
        with open(path, "wb") as f:
            pickle.dump(sd, f)
    jbb = _abstract(lambda rngs: JBACKBONES.get("ResNet")(depth=18, rngs=rngs))
    j_load_pretrained_backbone(jbb, path)
    cfg = dict(RETINA, backbone=dict(RETINA["backbone"], pretrained=path))
    tm = build_detector(cfg, device="cpu", seed=1)
    _assert_same_state(jbb, tm.backbone)


def test_backbone_pretrained_takes_a_file_of_the_jax_tool(tmp_path):
    """A file that the JAX package's `tools/convert_weights.py` wrote
    ({"meta": {"jdet_tpu_version"}, "model": flax paths}) still loads."""
    jbb, _ = _lsk_pair()
    path = str(tmp_path / "lsknet.jtp.pkl")
    with open(path, "wb") as f:
        pickle.dump({"meta": {"jdet_tpu_version": "0.1.0", "family": "lsknet_t"},
                     "model": state_to_numpy(nnx.state(jbb))}, f)
    tbb = LSKNet(**NARROW_LSK)
    _, missing, unexpected = pretrained.load_pretrained_backbone(tbb, path)
    assert not missing and not unexpected
    _assert_same_state(jbb, tbb)


def test_convert_weights_cli_on_a_family_and_a_config(tmp_path, capsys):
    """The CLI on a torchvision ResNet-18 `.pth` (`--family resnet18`) and
    on a JDet payload with a config; the files it writes load into the
    port equal to the reference's imports."""
    jbb, tbb = _backbones("resnet", depth=18)
    sd = _source_sd(tbb, _torchvision_name, seed=6, torch_tensors=True)
    src, out = str(tmp_path / "r18.pth"), str(tmp_path / "r18.jtorch.pkl")
    torch.save(sd, src)
    assert convert_weights.main(["--src", src, "--family", "resnet18", "--out", out]) == 0
    assert "left at init" in capsys.readouterr().out
    j_load_pretrained_backbone(jbb, src)
    fresh = BACKBONES.get("ResNet")(depth=18)
    _, missing, _ = pretrained.load_pretrained_backbone(fresh, out)
    assert not missing
    _assert_same_state(jbb, fresh)

    cfg_path = tmp_path / "retina_small.py"
    cfg_path.write_text(f"model = {RETINA!r}\n")
    jm, tm = _retina_pair()
    src, out = str(tmp_path / "jdet.pkl"), str(tmp_path / "jdet.jtorch.pkl")
    with open(src, "wb") as f:
        pickle.dump({"meta": {"jdet_version": "0.2"}, "model": _jdet_detector_sd(tm)}, f)
    assert convert_weights.main(["--src", src, "--config-file", str(cfg_path),
                                 "--out", out, "--strict"]) == 0
    j_import_jdet_checkpoint(jm, src)
    meta = load_checkpoint(out, tm)
    assert meta["imported_from"] == src and "jdet_torch_version" in meta
    _assert_same_state(jm, tm)


# AdamW --------------------------------------------------------------------------

SCHED = dict(steps_per_epoch=10, warmup="linear", warmup_iters=4, warmup_ratio=1.0 / 3)
ADAM_KW = dict(weight_decay=0.05, grad_clip=dict(max_norm=1.0),
               param_groups=[{"pattern": "stages.0.*", "lr_mult": 0.0},
                             {"pattern": "stage_norms.*", "lr_mult": 0.5}])


def _lsk_pair():
    """The narrow LSKNet in both packages with the same weights, drawn
    N(0, 0.05) (BN variances U(0.5, 1.5)), so that 3 updates at lr 0.1
    move each value by about its own size and the float32 rounding of the
    values stays far below 1e-6 of the change."""
    jm = _abstract(lambda rngs: JBACKBONES.get("LSKNet")(rngs=rngs, **NARROW_LSK))
    _, flat = flat_paths(jm)
    rng = np.random.RandomState(4)
    weights = {k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith(".var")
                   else rng.normal(0.0, 0.05, v.shape)).astype(np.float32)
               for k, v in flat.items()}
    j_assign_flat(jm, weights, strict=True)
    tm = LSKNet(**NARROW_LSK)
    load_from_jax(tm, weights)
    return jm, tm


def _given_grads(jm, step):
    """Gradients of every parameter, from a seed per step, large enough
    that the clip at 1.0 scales them."""
    rng = np.random.RandomState(10 + step)
    params = nnx.state(jm, nnx.Param)
    return jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
                        params)


def _set_torch_grads(tm, jgrads):
    flat = {".".join(map(str, path)): np.asarray(
        leaf.get_value() if hasattr(leaf, "get_value") else leaf)
        for path, leaf in nnx.to_flat_state(jgrads)}
    grads = params_from_jax(flat, tm)
    for name, p in tm.named_parameters():
        p.grad = grads[name].clone()


def _assert_update_matches(jm, tm, start):
    want = _reference_state(jm, tm)
    names = dict(tm.named_parameters())
    moved = 0
    for name, p in names.items():
        got, w, s = p.detach().numpy(), want[name].numpy(), start[name]
        scale = np.abs(w - s).max()
        if name.startswith("stages.0."):
            assert scale == 0 and np.array_equal(got, s), name
            continue
        moved += 1
        np.testing.assert_allclose(got - s, w - s, rtol=0, atol=1e-6 * scale, err_msg=name)
    assert moved > 10


@pytest.mark.parametrize("opt_type", ["AdamW", "Adam"])
def test_adam_updates_equal_the_reference(opt_type):
    """Three updates on the same given gradients: global-norm clip, Adam's
    moments, AdamW's decoupled decay on every parameter, a frozen
    (multiplier 0) stage and a half-rate group, under a linear warmup."""
    jm, tm = _lsk_pair()
    start = {n: p.detach().numpy().copy() for n, p in tm.named_parameters()}
    jopt = j_build_optimizer(jm, opt_type=opt_type, lr_schedule=j_build_lr_schedule(0.1, **SCHED),
                             **ADAM_KW)
    topt = build_optimizer(tm, opt_type=opt_type, lr_schedule=build_lr_schedule(0.1, **SCHED),
                           **ADAM_KW)
    assert topt.kind == opt_type.lower()
    update = nnx.jit(lambda m, o, g: o.update(m, g))
    for step in range(3):
        g = _given_grads(jm, step)
        update(jm, jopt, g)
        _set_torch_grads(tm, g)
        topt.step()
    assert topt.count == 3
    _assert_update_matches(jm, tm, start)


def test_resume_from_a_jdet_tpu_adamw_checkpoint(tmp_path):
    """A jdet_tpu checkpoint after 2 AdamW updates (its optax state holds
    Adam's count beside mu/nu and the schedule's count): the port takes
    the weights, both moments and both counts, and its 3rd update equals
    the reference's. Then the port's own checkpoint round trip keeps the
    state."""
    jm, tm = _lsk_pair()
    jopt = j_build_optimizer(jm, opt_type="AdamW", lr_schedule=j_build_lr_schedule(0.1, **SCHED),
                             **ADAM_KW)
    update = nnx.jit(lambda m, o, g: o.update(m, g))
    for step in range(2):
        update(jm, jopt, _given_grads(jm, step))
    path = str(tmp_path / "jtpu.pkl")
    j_save_checkpoint(path, jm, jopt, meta={"iter": 7})
    with open(path, "rb") as f:
        counts = sorted(k for k in pickle.load(f)["optimizer"] if k.endswith("/count"))
    assert len(counts) == 2, counts
    topt = build_optimizer(tm, opt_type="AdamW", lr_schedule=build_lr_schedule(0.1, **SCHED),
                           **ADAM_KW)
    load_checkpoint(path, tm, topt)
    assert topt.count == 2
    state = topt.state_by_name(tm)
    assert "stages.0.0.ls1" not in state and len(state) == len(topt.updated())
    assert all(float(s["step"]) == 2.0 for s in state.values())
    start = {n: p.detach().numpy().copy() for n, p in tm.named_parameters()}
    g = _given_grads(jm, 2)
    update(jm, jopt, g)
    _set_torch_grads(tm, g)
    topt.step()
    _assert_update_matches(jm, tm, start)

    ours = str(tmp_path / "jtorch.pkl")
    save_checkpoint(ours, tm, topt)
    tm2 = LSKNet(**NARROW_LSK)
    topt2 = build_optimizer(tm2, opt_type="AdamW", lr_schedule=build_lr_schedule(0.1, **SCHED),
                            **ADAM_KW)
    load_checkpoint(ours, tm2, topt2)
    assert topt2.count == 3
    got = topt2.state_by_name(tm2)
    for name, st in topt.state_by_name(tm).items():
        for k, v in st.items():
            assert torch.equal(got[name][k], v), (name, k)
    sgd = build_optimizer(tm2, lr_schedule=build_lr_schedule(0.1, **SCHED))
    with pytest.raises(ValueError, match="sgd"):
        load_checkpoint(ours, tm2, sgd)
