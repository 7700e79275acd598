"""The Rotated RetinaNet family's configs build in jdet_torch from their
own files, and ResNet-v1d (deep stem, avg-down) against jdet_tpu.

Every config is built at its full width on the CPU with random weights
(the checkpoints it names are not in the checkout). The v1d backbone is
held at depth 18 on a 64² input, float32, rtol 1e-4 with an atol of 1e-4
of the stage's largest value (convolutions sum in another order), its
weights carried through `params_from_jax`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jdet_tpu.models.backbones.resnet import ResNet_v1d as JResNet_v1d
from jdet_torch.config import load_cfg_file
from jdet_torch.models.backbones import ResNet_v1d
from jdet_torch.models.backbones.resnet import avg_pool_valid
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import load_from_jax
from jdet_torch.models.nn import compute_dtype_scope
from test_torch_retinanet import _numpy_params, _randomize_bn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# config file -> (detector, head, classes, anchors per location)
CONFIGS = {
    "gwd_r50_fpn_1x_dota": ("RotatedRetinaNet", "GWDRetinaHead", 15, 9),
    "kld_r50_fpn_1x_dota": ("RotatedRetinaNet", "KLDRetinaHead", 15, 9),
    "kfiou_r50_fpn_1x_dota": ("RotatedRetinaNet", "KFIoURRetinaHead", 15, 9),
    "rsdet_r50_fpn_1x_dota": ("RotatedRetinaNet", "RSDetHead", 15, 9),
    "atss_obb_r50_fpn_1x_dota": ("RotatedRetinaNet", "RotatedATSSHead", 15, 1),
    "csl_r50_fpn_1x_dota": ("RotatedRetinaNet", "CSLRRetinaHead", 15, 9),
    "ld_r50_fpn_1x_dota": ("KnowledgeDistillationSingleStageDetector", "LDRotatedRetinaHead",
                           15, 9),
    "rotated_retinanet_hbb_r50_fpn_1x_dota": ("RotatedRetinaNet", "RotatedRetinaHead", 15, 9),
    "rotated_retinanet_obb_r50v1d_fpn_1x_dota": ("RotatedRetinaNet", "RotatedRetinaHead", 15, 9),
    "rotated_retinanet_obb_r50_fpn_1x_dota1_5": ("RotatedRetinaNet", "RotatedRetinaHead", 16, 9),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_builds_at_full_width(name):
    cfg = load_cfg_file(f"configs/{name}.py")
    model = build_detector(cfg["model"], device="cpu", load_pretrained=False)
    det, head_type, classes, anchors = CONFIGS[name]
    head = model.bbox_head
    assert type(model).__name__ == det and type(head).__name__ == head_type
    assert head.cls_out_channels == classes and head.num_anchors == anchors
    assert head.feat_channels == 256 and len(head.cls_convs) == 4
    assert model.neck.out_channels == 256
    assert model.backbone.depth == (18 if name.startswith("ld_") else 50)
    if name.startswith("ld_"):
        teacher = model.teacher
        assert type(teacher.bbox_head).__name__ == "RotatedRetinaDistributionHead"
        assert teacher.backbone.depth == 50 and teacher.backbone.frozen_stages == 4
        assert tuple(head.retina_reg.weight.shape) == (9 * 5 * 9, 256, 1, 1)
        assert not any(m.training for m in teacher.modules())
    if "hbb" in name:
        assert head.train_cfg["assigner"]["iou_calculator"] == "fake_rbb"
    if "v1d" in name:
        bb = model.backbone
        assert bb.deep_stem and bb.layer2[0].downsample.avg_pool_first
        assert not any(p.requires_grad for p in bb.conv1c.parameters())
    if name.startswith("csl_"):
        assert tuple(head.retina_angle_cls.weight.shape) == (9 * 45, 256, 1, 1)


def test_resnet_v1d_matches():
    jb = nnx.jit(lambda: JResNet_v1d(depth=18, frozen_stages=1, rngs=nnx.Rngs(2)))()
    _randomize_bn(jb, seed=3)
    tb = ResNet_v1d(depth=18, frozen_stages=1)
    load_from_jax(tb, _numpy_params(jb))
    assert tuple(tb.conv1a.weight.shape) == (32, 3, 3, 3)
    assert tb.layer2[0].downsample.conv.stride == 1
    # the frozen stage 1 takes the three stem convs with it
    frozen = [n for n, p in tb.named_parameters() if not p.requires_grad]
    assert {n.split(".")[0] for n in frozen} == {"conv1a", "bn1a", "conv1b", "bn1b", "conv1c",
                                                "bn1c", "layer1"}
    tb.train()
    assert not tb.bn1b.training
    tb.eval()
    x = np.random.RandomState(4).rand(2, 64, 64, 3).astype(np.float32)
    want = nnx.jit(lambda m: m(jnp.asarray(x)))(jb)
    with torch.no_grad():
        got = tb(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(g.shape[-2:]) for g in got] == [(16, 16), (8, 8), (4, 4), (2, 2)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_avg_pool_sums_the_window_in_the_input_dtype():
    """The v1d shortcut's pool adds its 2x2 window in bf16, in window
    order, then divides by 4, as the reference's reduce_window does."""
    x = torch.tensor([[[[1.0, 2.0 ** -8], [2.0 ** -8, 0.0]]]], dtype=torch.bfloat16)
    got = avg_pool_valid(x, 2)
    # (1 + 2^-8) rounds to 1 in bf16, and again with the second 2^-8
    assert got.dtype == torch.bfloat16 and got.item() == 0.25
    assert torch.nn.functional.avg_pool2d(x, 2).item() != 0.25
    with compute_dtype_scope(torch.bfloat16):
        bb = ResNet_v1d(depth=18)
    assert bb(torch.rand(1, 3, 32, 32))[0].dtype == torch.bfloat16
