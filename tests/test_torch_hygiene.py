"""Boundaries of the PyTorch port: it imports nothing of JAX or jdet_tpu
(and its data pipeline neither cv2 nor PIL), its smoke script refuses to
run without a card, and `build_detector`, the Runner and the CLI default
to the card."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import jdet_torch
names = [m.name for m in pkgutil.walk_packages(jdet_torch.__path__, "jdet_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "jdet_tpu", "cv2", "PIL"))
print(len(names), bad)
print(" ".join(names))
"""


def _run(args, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_port_imports_no_jax_and_no_jdet_tpu():
    proc = _run(["-c", _IMPORT_ALL])
    assert proc.returncode == 0, proc.stderr
    counts, names = proc.stdout.strip().split("\n")
    n, bad = counts.split(" ", 1)
    assert int(n) >= 20
    assert bad == "[]", bad
    walked = set(names.split())
    for name in ("jdet_torch.data.image_io", "jdet_torch.data.devkits.voc_eval",
                 "jdet_torch.runner.runner", "jdet_torch.runner.checkpoint",
                 "jdet_torch.tools.run_net", "jdet_torch.tools.merge_results",
                 "jdet_torch.tools.time_paths",
                 "jdet_torch.ops.deform_conv", "jdet_torch.ops.orn",
                 "jdet_torch.models.heads.s2anet_head",
                 "jdet_torch.models.detectors.two_stage", "jdet_torch.models.heads.rpn_heads",
                 "jdet_torch.models.heads.oriented_head", "jdet_torch.ops.roi_align_rotated",
                 "jdet_torch.ops.nms", "jdet_torch.models.boxes.coder",
                 "jdet_torch.models.equivariant.econv", "jdet_torch.models.backbones.re_resnet",
                 "jdet_torch.models.necks.re_fpn", "jdet_torch.ops.riroi_align",
                 "jdet_torch.models.heads.roi_head_base",
                 "jdet_torch.models.heads.obb_roi_heads",
                 "jdet_torch.models.heads.csl_retina_head",
                 "jdet_torch.models.heads.ld_retina_head",
                 "jdet_torch.models.losses.gaussian_dist_loss",
                 "jdet_torch.models.losses.kf_iou_loss",
                 "jdet_torch.models.losses.misc_losses",
                 "jdet_torch.models.losses.smooth_focal_loss",
                 "jdet_torch.models.losses.iou_loss"):
        assert name in walked, name


def test_chip_smoke_refuses_to_run_without_a_card():
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert '"ok"' not in proc.stdout


def test_build_detector_defaults_to_cuda():
    from jdet_torch.models.builder import build_detector

    cfg = dict(
        type="RotatedRetinaNet",
        backbone=dict(type="ResNet", depth=18),
        neck=dict(type="FPN", out_channels=16, num_outs=5, start_level=1),
        bbox_head=dict(type="RotatedRetinaHead", num_classes=3, in_channels=16,
                       feat_channels=16, stacked_convs=1),
    )
    if torch.cuda.is_available():
        model = build_detector(cfg, load_pretrained=False)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            build_detector(cfg, load_pretrained=False)
    model = build_detector(cfg, device="cpu", load_pretrained=False)
    assert next(model.parameters()).device.type == "cpu"


def test_runner_and_cli_default_to_cuda(tmp_path):
    from jdet_torch.runner import Runner

    cfg = dict(work_dir=str(tmp_path), max_epoch=1, model={})
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-only refusal cannot be shown")
    with pytest.raises(RuntimeError, match="CUDA"):
        Runner(cfg)
    proc = _run(["-m", "jdet_torch.tools.run_net", "--config-file",
                 "configs/rotated_retinanet_obb_r50_fpn_1x_dota.py", "--save_dir",
                 str(tmp_path), "--task", "train"])
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
