"""`jdet_torch/tools/time_paths.py`, the tool that times a config's paths
on the card, here on the CPU: its second checkout's package loads apart
from `jdet_torch` and builds the same model from the same seed, and the
tool refuses to run without a card."""
import os
import subprocess
import sys

import pytest
import torch

from jdet_torch.models.builder import build_detector
from jdet_torch.tools.time_paths import load_package

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(
    type="RotatedRetinaNet",
    backbone=dict(type="ResNet", depth=18),
    neck=dict(type="FPN", out_channels=16, num_outs=5, start_level=1),
    bbox_head=dict(type="RotatedRetinaHead", num_classes=3, in_channels=16,
                   feat_channels=16, stacked_convs=1),
)


def test_load_package_builds_the_same_model_apart():
    name = "jdet_torch_against"
    try:
        pkg = load_package(ROOT, name)
        import importlib

        builder = importlib.import_module(f"{name}.models.builder")
        registry = importlib.import_module(f"{name}.utils.registry")
        import jdet_torch.utils.registry as own_registry

        assert pkg.__name__ == name and registry.HEADS is not own_registry.HEADS
        other = builder.build_detector(CFG, device="cpu", seed=3, load_pretrained=False)
        assert type(other).__module__.startswith(f"{name}.")
        want = build_detector(CFG, device="cpu", seed=3, load_pretrained=False).state_dict()
        got = other.state_dict()
        assert list(got) == list(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    finally:
        for m in [m for m in sys.modules if m == name or m.startswith(f"{name}.")]:
            del sys.modules[m]


def test_time_paths_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-only refusal cannot be shown")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "jdet_torch.tools.time_paths",
         "configs/rotated_retinanet_obb_r50_fpn_1x_dota.py", "--bf16"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert "{" not in proc.stdout
