"""Boundaries of the PyTorch port: it imports nothing of JAX or jdet_tpu,
its smoke script refuses to run without a card, and its builder defaults
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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "jdet_tpu"))
print(len(names), bad)
"""


def _run(args, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_port_imports_no_jax_and_no_jdet_tpu():
    proc = _run(["-c", _IMPORT_ALL])
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.strip().split(" ", 1)
    assert int(n) >= 20
    assert bad == "[]", bad


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
