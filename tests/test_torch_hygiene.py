"""Boundaries of the PyTorch port: it imports nothing of JAX or jdet_tpu,
nor cv2 or PIL (the GPU machine has neither: the port decodes, draws and
writes images itself), its smoke script refuses to run without a card,
and `build_detector`, the Runner and the CLI default to the card."""
import ast
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
                 "jdet_torch.data.jpeg", "jdet_torch.data.tiff", "jdet_torch.data.image_codecs",
                 "jdet_torch.data.coco", "jdet_torch.data.devkits.converters",
                 "jdet_torch.models.backbones.ssd_vgg", "jdet_torch.models.heads.ssd_head",
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
                 "jdet_torch.models.losses.iou_loss",
                 "jdet_torch.models.pretrained", "jdet_torch.models.equivariant.c8_basis",
                 "jdet_torch.models.backbones.lsknet", "jdet_torch.tools.convert_weights",
                 "jdet_torch.models.losses.ridet_loss", "jdet_torch.utils.draw",
                 "jdet_torch.utils.visualization"):
        assert name in walked, name


BANNED = ("jax", "jaxlib", "flax", "optax", "jdet_tpu", "cv2", "PIL")


def test_no_source_file_of_the_port_names_a_banned_import():
    """Every import statement of `jdet_torch/` and `chip_smoke.py`, lazy
    ones inside functions included, which the import test above cannot
    see run."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "jdet_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [(os.path.relpath(path, ROOT), m) for m in mods
                    if m.split(".")[0] in BANNED]
    assert len(files) > 60 and not bad, bad


_NO_JAX = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "jdet_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
import runpy
sys.argv = ["convert_weights"] + sys.argv[1:]
runpy.run_module("jdet_torch.tools.convert_weights", run_name="__main__")
"""


def test_convert_weights_runs_with_jax_unimportable(tmp_path):
    """`python -m jdet_torch.tools.convert_weights` with JAX, flax, optax
    and jdet_tpu made unimportable: a torchvision `.pth` by family, and a
    JDet payload by config."""
    import pickle

    from jdet_torch.models.builder import build_detector

    cfg = dict(type="RotatedRetinaNet", backbone=dict(type="ResNet", depth=18),
               neck=dict(type="FPN", out_channels=16, num_outs=5, start_level=1),
               bbox_head=dict(type="RotatedRetinaHead", num_classes=3, in_channels=16,
                              feat_channels=16, stacked_convs=1))
    model = build_detector(cfg, device="cpu", seed=2, load_pretrained=False)
    state = model.state_dict()
    backbone = {k.split(".", 1)[1].replace(".downsample.conv.", ".downsample.0.")
                .replace(".downsample.bn.", ".downsample.1."): v
                for k, v in state.items() if k.startswith("backbone.")}
    torch.save(backbone, tmp_path / "r18.pth")
    cfg_path = tmp_path / "small.py"
    cfg_path.write_text(f"model = {cfg!r}\n")
    with open(tmp_path / "jdet.pkl", "wb") as f:
        pickle.dump({"meta": {"jdet_version": "0.2"},
                     "model": {k: v.numpy() for k, v in state.items()}}, f)
    for args in (["--src", "r18.pth", "--family", "resnet18", "--out", "r18.jtorch.pkl"],
                 ["--src", "jdet.pkl", "--config-file", str(cfg_path), "--out", "det.pkl",
                  "--strict"]):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = ROOT
        proc = subprocess.run([sys.executable, "-c", _NO_JAX, *args], cwd=tmp_path, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "loaded" in proc.stdout and "0 source keys unused" in proc.stdout, proc.stdout


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
