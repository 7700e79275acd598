"""The port's drawing (`jdet_torch/utils/draw.py`, `utils/visualization.py`)
and `--task vis_test` against cv2 and jdet_tpu's visualizer, on the CPU.

This host has cv2 (5.0), which the reference's visualizer calls; the port
draws on numpy. Everything is held pixel for pixel:
- `polylines` at thickness 1, 2 and 3, on polygons partly or wholly
  outside the image, against `cv2.polylines` (LINE_8);
- `put_text` at the reference's scales 0.5 and 0.4 against `cv2.putText`
  (FONT_HERSHEY_SIMPLEX, thickness 1, LINE_AA) on printable ASCII
  strings, coloured, on random backgrounds, with origins outside the
  image. Text drawn from approximate glyphs would be held to an ink IoU
  of at least 0.9 and a mean absolute difference of at most 8 levels
  inside cv2.getTextSize's box; the port's is exact, which this file
  asserts;
- `draw_polys` / `visualize_results` and `draw_bboxes` (boxes of width 4,
  5 and 8; palette, named and listed colours), `visualize_gt`, against
  jdet_tpu's, on the same inputs;
- `python -m jdet_torch.tools.run_net --task vis_test --cpu` through the
  Runner writes every image of `images_dir` with its detections drawn,
  equal to the reference's `visualize_results` on the same results.
"""
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from jdet_tpu.utils import visualization as jvis
from jdet_torch.config.constants import DOTA1_CLASSES, class_palette
from jdet_torch.data.image_io import imread
from jdet_torch.data.synthetic import make_synthetic_dota
from jdet_torch.runner import Runner
from jdet_torch.runner.checkpoint import save_checkpoint
from jdet_torch.tools import run_net
from jdet_torch.utils import visualization as tvis
from jdet_torch.utils.draw import polyline_mask, polylines, put_text

FONT = cv2.FONT_HERSHEY_SIMPLEX
PRINTABLE = [chr(c) for c in range(32, 127)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """TensorBoard's import takes ~20 s where TensorFlow is installed."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_class_palette_is_the_references():
    from jdet_tpu.config.constants import class_palette as j_class_palette

    np.testing.assert_array_equal(class_palette(17), j_class_palette(17))


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_polylines_equal_cv2(thickness):
    rng = np.random.RandomState(thickness)
    for trial in range(400):
        h, w = rng.randint(4, 70, 2)
        n = rng.randint(2, 6)
        pts = rng.randint(-40, 110, (n, 2)).astype(np.int32)
        if trial % 4 == 0:  # inside
            pts = rng.randint(0, min(h, w), (n, 2)).astype(np.int32)
        closed = bool(trial % 3)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        want = cv2.polylines(img.copy(), [pts], closed, color, thickness)
        got = polylines(img.copy(), pts, closed, color, thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{pts.tolist()} {closed}")
    # a polygon that misses the image draws nothing
    assert not polyline_mask((10, 10), [[-50, -5], [-20, -30], [-40, -60]], True, 2).any()


@pytest.mark.parametrize("scale", [0.5, 0.4])
def test_put_text_equals_cv2(scale):
    rng = np.random.RandomState(int(scale * 10))
    for trial in range(300):
        text = "".join(rng.choice(PRINTABLE, rng.randint(1, 24)))
        h, w = rng.randint(5, 50), rng.randint(5, 160)
        img = (rng.randint(0, 256, (h, w, 3)) if trial % 2 else
               np.full((h, w, 3), rng.randint(0, 256))).astype(np.uint8)
        org = (int(rng.randint(-30, w)), int(rng.randint(-5, h + 15)))
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        want = cv2.putText(img.copy(), text, org, FONT, scale, color, 1, cv2.LINE_AA)
        got = put_text(img.copy(), text, org, scale, color)
        np.testing.assert_array_equal(got, want, err_msg=f"{text!r} at {org}")
    # the label strings of the visualizer, whole, on a black canvas
    for text in [f"{name} 0.{d}7" for d, name in enumerate(DOTA1_CLASSES)] + ["cls: 3|0.57"]:
        want = cv2.putText(np.zeros((24, 220, 3), np.uint8), text, (2, 16), FONT, scale,
                           (255, 255, 255), 1, cv2.LINE_AA)
        (tw, th), base = cv2.getTextSize(text, FONT, scale, 1)
        ink = want[..., 0] > 0
        ys, xs = np.nonzero(ink)
        assert xs.min() >= 1 and xs.max() <= 2 + tw and ys.min() >= 16 - th - 1
        np.testing.assert_array_equal(put_text(np.zeros_like(want), text, (2, 16), scale,
                                               (255, 255, 255)), want, err_msg=text)


def test_put_text_refuses_an_untabulated_scale():
    with pytest.raises(ValueError, match="0.5"):
        put_text(np.zeros((8, 8, 3), np.uint8), "a", (0, 6), 0.7, (1, 2, 3))


def _dets(rng, n, h, w):
    cx, cy = rng.uniform(-10, w + 10, n), rng.uniform(-10, h + 10, n)
    rb = np.stack([cx, cy, rng.uniform(4, 60, n), rng.uniform(4, 30, n),
                   rng.uniform(-np.pi / 4, 3 * np.pi / 4, n)], 1).astype(np.float32)
    from jdet_torch.data.transforms import rbox_to_poly_np

    return (rb, rbox_to_poly_np(rb), rng.uniform(0, 1, n).astype(np.float32),
            rng.randint(0, 15, n))


def test_draw_polys_equals_the_references():
    rng = np.random.RandomState(0)
    for trial in range(6):
        h, w = 96, 128
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        _, polys, scores, labels = _dets(rng, 12, h, w)
        names = DOTA1_CLASSES if trial % 3 else None
        for thickness in (1, 2):
            want = jvis.draw_polys(img.copy(), polys, scores, labels, names, 0.3, thickness)
            got = tvis.draw_polys(img.copy(), polys, scores, labels, names, 0.3, thickness)
            np.testing.assert_array_equal(got, want)
            assert (got != img).any()


@pytest.mark.parametrize("width", [4, 5, 8])
def test_draw_bboxes_equals_the_references(width, tmp_path):
    rng = np.random.RandomState(width)
    img = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    rb, polys, scores, labels = _dets(rng, 10, 96, 128)
    boxes = {5: rb, 8: polys,
             4: np.concatenate([polys[:, 0::2].min(1, keepdims=True),
                                polys[:, 1::2].min(1, keepdims=True),
                                polys[:, 0::2].max(1, keepdims=True),
                                polys[:, 1::2].max(1, keepdims=True)], 1)}[width]
    cases = [dict(), dict(scores=scores, score_thr=0.3, class_names=DOTA1_CLASSES),
             dict(scores=scores, colors="green", thickness=2, with_text=False),
             dict(colors=[(255, 0, 0), "cyan", np.array([1, 2, 3])], thickness=2),
             dict(scores=scores, score_thr=2.0)]
    for i, kw in enumerate(cases):
        kw = dict(kw, labels=labels % 3 if i == 3 else labels)
        want_file, got_file = str(tmp_path / f"ref{i}.png"), str(tmp_path / f"port{i}.png")
        want = jvis.draw_bboxes(img.copy(), boxes, out_file=want_file, **kw)
        got = tvis.draw_bboxes(img.copy(), boxes, out_file=got_file, **kw)
        np.testing.assert_array_equal(got, want, err_msg=str(kw))
        np.testing.assert_array_equal(imread(got_file), cv2.imread(want_file)[..., ::-1])
    # an image path in, as the reference takes one
    path = str(tmp_path / "in.png")
    cv2.imwrite(path, img[..., ::-1])
    np.testing.assert_array_equal(tvis.draw_bboxes(path, boxes, labels=labels),
                                  jvis.draw_bboxes(path, boxes, labels=labels))


def test_visualize_gt_equals_the_references(tmp_path):
    from jdet_torch.data.dota import DOTADataset

    img_dir, ann = make_synthetic_dota(str(tmp_path / "dota"), n_images=3, size=96,
                                       n_obj=(2, 4), seed=2)
    ds = DOTADataset(annotations_file=ann, images_dir=img_dir, image_size=(96, 96),
                     num_workers=0)
    want = jvis.visualize_gt(ds, str(tmp_path / "ref"))
    got = tvis.visualize_gt(ds, str(tmp_path / "port"))
    assert [os.path.basename(f) for f in got] == [os.path.basename(f) for f in want]
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(imread(g), cv2.imread(w)[..., ::-1])


def test_vis_test_through_the_runner_draws_as_the_reference(tmp_path):
    """run_net --task vis_test --cpu on 4 synthetic tiles, the class bias
    raised through `pretrained_weights` so that untrained scores pass the
    visualizer's 0.3; each written image equals the reference's
    `visualize_results` on the Runner's own results, and differs from its
    input."""
    from test_torch_runner import _mini_cfg

    img_dir, ann = make_synthetic_dota(str(tmp_path / "dota"), n_images=4, size=128,
                                       n_obj=(2, 5), seed=3)
    cfg = _mini_cfg(str(tmp_path), img_dir, ann, work_dir=str(tmp_path / "work"),
                    images_dir=img_dir, dataset_type="DOTA", max_epoch=1)
    runner = Runner(cfg, device="cpu")
    with torch.no_grad():
        runner.model.bbox_head.retina_cls.bias.fill_(1.0)
    ckpt = str(tmp_path / "raised.pkl")
    save_checkpoint(ckpt, runner.model)
    cfg["pretrained_weights"] = ckpt
    cfg_file = tmp_path / "vis_cfg.py"
    cfg_file.write_text("\n".join(f"{k} = {v!r}" for k, v in cfg.items()) + "\n")
    run_net.main(["--config-file", str(cfg_file), "--task", "vis_test", "--cpu"])

    runner = Runner(cfg, device="cpu")
    results = runner.run_on_images(img_dir)
    assert len(results) == 4 and all(d["scores"][d["valid"]].max() > 0.3 for d, _ in results)
    ref_dir = str(tmp_path / "ref_vis")
    jvis.visualize_results(results, DOTA1_CLASSES, img_dir, ref_dir)
    tiles = sorted(f for f in os.listdir(img_dir) if f.endswith(".png"))
    assert sorted(os.listdir(tmp_path / "work" / "vis")) == tiles
    for f in tiles:
        got = imread(str(tmp_path / "work" / "vis" / f))
        np.testing.assert_array_equal(got, cv2.imread(os.path.join(ref_dir, f))[..., ::-1],
                                      err_msg=f)
        assert (got != imread(os.path.join(img_dir, f))).sum() > 100
