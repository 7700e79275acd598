#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`jdet_torch`) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

1. Checks for a card (exits non-zero without one) and prints its name and
   power limit.
2. Builds every hand-written kernel of the main path from the sources in
   the checkout (`jdet_torch/csrc/`).
3. Holds each kernel against its plain PyTorch version on the card: the
   edge cases of the CPU tests and the main path's shape.
4. Builds Rotated RetinaNet-OBB R50-FPN from
   `configs/rotated_retinanet_obb_r50_fpn_1x_dota.py` at full width with
   random weights, checks the card against the CPU on a small input, then
   drives the main path once at B=2, 1024²: the loss forward, `predict`
   at the config's test_cfg, and `predict` with score_thr=0.0. Kernel
   launch counts are read around that run. Then times each phase.
5. Prints a `{"kernels": [...]}` line, the card line again, and as the last
   line `{"ok": true, "device": {...}}`.

Any failed check raises, and the script exits non-zero without the last
line. TF32 is off throughout, so float32 means float32.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# rect-frame IoU arithmetic for one pair whose boxes can touch
# (the reference kernel's cost estimate, jdet_tpu/ops/pallas_iou.py:306)
IOU_FLOPS_PER_TOUCHING_PAIR = 300
CONFIG = Path(__file__).resolve().parent / "configs/rotated_retinanet_obb_r50_fpn_1x_dota.py"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*a):
    print(*a, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def median_ms(fn, warmup=3, iters=10):
    """Median of `iters` CUDA-event timings of fn() after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def synth_batch(B, size, K=32, real=8, seed=0):
    """Images and padded targets made like `__graft_entry__._synth_batch`:
    `real` gts per image, the rest padding."""
    rng = np.random.RandomState(seed)
    images = rng.rand(B, size, size, 3).astype(np.float32)
    gt = np.zeros((B, K, 5), np.float32)
    mask = np.zeros((B, K), bool)
    labels = np.zeros((B, K), np.int64)
    for b in range(B):
        mask[b, :real] = True
        gt[b, :real] = np.stack([
            rng.uniform(50, size - 50, real), rng.uniform(50, size - 50, real),
            rng.uniform(20, 200, real), rng.uniform(10, 100, real),
            rng.uniform(-np.pi / 4, 3 * np.pi / 4, real)], 1)
        labels[b, :real] = rng.randint(1, 16, real)
    return images, {"gt_bboxes": gt, "gt_labels": labels, "gt_mask": mask}


def to_device(images, targets, device):
    return (torch.as_tensor(images, device=device),
            {k: torch.as_tensor(v, device=device) for k, v in targets.items()})


def edge_case_boxes(K=10, N=300, seed=3):
    """Identical, crossed and touching anchors beside random ones (the
    cases of tests/test_torch_iou_kernel.py)."""
    rng = np.random.RandomState(seed)

    def boxes(n):
        return np.stack([rng.uniform(0, 500, n), rng.uniform(0, 500, n),
                         rng.uniform(8, 200, n), rng.uniform(8, 120, n),
                         rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)

    gts, an = boxes(K), boxes(N)
    an[:K] = gts
    an[K:2 * K] = gts
    an[K:2 * K, 4] += np.pi / 2
    an[2 * K:3 * K] = gts
    an[2 * K:3 * K, 0] += gts[:, 2]
    return np.stack([gts, gts[::-1]]), an


def touching_pairs(gts, anchors):
    """Pairs that pass the kernel's circle pre-test (its data-dependent
    work)."""
    g = gts.reshape(-1, 5)
    n = 0
    for lo in range(0, g.shape[0], 64):
        gb = g[lo:lo + 64, None, :]
        d2 = ((anchors[None, :, :2] - gb[..., :2]) ** 2).sum(-1)
        rsum = 0.5 * (gb[..., 2] + gb[..., 3] + anchors[None, :, 2] + anchors[None, :, 3])
        n += int((d2 < rsum * rsum).sum())
    return n


def check_iou_kernel(rik, head):
    """The IoU kernel against its plain version on the card; returns its
    entry of the kernels line (launches filled in later)."""
    dev = "cuda"
    g, a = edge_case_boxes()
    g, a = torch.as_tensor(g, device=dev), torch.as_tensor(a, device=dev)
    got = rik.box_iou_rotated_rect(g, a)
    want = rik.box_iou_rotated_rect_reference(g, a)
    torch.cuda.synchronize()
    err_edge = (got - want).abs().max().item()
    K = g.shape[1]
    diag = got[0, torch.arange(K), torch.arange(K)]
    diag_err = (diag - 1).abs().max().item()
    log(f"iou kernel, edge cases (2, {K}, {a.shape[0]}): max_abs_err={err_edge:.3e} "
        f"diag_err={diag_err:.3e}")
    check(err_edge <= 2e-4, f"edge cases disagree: {err_edge}")
    check(diag_err <= 1e-5, f"identical boxes: IoU off 1 by {diag_err}")

    # the main path's shape: all anchors at 1024², gts of B=2 x K=32 (8 real)
    sizes = [(1024 // s, 1024 // s) for s in head.anchor_strides]
    anchors = head._flat_anchors(sizes, dev)
    _, t = synth_batch(2, 1024)
    gts = rik.park_masked_boxes(torch.as_tensor(t["gt_bboxes"], device=dev),
                                torch.as_tensor(t["gt_mask"], device=dev))
    B, K, N = gts.shape[0], gts.shape[1], anchors.shape[0]
    check(N == 196416, f"expected 196,416 anchors at 1024², got {N}")
    got = rik.box_iou_rotated_rect(gts, anchors)
    want = rik.box_iou_rotated_rect_reference(gts, anchors)
    torch.cuda.synchronize()
    err_main = (got - want).abs().max().item()
    log(f"iou kernel, main path ({B}, {K}, {N}): max_abs_err={err_main:.3e} "
        f"nonzero={int((got > 0).sum())}")
    check(err_main <= 2e-4, f"main-path shape disagrees: {err_main}")
    check(torch.isfinite(got).all().item(), "non-finite IoU")

    ms = median_ms(lambda: rik.box_iou_rotated_rect(gts, anchors), iters=20)
    plain_ms = median_ms(lambda: rik.box_iou_rotated_rect_reference(gts, anchors))
    nbytes = (B * K * 5 + N * 5 + B * K * N) * 4
    touching = touching_pairs(gts.cpu().numpy(), anchors.cpu().numpy())
    ops = IOU_FLOPS_PER_TOUCHING_PAIR * touching
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    log(f"iou kernel timing: {ms:.4f} ms (plain {plain_ms:.4f} ms); bound "
        f"{max(bytes_ms, ops_ms):.4f} ms = max(bytes {nbytes} -> {bytes_ms:.4f}, "
        f"ops {ops} for {touching} touching pairs -> {ops_ms:.4f})")

    # the config's gt budget (max_gt=512), kernel alone: 512 real gts per image
    _, t512 = synth_batch(2, 1024, K=512, real=512, seed=1)
    g512 = torch.as_tensor(t512["gt_bboxes"], device=dev)
    ms512 = median_ms(lambda: rik.box_iou_rotated_rect(g512, anchors))
    log(f"iou kernel at (2, 512, {N}): {ms512:.4f} ms, output "
        f"{2 * 512 * N * 4} bytes -> bytes bound "
        f"{2 * 512 * N * 4 / HBM_BYTES_PER_S * 1e3:.4f} ms")
    return {
        "name": "rotated_iou_rect",
        "route": "cuda",
        "source": "jdet_torch/csrc/rotated_iou.cu",
        "replaces": "jdet_tpu/ops/pallas_iou.py:148",
        "launches": None,
        "max_abs_err": max(err_edge, err_main),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def check_card_against_cpu(model, cpu_model):
    """The full-width model on the card against the same weights on the
    CPU, B=1 at 512² (large enough that the card's assigner takes the
    kernel, the CPU's the plain version)."""
    images, targets = synth_batch(1, 512, seed=5)
    out = {}
    for name, m, dev in (("cuda", model, "cuda"), ("cpu", cpu_model, "cpu")):
        x, t = to_device(images, targets, dev)
        m.train()
        losses = m.loss(x, t)
        m.eval()
        test_cfg = m.bbox_head.test_cfg
        m.bbox_head.test_cfg = dict(test_cfg, score_thr=0.0)
        det = m.predict(x)
        m.bbox_head.test_cfg = test_cfg
        out[name] = ({k: v.item() for k, v in losses.items()},
                     {k: v.cpu() for k, v in det.items()})
    (lc, dc), (lp, dp) = out["cuda"], out["cpu"]
    log(f"card vs cpu at 512²: losses {lc} vs {lp}")
    for k in lc:
        check(abs(lc[k] - lp[k]) <= 1e-4 * abs(lp[k]), f"{k}: card {lc[k]} cpu {lp[k]}")
    v = dp["valid"]
    same_valid = (dc["valid"] == v).float().mean().item()
    both = dc["valid"] & v
    score_err = (dc["scores"][both] - dp["scores"][both]).abs().max().item()
    log(f"card vs cpu predict: {int(v.sum())} valid on cpu, valid slots agree "
        f"{same_valid:.4f}, top-100 labels agree "
        f"{(dc['labels'][:, :100] == dp['labels'][:, :100]).float().mean().item():.3f}, "
        f"max score err {score_err:.2e}")
    check(v.sum() > 0 and same_valid >= 0.99, "card and cpu detections differ")
    check(score_err <= 1e-4, f"scores differ by {score_err}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from jdet_torch.config import load_cfg_file
    from jdet_torch.models.builder import build_detector
    from jdet_torch.ops import box_iou_rotated
    from jdet_torch.ops import rotated_iou_kernel as rik

    t0 = time.perf_counter()
    lib = rik.build()
    log(f"build: {time.perf_counter() - t0:.2f} s ({lib._name})")
    log(Path(lib._name).with_suffix(".log").read_text().strip())

    cfg = load_cfg_file(CONFIG)["model"]
    model = build_detector(cfg, device="cuda", seed=0, load_pretrained=False)
    head = model.bbox_head
    check(model.backbone.depth == 50 and model.neck.out_channels == 256
          and len(head.cls_convs) == 4 and head.num_anchors == 9
          and head.cls_out_channels == 15, "model is not R50-FPN at full width")
    log(f"model: {sum(p.numel() for p in model.parameters())} parameters")

    entry = check_iou_kernel(rik, head)

    cpu_model = build_detector(cfg, device="cpu", seed=0, load_pretrained=False)
    check_card_against_cpu(model, cpu_model)
    del cpu_model

    images, targets = to_device(*synth_batch(2, 1024), "cuda")
    test_cfg = dict(head.test_cfg)

    def loss_fwd():
        model.train()
        out = model.loss(images, targets)
        model.eval()
        return out

    def predict(score_thr):
        head.test_cfg = dict(test_cfg, score_thr=score_thr)
        return model.predict(images)

    # the main path, once, with the launch counts read around it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rik.LAUNCHES = 0
    losses = loss_fwd()
    torch.cuda.synchronize()
    loss_launches = rik.LAUNCHES
    det = predict(test_cfg["score_thr"])
    det0 = predict(0.0)
    torch.cuda.synchronize()
    entry["launches"] = rik.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    log(f"main path: launches {rik.LAUNCHES} (loss forward {loss_launches}), "
        f"peak memory {peak} bytes")
    check(loss_launches >= 1, "the loss forward did not launch the IoU kernel")

    lv = {k: v.item() for k, v in losses.items()}
    log(f"losses at 1024², B=2: {lv}")
    check(all(np.isfinite(v) for v in lv.values()), "non-finite loss")
    check(lv["loss_cls"] > 0, "loss_cls is not positive")
    for name, d in (("predict", det), ("predict score_thr=0", det0)):
        shapes = {k: tuple(v.shape) for k, v in d.items()}
        log(f"{name}: {shapes}, valid per image {d['valid'].sum(1).tolist()}")
        check(shapes["boxes"] == (2, 2000, 5) and shapes["polys"] == (2, 2000, 8)
              and shapes["scores"] == (2, 2000), f"{name}: shapes {shapes}")
        check(all(torch.isfinite(d[k]).all().item() for k in ("boxes", "polys", "scores")),
              f"{name}: non-finite detections")
    v = det0["valid"]
    check(v.sum().item() > 0, "no valid detections at score_thr=0.0")
    check((det0["boxes"][v][:, 2:4] > 0).all().item(), "degenerate valid boxes")
    check(((det0["labels"][v] >= 0) & (det0["labels"][v] < 15)).all().item(), "bad labels")

    # each phase, and its parts: the network forward, and the head's loss
    # (targets + losses) or post-processing (decode + NMS) on its outputs
    with torch.no_grad():
        outs = head(model.extract_feat(images))

    def head_predict(score_thr):
        head.test_cfg = dict(test_cfg, score_thr=score_thr)
        return head.predict(outs)

    # the NMS's per-class IoU blocks alone: 15 classes x 512 candidates
    rng = np.random.RandomState(7)
    cand = torch.as_tensor(np.stack([
        rng.uniform(0, 1024, (2, 15, 512)), rng.uniform(0, 1024, (2, 15, 512)),
        rng.uniform(10, 200, (2, 15, 512)), rng.uniform(10, 100, (2, 15, 512)),
        rng.uniform(-np.pi / 4, 3 * np.pi / 4, (2, 15, 512))], -1),
        dtype=torch.float32, device="cuda")

    thr = test_cfg["score_thr"]
    times = {"loss_forward_ms": median_ms(loss_fwd, warmup=2, iters=10)}
    with torch.no_grad():
        for name, fn in (
            ("predict_ms", lambda: predict(thr)),
            ("predict_score_thr0_ms", lambda: predict(0.0)),
            ("network_forward_no_grad_ms", lambda: head(model.extract_feat(images))),
            ("head_loss_ms", lambda: head.loss(outs, targets)),
            ("head_predict_ms", lambda: head_predict(thr)),
            ("head_predict_score_thr0_ms", lambda: head_predict(0.0)),
            ("nms_class_iou_ms", lambda: box_iou_rotated(cand, cand)),
        ):
            times[name] = median_ms(fn, warmup=2, iters=10)
    log(f"phases at 1024², B=2 (median of 10): {json.dumps(times)}")

    log(json.dumps({"kernels": [entry]}))
    log(f"card: {card_line()}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
