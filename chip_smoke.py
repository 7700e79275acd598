#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`jdet_torch`) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root
    python3 chip_smoke.py --old-generic build/parent_rotated_iou.cu
                                   # also times another copy's K2 in turns

1. Checks for a card (exits non-zero without one) and prints its name and
   power limit.
2. Builds the hand-written kernels from the sources in the checkout
   (`jdet_torch/csrc/rotated_iou.cu`: K1, the rect IoU, as a matrix kernel
   and as the max-IoU assigner fused onto it; K2, the generic IoU kernel)
   with nvcc, and at the same time the host polygon library
   (`jdet_torch/csrc/polygon.cpp`) with g++.
3. Holds each kernel against its plain PyTorch version on the card: the
   edge cases of the CPU tests and the main path's shapes; times both.
   K1's matrix route at the NMS's (30, 512, 512) per-class self-IoU, timed
   against the plain path `predict` ran before it (in turns); the fused
   assigner at the train step's (4, 512, 196416), identical to the
   unfused route (K1's matrix, then the PyTorch assigner) and timed
   against it in turns, and within atol of the plain version (on the CPU
   for the edge cases, on the card at the train step's shape).
   K2 on the edge cases, on the degenerate operands and at the main path's
   (2, 32, 196416), with exact zeros from kernel and plain version on every
   early-out pair; timed there and at (2, 512, 196416) against its bound,
   which counts the clip's flops only for the pairs that do the clip.
4. Builds Rotated RetinaNet-OBB R50-FPN from
   `configs/rotated_retinanet_obb_r50_fpn_1x_dota.py` at full width with
   random weights, checks the card against the CPU on a small input, then
   drives the serving path once at B=2, 1024²: the loss forward, `predict`
   at the config's test_cfg, and `predict` with score_thr=0.0. Then times
   each phase.
5. Drives K2's own entry point, `box_iou_rotated_generic`, on the main
   path's operands (no train or predict path reaches it).
6. Checks the train step on the card against the CPU (B=1, 512², 2 SGD
   steps, same weights), then trains at the config's traffic: B=4, 1024²,
   512 gt slots with 64 real gts per image, uint8 images normalized and
   flipped inside the step, the config's SGD and warmup, 20 steps on one
   batch. Then times the step and its parts.
7. Builds the same model under the bf16 policy
   (`compute_dtype_scope(torch.bfloat16)`, the reference's training and
   benchmark precision) and checks the card against the CPU at 512², B=1:
   loss forward, `predict` and 2 train steps, each within this run's
   f32 - bf16 gap. Then drives the bf16 serving path at B=2 and trains 20
   bf16 steps at the config's traffic, timed as in 4 and 6, with the
   share of the step's device time in bf16 tensor-core kernels and in
   layout transposes.
8. S2ANet R50-FPN from `configs/s2anet_r50_fpn_1x_dota.py` at full width
   with random weights: the fused assigner on per-image anchors (the
   ODM's route) on the edge cases fed per image and at the train step's
   (4, 512, 21824) on the refined anchors of a real FAM forward, identical
   to K1's matrix on the same anchors plus the PyTorch assigner and to the
   CPU plain version's gt_inds and labels, timed against the unfused
   route; AlignConv's deformable conv and the ORConv against the CPU at
   the P3 shape and timed at the step's shapes; card against CPU at 512²
   (head outputs, losses, 2 train steps, and in bf16 within the f32 -
   bf16 gap); the serving path at B=2 and 5 train steps at B=4, 1024²,
   K=512, in float32 and bf16; and one epoch of 2 iterations, a val and a test
   through `python -m jdet_torch.tools.run_net` on 8 synthetic tiles.
8b. Oriented R-CNN R50-FPN from `configs/oriented_rcnn_r50_fpn_1x_dota.py`
   at full width with random weights: the fused assigner on the RoI
   head's route (each image's gts prepended to its proposals, per-image
   masks, no low-quality match) on the RoI edge cases and at the train
   step's (4, 512, 2512) on the proposals of a real RPN forward,
   identical to K1's matrix plus the PyTorch assigner and to the CPU
   plain version's gt_inds and labels, timed against the unfused route;
   card against CPU at 512² (network outputs, proposals and detections as
   sets, the four losses and 2 train steps on the same sampler draws, and
   in bf16 within the f32 - bf16 gap); the serving path at B=2, 5 train
   steps at B=4 and 3 at B=16 (the reference's bench batch), in float32
   and bf16, with the step's parts in float32 (the RPN's hbb assignment
   and its peak memory, its targets, the proposals, the RoI sampling, the
   RoI align forward and backward, the FCs); and `run_net` on 8
   synthetic tiles.
8c. ReDet ReResNet50-ReFPN from `configs/redet_re50_refpn_1x_dota.py` at
   full width with random weights: the fused assigner on its stage-2 route
   at (4, 512, 1024) (each image's 512 gt slots, 64 real, prepended to the
   512 RoIs of a real stage-1 sample refined by their own deltas, with the
   gt masks and the stage-1 validity), identical to K1's matrix plus the
   PyTorch assigner and to the CPU plain version's gt_inds and labels,
   timed against the unfused route; card against CPU at 512² (the RPN's
   outputs and both stages', proposals and detections as sets, the six
   losses and 2 train steps on the same sampler draws, each step from the
   same parameters and momentum on both devices, and in bf16 within the
   f32 - bf16 gap); the serving path at B=2 (its predicts with every
   expanded weight cached, as the Runner's inference runs) and 5 train
   steps at B=4, in float32 and bf16, with the step's parts in float32 (the C8
   weight expansions, stage-1 and stage-2 sampling, RiRoIAlign forward and
   backward, the FCs); and `run_net` on 8 synthetic tiles, which fills
   and drops the expansion cache around its val and test.
8d. The Rotated RetinaNet family's other configs, each at full width
   with random weights, from its own file: GWD, KLD, KFIoU, RSDet, ATSS,
   CSL, LD (an R18 student, an R50 teacher), the hbb assigner, ResNet-50-
   v1d and DOTA-1.5. K1's matrix route inside ATSS's assigner at the
   train step's (4, 512, 21824): K1 against its plain version, the
   assignment against the CPU plain version on the decisive anchors, K1
   timed against its bound. Each head (but v1d's and DOTA-1.5's, the
   main path's) on the card against a CPU copy fed the same outputs at
   512², B=2: the losses, their gradients with respect to the outputs,
   CSL's predict as sets; in bf16 too for KLD and CSL. Then each model's
   loss forward and predict at B=2, 1024², and 5 train steps at B=4,
   1024², K=512, in float32 and bf16, timed, with the peak memory; LD's
   teacher bit-unchanged by them. Then `run_net` on LD's config (8
   tiles), its checkpoint's teacher leaves unchanged.
8e. Oriented R-CNN LSKNet-S (`configs/oriented_rcnn_lsknet_s_fpn_1x_dota.py`)
   and Strip R-CNN StripNet-S (`configs/strip_rcnn_stripnet_s_fpn_1x_dota.py`
   with one override, rpn_head.type="OrientedRPNHead": the committed hbb
   RPN fails in the reference), each at full width (dims 64-128-320-512,
   depths 2-2-4-2) with random weights and the config's AdamW: card
   against CPU at 512² (network outputs, proposals and detections as
   sets, the losses and every gradient from one state; LSKNet-S's also
   under the bf16 policy within the f32 - bf16 gap); the serving path
   at B=2 and 5 train steps at B=4, 1024², K=512 with peak memory, in
   float32 and bf16.
8g. FasterRCNN-OBB and Gliding Vertex R50-FPN
   (`configs/faster_rcnn_obb_r50_fpn_1x_dota.py`, `gliding_r50_fpn_1x_dota.py`),
   each at full width with random weights: card against CPU at 512²
   (network outputs, proposals and detections as sets, the losses and 2
   train steps on the same sampler draws; FasterRCNN-OBB's bf16 within
   the f32 - bf16 gap), the serving path at B=2 and 5 train steps at
   B=4, 1024², K=512, in float32 and bf16; Gliding's step parts in float32 (its one hbb NMS
   over all levels, with its fixpoint rounds, and the RoI sampling). Both assign
   horizontal boxes only: no fused launch, one K1 matrix launch per
   `predict`. Then `gliding_r50_fpn_1x_dota_ra90_balance.py` from its file:
   2 steps with its device flip and rot90.
8h. S2ANet with the RIDet loss (`s2anet_r50_fpn_1x_dota_ridet.py`): card
   against CPU at 512² (head outputs, losses, 2 train steps), then 5
   train steps at the config's traffic in float32 and
   bf16. S2ANet R101 (`s2anet_r101_fpn_1x_dota.py`): the serving path in
   float32 and 5 train steps in float32 and bf16. Both: one shared and one
   per-image fused launch per loss forward and train step.
8i. `python -m jdet_torch.tools.run_net --task vis_test` with the main
   config on 8 synthetic 1024² tiles (the class bias raised through
   `pretrained_weights` so that untrained scores pass the visualizer's
   0.3): the PNGs it writes to work_dir/vis, the pixels drawn, one K1
   matrix launch per predict batch.
8j. R3Det, Rotated FCOS and H2RBox R50-FPN, each from its config file
   (`r3det_r50_fpn_1x_dota.py`, `fcos_obb_r50_fpn_1x_dota.py`,
   `h2rbox_r50_fpn_1x_dota.py` with its AdamW) at full width with random
   weights: R3Det's per-image fused route on its refine stage's refined
   boxes at (4, 512, 21824), against K1's matrix + the PyTorch assigner,
   the CPU plain version and its bound; card against CPU at 512², B=1
   (the loss forward in float32; R3Det's and FCOS's 2 SGD train steps in
   float32; for H2RBox's AdamW every gradient from one state under the
   float64 policy, both devices on one theta); the serving path at B=2
   and 5 train steps at B=4, 1024², K=512, in float32 and bf16.
8k. Rotated RepPoints R50-FPN (`rotated_reppoints_r50_fpn_1x_dota.py`) at
   full width with random weights: its convex ops (plain PyTorch) on the
   card against the CPU on a real forward at B=4, 1024², K=512 (64 real):
   the refine assignment's convex IoU (zeros identical, gt_inds identical
   on a batch without near ties; its ms and peak bytes), `convex_giou`
   and its gradient at the loss's pairs, `min_area_rect`; card against
   CPU at 512², B=1 (the float32 loss forward, 2 SGD steps) and once in
   bf16; the serving path at B=2 and 5 train steps in float32 and bf16
   with the step's parts and profile. Then the main RetinaNet with
   `loss_bbox=dict(type="poly_giou")` at the train step's traffic: its
   loss forward and one step, timed, with peak memory.
8l. SSD300-VGG16 from `configs/ssd300_coco.py` at full width (VGG16, 300²,
   80 classes) with weights drawn from a seed so that its untrained
   `predict` keeps thousands of candidates per image (`draw_ssd_weights`):
   card against CPU at B=2 on a batch without near ties (the float32 loss
   forward, `predict` on the same head outputs and on each device's own, 2
   SGD steps, then the bf16 model within the f32 - bf16 gap); K1's matrix
   route on SSD's real candidates at B=8, (640, 512, 512) axis-aligned
   boxes, against its plain version and the exact hbb IoU, the NMS's
   decisions off 0.45 identical, timed against its bound; the serving
   path at B=8 and 5 train steps at B=32 in float32 and bf16, with the
   step's parts, busy share and peak memory.
8m. The JPEG and TIFF fixtures of `tests/data/torch_codecs/` decoded to the
   digests cv2 gave (`tests/make_codec_fixtures.py`), a 640x480 JPEG and
   the 1000² LZW TIFF timed; COCO from disk: the Runner trains one epoch
   of SSD300 at B=4 on a COCO-style tree over those JPEGs with the
   config's whole augmentation stack, then validates through
   `COCODataset.evaluate`; the SSDD+ and FAIR1M-1.5 configs' `convert`
   steps through `python -m jdet_torch.tools.preprocess` (then FAIR1M's
   tiling) and a FAIR1M-1.5 csv through `python -m
   jdet_torch.tools.merge_results`.
8f. Weight import, from files written from a seed: a torchvision-named
   ResNet-50 `.pth` as the main config's `backbone.pretrained`; a JDet
   payload of the whole RetinaNet through `Runner.load`, then its loss
   forward and `predict` on the card against the CPU; `python -m
   jdet_torch.tools.convert_weights` on an mmcls-named LSKNet-S state
   dict, its output as the LSKNet-S config's `backbone.pretrained`. Each
   import held tensor for tensor to its file.
9. Drives the Runner from the same config at full width on a synthetic
   DOTA tree (16 PNG tiles of 1024² under `build/`, uint8 batches, device
   normalize and augment, 2 spawned loader workers, the tile cache):
   `run()` trains 2 epochs of 4 iterations with a `val` and a checkpoint
   after each and a `test` at the end; checks the losses, the 15 class
   APs, the test pkl and its merge into 15 `Task1_*` files; resumes from
   the checkpoint into identical weights and momentum. Then prints the
   loader-fed numbers: iteration time and loader wait of each epoch, val
   and `test_time` images/s, the device busy share of a profiled
   loader-fed epoch, the PNG decode time of a tile per row filter, and
   peak memory.
10. Runs the README's quick start on synthetic raw scenes:
   `jdet_torch.tools.preprocess` tiles 2 scenes of 2000 x 1500 (tiles/s),
   a Runner trains one epoch on the tiles, validates and tests with
   score_thr=0.0 (every tile carries all that its NMS keeps), and the
   test merges back into the 2 scenes. `DOTADataset.evaluate` and the
   merge are timed on the native polygon library (`csrc/polygon.cpp`,
   g++) and on its numpy plain path, with the same APs and merged
   detections. One more scene is tiled at rates 0.5, 1.0 and 1.5 (the
   bicubic resize on numpy) and its tiles' objects merged back.
   `Runner.profile` records 3 steps into a trace that must name the
   fused assigner's kernels.
11. Prints a `{"kernels": [...]}` line, the card line again, and as the
   last line `{"ok": true, "device": {...}}`.

Each path (serving, K2's entry point, training, the same in bf16, the
S2ANet, Oriented R-CNN, ReDet and RetinaNet variants' paths and their
`run_net`, LSKNet-S's and StripNet-S's paths, the imported detector's
loss forward and `predict`, FasterRCNN-OBB's, Gliding Vertex's, S2ANet
RIDet's and R101's paths, R3Det's, FCOS's, H2RBox's and RepPoints'
paths, `vis_test`, SSD300's paths and its COCO Runner, the Runner's
`run()`, the epoch on the preprocessed tiles and its val and test) runs
with the launch counters set to 0 just before it and read just after:
one fused assigner launch per loss forward and per train step
(RetinaNet), two for S2ANet (FAM on shared anchors, ODM on per-image
anchors), one per-image launch for Oriented R-CNN (its RoI head) and for
ReDet (its stage 2) and for LSKNet-S and StripNet-S (their RoI heads),
and for the RetinaNet variants one fused launch
(GWD, KLD, KFIoU, RSDet, CSL, LD, v1d, DOTA-1.5), one K1 matrix launch
inside the assigner (ATSS) or none (hbb); none for FasterRCNN-OBB and
Gliding Vertex; one shared and one per-image (no mask) for R3Det; none
for FCOS, H2RBox, RepPoints and SSD300; one K1 matrix launch per `predict`
(per predict batch in `val`, `test` and `vis_test`), no K2 launch.

The families whose times `PERF.md` already holds (all but the main
RetinaNet and SSD300) are timed briefly (`brief=True`) and run 5 train steps
(Oriented R-CNN 3 at B=16), and the bf16 card-against-CPU check runs
once per head family (RetinaNet, S2ANet, Oriented R-CNN R50, ReDet,
FasterRCNN-OBB, RepPoints) and once for the LSKNet/StripNet backbones
(LSKNet-S):
the script stays well inside its 1200 s.

Any failed check raises, and the script exits non-zero without the last
line. TF32 is off throughout, so float32 means float32.
"""
import json
import os
import pickle
from collections import Counter
import re
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
# generic quad-quad IoU arithmetic for one pair that does the clip (the
# reference's cost estimate for kernel="generic", same line)
IOU_FLOPS_PER_PAIR_GENERIC = 700
# The schedule's epoch length comes from the dataset, which the checkout
# does not hold: take 1000 steps per epoch. The 5-20 steps here see only
# the warmup (500 iterations); the milestones (epochs 8, 11) lie far beyond.
STEPS_PER_EPOCH = 1000
# how far the bf16 model on the card may sit from the bf16 model on the
# CPU, in units of the f32 - bf16 gap (check_bf16_card_against_cpu)
BF16_GAP_FACTOR = 1.0
# ReDet's card against the CPU, each train step from the same state: per
# trainable tensor, the largest error over the CPU's largest value, of the
# values and of the step's change, and the change's RMS error over its RMS
# (check_rcnn_card_against_cpu; the readings they were set from: PERF.md §6)
REDET_STEP_LIMITS = {"value": 1e-3, "change": 0.15, "change_rms": 0.1}
CONFIG = Path(__file__).resolve().parent / "configs/rotated_retinanet_obb_r50_fpn_1x_dota.py"
S2ANET_CONFIG = Path(__file__).resolve().parent / "configs/s2anet_r50_fpn_1x_dota.py"
ORCNN_CONFIG = Path(__file__).resolve().parent / "configs/oriented_rcnn_r50_fpn_1x_dota.py"
REDET_CONFIG = Path(__file__).resolve().parent / "configs/redet_re50_refpn_1x_dota.py"
LSKNET_CONFIG = Path(__file__).resolve().parent / "configs/oriented_rcnn_lsknet_s_fpn_1x_dota.py"
STRIP_CONFIG = Path(__file__).resolve().parent / "configs/strip_rcnn_stripnet_s_fpn_1x_dota.py"
FASTER_CONFIG = Path(__file__).resolve().parent / "configs/faster_rcnn_obb_r50_fpn_1x_dota.py"
GLIDING_CONFIG = Path(__file__).resolve().parent / "configs/gliding_r50_fpn_1x_dota.py"
GLIDING_RA90_CONFIG = (Path(__file__).resolve().parent
                       / "configs/gliding_r50_fpn_1x_dota_ra90_balance.py")
RIDET_CONFIG = Path(__file__).resolve().parent / "configs/s2anet_r50_fpn_1x_dota_ridet.py"
S2ANET_R101_CONFIG = Path(__file__).resolve().parent / "configs/s2anet_r101_fpn_1x_dota.py"
R3DET_CONFIG = Path(__file__).resolve().parent / "configs/r3det_r50_fpn_1x_dota.py"
FCOS_CONFIG = Path(__file__).resolve().parent / "configs/fcos_obb_r50_fpn_1x_dota.py"
H2RBOX_CONFIG = Path(__file__).resolve().parent / "configs/h2rbox_r50_fpn_1x_dota.py"
REPPOINTS_CONFIG = Path(__file__).resolve().parent / "configs/rotated_reppoints_r50_fpn_1x_dota.py"
ROOT = Path(__file__).resolve().parent
SSD_CONFIG = ROOT / "configs/ssd300_coco.py"
SSDD_PLUS_CONFIG = ROOT / "configs/s2anet_r50_fpn_1x_ssdd_plus.py"
FAIR1M_CONFIG = ROOT / "configs/s2anet_r50_fpn_1x_fair1m_1_5.py"
CODEC_FIXTURES = ROOT / "tests/data/torch_codecs"
# the card-vs-CPU gradients of LSKNet-S / StripNet-S from one state: each
# trainable tensor's largest error over its largest CPU gradient, and the
# error's RMS over the gradient's RMS (a probe run read StripNet-S's worst
# at 5.2e-6 and 2.6e-6, PERF.md §6)
GRAD_LIMITS = {"grad": 1e-3, "grad_rms": 5e-4}
# the Oriented R-CNN RoI head's assigner (jdet_tpu/models/heads/oriented_head.py:35-39)
ROI_THR = dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5, match_low_quality=False)


# the fused assigner's two kernels, as `device_profile` names them
ASSIGN_KERNELS = ("assign_pass1_kernel", "assign_pass2_kernel")
# spin kernels that open each profiler window and absorb the records it
# drops (see device_profile); how many it dropped, window by window
PROFILER_MARKERS = 256
MARKERS_DROPPED = []
# each kernel route's launch counter in jdet_torch/ops/rotated_iou_kernel.py
# (ASSIGN_PER_IMAGE_LAUNCHES counts the per-image launches with per-image
# masks too; `route_launches` takes them out)
COUNTERS = {"rotated_iou_rect": "LAUNCHES", "max_iou_assign_rect": "ASSIGN_LAUNCHES",
            "max_iou_assign_rect_per_image": "ASSIGN_PER_IMAGE_LAUNCHES",
            "max_iou_assign_rect_per_image_masked": "ASSIGN_PER_IMAGE_MASK_LAUNCHES",
            "rotated_iou_generic": "GENERIC_LAUNCHES"}


def launch_counts(rik):
    return {name: getattr(rik, attr) for name, attr in COUNTERS.items()}


def reset_launch_counts(rik):
    for attr in COUNTERS.values():
        setattr(rik, attr, 0)


def route_launches(counts):
    """Launches by kernel route from `launch_counts`: the per-image route
    on a shared (or no) anchor mask without those on per-image masks."""
    return {**counts, "max_iou_assign_rect_per_image":
            counts["max_iou_assign_rect_per_image"]
            - counts["max_iou_assign_rect_per_image_masked"]}


def is_s2anet(model):
    return type(model).__name__ == "S2ANet"


def is_orcnn(model):
    """Oriented R-CNN's RoI route: Oriented R-CNN on any backbone, and
    Strip R-CNN (its head an Oriented R-CNN head with strip convs)."""
    return type(model).__name__ in ("OrientedRCNN", "StripRCNN")


def is_redet(model):
    return type(model).__name__ == "ReDet"


def is_r3det(model):
    return type(model).__name__ == "R3Det"


def is_point_head(model):
    """Rotated FCOS and H2RBox: anchor-free heads whose targets come from
    points inside the gts, with no rotated IoU assigner."""
    return type(model).__name__ in ("FCOS", "H2RBox")


def is_reppoints(model):
    """Rotated RepPoints: convex assigners on point sets, no rotated IoU
    assigner."""
    return type(model).__name__ == "RotatedRepPoints"


def is_hbb_rcnn(model):
    """FasterRCNN-OBB and Gliding Vertex: RoI heads on hbb proposals, which
    assign with `max_iou_assign_hbb` (no kernel)."""
    return type(model).__name__ in ("FasterRCNNOBB", "GlidingVertex")


def fused_per_loss(model):
    """Fused assigner launches per loss forward, by route: RetinaNet assigns
    once on shared anchors; S2ANet's FAM on shared init anchors and its
    ODM on per-image refined anchors; Oriented R-CNN's RoI head once on
    its per-image proposals, and ReDet's cascade once on its stage-2
    candidates (their RPNs, and ReDet's stage 1, assign horizontal boxes
    in plain PyTorch); R3Det's stage 1 on shared anchors and its refine
    stage on per-image refined boxes; FasterRCNN-OBB's and Gliding
    Vertex's never (their RPNs and RoI heads assign horizontal boxes), nor
    Rotated FCOS's and H2RBox's (point targets), nor RepPoints' (convex
    assigners on its point sets, plain PyTorch)."""
    if is_hbb_rcnn(model) or is_point_head(model) or is_reppoints(model):
        return {"max_iou_assign_rect": 0, "max_iou_assign_rect_per_image": 0,
                "max_iou_assign_rect_per_image_masked": 0}
    if is_orcnn(model) or is_redet(model):
        return {"max_iou_assign_rect": 0, "max_iou_assign_rect_per_image": 1,
                "max_iou_assign_rect_per_image_masked": 1}
    return {"max_iou_assign_rect": 1,
            "max_iou_assign_rect_per_image": 1 if is_s2anet(model) or is_r3det(model) else 0,
            "max_iou_assign_rect_per_image_masked": 0}


def fused_launches(rik):
    return rik.ASSIGN_LAUNCHES + rik.ASSIGN_PER_IMAGE_LAUNCHES


_T0 = time.perf_counter()


def elapsed(phase):
    log(f"elapsed after {phase}: {time.perf_counter() - _T0:.1f} s")


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


# Brief timing (`brief=True`), for the families whose times PERF.md
# already holds: medians of 3 after 1 call, and no step parts or profiler
# window in `train_at_config_traffic`. Launch counts and checks are the same.
def timing(brief, warmup=2, iters=10):
    """(warmup, iters) of `median_ms`: (1, 3) if `brief`."""
    return (1, 3) if brief else (warmup, iters)


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


def synth_batch(B, size, K=32, real=8, seed=0, uint8=False):
    """Images and padded targets made like `__graft_entry__._synth_batch`:
    `real` gts per image, the rest padding. `uint8` images are the float
    ones scaled to 0..255, as `__graft_entry__.dryrun_multichip` ships
    them."""
    rng = np.random.RandomState(seed)
    images = rng.rand(B, size, size, 3).astype(np.float32)
    if uint8:
        images = (images * 255).astype(np.uint8)
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


def touching_pairs(gts, anchors, gt_mask=None):
    """Pairs that pass the kernels' circle pre-test (their data-dependent
    work): gts (B, K, 5) against anchors (N, 5) or (B, N, 5), over the
    gts of `gt_mask` if given."""
    n = 0
    for b in range(gts.shape[0]):
        a = anchors[b] if anchors.dim() == 3 else anchors
        g = gts[b] if gt_mask is None else gts[b][gt_mask[b]]
        for lo in range(0, g.shape[0], 64):
            gb = g[lo:lo + 64, None, :]
            d2 = ((a[None, :, :2] - gb[..., :2]) ** 2).sum(-1)
            rsum = 0.5 * (gb[..., 2] + gb[..., 3] + a[None, :, 2] + a[None, :, 3])
            n += int((d2 < rsum * rsum).sum())
    return n


def in_turns(old, new, iters=10):
    """Median ms of old, new, new, old (in that order); returns the mean
    of each pair and the four medians."""
    t = [median_ms(fn, iters=iters) for fn in (old, new, new, old)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def peak_bytes(fn):
    """Device memory that fn() holds at its peak beyond what was
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def device_profile(fn, iters=50, warmup=True, families=None, expect=()):
    """fn() under torch.profiler: device ms per call of each kernel it
    launches (by short name, busiest first; empty if the profiler saw no
    device time), their sum, and the wall ms per call of the same window,
    from the synchronize before the first call to the one after the last
    (the profiler's own overhead included). One unprofiled call first,
    unless warmup is False. With `families` ({key: regex}), a fourth value:
    the device ms per call of the kernels whose full name matches each.

    On the H100 the profiler drops the first kernel records of a window,
    a few to a dozen, more the longer the process has run; in a window of
    a few short calls that can be all of them. So each window opens with
    PROFILER_MARKERS spin kernels, which are not counted. `expect` names
    kernels that fn launches the same number of times on every call: a
    window that recorded one of them not a whole, non-zero number of times
    per call is profiled again with 4 times the markers, up to 3 windows
    in all, and then fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    markers = PROFILER_MARKERS
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(markers):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
        kernels, counts = {}, Counter()
        family_ms = dict.fromkeys(families or (), 0.0)
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and "spin_kernel" in e.key:
                counts["spin_kernel"] += e.count
            elif getattr(e, "is_user_annotation", False) or e.key.startswith("Optimizer."):
                # a `record_function` range's span on the device (torch.optim
                # wraps each step in one), not a kernel: its kernels count
                # on their own
                continue
            elif e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                ms = e.self_device_time_total / 1e3 / iters
                ours = re.search(r"(assign_pass\d_kernel|rotated_iou_(?:rect|generic)_kernel)",
                                 e.key)
                name = ours.group(1) if ours else re.sub(r"^void |<.*", "", e.key)[:48]
                kernels[name] = kernels.get(name, 0.0) + ms
                counts[name] += e.count
                for key, pattern in (families or {}).items():
                    family_ms[key] += ms if re.search(pattern, e.key) else 0.0
        short = {k: counts[k] for k in expect if counts[k] == 0 or counts[k] % iters}
        if not short:
            break
        log(f"profiler window {attempt + 1}, {markers} markers, {iters} calls: recorded "
            f"{short} launches of the expected kernels (kernels seen: {dict(counts)})")
        markers *= 4
    check(not short, f"the profiler recorded {short} launches of {list(expect)} in {iters} "
                     f"calls after {markers // 4} markers, not a whole number per call")
    MARKERS_DROPPED.append(markers - counts["spin_kernel"])
    kernels = dict(sorted(kernels.items(), key=lambda kv: -kv[1]))
    if families is not None:
        return kernels, sum(kernels.values()), wall_ms, family_ms
    return kernels, sum(kernels.values()), wall_ms


def bound(nbytes, ops):
    """(bound ms, what bounds it) from the bytes moved and the float32
    operations, at the H100's peaks."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def nms_candidates(B=2, C=15, K=512, seed=7):
    """The NMS's per-class candidates at predict's shapes: B images x C
    classes x K boxes, uniform over a 1024² tile, as (B * C, K, 5)."""
    rng = np.random.RandomState(seed)
    return torch.as_tensor(np.stack([
        rng.uniform(0, 1024, (B * C, K)), rng.uniform(0, 1024, (B * C, K)),
        rng.uniform(10, 200, (B * C, K)), rng.uniform(10, 100, (B * C, K)),
        rng.uniform(-np.pi / 4, 3 * np.pi / 4, (B * C, K))], -1),
        dtype=torch.float32, device="cuda")


def check_iou_kernel(rik, head):
    """K1's matrix route against its plain version on the card; times it
    at the NMS's per-class self-IoU against the plain path `predict` ran
    before. Returns its entry of the kernels line (launches filled in
    later)."""
    from jdet_torch.ops import box_iou_rotated
    from jdet_torch.utils.edge_cases import edge_case_boxes

    dev = "cuda"
    g, a = edge_case_boxes()
    g, a = torch.as_tensor(g, device=dev), torch.as_tensor(a, device=dev)
    a2 = torch.stack([a, a.flip(0)])  # per-image anchors
    err_edge = 0.0
    for anchors in (a, a2):
        got = rik.box_iou_rotated_rect(g, anchors)
        want = rik.box_iou_rotated_rect_reference(g, anchors)
        torch.cuda.synchronize()
        err_edge = max(err_edge, (got - want).abs().max().item())
    K = g.shape[1]
    diag = got[0, torch.arange(K), torch.arange(K)]
    diag_err = (diag - 1).abs().max().item()
    log(f"iou kernel, edge cases (2, {K}, {a.shape[0]}), shared and per-image anchors: "
        f"max_abs_err={err_edge:.3e} diag_err={diag_err:.3e}")
    check(err_edge <= 2e-4, f"edge cases disagree: {err_edge}")
    check(diag_err <= 1e-5, f"identical boxes: IoU off 1 by {diag_err}")

    # the loss forward's shape before the fused assigner: B=2 x K=32 (8 real)
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
    log(f"iou kernel ({B}, {K}, {N}): max_abs_err={err_main:.3e} "
        f"nonzero={int((got > 0).sum())}, "
        f"{median_ms(lambda: rik.box_iou_rotated_rect(gts, anchors), iters=20):.4f} ms")
    check(err_main <= 2e-4, f"(2, 32, N) disagrees: {err_main}")
    check(torch.isfinite(got).all().item(), "non-finite IoU")

    # the main path's matrix route: predict's per-class NMS self-IoU
    cand = nms_candidates()
    B, K = cand.shape[:2]
    got = rik.box_iou_rotated_rect(cand, cand)
    want = rik.box_iou_rotated_rect_reference(cand, cand)
    torch.cuda.synchronize()
    err_nms = (got - want).abs().max().item()
    diag_err = (got.diagonal(dim1=1, dim2=2) - 1).abs().max().item()
    log(f"iou kernel, NMS self-IoU ({B}, {K}, {K}): max_abs_err={err_nms:.3e} "
        f"diag_err={diag_err:.3e} nonzero={int((got > 0).sum())}")
    check(err_nms <= 2e-4 and diag_err <= 1e-5, f"NMS self-IoU disagrees: {err_nms}, {diag_err}")
    cand4 = cand.reshape(2, 15, K, 5)
    old_ms, ms, turns = in_turns(lambda: box_iou_rotated(cand4, cand4, impl="xla"),
                                 lambda: rik.box_iou_rotated_rect(cand, cand))
    plain_ms = median_ms(lambda: rik.box_iou_rotated_rect_reference(cand, cand))
    kernels, device_ms, _ = device_profile(lambda: rik.box_iou_rotated_rect(cand, cand),
                                           expect=("rotated_iou_rect_kernel",))
    log(f"NMS self-IoU on K1 under the profiler, device ms per call: {kernels}")
    nbytes = (2 * B * K * 5 + B * K * K) * 4
    touching = touching_pairs(cand, cand)
    bound_ms, bound_by = bound(nbytes, IOU_FLOPS_PER_TOUCHING_PAIR * touching)
    log(f"NMS self-IoU ({B}, {K}, {K}), in turns old/new/new/old {turns}: plain path "
        f"(predict before) {old_ms:.4f} ms, K1 {ms:.4f} ms (rect plain version "
        f"{plain_ms:.4f} ms); bound {bound_ms:.4f} ms by {bound_by} (bytes {nbytes}, "
        f"{touching} touching pairs x {IOU_FLOPS_PER_TOUCHING_PAIR} flops)")
    return {
        "name": "rotated_iou_rect",
        "route": "cuda",
        "source": "jdet_torch/csrc/rotated_iou.cu",
        "replaces": "jdet_tpu/ops/pallas_iou.py:148",
        "launches": None,
        "max_abs_err": max(err_edge, err_main, err_nms),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": [B, K, K],
        "device_ms": device_ms,
        "old_route_ms": old_ms,
    }


def decisive_anchors(ov, gt_mask, pos_thr=0.5, neg_thr=0.4):
    """(B, N) mask of the anchors whose assignment no change below 1e-5 in
    an IoU can flip: the max IoU off both thresholds, no second gt within
    1e-5 of a positive's best, and no IoU within 1e-5 of its gt's max."""
    ov = ov.masked_fill(~gt_mask[..., None], float("-inf"))
    top2 = ov.topk(2, dim=1).values
    mo = top2[:, 0]
    ok = ((mo - neg_thr).abs() >= 1e-5) & ((mo - pos_thr).abs() >= 1e-5)
    ok &= ~((mo >= pos_thr - 1e-5) & (top2[:, 0] - top2[:, 1] < 1e-5))
    return ok & ~((ov - ov.amax(-1, keepdim=True)).abs() < 1e-5).any(1)


def check_assign_kernel(rik, anchors):
    """The fused assigner on the card: identical to the unfused route (K1's
    matrix, then the PyTorch assigner) on the edge cases and at the train
    step's shape, within atol of the plain version (on the CPU for the edge
    cases, on the card at the train step's shape), and timed against the
    unfused route in turns. Returns its entry of the kernels line
    (launches filled in later)."""
    from jdet_torch.models.boxes.assigner import assign_wrt_overlaps, max_iou_assign_rotated
    from jdet_torch.ops import box_iou_rotated
    from jdet_torch.utils.edge_cases import ASSIGN_CASES, assign_edge_case

    thr = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)

    def assign(gts, mask, labels, an, am):
        """The assigner's entry point, which on the card launches the
        fused kernel."""
        return max_iou_assign_rotated(an, gts, mask, labels, anchor_mask=am, **thr)

    def unfused(gts, mask, labels, an, am):
        """The route the fused kernel replaces: K1's matrix, then the
        PyTorch assigner."""
        ov = rik.box_iou_rotated_rect(rik.park_masked_boxes(gts, mask), an)
        return assign_wrt_overlaps(ov, mask, labels, anchor_mask=am, **thr)

    def plain(gts, mask, labels, an, am, iou_chunk=512):
        """The plain version on any device: the assigner on the matrix of
        the differentiable IoU path, `iou_chunk` gt rows at a time."""
        ov = box_iou_rotated(rik.park_masked_boxes(gts, mask), an, chunk=iou_chunk, impl="xla")
        return assign_wrt_overlaps(ov, mask, labels, anchor_mask=am, **thr)

    def routes(gts, mask, labels, an, am, iou_chunk=512, plain_device="cpu"):
        """Fused and unfused on the card, checked identical, and the plain
        version (on the CPU, or on `plain_device`) with its max_overlaps
        error."""
        fused = assign(gts, mask, labels, an, am)
        want = unfused(gts, mask, labels, an, am)
        cpu = plain(*(None if x is None else x.to(plain_device)
                      for x in (gts, mask, labels, an, am)), iou_chunk=iou_chunk)
        cpu = {k: v.cpu() for k, v in cpu.items()}
        for k in fused:
            check(fused[k].dtype == want[k].dtype and torch.equal(fused[k], want[k]),
                  f"fused assigner: {k} differs from the unfused route")
        mo, mo_cpu = fused["max_overlaps"].cpu(), cpu["max_overlaps"]
        check(torch.equal(torch.isfinite(mo), torch.isfinite(mo_cpu)), "-inf slots differ")
        fin = torch.isfinite(mo_cpu)
        return fused, cpu, (mo[fin] - mo_cpu[fin]).abs().max().item()

    err = 0.0
    for name in ASSIGN_CASES:
        gts, mask, labels, an, am, about = assign_edge_case(name)
        am = None if am is None else torch.as_tensor(am, device="cuda")
        fused, cpu, e = routes(*(torch.as_tensor(x, device="cuda")
                                 for x in (gts, mask, labels, an)), am)
        for k in ("gt_inds", "labels"):
            check(torch.equal(fused[k].cpu(), cpu[k]), f"{name}: {k} differs from the CPU")
        err = max(err, e)
        log(f"fused assigner, {name}: identical to the unfused route, matches the CPU "
            f"(max_overlaps err {e:.2e}); gt_inds at {about}: "
            f"{fused['gt_inds'][0, about].tolist()}")
    check(err <= 2e-4, f"edge cases: max_overlaps off the CPU by {err}")

    # the train step's shape: B=4 x 512 gt slots, 64 real, all anchors
    _, t = synth_batch(4, 1024, K=512, real=64, seed=3)
    gts, mask, labels = (torch.as_tensor(t[k], device="cuda")
                         for k in ("gt_bboxes", "gt_mask", "gt_labels"))
    am = torch.ones(anchors.shape[0], dtype=torch.bool, device="cuda")
    B, K, N = gts.shape[0], gts.shape[1], anchors.shape[0]
    fused = assign(gts, mask, labels, anchors, am)
    want = unfused(gts, mask, labels, anchors, am)
    for k in fused:
        check(torch.equal(fused[k], want[k]), f"train shape: {k} differs from the unfused route")
    # the plain version on the real slots (the first 64; padding slots are
    # -inf and claim nothing in every route), on the card: on the CPU it
    # took 72 s of the script's 1200 s, on the card it takes ~0.3 s; the
    # edge cases above hold the kernel against the CPU's
    real = int(mask.sum(1).max())
    check(bool(mask[:, :real].all()) and not mask[:, real:].any(), "real gts not first")
    t0 = time.perf_counter()
    _, cpu, e = routes(gts[:, :real].contiguous(), mask[:, :real].contiguous(),
                       labels[:, :real].contiguous(), anchors, am, iou_chunk=16,
                       plain_device="cuda")
    cpu_s = time.perf_counter() - t0
    ov = rik.box_iou_rotated_rect(gts[:, :real].contiguous(), anchors)
    ok = decisive_anchors(ov, mask[:, :real]).cpu()
    del ov
    agree = {k: int((fused[k].cpu()[ok] != cpu[k][ok]).sum()) for k in ("gt_inds", "labels")}
    log(f"fused assigner ({B}, {K}, {N}), {real} real gts: identical to the unfused route; "
        f"vs the plain version on the card ({cpu_s:.1f} s): max_overlaps err {e:.2e}, "
        f"{int(ok.sum())} of {ok.numel()} anchors decisive, disagreements there {agree}, "
        f"positives {int((fused['gt_inds'] > 0).sum())}")
    check(e <= 2e-4 and ok.float().mean() > 0.99 and not any(agree.values()),
          "train shape: the fused assigner is off the plain version")
    err = max(err, e)

    old_ms, ms, turns = in_turns(
        lambda: unfused(gts, mask, labels, anchors, am),
        lambda: assign(gts, mask, labels, anchors, am))
    matrix_ms = median_ms(lambda: rik.box_iou_rotated_rect(rik.park_masked_boxes(gts, mask),
                                                           anchors))
    # the plain version on the card, its IoU rows in chunks of 32 gts
    plain_ms = median_ms(lambda: plain(gts, mask, labels, anchors, am, iou_chunk=32),
                         warmup=1, iters=3)
    kernels, device_ms, _ = device_profile(
        lambda: assign(gts, mask, labels, anchors, am), expect=ASSIGN_KERNELS)
    log(f"fused assigner under the profiler, device ms per call: {kernels} "
        f"(sum {device_ms:.4f}; the rest of the {ms:.4f} ms is the host's)")
    mem = {name: peak_bytes(fn) for name, fn in (
        ("unfused", lambda: unfused(gts, mask, labels, anchors, am)),
        ("fused", lambda: assign(gts, mask, labels, anchors, am)))}
    nbytes = B * K * (5 * 4 + 1 + 8) + N * (5 * 4 + 1) + B * N * (8 + 4 + 8)
    touching = touching_pairs(gts, anchors, mask)
    bound_ms, bound_by = bound(nbytes, IOU_FLOPS_PER_TOUCHING_PAIR * touching)
    log(f"fused assigner ({B}, {K}, {N}), in turns old/new/new/old {turns}: unfused "
        f"route {old_ms:.4f} ms (K1 matrix alone {matrix_ms:.4f} ms), fused {ms:.4f} ms, "
        f"plain version {plain_ms:.4f} ms; peak bytes {mem}; bound {bound_ms:.4f} ms by "
        f"{bound_by} (bytes {nbytes}, {touching} touching pairs x "
        f"{IOU_FLOPS_PER_TOUCHING_PAIR} flops)")
    return {
        "name": "max_iou_assign_rect",
        "route": "cuda",
        "source": "jdet_torch/csrc/rotated_iou.cu",
        "replaces": "jdet_tpu/ops/pallas_iou.py:148",
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": [B, K, N],
        "device_ms": device_ms,
        "device_ms_by_kernel": kernels,
        "old_route_ms": old_ms,
        "old_route_matrix_ms": matrix_ms,
        "peak_bytes": mem,
    }


def refined_anchors_of(model, images):
    """The per-image refined anchors (B, N, 5) of `model`'s forward on
    `images`: FAM deltas decoding the init anchors."""
    with torch.no_grad():
        outs = model.bbox_head(model.extract_feat(images))
    return torch.cat([o[2].reshape(images.shape[0], -1, 5) for o in outs], 1).float()


def check_assign_per_image_kernel(rik, model, cfg, thr=None, edge_cases=True):
    """The fused assigner on per-image anchors (S2ANet's ODM route, and
    R3Det's refine stage at its `thr`): the edge cases of the CPU tests
    fed as per-image anchors (image 1's refined like the ODM's, some
    stretched to the decoder's clip), then the train step's (4, 512,
    21824) on the refined anchors of a real FAM (or R3Det stage-1) forward
    of `model` at 1024². Each identical to K1's matrix on the same anchors
    plus the PyTorch assigner (max_overlaps to the bit), and gt_inds and
    labels identical to the CPU plain version (at the train shape on the
    64 real gt slots, on the anchors no 1e-5 change of an IoU can flip).
    Timed against the unfused route in turns. Returns its entry of the
    kernels line (launches filled in later)."""
    from jdet_torch.models.boxes.assigner import assign_wrt_overlaps, max_iou_assign_rotated
    from jdet_torch.ops import box_iou_rotated
    from jdet_torch.parallel import make_device_normalizer
    from jdet_torch.utils.edge_cases import ASSIGN_CASES, per_image_assign_edge_case

    thr = thr or dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)

    def assign(gts, mask, labels, an, am):
        return max_iou_assign_rotated(an, gts, mask, labels, anchor_mask=am, **thr)

    def unfused(gts, mask, labels, an, am):
        ov = rik.box_iou_rotated_rect(rik.park_masked_boxes(gts, mask), an)
        return assign_wrt_overlaps(ov, mask, labels, anchor_mask=am, **thr)

    def plain(gts, mask, labels, an, am, iou_chunk=512):
        ov = box_iou_rotated(rik.park_masked_boxes(gts, mask), an, chunk=iou_chunk, impl="xla")
        return assign_wrt_overlaps(ov, mask, labels, anchor_mask=am, **thr)

    def identical(fused, want, what):
        for k in fused:
            check(fused[k].dtype == want[k].dtype and torch.equal(fused[k], want[k]),
                  f"per-image fused assigner, {what}: {k} differs from K1's matrix + "
                  "the PyTorch assigner")

    err = 0.0
    for name in ASSIGN_CASES if edge_cases else ():
        gts, mask, labels, an, am, about = per_image_assign_edge_case(name)
        args = [torch.as_tensor(x, device="cuda") for x in (gts, mask, labels, an)]
        am = None if am is None else torch.as_tensor(am, device="cuda")
        before = rik.ASSIGN_PER_IMAGE_LAUNCHES, rik.ASSIGN_PER_IMAGE_MASK_LAUNCHES
        fused = assign(*args, am)
        check((rik.ASSIGN_PER_IMAGE_LAUNCHES, rik.ASSIGN_PER_IMAGE_MASK_LAUNCHES)
              == (before[0] + 1, before[1]), f"{name}: not one per-image launch on shared masks")
        identical(fused, unfused(*args, am), name)
        cpu = plain(*(x.cpu() for x in args), None if am is None else am.cpu())
        for k in ("gt_inds", "labels"):
            check(torch.equal(fused[k].cpu(), cpu[k]), f"{name}: {k} differs from the CPU")
        mo, mo_cpu = fused["max_overlaps"].cpu(), cpu["max_overlaps"]
        check(torch.equal(torch.isfinite(mo), torch.isfinite(mo_cpu)), f"{name}: -inf slots")
        fin = torch.isfinite(mo_cpu)
        e = (mo[fin] - mo_cpu[fin]).abs().max().item()
        err = max(err, e)
        log(f"per-image fused assigner, {name}: identical to the unfused route and to the "
            f"CPU's gt_inds and labels (max_overlaps err {e:.2e}); image 0 gt_inds at "
            f"{about}: {fused['gt_inds'][0, about].tolist()}, image 1 positives "
            f"{int((fused['gt_inds'][1] > 0).sum())}")
    check(err <= 2e-4, f"edge cases: max_overlaps off the CPU by {err}")

    # the train step's shape on the refined anchors of a real FAM forward
    images, t = synth_batch(4, 1024, K=512, real=64, seed=3, uint8=True)
    normalize = make_device_normalizer(**cfg["device_normalize"])
    anchors = refined_anchors_of(model, normalize(torch.as_tensor(images, device="cuda")))
    gts, mask, labels = (torch.as_tensor(t[k], device="cuda")
                         for k in ("gt_bboxes", "gt_mask", "gt_labels"))
    am = torch.ones(anchors.shape[1], dtype=torch.bool, device="cuda")
    B, K, N = gts.shape[0], gts.shape[1], anchors.shape[1]
    check(N == 21824, f"expected 21,824 anchors per image at 1024², got {N}")
    fused = assign(gts, mask, labels, anchors, am)
    identical(fused, unfused(gts, mask, labels, anchors, am), f"({B}, {K}, {N})")
    real = int(mask.sum(1).max())
    check(bool(mask[:, :real].all()) and not mask[:, real:].any(), "real gts not first")
    sub = [x[:, :real].contiguous() for x in (gts, mask, labels)]
    t0 = time.perf_counter()
    cpu = plain(*(x.cpu() for x in sub), anchors.cpu(), am.cpu(), iou_chunk=16)
    cpu_s = time.perf_counter() - t0
    fused_sub = assign(*sub, anchors, am)
    ok = decisive_anchors(rik.box_iou_rotated_rect(sub[0], anchors), sub[1],
                          thr["pos_iou_thr"], thr["neg_iou_thr"]).cpu()
    agree = {k: int((fused_sub[k].cpu()[ok] != cpu[k][ok]).sum()) for k in ("gt_inds", "labels")}
    fin = torch.isfinite(cpu["max_overlaps"])
    e = (fused_sub["max_overlaps"].cpu()[fin] - cpu["max_overlaps"][fin]).abs().max().item()
    spread = anchors[..., 2:4].amax().item(), (anchors[..., 2] / anchors[..., 3]).amax().item()
    log(f"per-image fused assigner ({B}, {K}, {N}) on refined anchors (largest side "
        f"{spread[0]:.1f}, largest w/h {spread[1]:.3f}), {real} real gts: identical to the "
        f"unfused route; vs the CPU plain version ({cpu_s:.1f} s): max_overlaps err {e:.2e}, "
        f"{int(ok.sum())} of {ok.numel()} anchors decisive, disagreements there {agree}, "
        f"positives {int((fused['gt_inds'] > 0).sum())}")
    check(e <= 2e-4 and ok.float().mean() > 0.99 and not any(agree.values()),
          "train shape: the per-image fused assigner is off the CPU plain version")
    err = max(err, e)

    old_ms, ms, turns = in_turns(lambda: unfused(gts, mask, labels, anchors, am),
                                 lambda: assign(gts, mask, labels, anchors, am))
    matrix_ms = median_ms(lambda: rik.box_iou_rotated_rect(rik.park_masked_boxes(gts, mask),
                                                           anchors))
    plain_ms = median_ms(lambda: plain(gts, mask, labels, anchors, am, iou_chunk=64),
                         warmup=1, iters=3)
    kernels, device_ms, _ = device_profile(lambda: assign(gts, mask, labels, anchors, am),
                                           expect=ASSIGN_KERNELS)
    # CUDA events over 20 calls back to back: the host's part hides behind
    # the card's queue
    b2b_ms = back_to_back_ms(lambda: assign(gts, mask, labels, anchors, am))
    log(f"per-image fused assigner under the profiler, device ms per call: {kernels} "
        f"(sum {device_ms:.4f}; the rest of the {ms:.4f} ms is the host's); "
        f"{b2b_ms:.4f} ms per call back to back")
    # each input read once, each output written once: gts, masks and
    # labels, the per-image anchors and the anchor mask; gt_inds, labels
    # (int64) and max_overlaps (float32)
    nbytes = B * K * (5 * 4 + 1 + 8) + B * N * 5 * 4 + N + B * N * (8 + 4 + 8)
    touching = touching_pairs(gts, anchors, mask)
    bound_ms, bound_by = bound(nbytes, IOU_FLOPS_PER_TOUCHING_PAIR * touching)
    log(f"per-image fused assigner ({B}, {K}, {N}), in turns old/new/new/old {turns}: "
        f"unfused route {old_ms:.4f} ms (K1 matrix alone {matrix_ms:.4f} ms), fused "
        f"{ms:.4f} ms, plain version {plain_ms:.4f} ms; bound {bound_ms:.5f} ms by {bound_by} "
        f"(bytes {nbytes}, {touching} touching pairs x {IOU_FLOPS_PER_TOUCHING_PAIR} flops)")
    return {
        "name": "max_iou_assign_rect_per_image",
        "route": "cuda",
        "source": "jdet_torch/csrc/rotated_iou.cu",
        "replaces": "jdet_tpu/ops/pallas_iou.py:148",
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": [B, K, N],
        "device_ms": device_ms,
        "device_ms_by_kernel": kernels,
        "back_to_back_ms": b2b_ms,
        "old_route_ms": old_ms,
        "old_route_matrix_ms": matrix_ms,
        "model": type(model).__name__,
    }, (images, t, anchors)


def check_align_and_orconv(model, images, anchors):
    """S2ANet's AlignConv (offsets from the refined anchors, the deformable
    conv) and ORConv2d on the card against the CPU at the P3 shape (B=2,
    256 channels, 128²), outputs and gradients, float32: within 1e-4 of
    each tensor's largest value (sums run in other orders; TF32 is off).
    Then both timed at the train step's shapes (B=4, every level), forward
    and forward + backward, in float32 and with bf16 features."""
    from jdet_torch.ops.deform_conv import deform_conv2d

    head = model.bbox_head
    with torch.no_grad():
        feats = model.extract_feat(images)
    p3 = feats[0][:2].float().clone()
    B, C, H, W = p3.shape
    offsets = head.align_conv.get_offset(anchors[:2, :H * W].reshape(2, H, W, 5),
                                         head.anchor_strides[0])
    rng = np.random.RandomState(8)
    cot = torch.as_tensor(rng.randn(B, C, H, W).astype(np.float32))
    cot_or = torch.as_tensor(rng.randn(B, 256, H, W).astype(np.float32))
    weights = {"deform": head.align_conv.deform_conv.weight.detach(),
               "orconv": head.or_conv.weight.detach(), "orconv_bias": head.or_conv.bias.detach()}
    from jdet_torch.ops.orn import ORConv2d

    def run(dev):
        x = p3.detach().to(dev).requires_grad_()
        w = weights["deform"].to(dev).clone().requires_grad_()
        out = deform_conv2d(x, offsets.to(dev), w)
        (out * cot.to(dev)).sum().backward()
        orc = ORConv2d(256, 32, 3, (1, 8)).to(dev)
        with torch.no_grad():
            orc.weight.copy_(weights["orconv"])
            orc.bias.copy_(weights["orconv_bias"])
        y = out.detach().relu().requires_grad_()
        o2 = orc(y)
        (o2 * cot_or.to(dev)).sum().backward()
        return {k: v.detach().cpu() for k, v in (("deform out", out), ("deform d input", x.grad),
                                                  ("deform d weight", w.grad), ("orconv out", o2),
                                                  ("orconv d input", y.grad),
                                                  ("orconv d weight", orc.weight.grad))}

    card, cpu = run("cuda"), run("cpu")
    errs = {}
    for k, want in cpu.items():
        errs[k] = ((card[k] - want).abs().max() / want.abs().max()).item()
    log(f"AlignConv and ORConv at P3 ({B}, {C}, {H}, {W}), card vs CPU, max error over the "
        f"tensor's largest value: {json.dumps(errs)}")
    check(all(e <= 1e-4 for e in errs.values()), f"AlignConv / ORConv card vs CPU: {errs}")

    # timed at the train step's shapes, every level of B=4
    times = {}
    for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        xs = [f.to(dtype).detach().requires_grad_() for f in feats]
        offs = [head.align_conv.get_offset(
            anchors[:, lo:lo + f.shape[2] * f.shape[3]].reshape(
                f.shape[0], f.shape[2], f.shape[3], 5), s)
            for f, lo, s in zip(feats, np.cumsum([0] + [f.shape[2] * f.shape[3] for f in feats]),
                                head.anchor_strides)]
        w = head.align_conv.deform_conv.weight

        def align_fwd():
            with torch.no_grad():
                return [deform_conv2d(x, o, w) for x, o in zip(xs, offs)]

        def align_fwd_bwd():
            outs = [deform_conv2d(x, o, w) for x, o in zip(xs, offs)]
            torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])

        ys = [a.detach().relu().requires_grad_() for a in align_fwd()]

        def or_fwd():
            with torch.no_grad():
                return [head.or_conv(y) for y in ys]

        def or_fwd_bwd():
            outs = [head.or_conv(y) for y in ys]
            torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])

        for name, fn in (("align_conv_forward_ms", align_fwd),
                         ("align_conv_forward_backward_ms", align_fwd_bwd),
                         ("orconv_forward_ms", or_fwd),
                         ("orconv_forward_backward_ms", or_fwd_bwd)):
            times[f"{label}_{name}"] = median_ms(fn, warmup=2, iters=10)
        head.zero_grad(set_to_none=True)
    log(f"AlignConv's deformable conv (grid-sample + float32 product) and the ORConv at the "
        f"train step's shapes, B=4, all 5 levels: {json.dumps(times)}")
    return errs, times


def check_s2anet_card_against_cpu(cfg, rik):
    """The full-width S2ANet with the same random weights on the card and on
    the CPU, B=1 at 512², a batch without near ties in either assignment:
    the head's outputs (FAM and ODM class and box outputs, the refined
    anchors) and the four losses. The NMS's choice is not compared: it
    follows each device's order among tied scores. Then 2 train steps
    (`check_train_card_against_cpu`)."""
    from jdet_torch.models.builder import build_detector
    from jdet_torch.parallel import make_device_normalizer

    models = {dev: build_detector(cfg["model"], device=dev, seed=1, load_pretrained=False)
              for dev in ("cuda", "cpu")}
    randomize_constants(models["cpu"])
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    seed = untied_batch_seed(models["cpu"], cfg)
    images, targets = synth_batch(1, 512, seed=seed, uint8=True)
    normalize = make_device_normalizer(**cfg["device_normalize"])
    out = {}
    for dev, m in models.items():
        x, t = to_device(images, targets, dev)
        x = normalize(x)
        m.eval()
        with torch.no_grad():
            outs = m.bbox_head(m.extract_feat(x))
        m.train()
        out[dev] = ([[o.cpu() for o in lvl] for lvl in outs],
                    {k: v.item() for k, v in m.loss(x, t).items()})
    names = ("fam_cls", "fam_reg", "refined anchors", "odm_cls", "odm_reg")
    errs = {}
    for i, name in enumerate(names):
        got = torch.cat([lvl[i].flatten() for lvl in out["cuda"][0]])
        want = torch.cat([lvl[i].flatten() for lvl in out["cpu"][0]])
        errs[name] = (got - want).abs().max().item()
    log(f"S2ANet card vs cpu at 512², B=1, batch seed {seed}: head outputs max abs error "
        f"{json.dumps(errs)}; losses {out['cuda'][1]} vs {out['cpu'][1]}")
    for name, e in errs.items():
        # image coordinates for the anchors, logits and deltas otherwise
        check(e <= (1e-3 if name == "refined anchors" else 1e-4), f"{name}: card vs cpu {e}")
    for k, want in out["cpu"][1].items():
        got = out["cuda"][1][k]
        check(abs(got - want) <= 1e-4 * abs(want), f"{k}: card {got} cpu {want}")
    del models
    check_train_card_against_cpu(cfg, rik)


def run_net_phase(rik, root, config=S2ANET_CONFIG, per_iter=None, n_tiles=8,
                  model_override="model = dict(backbone=dict(pretrained=None))"):
    """`python -m jdet_torch.tools.run_net --config-file <cfg>` on the card,
    in this process, with a config whose `_base_` is `config` (S2ANet's
    by default) and which points the datasets at a synthetic DOTA tree of
    `n_tiles` 1024² tiles (random weights: no backbone checkpoint): one
    epoch of n_tiles / 4 iterations, a val, a checkpoint and a test, the
    batches loaded in this process (`num_workers=0`: spawning each
    loader's workers took ~20 s of each such phase; the Runner phase and
    `vis_test` drive the spawned workers).
    `per_iter` is the fused assigner's launches per train iteration, by
    route; `model_override` the config line that drops the checkpoints the
    model names. Returns the launches and the logged records."""
    import shutil

    from jdet_torch.data.synthetic import make_synthetic_dota
    from jdet_torch.tools import run_net
    from jdet_torch.utils import logger as logger_module

    shutil.rmtree(root, ignore_errors=True)
    img_dir, ann = make_synthetic_dota(str(root / "dota"), n_images=n_tiles, size=1024, seed=2)
    cfg_file = root / "smoke_cfg.py"
    data = dict(annotations_file=ann, images_dir=img_dir, num_workers=0)
    cfg_file.write_text("\n".join([
        f"_base_ = [{str(config)!r}]",
        model_override,
        f"dataset = dict(train={data!r}, val={data!r}, "
        f"test=dict(images_dir={img_dir!r}, num_workers=0))",
        f"work_dir = {str(root / 'work')!r}",
        "max_epoch = 1",
        "eval_interval = 1",
        "checkpoint_interval = 1",
        "log_interval = 1",
    ]) + "\n")
    logged = []
    real_log = logger_module.RunLogger.log
    logger_module.RunLogger.log = lambda self, d: (logged.append(d), real_log(self, d))[1]
    torch.cuda.synchronize()
    reset_launch_counts(rik)
    t0 = time.perf_counter()
    try:
        run_net.main(["--config-file", str(cfg_file), "--task", "train"])
    finally:
        logger_module.RunLogger.log = real_log
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launch_counts(rik)
    iters = n_tiles // 4
    losses = [d for d in logged if "total_loss" in d]
    evals = [d for d in logged if "eval/0_meanAP" in d]
    log(f"run_net {config.name}: {run_s:.2f} s for {len(losses)} iterations, a val and a test; "
        f"launches {launches}; losses "
        f"{[{k: round(v, 5) for k, v in d.items() if 'loss' in k} for d in losses]}; "
        f"meanAP {[m['eval/0_meanAP'] for m in evals]}")
    check(len(losses) == iters and all(np.isfinite(d["total_loss"]) for d in losses),
          f"run_net: {len(losses)} logged iterations, or a non-finite loss")
    check(len(evals) == 1, f"run_net: {len(evals)} val results")
    check((root / "work" / "checkpoints" / "ckpt_1.pkl").exists()
          and (root / "work" / "test" / "test_1.pkl").exists(),
          "run_net: no checkpoint or test pkl")
    per_iter = per_iter or {"max_iou_assign_rect": 1, "max_iou_assign_rect_per_image": 1,
                            "max_iou_assign_rect_per_image_masked": 0}
    check(launches == {"rotated_iou_rect": 2 * (n_tiles // 4), "rotated_iou_generic": 0,
                       **{k: n * iters for k, n in per_iter.items()}},
          f"run_net: not {per_iter} fused launches per iteration and one K1 "
          f"matrix launch per predict batch: {launches}")
    return launches, {"run_s": run_s, "iterations": len(losses)}


def build_old_generic(rik, src):
    """The `rotated_iou_generic` C entry point of another copy of
    `rotated_iou.cu` (e.g. the parent commit's), built with the same flags
    into `build/`."""
    import ctypes

    so = rik.BUILD_DIR / f"old_generic_{Path(src).stem}.so"
    rik.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([rik._nvcc(), *rik.NVCC_FLAGS, "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).rotated_iou_generic
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def generic_launcher(fn):
    """A function (gts (B, K, 5), anchors (N, 5), out=None) -> out that
    calls the C entry point `fn` directly, without the wrapper's checks and
    allocation when `out` is given: back to back, such calls time the
    kernel and not the host."""
    def launch(gts, anchors, out=None):
        B, K, _ = gts.shape
        if out is None:
            out = torch.empty((B, K, anchors.shape[0]), device=gts.device)
        rc = fn(gts.data_ptr(), anchors.data_ptr(), out.data_ptr(), B, K,
                anchors.shape[0], torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"generic kernel: CUDA error {rc}")
        return out
    return launch


def back_to_back_ms(launch, *args, reps=20):
    """ms per call of `reps` calls of launch(*args) queued back to back
    (median of 10 such runs)."""
    return median_ms(lambda: [launch(*args) for _ in range(reps)]) / reps


def check_generic_kernel(rik, anchors, old_srcs=()):
    """K2 against its plain version on the card: the edge cases, the
    degenerate operands and the main path's shape, with exact zeros from
    both on every early-out pair. Times it at (2, 32, N) and (2, 512, N)
    against its data-dependent bound and against the K2 of each of
    `old_srcs` (other copies of `rotated_iou.cu`) in turns. Returns its entry
    of the kernels line (launches filled in later) and its main-path gts."""
    from jdet_torch.utils.edge_cases import degenerate_boxes, edge_case_boxes

    dev = "cuda"

    def zeros_on_early(got, want, g, a):
        """The early-out pairs, checked exact zeros in kernel and plain
        version; returns their count."""
        early = rik.generic_early_out_pairs(g, a)
        check(not got[early].any() and not want[early].any(),
              "generic kernel: nonzero IoU on an early-out pair")
        return int(early.sum())

    g, a = edge_case_boxes()
    g, a = torch.as_tensor(g, device=dev), torch.as_tensor(a, device=dev)
    got = rik.box_iou_rotated_generic(g, a)
    want = rik.box_iou_rotated_generic_reference(g, a)
    torch.cuda.synchronize()
    err_edge = (got - want).abs().max().item()
    K = g.shape[1]
    diag = got[0, torch.arange(K), torch.arange(K)]
    diag_err = (diag - 1).abs().max().item()
    early = zeros_on_early(got, want, g, a)
    log(f"generic iou kernel, edge cases (2, {K}, {a.shape[0]}): "
        f"max_abs_err={err_edge:.3e} diag_err={diag_err:.3e}, {early} early-out pairs all 0")
    check(err_edge <= 2e-4, f"generic kernel, edge cases disagree: {err_edge}")
    check(diag_err <= 1e-5, f"generic kernel, identical boxes: IoU off 1 by {diag_err}")

    # zero-size, needle, thin, 1e-3 apart, multiples of pi/2, near 1e4; the
    # pairs whose fp32 value is rounding noise (the parked gt's among them)
    # are left out of the comparison, not out of the exact-zero check
    g, a, checked = (torch.as_tensor(x, device=dev) for x in degenerate_boxes())
    got = rik.box_iou_rotated_generic(g, a)
    want = rik.box_iou_rotated_generic_reference(g, a)
    torch.cuda.synchronize()
    err_deg = (got - want)[checked].abs().max().item()
    early = zeros_on_early(got, want, g, a)
    log(f"generic iou kernel, degenerate operands {tuple(got.shape)}: max_abs_err="
        f"{err_deg:.3e} on {int(checked.sum())} compared pairs; zero-size gt row "
        f"{got[0, 0][checked[0, 0]].min().item():.6f}..{got[0, 0][checked[0, 0]].max().item():.6f}; "
        f"{early} early-out pairs all 0")
    check(err_deg <= 2e-4, f"generic kernel, degenerate operands disagree: {err_deg}")

    # the main path's shape, (2, 32, 196416), every slot a real gt (a gt
    # parked at FAR_CENTER is zero-size, so it takes the full path, and its
    # clip arithmetic at |x| ~ 1e6 gives rounding noise in any
    # implementation)
    _, t = synth_batch(2, 1024, K=32, real=32, seed=2)
    gts = torch.as_tensor(t["gt_bboxes"], device=dev)
    B, K, N = gts.shape[0], gts.shape[1], anchors.shape[0]
    got = rik.box_iou_rotated_generic(gts, anchors)
    want = rik.box_iou_rotated_generic_reference(gts, anchors)
    torch.cuda.synchronize()
    err_main = (got - want).abs().max().item()
    early = zeros_on_early(got, want, gts, anchors)
    log(f"generic iou kernel, main path ({B}, {K}, {N}): max_abs_err={err_main:.3e} "
        f"nonzero={int((got > 0).sum())}, early-out {early} of {B * K * N} pairs "
        f"({early / (B * K * N):.4f}), all 0")
    check(err_main <= 2e-4, f"generic kernel, main-path shape disagrees: {err_main}")
    check(torch.isfinite(got).all().item(), "generic kernel: non-finite IoU")
    del want

    def bound_of(B, K, early):
        """Bytes: the boxes in, the matrix out; operations: the clip's
        flops for each pair that does not take the early-out."""
        work = B * K * N - early
        return (*bound((B * K * 5 + N * 5 + B * K * N) * 4, IOU_FLOPS_PER_PAIR_GENERIC * work),
                work)

    # device time: launches back to back (the profiler sees K2's launches
    # but records no device time for them)
    new = generic_launcher(rik.build().rotated_iou_generic)
    ms = median_ms(lambda: rik.box_iou_rotated_generic(gts, anchors), iters=20)
    device_ms = back_to_back_ms(new, gts, anchors, torch.empty_like(got))
    plain_ms = median_ms(lambda: rik.box_iou_rotated_generic_reference(gts, anchors))
    bound_ms, bound_by, work = bound_of(B, K, early)
    log(f"generic iou kernel ({B}, {K}, {N}): {ms:.4f} ms per call, {device_ms:.4f} ms "
        f"back to back, plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
        f"({work} pairs do the clip x {IOU_FLOPS_PER_PAIR_GENERIC} flops), "
        f"{device_ms / bound_ms:.1f}x the bound")

    # the config's gt budget (max_gt=512), kernel alone
    _, t512 = synth_batch(2, 1024, K=512, real=512, seed=1)
    g512 = torch.as_tensor(t512["gt_bboxes"], device=dev)
    got512 = rik.box_iou_rotated_generic(g512, anchors)
    early512 = rik.generic_early_out_pairs(g512, anchors)
    check(not got512[early512].any(), "generic kernel (2, 512, N): nonzero on early-out pairs")
    check(torch.isfinite(got512).all().item(), "generic kernel (2, 512, N): non-finite IoU")
    early512 = int(early512.sum())
    ms512 = median_ms(lambda: rik.box_iou_rotated_generic(g512, anchors))
    device_ms512 = back_to_back_ms(new, g512, anchors, got512, reps=5)
    B5, K5 = g512.shape[:2]
    bound512, bound_by512, work512 = bound_of(B5, K5, early512)
    log(f"generic iou kernel ({B5}, {K5}, {N}): {ms512:.4f} ms per call, {device_ms512:.4f} "
        f"ms back to back; early-out {early512} of {B5 * K5 * N} pairs "
        f"({early512 / (B5 * K5 * N):.4f}); bound {bound512:.4f} ms by {bound_by512} "
        f"({work512} pairs do the clip), {device_ms512 / bound512:.1f}x the bound")

    entry = {
        "name": "rotated_iou_generic",
        "route": "cuda",
        "source": "jdet_torch/csrc/rotated_iou.cu",
        "replaces": "jdet_tpu/ops/pallas_iou.py:219",
        "launches": None,
        "max_abs_err": max(err_edge, err_deg, err_main),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": [B, K, N],
        "device_ms": device_ms,
        "early_out_share": early / (B * K * N),
        "ms_512": ms512,
        "device_ms_512": device_ms512,
        "bound_ms_512": bound512,
        "early_out_share_512": early512 / (B5 * K5 * N),
    }
    for old_src in old_srcs:
        old = generic_launcher(build_old_generic(rik, old_src))
        for name, g_, reps in (("", gts, 20), ("_512", g512, 5)):
            diff = (old(g_, anchors) - rik.box_iou_rotated_generic(g_, anchors)).abs().max().item()
            old_ms, new_ms, turns = in_turns(lambda: old(g_, anchors),
                                             lambda: rik.box_iou_rotated_generic(g_, anchors))
            out = torch.empty((*g_.shape[:2], N), device=dev)
            old_b2b, new_b2b, turns_b2b = in_turns(
                lambda: [old(g_, anchors, out) for _ in range(reps)],
                lambda: [new(g_, anchors, out) for _ in range(reps)])
            log(f"generic iou kernel {tuple(g_.shape[:2]) + (N,)}, {old_src} against the "
                f"checkout, in turns old/new/new/old: per call {turns}, old {old_ms:.4f} ms, "
                f"new {new_ms:.4f} ms; back to back, ms per {reps} calls {turns_b2b}, old "
                f"{old_b2b / reps:.4f} ms, new {new_b2b / reps:.4f} ms; max |new - old| {diff:.3e}")
            entry.setdefault("old", {}).setdefault(Path(old_src).stem, {}).update({
                f"ms{name}": old_ms, f"device_ms{name}": old_b2b / reps,
                f"max_abs_diff{name}": diff})
    del got512
    return entry, gts


def assignment_margin(model, targets, size, images=None):
    """Smallest distance between a gt's best IoU and its second best, and
    between an anchor's best IoU and the 0.4 / 0.5 thresholds, from the
    plain IoU on the CPU, over every assignment of the loss: RetinaNet's on
    its anchors; S2ANet's FAM on its init anchors and its ODM on the
    refined anchors that a CPU forward of `images` gives. The assigner's
    low-quality match takes every anchor whose IoU equals the gt's best
    exactly, so K1's rounding and the plain version's can break such a tie
    differently and train on other targets; a batch with a margin has no
    such tie."""
    from jdet_torch.ops import box_iou_rotated

    head = model.bbox_head
    if is_point_head(model):
        return point_margin(model, targets, size)
    if is_reppoints(model):
        return reppoints_margin(model, targets, images)
    sizes = [(size // s, size // s) for s in head.anchor_strides]
    B = len(targets["gt_bboxes"])
    if is_s2anet(model) or is_r3det(model):
        was_training = model.training
        model.eval()
        with torch.no_grad():
            outs = head(model.extract_feat(images))
        model.train(was_training)
        refined = torch.cat([o[2].reshape(B, -1, 5) for o in outs], 1).float()
        first = head._flat_anchors if is_r3det(model) else head._flat_init_anchors
        # R3Det's refine stage assigns at IoU 0.6 / 0.5
        thr = ((0.6, 0.5) if is_r3det(model) else (0.5, 0.4))
        anchor_sets = [([first(sizes, "cpu")] * B, (0.5, 0.4)), (list(refined), thr)]
    else:
        anchor_sets = [([head._flat_anchors(sizes, "cpu")] * B, (0.5, 0.4))]
    return min(iou_margin(box_iou_rotated(torch.as_tensor(gt[m]), anchors), thr)
               for per_image, thr in anchor_sets
               for gt, m, anchors in zip(targets["gt_bboxes"], targets["gt_mask"], per_image))


def point_margin(model, targets, size):
    """Rotated FCOS's and H2RBox's targets (H2RBox's on the gts'
    circumscribed boxes): the smallest distance, in pixels, from a point
    to a side of a gt's box and from a gt's largest side distance to a
    bound of the point's regress range, where a 1e-5 change of the
    rounding could move a point in or out."""
    from jdet_torch.ops.box_convert import hbox_to_rbox, mintheta_obb, rbox_to_hbox

    head = model.bbox_head
    points, rr, _ = head._point_table([(size // s, size // s) for s in head.strides], "cpu")
    points, rr = points.double(), rr.double()
    margin = float("inf")
    for gt, m in zip(targets["gt_bboxes"], targets["gt_mask"]):
        gt = torch.as_tensor(gt[m])
        if type(model).__name__ == "H2RBox":
            gt = hbox_to_rbox(rbox_to_hbox(gt))
        cx, cy, w, h, a = mintheta_obb(gt).double().unbind(-1)
        ox, oy = points[:, 0] - cx[:, None], points[:, 1] - cy[:, None]
        dx = torch.cos(a)[:, None] * ox + torch.sin(a)[:, None] * oy
        dy = -torch.sin(a)[:, None] * ox + torch.cos(a)[:, None] * oy
        ltrb = torch.stack([w[:, None] / 2 + dx, h[:, None] / 2 + dy,
                            w[:, None] / 2 - dx, h[:, None] / 2 - dy], -1)
        margin = min(margin, ltrb.amin(-1).abs().min().item(),
                     (ltrb.amax(-1)[..., None] - rr).abs().min().item())
    return margin


def iou_margin(iou, thr=(0.5, 0.4)):
    """Of a (K, N) IoU matrix of real gts: the smallest gap between a gt's
    best IoU and its second best, and between an anchor's best IoU and
    the thresholds `thr`."""
    iou = iou.double()
    top2 = iou.topk(2, dim=1).values
    best = iou.max(0).values
    return min((top2[:, 0] - top2[:, 1]).min().item(),
               *((best - t).abs().min().item() for t in thr))


def build_trainer(cfg, model, augment=True):
    """The train step of `model` with the config's optimizer, schedule,
    device normalization and (if `augment`) device augmentation, mapped
    from the config as `jdet_tpu/runner/runner.py` maps them. Returns the
    step and its optimizer, normalizer and augmenter."""
    from jdet_torch.optim import build_lr_schedule, build_optimizer
    from jdet_torch.parallel import (build_train_step, make_device_augmenter,
                                     make_device_normalizer)

    ocfg, scfg = cfg["optimizer"], cfg["scheduler"]
    schedule = build_lr_schedule(
        ocfg["lr"], scheduler_type=scfg["type"], milestones=scfg["milestones"],
        gamma=scfg["gamma"], steps_per_epoch=STEPS_PER_EPOCH,
        max_steps=cfg["max_epoch"] * STEPS_PER_EPOCH, warmup=scfg["warmup"],
        warmup_iters=scfg["warmup_iters"], warmup_ratio=scfg["warmup_ratio"])
    opt = build_optimizer(
        model, opt_type=ocfg["type"], lr_schedule=schedule,
        momentum=ocfg.get("momentum", 0.9), weight_decay=ocfg["weight_decay"],
        grad_clip=ocfg["grad_clip"],
        frozen_stages=cfg["model"]["backbone"].get("frozen_stages"))
    normalize = make_device_normalizer(**cfg["device_normalize"])
    augment = make_device_augmenter(**cfg["device_augment"]) if augment else None
    step = build_train_step(model, opt, preprocess=normalize, augment=augment,
                            seed=cfg["seed"])
    return step, opt, normalize, augment


def randomize_constants(model, seed=4):
    """Draw at random what the initializer sets to a constant (BN affine
    and statistics, zero conv biases), as the CPU parity tests do, so that
    no parameter's scale is its own 2-step update."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                n = mod.num_features
                for t, draw in ((mod.weight, rng.uniform(0.5, 1.5, n)),
                                (mod.bias, rng.normal(0.0, 0.1, n)),
                                (mod.running_mean, rng.normal(0.0, 0.1, n)),
                                (mod.running_var, rng.uniform(0.5, 1.5, n))):
                    t.copy_(torch.as_tensor(draw))
            elif getattr(mod, "bias", None) is not None and not mod.bias.any():
                mod.bias.copy_(torch.as_tensor(rng.normal(0.0, 0.01, mod.bias.shape)))


def untied_batch_seed(model, cfg, size=512):
    """The first batch seed from 5 whose B=1 uint8 batch at `size`
    (normalized as the config's train step normalizes it) has no near tie
    in any assignment of `model`, a CPU model."""
    from jdet_torch.parallel import make_device_normalizer

    normalize = make_device_normalizer(**cfg["device_normalize"])

    def margin(seed):
        images, targets = synth_batch(1, size, seed=seed, uint8=True)
        return assignment_margin(model, targets, size, normalize(torch.as_tensor(images)))

    return next(s for s in range(5, 100) if margin(s) > 1e-5)


def aug_map_margin(model, targets, size, theta):
    """H2RBox: over the positive points of the batch's (weak) targets, the
    smallest distance, in cells, from a point's rotated position in the
    rotated view's grid to a rounding boundary of `_aug_index_map` (half
    a cell), in float64. The devices' float32 cosine and sine of theta may
    differ by an ulp, which moves a position by up to ~1e-5 cells."""
    from jdet_torch.ops.box_convert import hbox_to_rbox, rbox_to_hbox

    head = model.bbox_head
    sizes = [(size // s, size // s) for s in head.strides]
    points, rr, strides = head._point_table(sizes, "cpu")
    gts = hbox_to_rbox(rbox_to_hbox(torch.as_tensor(targets["gt_bboxes"]).float()))
    _, _, pos = head._targets(points, rr, strides, gts,
                              torch.as_tensor(targets["gt_mask"]).bool(),
                              torch.as_tensor(targets["gt_labels"]))
    (h0, w0), s0 = sizes[0], head.strides[0]
    cx, cy = (w0 * s0 - 1) / 2.0, (h0 * s0 - 1) / 2.0
    th = float(theta)
    p, st = points.double(), strides.double()
    rx = np.cos(th) * (p[:, 0] - cx) - np.sin(th) * (p[:, 1] - cy) + cx
    ry = np.sin(th) * (p[:, 0] - cx) + np.cos(th) * (p[:, 1] - cy) + cy
    cells = torch.stack([(rx - st / 2) / st, (ry - st / 2) / st], -1)
    dist = (cells - cells.floor() - 0.5).abs().amin(-1)
    return dist[pos.any(0)].min().item()


def check_train_card_against_cpu(cfg, rik, loss_forward=False, param_tol=1e-3):
    """The full-width model with the same random weights on the card and
    on the CPU, B=1 at 512² (the card's assigner takes the fused kernel,
    the CPU's the plain version), augmentation off, on a batch without
    near ties in its targets; with `loss_forward`, a float32 loss forward
    first (rtol 1e-4). Then, with the config's SGD, two float32 train
    steps, each parameter after them within `param_tol` of its tensor's
    largest value; with Adam (H2RBox's AdamW), the gradients of the loss from the
    one state instead, held to `GRAD_LIMITS` as
    `check_rcnn_card_against_cpu(grads=True)` holds them: an Adam step
    divides each gradient by its own size, so a gradient near 0 takes a
    full step in either direction and two devices' steps are not
    comparable. H2RBox's gradients are held under the float64 policy and
    its float32 ones logged beside them: a ReLU pre-activation within the
    devices' float32 rounding of zero takes the gradient through on one
    device and not on the other, and among the backbone's millions of
    ReLUs (two passes, randomized BN statistics) some always do, on every
    batch seed tried, which puts many of its float32 tensors ~1e-3 of
    their largest apart; in float64 none lies that near. Both devices
    take one theta, drawn from the CPU's generator, whose rotated view
    maps no positive point within 1e-4 of a cell boundary
    (`aug_map_margin`)."""
    from jdet_torch.models.builder import build_detector
    from jdet_torch.models.nn import compute_dtype_scope
    from jdet_torch.utils.general import parse_losses

    adam = cfg["optimizer"]["type"].startswith("Adam")
    models = {dev: build_detector(cfg["model"], device=dev, seed=1, load_pretrained=False)
              for dev in ("cpu", "cuda")}
    randomize_constants(models["cpu"])
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    start = {n: p.detach().clone() for n, p in models["cpu"].named_parameters()}
    seed = untied_batch_seed(models["cpu"], cfg)
    images, targets = synth_batch(1, 512, seed=seed, uint8=True)
    name = cfg["model"]["type"]
    kw = {}
    if hasattr(models["cpu"], "draw_theta"):
        draws = (models["cpu"].draw_theta(torch.Generator().manual_seed(g), "cpu")
                 for g in range(100))
        kw["theta"] = next(th for th in draws
                           if aug_map_margin(models["cpu"], targets, 512, th) > 1e-4)
        log(f"{name} card vs cpu: theta {kw['theta'].item()!r}, aug map margin "
            f"{aug_map_margin(models['cpu'], targets, 512, kw['theta']):.3e} cells")
    if adam:
        with compute_dtype_scope(torch.float64):
            for dev in ("cpu", "cuda"):
                models[f"f64_{dev}"] = build_detector(cfg["model"], device=dev, seed=1,
                                                      load_pretrained=False)
                models[f"f64_{dev}"].load_state_dict(models["cpu"].state_dict())
    losses, forward, grads = {}, {}, {}
    for key, m in models.items():
        dev = "cuda" if key.endswith("cuda") else "cpu"
        step, _, normalize, _ = build_trainer(cfg, m, augment=False)
        x, t = to_device(images, targets, dev)
        x = normalize(x)
        launches = launch_counts(rik)
        if key.startswith("f64"):
            x = x.double()
        if loss_forward or adam:
            m.train()
            m.zero_grad(set_to_none=True)
            out = m.loss(x, t, **kw)
            forward[key] = {k: v.item() for k, v in out.items()}
            if adam:
                parse_losses(out)[0].backward()
                grads[key] = {n: p.grad.detach().cpu().clone()
                              for n, p in m.named_parameters() if p.grad is not None}
                m.zero_grad(set_to_none=True)
            del out
        if not adam:
            losses[key] = [{k: v.item() for k, v in step(*to_device(images, targets, dev),
                                                         it).items()} for it in range(2)]
        if dev == "cuda":
            n_losses = 1 if adam else 2 + loss_forward
            got = {k: v - launches[k] for k, v in launch_counts(rik).items()}
            want = {k: n_losses * n for k, n in fused_per_loss(m).items()}
            check(all(got[k] == n for k, n in want.items()),
                  f"the card's loss forward and train steps did not launch the fused "
                  f"assigner as {want}: {got}")
    if loss_forward:
        log(f"{name} loss forward card vs cpu at 512², B=1, batch seed "
            f"{seed}: {forward['cuda']} vs {forward['cpu']}")
        for k, want in forward["cpu"].items():
            got = forward["cuda"][k]
            check(abs(got - want) <= 1e-4 * abs(want), f"loss forward {k}: card {got} cpu {want}")
    if adam:
        for prec, card, cpu in (("float32", "cuda", "cpu"), ("float64", "f64_cuda", "f64_cpu")):
            worst = {"grad": {}, "grad_rms": {}}
            for n, want in grads[cpu].items():
                got = grads[card][n]
                for what, norm in (("grad", torch.amax), ("grad_rms", torch.linalg.vector_norm)):
                    scale = norm(want.abs()).item()
                    worst[what][n] = norm((got - want).abs()).item() / scale if scale else (
                        0.0 if torch.equal(got, want) else float("inf"))
            top = {what: max(errs.items(), key=lambda kv: kv[1]) for what, errs in worst.items()}
            median = {what: float(np.median(list(errs.values())))
                      for what, errs in worst.items()}
            over = {what: sum(e > GRAD_LIMITS[what] for e in errs.values())
                    for what, errs in worst.items()}
            log(f"{name} gradients card vs cpu from one state in {prec}, batch seed {seed}: "
                f"{len(worst['grad'])} tensors; error over the CPU's gradient, largest and "
                f"RMS: worst {top}, median {json.dumps(median)}, tensors over "
                f"{json.dumps(GRAD_LIMITS)}: {json.dumps(over)}")
            if prec == "float32":
                continue
            check(set(grads[card]) == set(grads[cpu]) and len(grads[cpu]) > 100,
                  "the card and the CPU have gradients for different parameters")
            for what, tol in GRAD_LIMITS.items():
                bad = {n: e for n, e in worst[what].items() if not e <= tol}
                check(not bad, f"{name} gradient {what} in {prec} off the CPU's by more "
                      f"than {tol}: {bad}")
        return
    log(f"{name} train card vs cpu at 512², B=1, batch seed {seed}: losses "
        f"{losses['cuda']} vs {losses['cpu']}")
    for it in range(2):
        for k, want in losses["cpu"][it].items():
            got = losses["cuda"][it][k]
            check(abs(got - want) <= 1e-3 * abs(want), f"step {it} {k}: card {got} cpu {want}")
    cpu_params = dict(models["cpu"].named_parameters())
    worst, worst_update, n = 0.0, 0.0, 0
    for pname, p in models["cuda"].named_parameters():
        if not p.requires_grad:
            continue
        want = cpu_params[pname].detach()
        err = (p.detach().cpu() - want).abs().max().item()
        scale = want.abs().max().item()
        check(err <= param_tol * scale,
              f"parameter {pname} after 2 steps: err {err}, max {scale}")
        update = (want - start[pname]).abs().max().item()
        worst, n = max(worst, err / scale), n + 1
        worst_update = max(worst_update, err / max(update, 1e-30))
    log(f"train card vs cpu: {n} trainable parameters agree after 2 steps, worst "
        f"error {worst:.3e} of the tensor's largest value ({worst_update:.3e} of its "
        f"largest 2-step change)")


def check_bf16_card_against_cpu(cfg, rik, gap_factor=BF16_GAP_FACTOR):
    """The full-width model built under the bf16 policy, on the card and on
    the CPU with the same weights, B=1 at 512²: the loss forward, the
    head outputs and `predict` (score_thr 0.0), and 2 train steps
    (augmentation off). The tolerance is this run's f32 - bf16 gap, the
    distance from the float32 model on the card to the CPU's bf16 result:
    for the 8 losses together, the head's class and box outputs and the 2
    steps' change of all trainable parameters together (root mean
    squares), the card's bf16 result lies within `gap_factor` of that
    gap from the CPU's (BF16_GAP_FACTOR by default). `predict`'s
    detections are not compared: bf16
    logits near the 0.01 prior take few distinct values, so many scores
    tie, and which boxes the greedy NMS keeps follows the order in which
    each device breaks those ties (on the H100, 572 valid detections on
    the card against 773 on the CPU; the float32 model keeps the same
    ones on both)."""
    from jdet_torch.models.builder import build_detector
    from jdet_torch.models.nn import compute_dtype_scope

    runs = {"bf16_card": ("cuda", torch.bfloat16), "bf16_cpu": ("cpu", torch.bfloat16),
            "f32_card": ("cuda", None)}
    models = {}
    for name, (dev, dtype) in runs.items():
        with compute_dtype_scope(dtype):
            models[name] = build_detector(cfg["model"], device=dev, seed=1, load_pretrained=False)
    randomize_constants(models["bf16_cpu"])
    for name in ("bf16_card", "f32_card"):
        models[name].load_state_dict(models["bf16_cpu"].state_dict())
    start = {n: p.detach().clone() for n, p in models["bf16_cpu"].named_parameters()}
    images, targets = synth_batch(1, 512, seed=untied_batch_seed(models["bf16_cpu"], cfg),
                                  uint8=True)
    out = {}
    t0 = time.perf_counter()
    for name, m in models.items():
        dev = runs[name][0]
        step, _, normalize, _ = build_trainer(cfg, m, augment=False)
        x, t = to_device(images, targets, dev)
        launches = fused_launches(rik), rik.LAUNCHES
        m.train()
        losses = {k: v.item() for k, v in m.loss(normalize(x), t).items()}
        m.eval()
        m.bbox_head.test_cfg = dict(m.bbox_head.test_cfg, score_thr=0.0)
        with torch.no_grad():
            outs = m.bbox_head(m.extract_feat(normalize(x)))
            det = m.predict(normalize(x))
        # the class and the box outputs: RetinaNet's; S2ANet's FAM and ODM
        idx = ((0, 3), (1, 4)) if is_s2anet(m) else ((0,), (1,))
        head = [torch.cat([lvl[i].float().flatten().cpu() for lvl in outs for i in ii])
                for ii in idx]
        steps = [{k: v.item() for k, v in step(x, t, it).items()} for it in range(2)]
        change = torch.cat([(p.detach().cpu() - start[n]).flatten()
                            for n, p in m.named_parameters() if p.requires_grad])
        valid = int(det["valid"].sum())
        check(valid > 0 and all(torch.isfinite(det[k]).all().item() for k in ("boxes", "scores")),
              f"{name}: predict gave {valid} valid detections, or non-finite ones")
        out[name] = (losses, head, steps, change, valid)
        want_dtype = runs[name][1] or torch.float32
        check({o.dtype for lvl in outs for ii in idx for i in ii for o in (lvl[i],)}
              == {want_dtype} and all(p.dtype == torch.float32 for p in m.parameters()),
              f"{name}: head outputs not {want_dtype}, or parameters not float32")
        if dev == "cuda":
            per_loss = fused_per_loss(m)
            n_fused = 3 * (per_loss["max_iou_assign_rect"]
                           + per_loss["max_iou_assign_rect_per_image"])
            check((fused_launches(rik) - launches[0], rik.LAUNCHES - launches[1])
                  == (n_fused, 1),
                  f"{name}: not {n_fused // 3} fused assigner launches per loss forward "
                  "and train step and one K1 matrix launch per predict")
        log(f"{cfg['model']['type']} bf16 card vs cpu at 512², B=1: {name} done at "
            f"{time.perf_counter() - t0:.1f} s")

    def rms(a):
        return float(torch.sqrt(torch.mean(torch.as_tensor(a, dtype=torch.float64) ** 2)))

    card, cpu, f32 = (out[k] for k in ("bf16_card", "bf16_cpu", "f32_card"))

    def losses(o):
        return torch.tensor(list(o[0].values()) + [v for lv in o[2] for v in lv.values()],
                            dtype=torch.float64)

    rows = [("the losses of the loss forward and of 2 train steps",
             losses(card) - losses(cpu), losses(f32) - losses(cpu)),
            ("the head's class outputs", card[1][0] - cpu[1][0], f32[1][0] - cpu[1][0]),
            ("the head's box outputs", card[1][1] - cpu[1][1], f32[1][1] - cpu[1][1]),
            ("the 2 steps' parameter change", card[3] - cpu[3], f32[3] - cpu[3])]
    fractions = {what: rms(err) / rms(gap) for what, err, gap in rows}
    log(f"{cfg['model']['type']} bf16 card vs cpu: losses card {card[0]} cpu {cpu[0]} "
        f"f32 {f32[0]}; valid detections "
        f"card/cpu/f32 {[o[4] for o in (card, cpu, f32)]}; |card - cpu| over the f32 - bf16 "
        f"gap: " + json.dumps(fractions))
    for what, frac in fractions.items():
        check(frac <= gap_factor,
              f"bf16 card vs cpu, {what}: {frac:.3f} of the f32 - bf16 gap apart")


def train_at_config_traffic(cfg, model, rik, label, n_steps=20, brief=False):
    """The train step at the config's batch (B=4) at 1024², 512 gt slots
    with 64 real gts per image: `n_steps` steps on one batch, then the step
    timed whole and in parts, and its busiest kernels under the profiler:
    which of them are bf16 tensor-core convolutions, which are layout
    transposes, and for S2ANet the deformable conv's sampling (forward)
    and its scatter-add (backward) and the ORConv's ARF expansion. Returns
    the kernel launches of the steps."""
    step, opt, normalize, augment = build_trainer(cfg, model)
    images, targets = to_device(*synth_batch(4, 1024, K=512, real=64, seed=3, uint8=True),
                                "cuda")

    # the training path, with the launch counters read around it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(rik)
    log_vars, per_step = [], []
    for it in range(n_steps):
        before = launch_counts(rik)
        log_vars.append(step(images, targets, it))
        per_step.append({k: v - before[k] for k, v in launch_counts(rik).items()
                         if k in fused_per_loss(model)})
    torch.cuda.synchronize()
    launches = launch_counts(rik)
    peak = torch.cuda.max_memory_allocated()
    losses = [{k: v.item() for k, v in lv.items()} for lv in log_vars]
    for it, lv in enumerate(losses):
        log(f"{label} {cfg['model']['type']} train step {it}: " + " ".join(f"{k}={v:.6f}" for k, v in lv.items())
            + f" lr={opt.lr_schedule(it):.6g}")
    log(f"{label} {cfg['model']['type']} training path: launches {launches} "
        f"(fused assigner per step {per_step[0]}), "
        f"peak memory {peak} bytes")
    check(all(np.isfinite(v) for lv in losses for v in lv.values()), "non-finite train loss")
    check(losses[-1]["total_loss"] < losses[0]["total_loss"],
          f"the loss did not fall: {losses[0]['total_loss']} -> {losses[-1]['total_loss']}")
    check(per_step == [fused_per_loss(model)] * n_steps and launches["rotated_iou_rect"] == 0,
          f"not {fused_per_loss(model)} fused assigner launches per train step: "
          f"{per_step}, {launches}")

    counter = iter(range(n_steps, 10**6))
    times = {"train_step_ms": median_ms(lambda: step(images, targets, next(counter)),
                                        *timing(brief, 3, 10)),
             "peak_memory_bytes": peak}
    if brief:
        log(f"{label} {cfg['model']['type']} train step at 1024², B=4, K=512 (median of 3 "
            f"after 1): {json.dumps(times)}")
        return launches

    # the step's parts, timed apart on the same objects as the step
    from jdet_torch.utils.general import parse_losses

    parts = {"forward_loss_ms": [], "backward_ms": [], "clip_sgd_ms": []}
    for i in range(13):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        model.train()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cfg["seed"] * 2**32 + 100 + i)
        x, t = augment(images, targets, gen)
        total, _ = parse_losses(model.loss(normalize(x), t))
        ev[1].record()
        opt.zero_grad()
        total.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        ev[3].synchronize()
        if i >= 3:
            for k, (a, b) in zip(parts, ((0, 1), (1, 2), (2, 3))):
                parts[k].append(ev[a].elapsed_time(ev[b]))
    times.update({k: float(np.median(v)) for k, v in parts.items()})
    # device time and wall time of the same 3 profiled steps, and the
    # kernel families by full name: bf16 tensor-core kernels (cuDNN's and
    # CUTLASS's name their bf16 operands), NCHW <-> NHWC layout transposes
    # the fused assigner's kernels run a whole number of times per step
    # where the model assigns rotated boxes (none in FasterRCNN-OBB's and
    # Gliding's steps)
    expect = ASSIGN_KERNELS if any(fused_per_loss(model).values()) else ()
    kernels, device_ms, wall_ms, family_ms = device_profile(
        lambda: step(images, targets, next(counter)), iters=3, expect=expect,
        families={"conv_kernels_ms": r"fprop|dgrad|wgrad|conv|implicit",
                  "bf16_tensor_core_kernels_ms": r"bf16",
                  "layout_transpose_kernels_ms": r"nchwToNhwc|nhwcToNchw|[Tt]ranspose",
                  "deform_grid_sample_forward_ms": r"grid_sampler_2d_kernel",
                  "deform_grid_sample_backward_scatter_add_ms": r"grid_sampler_2d_backward",
                  "orconv_arf_index_select_and_backward_ms": r"index_?[Ss]elect|indexFunc|index_add",
                  "fused_assigner_ms": r"assign_pass\d_kernel",
                  "depthwise_conv_ms": r"depthwise|[Gg]rouped",
                  "roi_align_gather_forward_ms": r"EmbeddingBag|embedding_bag",
                  "roi_align_scatter_backward_ms":
                      r"embedding_backward|compute_grad_weight|sum_and_scatter|partials_per_segment"})
    times["profiled_step_device_ms"] = device_ms
    times["profiled_step_wall_ms"] = wall_ms
    times["device_busy_share"] = device_ms / wall_ms
    times.update(family_ms)
    log(f"{label} {cfg['model']['type']} train step at 1024², B=4, K=512 (median of 10 after 3): "
        f"{json.dumps(times)}")
    log(f"{label} {cfg['model']['type']} train step under the profiler, the 12 busiest "
        "kernels, device ms per step: "
        + json.dumps(dict(list(kernels.items())[:12])))
    check(all(p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
              for p in model.parameters()), f"{label}: a parameter or gradient is not float32")
    return launches


def check_card_against_cpu(model, cpu_model):
    """The full-width model on the card against the same weights on the
    CPU, B=1 at 512² (large enough that the card's assigner takes the
    fused kernel, the CPU's the plain version; the card's NMS IoU takes K1,
    the CPU's the plain path)."""
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


def serving_phase(model, rik, label, brief=False):
    """The serving path of `model` at B=2, 1024², once, with the launch
    counts read around it: the loss forward, `predict` at the config's
    test_cfg and `predict` with score_thr=0.0; then each phase and its
    parts timed. Returns the launches."""
    head = model.bbox_head
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

    # the serving path, once, with the launch counts read around it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(rik)
    losses = loss_fwd()
    torch.cuda.synchronize()
    loss_launches = launch_counts(rik)
    det = predict(test_cfg["score_thr"])
    det0 = predict(0.0)
    torch.cuda.synchronize()
    serving_launches = launch_counts(rik)
    peak = torch.cuda.max_memory_allocated()
    label = f"{label} {type(model).__name__}"
    log(f"{label} serving path: launches {serving_launches} (loss forward {loss_launches}), "
        f"peak memory {peak} bytes")
    check(loss_launches == {"rotated_iou_rect": 0, "rotated_iou_generic": 0,
                            **fused_per_loss(model)},
          f"not {fused_per_loss(model)} fused assigner launches in the loss forward: "
          f"{loss_launches}")
    check(serving_launches["rotated_iou_rect"] == 2,
          f"not one K1 matrix launch per predict: {serving_launches}")

    lv = {k: v.item() for k, v in losses.items()}
    log(f"{label} losses at 1024², B=2: {lv}")
    check(all(np.isfinite(v) for v in lv.values()), "non-finite loss")
    check(all(v > 0 for k, v in lv.items() if "cls" in k), "a class loss is not positive")
    for name, d in (("predict", det), ("predict score_thr=0", det0)):
        shapes = {k: tuple(v.shape) for k, v in d.items()}
        log(f"{label} {name}: {shapes}, valid per image {d['valid'].sum(1).tolist()}")
        check(shapes["boxes"] == (2, 2000, 5) and shapes["polys"] == (2, 2000, 8)
              and shapes["scores"] == (2, 2000), f"{name}: shapes {shapes}")
        check(all(torch.isfinite(d[k]).all().item() for k in ("boxes", "polys", "scores")),
              f"{name}: non-finite detections")
    v = det0["valid"]
    check(v.sum().item() > 0, "no valid detections at score_thr=0.0")
    # untrained FCOS and H2RBox heads put ReLU'd distances of exactly 0
    # (a zero side) beside positive ones, and a RepPoints set may be
    # collinear; decoded anchors never do
    sides = det0["boxes"][v][:, 2:4]
    check(((sides >= 0) if is_point_head(model) or is_reppoints(model) else (sides > 0))
          .all().item(), "degenerate valid boxes")
    check(((det0["labels"][v] >= 0) & (det0["labels"][v] < 15)).all().item(), "bad labels")

    # each phase, and its parts: the network forward, and the head's loss
    # (targets + losses) or post-processing (decode + NMS) on its outputs
    with torch.no_grad():
        outs = head(model.extract_feat(images))

    def head_predict(score_thr):
        head.test_cfg = dict(test_cfg, score_thr=score_thr)
        return head.predict(outs)

    # the NMS's per-class IoU blocks alone, as predict runs them
    cand = nms_candidates()

    thr = test_cfg["score_thr"]
    times = {"loss_forward_ms": median_ms(loss_fwd, *timing(brief))}
    with torch.no_grad():
        for name, fn in (
            ("predict_ms", lambda: predict(thr)),
            ("predict_score_thr0_ms", lambda: predict(0.0)),
            ("network_forward_no_grad_ms", lambda: head(model.extract_feat(images))),
            ("head_loss_ms", lambda: head.loss(outs, targets)),
            ("head_predict_ms", lambda: head_predict(thr)),
            ("head_predict_score_thr0_ms", lambda: head_predict(0.0)),
            ("nms_class_iou_ms", lambda: rik.box_iou_rotated_rect(cand, cand)),
        ):
            times[name] = median_ms(fn, *timing(brief))
    log(f"{label} phases at 1024², B=2 (median of {timing(brief)[1]}): {json.dumps(times)}")
    # the first class output of each level (R3Det's: stage 1's)
    check({(lvl[0][0] if is_r3det(model) else lvl[0]).dtype for lvl in outs}
          == {model_dtype(model)}, f"{label}: head outputs are not {model_dtype(model)}")
    head.test_cfg = test_cfg
    return serving_launches


def model_dtype(model):
    """The dtype the model's layers compute in: float32 or the policy's."""
    from jdet_torch.models.layers import Conv2d

    conv = next(m for m in model.bbox_head.modules() if isinstance(m, Conv2d))
    return conv.dtype or torch.float32


def decode_ms_by_filter(image, root, reps=3):
    """Median ms of the port's PNG reader on `image` written with each of
    the five row filters."""
    from jdet_torch.data import image_io

    out = {}
    for ftype, name in enumerate(image_io.FILTER_NAMES):
        path = str(root / f"decode_{name}.png")
        image_io.imwrite(path, image, filter_type=ftype)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            got = image_io.imread(path)
            times.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(got, image), f"PNG {name}: the reader does not round-trip")
        out[name] = float(np.median(times))
    return out


def runner_phase(cfg, rik, root, n_tiles=16):
    """The Runner on a synthetic DOTA tree: `run()` (2 epochs of training,
    `val` after each, a checkpoint after each, then `test` on an
    ImageDataset of the same tiles), merged submission, resume, then the
    loader-fed numbers. Returns the kernel launches of `run()`."""
    import copy
    import shutil

    from jdet_torch.data import image_io
    from jdet_torch.data.synthetic import make_synthetic_dota
    from jdet_torch.runner import Runner
    from jdet_torch.tools import merge_results as merge_cli

    shutil.rmtree(root, ignore_errors=True)
    cfg = copy.deepcopy(cfg)
    size = cfg["dataset"]["train"]["image_size"][0]
    t0 = time.perf_counter()
    img_dir, ann = make_synthetic_dota(str(root), n_images=n_tiles, size=size, seed=0)
    log(f"runner phase: {n_tiles} synthetic {size}² tiles written in "
        f"{time.perf_counter() - t0:.2f} s")
    cfg["model"]["backbone"]["pretrained"] = None
    ds = cfg["dataset"]
    for split in ("train", "val"):
        ds[split].update(annotations_file=ann, images_dir=img_dir, num_workers=2)
    ds["train"]["image_cache"] = "auto"
    ds["test"].update(images_dir=img_dir, num_workers=2)
    cfg.update(name="runner_smoke", work_dir=str(root / "work"), max_epoch=2,
               eval_interval=1, checkpoint_interval=1, log_interval=1)
    B = ds["train"]["batch_size"]
    iters = 2 * (n_tiles // B)

    runner = Runner(cfg, device="cuda")
    logged = []
    real_log = runner.logger.log
    runner.logger.log = lambda d: (logged.append(d), real_log(d))

    # the main path through the Runner, with the launch counters read
    # around it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(rik)
    t0 = time.perf_counter()
    runner.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launch_counts(rik)
    peak = torch.cuda.max_memory_allocated()
    log(f"runner path: run() {run_s:.2f} s, launches {launches}, peak memory {peak} bytes")

    losses = [d for d in logged if "total_loss" in d]
    evals = [d for d in logged if "eval/0_meanAP" in d]
    check(len(losses) == iters and all(np.isfinite(d[k]) for d in losses
                                       for k in ("loss_cls", "loss_bbox", "total_loss")),
          f"runner: {len(losses)} logged train iterations, or a non-finite loss")
    check((runner.epoch, runner.iter) == (2, iters), f"runner at {runner.epoch}, {runner.iter}")
    check(len(evals) == 2, f"runner: {len(evals)} val results, expected 2")
    for m in evals:
        aps = [k for k in m if k.startswith("eval/") and k.endswith("_AP") and k != "eval/0_meanAP"]
        check(len(aps) == 15 and 0.0 <= m["eval/0_meanAP"] <= 1.0,
              f"runner val: {len(aps)} class APs, meanAP {m['eval/0_meanAP']}")
    n_val = n_tiles // B  # predict batches of one val or one test
    check(launches == {"rotated_iou_rect": 3 * n_val, "max_iou_assign_rect": iters,
                       "max_iou_assign_rect_per_image": 0,
                       "max_iou_assign_rect_per_image_masked": 0, "rotated_iou_generic": 0},
          f"runner: not one fused assigner launch per train iteration and one K1 matrix "
          f"launch per predict batch: {launches}")
    work = root / "work"
    test_pkl = work / "test" / "test_2.pkl"
    check(test_pkl.exists() and (work / "checkpoints" / "ckpt_2.pkl").exists(),
          "runner: no test pkl or checkpoint")
    with open(test_pkl, "rb") as f:
        results = pickle.load(f)
    check(len(results) == n_tiles and all(np.isfinite(det["polys"]).all() for det, _ in results),
          "runner test: missing or non-finite detections")
    files = merge_cli.main(["--results", str(test_pkl), "--out-dir", str(work / "merged")])
    check(len(files) == 15 and all(Path(f).name.startswith("Task1_") for f in files),
          f"merge_results wrote {len(files)} files")
    log(f"runner: losses {[round(d['total_loss'], 5) for d in losses]}, meanAP "
        f"{[m['eval/0_meanAP'] for m in evals]}, test pkl {len(results)} tiles with "
        f"{sum(int(det['valid'].sum()) for det, _ in results)} valid detections, "
        f"{len(files)} merged submission files")

    # resume: the checkpoint restores the epoch, the iteration, the weights
    # and the momentum buffers
    resumed = Runner(dict(cfg, resume=True), device="cuda")
    check((resumed.epoch, resumed.iter, resumed.optimizer.count) == (2, iters, iters),
          f"resume at {resumed.epoch}, {resumed.iter}, {resumed.optimizer.count}")
    for (name, p), p2 in zip(runner.model.state_dict().items(),
                             resumed.model.state_dict().values()):
        check(torch.equal(p, p2), f"resume: {name} differs")
    params = dict(resumed.model.named_parameters())
    n_buf = 0
    for name, p in runner.model.named_parameters():
        if p in runner.optimizer.sgd.state:
            buf = resumed.optimizer.sgd.state[params[name]]["momentum_buffer"]
            check(torch.equal(runner.optimizer.sgd.state[p]["momentum_buffer"], buf),
                  f"resume: momentum of {name} differs")
            n_buf += 1
    log(f"resume: epoch 2, iter {iters}, parameters and {n_buf} momentum buffers identical")
    resumed.close()
    del resumed

    # loader-fed numbers. run() read the losses every iteration
    # (log_interval=1), so its iteration times are synchronised ones
    times = {}
    for epoch, its in enumerate(runner.iteration_times):
        times[f"epoch{epoch}_iteration_ms_median"] = 1e3 * float(np.median([t for _, t in its]))
        times[f"epoch{epoch}_loader_wait_ms_median"] = 1e3 * float(np.median([w for w, _ in its]))
        times[f"epoch{epoch}_loader_wait_ms_mean"] = 1e3 * float(np.mean([w for w, _ in its]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.val()
    torch.cuda.synchronize()
    times["val_images_per_s"] = n_tiles / (time.perf_counter() - t0)
    # two more epochs from the memmap cache, losses read once per epoch: the
    # first timed whole, the second under the profiler
    runner.max_epoch, runner.max_iter, runner.log_interval = 4, 2 * iters, n_tiles // B
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.train_epoch()
    torch.cuda.synchronize()
    times["epoch2_unsynced_iteration_ms_mean"] = (time.perf_counter() - t0) * 1e3 / (n_tiles // B)
    kernels, device_ms, wall_ms = device_profile(runner.train_epoch, iters=1, warmup=False)
    times["profiled_epoch_device_ms"] = device_ms
    times["profiled_epoch_wall_ms"] = wall_ms
    times["loader_fed_device_busy_share"] = device_ms / wall_ms
    times["test_time_images_per_s"] = runner.test_time(warmup=3, rerun=10)
    times["run_s"] = run_s
    times["peak_memory_bytes"] = peak
    times["png_decode_ms_per_tile"] = decode_ms_by_filter(
        image_io.imread(os.path.join(img_dir, "tile_0000.png")), root)
    log(f"runner, loader-fed at {size}², B={B}: {json.dumps(times)}")
    log("runner, profiled loader-fed epoch, the 8 busiest kernels, device ms: "
        + json.dumps(dict(list(kernels.items())[:8])))
    runner.close()
    return launches


def multi_rate_tiling(root):
    """One synthetic scene of 1500 x 1100 tiled by `preprocess` at the
    multi-scale configs' rates [0.5, 1.0, 1.5] (the bicubic resize of
    `tiling.resize_cubic` on numpy), then its tiles' objects, as
    detections at tile coordinates, merged back (`merge_results`): every
    quad inside the scene comes back from the one rate-0.5 tile within
    1e-3 px. Returns its times."""
    from jdet_torch.config.constants import get_classes_by_name
    from jdet_torch.data.devkits import result_merge, tiling
    from jdet_torch.data.synthetic import make_synthetic_raw_dota
    from jdet_torch.tools import preprocess

    img_dir, label_dir = make_synthetic_raw_dota(str(root / "raw"), sizes=((1500, 1100),),
                                                 corner_only=(False,), seed=2)
    out = root / "tiles"
    cfg_file = root / "ms_cfg.py"
    cfg_file.write_text(
        f"preprocess = dict(dataset_type='DOTA', subsize=1024, gap=200, rates=[0.5, 1.0, 1.5], "
        f"tasks=[dict(image_dir={img_dir!r}, label_dir={label_dir!r}, out_dir={str(out)!r})])\n")
    t0 = time.perf_counter()
    tiles = preprocess.main(["--config-file", str(cfg_file), "--clear"])[0]
    seconds = time.perf_counter() - t0
    per_rate = Counter(result_merge.parse_tile_name(n)[1] for n in tiles)
    check(per_rate == {0.5: 1, 1.0: 4, 1.5: 6}, f"multi-rate tiling: tiles per rate {per_rate}")
    classes = get_classes_by_name("DOTA")
    results, back = [], []
    for n in tiles:
        polys, names, _ = tiling.parse_dota_label(str(out / "labelTxt" / (n + ".txt")))
        results.append(({"polys": polys, "scores": np.ones(len(polys), np.float32),
                         "labels": np.array([classes.index(c) for c in names], np.int64),
                         "valid": np.ones(len(polys), bool)}, {"filename": n + ".png"}))
        _, rate, left, up = result_merge.parse_tile_name(n)
        if rate == 0.5:
            back.append(result_merge.tile_to_original(polys, rate, left, up))
    merged = result_merge.merge_results(results, classes)
    src, _, _ = tiling.parse_dota_label(str(Path(label_dir) / "scene_0000.txt"))
    inside = ((src[:, 0::2] >= 0) & (src[:, 0::2] <= 1500)).all(1) & (
        (src[:, 1::2] >= 0) & (src[:, 1::2] <= 1100)).all(1)
    back = np.concatenate(back)
    gap = max(np.abs(back - poly).max(1).min() for poly in src[inside])
    check(list(merged) == ["scene_0000"] and inside.sum() > 10 and gap < 1e-3,
          f"multi-rate merge: scenes {list(merged)}, {int(inside.sum())} quads inside, "
          f"worst {gap}")
    return {"multi_rate_tiles": len(tiles), "multi_rate_tiling_s": seconds,
            "multi_rate_merged_detections": int(sum(len(v) for v in merged["scene_0000"].values())),
            "multi_rate_worst_quad_px": float(gap)}


def tiling_phase(cfg, rik, root):
    """The README's quick start on synthetic data: `python -m
    jdet_torch.tools.preprocess` tiles 2 raw scenes of 2000 x 1500 at the
    config's subsize 1024 and gap 200; then a Runner on the tiles trains
    one epoch, validates with score_thr=0.0 (every tile carries all the
    detections its NMS keeps, up to the config's 2000) and tests, and
    `merge_results` merges
    the test's tiles back into scenes. `DOTADataset.evaluate` and the merge
    are timed on the native polygon library and once more on its numpy
    plain path, with the same APs and the same merged detections.
    Then `multi_rate_tiling` at rates 0.5, 1.0 and 1.5. Last,
    `Runner.profile` records 3 steps. Returns the launches of the epoch
    and those of val and test."""
    import copy
    import shutil

    from jdet_torch.data import image_io
    from jdet_torch.data.devkits import polygon, result_merge, voc_eval
    from jdet_torch.data.synthetic import make_synthetic_raw_dota
    from jdet_torch.runner import Runner
    from jdet_torch.tools import merge_results as merge_cli
    from jdet_torch.tools import preprocess

    shutil.rmtree(root, ignore_errors=True)
    img_dir, label_dir = make_synthetic_raw_dota(
        str(root / "raw"), sizes=((2000, 1500),) * 2, corner_only=(False, False), seed=1)
    out = root / "tiles"
    cfg_file = root / "preprocess_cfg.py"
    cfg_file.write_text(
        f"preprocess = dict(dataset_type='DOTA', subsize=1024, gap=200, rates=[1.0], "
        f"tasks=[dict(image_dir={img_dir!r}, label_dir={label_dir!r}, out_dir={str(out)!r})])\n")
    t0 = time.perf_counter()
    tiles = preprocess.main(["--config-file", str(cfg_file), "--clear"])[0]
    tiling_s = time.perf_counter() - t0
    names = sorted(os.listdir(out / "images"))
    check(len(tiles) == len(names) == 12, f"preprocess wrote {len(names)} tiles, expected 12")
    check(all((image_io.png_row_filters(str(out / "images" / n)) == 1).all() for n in names),
          "preprocess: a tile row not written with the Sub filter")
    with open(out / "labels.pkl", "rb") as f:
        records = pickle.load(f)
    check(len(records) == 12 and all(len(r["ann"]["bboxes"]) for r in records),
          f"labels.pkl: {len(records)} records")
    times = {"tiling_s": tiling_s, "tiles_per_s": len(names) / tiling_s}

    cfg = copy.deepcopy(cfg)
    cfg["model"]["backbone"]["pretrained"] = None
    ds = cfg["dataset"]
    # batches loaded in this process: the Runner phase drives the spawned
    # loader workers, whose start took ~20 s here
    for split in ("train", "val"):
        ds[split].update(annotations_file=str(out / "labels.pkl"),
                         images_dir=str(out / "images"), num_workers=0)
    ds["test"].update(images_dir=str(out / "images"), num_workers=0)
    cfg.update(name="tiling_smoke", work_dir=str(root / "work"), max_epoch=1, log_interval=1)
    runner = Runner(cfg, device="cuda")
    logged = []
    real_log = runner.logger.log
    runner.logger.log = lambda d: (logged.append(d), real_log(d))
    torch.cuda.synchronize()
    reset_launch_counts(rik)
    runner.train_epoch()
    torch.cuda.synchronize()
    epoch_launches = launch_counts(rik)
    losses = [d for d in logged if "total_loss" in d]
    check(runner.iter == 3 and len(losses) == 3
          and all(np.isfinite(d["total_loss"]) for d in losses),
          f"tiling epoch: {runner.iter} iterations, losses {losses}")
    check(epoch_launches == {"rotated_iou_rect": 0, "max_iou_assign_rect": 3,
                             "max_iou_assign_rect_per_image": 0,
                             "max_iou_assign_rect_per_image_masked": 0,
                             "rotated_iou_generic": 0},
          f"tiling epoch: not one fused assigner launch per iteration: {epoch_launches}")

    # val and test with every detection kept
    head = runner.model.bbox_head
    head.test_cfg = dict(head.test_cfg, score_thr=0.0)
    reset_launch_counts(rik)
    t0 = time.perf_counter()
    val_results = runner._run_inference(runner.val_dataset)
    times["val_predict_s"] = time.perf_counter() - t0
    test_pkl = runner.test()
    torch.cuda.synchronize()
    eval_launches = launch_counts(rik)
    check(eval_launches["rotated_iou_rect"] == 6 and eval_launches["max_iou_assign_rect"] == 0,
          f"val and test: not one K1 matrix launch per predict batch: {eval_launches}")
    n_det = [int(det["valid"].sum()) for det, _ in val_results]
    times["val_detections_per_tile"] = float(np.mean(n_det))
    check(min(n_det) > 0, f"val at score_thr 0: detections per tile {n_det}")

    ds_val, work = runner.val_dataset, runner.work_dir
    with open(test_pkl, "rb") as f:
        test_results = pickle.load(f)
    merged = {}
    real_iou, real_nms = voc_eval.poly_iou, result_merge.nms_poly_np
    try:
        for path, iou_fn, nms_fn in (("native", real_iou, real_nms),
                                     ("numpy", polygon.poly_iou_plain, polygon.nms_poly_plain)):
            voc_eval.poly_iou, result_merge.nms_poly_np = iou_fn, nms_fn
            t0 = time.perf_counter()
            metrics = ds_val.evaluate(val_results, work, runner.epoch)
            times[f"evaluate_{path}_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            files = merge_cli.main(["--results", test_pkl, "--out-dir", str(root / f"merged_{path}")])
            times[f"merge_{path}_s"] = time.perf_counter() - t0
            merged[path] = (metrics, [Path(f).read_text().splitlines() for f in files])
    finally:
        voc_eval.poly_iou, result_merge.nms_poly_np = real_iou, real_nms
    (m_nat, f_nat), (m_np, f_np) = merged["native"], merged["numpy"]
    check(m_nat.keys() == m_np.keys() and all(abs(m_nat[k] - m_np[k]) <= 1e-12 for k in m_nat),
          f"evaluate: native {m_nat} numpy {m_np}")
    # as multisets: equal scores may come out of the NMS in either order
    lines_nat = Counter(line for f in f_nat for line in f)
    lines_np = Counter(line for f in f_np for line in f)
    same = sum((lines_nat & lines_np).values()) / max(lines_nat.total(), lines_np.total(), 1)
    times["merged_detections"] = lines_nat.total()
    times["merge_lines_identical_share"] = same
    check(lines_nat.total() > 0 and same >= 0.99,
          f"merge: native and numpy keep other detections ({same:.4f} of lines identical)")
    scenes = {line.split()[0] for line in lines_nat}
    check(scenes == {"scene_0000", "scene_0001"}, f"merge: scenes {sorted(scenes)[:5]}")
    times["meanAP"] = m_nat["eval/0_meanAP"]
    times["test_tiles"] = len(test_results)

    times.update(multi_rate_tiling(root / "rates"))

    # Runner.profile: 3 steps, a trace that names K1's fused kernels
    t0 = time.perf_counter()
    trace = runner.profile(n_steps=3)
    times["profile_s"] = time.perf_counter() - t0
    text = Path(trace).read_text()
    check("assign_pass1_kernel" in text and "assign_pass2_kernel" in text,
          f"{trace}: the profile names no fused assigner kernel")
    times["profile_trace_bytes"] = len(text)
    log(f"tiling, val and test with detections, merge, profile: {json.dumps(times)}")
    runner.close()
    return epoch_launches, eval_launches



# Oriented R-CNN ------------------------------------------------------------

class Draws:
    """The samplers' uniforms, drawn on the host from a numpy seed and
    copied to `device`, so that the card and the CPU sample alike (their
    generators give different streams). `rand(shape)` of the two-stage
    loss."""

    def __init__(self, seed, device):
        self.rng = np.random.RandomState(seed)
        self.device = device

    def __call__(self, shape):
        return torch.as_tensor(self.rng.random_sample(shape).astype(np.float32),
                               device=self.device)


def replay_draws(model, seed, device):
    """Make `model.loss` (as the train step calls it) draw from
    `Draws(seed + k, device)` at its k-th call."""
    loss = type(model).loss
    calls = iter(range(10**6))
    model.loss = lambda images, targets, generator=None: loss(
        model, images, targets, rand=Draws(seed + next(calls), device))


def sgd_state(model, opt):
    """Each parameter that `opt` updates, by name: its value and its
    momentum buffer (if it has one yet), on the CPU."""
    updated = {id(q) for g in opt.sgd.param_groups for q in g["params"]}
    state = {}
    for n, p in model.named_parameters():
        if id(p) in updated:
            buf = opt.sgd.state.get(p, {}).get("momentum_buffer")
            state[n] = (p.detach().cpu().clone(), None if buf is None else buf.cpu().clone())
    return state


def load_sgd_state(model, opt, state):
    """Set the parameters that `opt` updates, and their momentum buffers,
    to `state` (`sgd_state` of another model of the same config)."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n in state:
                value, buf = state[n]
                p.copy_(value)
                if buf is not None:
                    opt.sgd.state[p]["momentum_buffer"].copy_(buf)


def proposals_of(model, images):
    """The RPN's proposals of `model` (eval mode, no gradient)."""
    was_training = model.training
    model.eval()
    with torch.no_grad():
        out = model.rpn_head.get_proposals(model.rpn_head(model.extract_feat(images)))
    model.train(was_training)
    return out


def rpn_anchors(rpn, size):
    """The RPN's anchors of all levels for a size² image, on the CPU."""
    return torch.cat([rpn.anchor_generator.grid_anchors((size // s, size // s), lvl, "cpu")
                      for lvl, s in enumerate(rpn.anchor_strides)])


def rpn_margin(gt_hboxes, anchors):
    """Smallest distance of the RPN's hbb IoUs from 0.7 / 0.3, and between
    a gt's best IoU and its best IoU below that. On the anchor grid a
    gt's best IoU is often reached exactly by many anchors, which tie
    alike on both devices; a near tie does not."""
    from jdet_torch.models.boxes.assigner import hbb_overlaps

    iou = hbb_overlaps(gt_hboxes, anchors).double()
    best = iou.amax(1, keepdim=True)
    below = torch.where(iou < best, iou, -1.0).amax(1, keepdim=True)
    return min((best - below).min().item(), (iou - 0.7).abs().min().item(),
               (iou - 0.3).abs().min().item())


def orcnn_margin(model, targets, images):
    """Smallest distance, on the CPU, of any IoU from the thresholds of
    Oriented R-CNN's two assignments: `rpn_margin`, and the RoI head's
    rotated IoUs of its gts and proposals from 0.5."""
    from jdet_torch.ops import box_iou_rotated, rbox_to_hbox

    anchors = rpn_anchors(model.rpn_head, images.shape[1])
    props = proposals_of(model, images)
    margin = np.inf
    for b in range(images.shape[0]):
        gts = torch.as_tensor(targets["gt_bboxes"][b][targets["gt_mask"][b]])
        margin = min(margin, rpn_margin(rbox_to_hbox(gts), anchors))
        cand = torch.cat([gts, props["boxes"][b][props["valid"][b]]])
        margin = min(margin, (box_iou_rotated(gts, cand).double() - 0.5).abs().min().item())
    return margin


def hbb_rcnn_margin(model, targets, images):
    """Smallest distance, on the CPU, of any IoU from the thresholds of
    FasterRCNN-OBB's or Gliding Vertex's two assignments: `rpn_margin`,
    and the RoI head's hbb IoUs of its gt hbbs and proposals from 0.5."""
    from jdet_torch.models.boxes.assigner import hbb_overlaps
    from jdet_torch.ops import rbox_to_hbox

    anchors = rpn_anchors(model.rpn_head, images.shape[1])
    props = proposals_of(model, images)
    margin = np.inf
    for b in range(images.shape[0]):
        gts = rbox_to_hbox(torch.as_tensor(targets["gt_bboxes"][b][targets["gt_mask"][b]]))
        margin = min(margin, rpn_margin(gts, anchors))
        cand = torch.cat([gts, props["boxes"][b][props["valid"][b]]])
        margin = min(margin, (hbb_overlaps(gts, cand).double() - 0.5).abs().min().item())
    return margin


def redet_stage1(model, x, t, rand=None, generator=None):
    """ReDet's stage 1 on the normalized batch x, without gradient: the
    RPN's proposals, the stage-1 sample of them (drawn from `rand` or
    `generator`) and its RoIs refined by their own stage-1 deltas.
    Returns the proposals, the sample's validity and the refined RoIs."""
    from jdet_torch.ops import rbox_to_hbox

    head = model.bbox_head
    props = proposals_of(model, x)
    with torch.no_grad():
        feats = model.extract_feat(x)
        rois, valid, *_ = head._sample_rois(props["boxes"], props["valid"],
                                            rbox_to_hbox(t["gt_bboxes"]), t["gt_mask"],
                                            t["gt_labels"], rand=rand, generator=generator,
                                            gt_reg=t["gt_bboxes"])
        refined = head._refine(rois, head._stage1_forward(feats, rois, valid)[1])
    return props, valid, refined


def redet_margin(model, targets, images, draws_seed=7):
    """`rpn_margin`, then the smallest distance from 0.5 of
    ReDet's stage-1 hbb IoUs (each image's gt hbbs against its gts and
    proposals) and of its stage-2 rotated IoUs (its gts against its gts
    and the refined RoIs of the stage-1 sample that `Draws(draws_seed)`
    gives after the RPN's draws), on the CPU."""
    from jdet_torch.models.boxes.assigner import hbb_overlaps
    from jdet_torch.ops import box_iou_rotated, rbox_to_hbox

    anchors = rpn_anchors(model.rpn_head, images.shape[1])
    t = {k: torch.as_tensor(v) for k, v in targets.items()}
    draws = Draws(draws_seed, "cpu")
    for _ in range(2):
        draws((images.shape[0], anchors.shape[0]))
    props, valid, refined = redet_stage1(model, images, t, rand=draws)
    margin = np.inf
    for b in range(images.shape[0]):
        gts = t["gt_bboxes"][b][t["gt_mask"][b]]
        hb = rbox_to_hbox(gts)
        margin = min(margin, rpn_margin(hb, anchors))
        cand = torch.cat([hb, props["boxes"][b][props["valid"][b]]])
        margin = min(margin, (hbb_overlaps(hb, cand).double() - 0.5).abs().min().item())
        cand = torch.cat([gts, refined[b][valid[b]]])
        margin = min(margin, (box_iou_rotated(gts, cand).double() - 0.5).abs().min().item())
    return margin


def calibrate_inner_norms(model, x):
    """Set the running statistics of every InnerBatchNorm of `model` to
    those of its own input on the batch x, in one forward, layer by
    layer, as a trained model's would be. With random weights and the
    initial statistics (mean 0, variance 1) the ReResNet's activations
    grow block after block (the losses start in the thousands, and the
    RPN's boxes reach 1e4 px)."""
    from jdet_torch.models.equivariant import N_ORIENT, InnerBatchNorm

    def calibrate(mod, args):
        xf = args[0].float()
        mean = xf.mean((0, 2, 3)).reshape(mod.fields, N_ORIENT).mean(-1)
        mean2 = (xf * xf).mean((0, 2, 3)).reshape(mod.fields, N_ORIENT).mean(-1)
        mod.bn.running_mean.copy_(mean)
        mod.bn.running_var.copy_((mean2 - mean * mean).clamp(min=0.0))

    hooks = [m.register_forward_pre_hook(calibrate) for m in model.modules()
             if isinstance(m, InnerBatchNorm)]
    with torch.no_grad():
        model.extract_feat(x)
    for h in hooks:
        h.remove()
    return len(hooks)


def roi_head_outputs(model, feats, rois, valid):
    """The RoI head's outputs on the RoIs, flattened: Oriented R-CNN's
    class and box FCs; FasterRCNN-OBB's, and Gliding Vertex's with its
    glide and ratio FCs; ReDet's two stages (stage 2 on the refined
    RoIs)."""
    head = model.bbox_head
    if is_hbb_rcnn(model):
        x = head._shared_forward(feats, rois, valid)
        outs = [fc(x) for fc in (head.fc_cls, head.fc_reg, getattr(head, "fc_fix", None),
                                 getattr(head, "fc_ratio", None)) if fc is not None]
    elif not is_redet(model):
        outs = head._forward_rois(feats, rois, valid)
    else:
        stage1 = head._stage1_forward(feats, rois, valid)
        refined = head._refine(rois, stage1[1])
        outs = (*stage1, refined, *head._stage2_forward(feats, refined, valid))
    return torch.cat([o.float().flatten().cpu() for o in outs])


def decisive_rois(ov, gt_mask):
    """(B, N) mask of the candidates whose RoI assignment no change below
    1e-5 of an IoU can flip: the max IoU off 0.5, and no second gt within
    1e-5 of a positive's best."""
    ov = ov.masked_fill(~gt_mask[..., None], float("-inf"))
    top2 = ov.topk(2, dim=1).values
    mo = top2[:, 0]
    return ((mo - 0.5).abs() >= 1e-5) & ~((mo >= 0.5 - 1e-5) & (top2[:, 0] - top2[:, 1] < 1e-5))


def redet_stage2_candidates(model, x, t):
    """ReDet's stage-2 candidates of a real forward of `model` on the
    normalized batch x: each image's gts prepended to its 512 refined
    RoIs (the stage-1 sample of the RPN's proposals, decoded by its own
    stage-1 deltas), with the gt masks and the stage-1 validity."""
    _, valid, refined = redet_stage1(
        model, x, t, generator=torch.Generator(device="cuda").manual_seed(0))
    return (torch.cat([t["gt_bboxes"], refined], 1).contiguous(),
            torch.cat([t["gt_mask"], valid], 1))


def check_assign_roi_kernel(rik, model, cfg, edge_cases=True):
    """The fused assigner on the RoI route, per-image candidates with
    per-image masks and no low-quality match: the edge cases of the CPU
    tests in the RoI head's form (with and without the low-quality
    match, if `edge_cases`), then the train step's shape on a real
    forward of `model` at 1024²: each image's 512 gt slots (64 real)
    prepended to the 2000 proposals of Oriented R-CNN's RPN (4, 512,
    2512), or to the 512 refined RoIs of ReDet's stage 1 (4, 512, 1024),
    with their masks. Each identical to K1's matrix on the same candidates plus
    the PyTorch assigner (max_overlaps to the bit), and gt_inds and labels
    equal to the CPU plain version's (on the decisive candidates at the
    train shape). Timed against the unfused route in turns. Returns its
    entry of the kernels line (launches filled in later)."""
    from jdet_torch.models.boxes.assigner import assign_wrt_overlaps, max_iou_assign_rotated
    from jdet_torch.ops import box_iou_rotated
    from jdet_torch.parallel import make_device_normalizer
    from jdet_torch.utils.edge_cases import ASSIGN_CASES, ROI_ASSIGN_CASES, roi_assign_edge_case

    def assign(gts, mask, labels, cand, cm, thr=ROI_THR):
        return max_iou_assign_rotated(cand, gts, mask, labels, anchor_mask=cm, **thr)

    def unfused(gts, mask, labels, cand, cm, thr=ROI_THR):
        ov = rik.box_iou_rotated_rect(rik.park_masked_boxes(gts, mask), cand)
        return assign_wrt_overlaps(ov, mask, labels, anchor_mask=cm, **thr)

    def plain(gts, mask, labels, cand, cm, thr=ROI_THR, iou_chunk=512):
        ov = box_iou_rotated(rik.park_masked_boxes(gts, mask), cand, chunk=iou_chunk, impl="xla")
        return assign_wrt_overlaps(ov, mask, labels, anchor_mask=cm, **thr)

    def identical(fused, want, what):
        for k in fused:
            check(fused[k].dtype == want[k].dtype and torch.equal(fused[k], want[k]),
                  f"RoI fused assigner, {what}: {k} differs from K1's matrix + "
                  "the PyTorch assigner")

    err = 0.0
    for name in (ASSIGN_CASES + ROI_ASSIGN_CASES) if edge_cases else ():
        for lq in (False, True):
            thr = dict(ROI_THR, match_low_quality=lq)
            args = [torch.as_tensor(x, device="cuda") for x in roi_assign_edge_case(name)]
            before = rik.ASSIGN_PER_IMAGE_LAUNCHES, rik.ASSIGN_PER_IMAGE_MASK_LAUNCHES
            fused = assign(*args, thr=thr)
            check((rik.ASSIGN_PER_IMAGE_LAUNCHES, rik.ASSIGN_PER_IMAGE_MASK_LAUNCHES)
                  == (before[0] + 1, before[1] + 1),
                  f"{name}: not one per-image launch on per-image masks")
            identical(fused, unfused(*args, thr=thr), f"{name}, low quality {lq}")
            cpu = plain(*(x.cpu() for x in args), thr=thr)
            for k in ("gt_inds", "labels"):
                check(torch.equal(fused[k].cpu(), cpu[k]), f"{name}: {k} differs from the CPU")
            mo, mo_cpu = fused["max_overlaps"].cpu(), cpu["max_overlaps"]
            check(torch.equal(torch.isfinite(mo), torch.isfinite(mo_cpu)), f"{name}: -inf slots")
            fin = torch.isfinite(mo_cpu)
            e = (mo[fin] - mo_cpu[fin]).abs().max().item()
            err = max(err, e)
            log(f"RoI fused assigner, {name}, match_low_quality={lq}: identical to the "
                f"unfused route and to the CPU's gt_inds and labels (max_overlaps err "
                f"{e:.2e}); positives per image {(fused['gt_inds'] > 0).sum(1).tolist()}, "
                f"ignored {(fused['gt_inds'] < 0).sum(1).tolist()}")
    check(err <= 2e-4, f"RoI edge cases: max_overlaps off the CPU by {err}")

    # the train step's shape on the candidates of a real forward
    images, t = to_device(*synth_batch(4, 1024, K=512, real=64, seed=3, uint8=True), "cuda")
    x = make_device_normalizer(**cfg["device_normalize"])(images)
    gts, mask, labels = t["gt_bboxes"], t["gt_mask"], t["gt_labels"]
    if is_redet(model):
        cand, cm = redet_stage2_candidates(model, x, t)
    else:
        props = proposals_of(model, x)
        cand = torch.cat([gts, props["boxes"]], 1).contiguous()
        cm = torch.cat([mask, props["valid"]], 1)
    B, K, N = gts.shape[0], gts.shape[1], cand.shape[1]
    n_want = 512 + (512 if is_redet(model) else 2000)
    check(N == n_want, f"expected {n_want} candidates per image, got {N}")
    fused = assign(gts, mask, labels, cand, cm)
    identical(fused, unfused(gts, mask, labels, cand, cm), f"({B}, {K}, {N})")
    real = int(mask.sum(1).max())
    sub = [x[:, :real].contiguous() for x in (gts, mask, labels)]
    t0 = time.perf_counter()
    cpu = plain(*(x.cpu() for x in sub), cand.cpu(), cm.cpu())
    cpu_s = time.perf_counter() - t0
    fused_sub = assign(*sub, cand, cm)
    ok = decisive_rois(rik.box_iou_rotated_rect(sub[0], cand), sub[1]).cpu()
    agree = {k: int((fused_sub[k].cpu()[ok] != cpu[k][ok]).sum()) for k in ("gt_inds", "labels")}
    fin = torch.isfinite(cpu["max_overlaps"])
    e = (fused_sub["max_overlaps"].cpu()[fin] - cpu["max_overlaps"][fin]).abs().max().item()
    log(f"RoI fused assigner ({B}, {K}, {N}) on {type(model).__name__}'s per-image "
        f"candidates, {real} real gts, "
        f"{int(cm.sum())} unmasked candidates: identical to the unfused route; vs the CPU "
        f"plain version ({cpu_s:.1f} s): max_overlaps err {e:.2e}, {int(ok.sum())} of "
        f"{ok.numel()} candidates decisive, disagreements there {agree}, positives "
        f"{(fused['gt_inds'] > 0).sum(1).tolist()}")
    check(e <= 2e-4 and ok.float().mean() > 0.99 and not any(agree.values()),
          "train shape: the RoI fused assigner is off the CPU plain version")
    err = max(err, e)

    old_ms, ms, turns = in_turns(lambda: unfused(gts, mask, labels, cand, cm),
                                 lambda: assign(gts, mask, labels, cand, cm))
    plain_ms = median_ms(lambda: plain(gts, mask, labels, cand, cm, iou_chunk=128),
                         warmup=1, iters=5)
    kernels, device_ms, _ = device_profile(lambda: assign(gts, mask, labels, cand, cm),
                                           expect=ASSIGN_KERNELS)
    b2b_ms = back_to_back_ms(lambda: assign(gts, mask, labels, cand, cm))
    log(f"RoI fused assigner under the profiler, device ms per call: {kernels} "
        f"(sum {device_ms:.4f}); {b2b_ms:.4f} ms per call back to back")
    # gts, their masks and labels; the per-image candidates and their
    # per-image mask; gt_inds, labels (int64) and max_overlaps (float32)
    nbytes = B * K * (5 * 4 + 1 + 8) + B * N * (5 * 4 + 1) + B * N * (8 + 4 + 8)
    touching = touching_pairs(gts, cand, mask)
    bound_ms, bound_by = bound(nbytes, IOU_FLOPS_PER_TOUCHING_PAIR * touching)
    log(f"RoI fused assigner ({B}, {K}, {N}), in turns old/new/new/old {turns}: unfused "
        f"route {old_ms:.4f} ms, fused {ms:.4f} ms, plain version {plain_ms:.4f} ms; bound "
        f"{bound_ms:.5f} ms by {bound_by} (bytes {nbytes}, {touching} touching pairs x "
        f"{IOU_FLOPS_PER_TOUCHING_PAIR} flops)")
    return {
        "name": "max_iou_assign_rect_per_image_masked",
        "route": "cuda",
        "source": "jdet_torch/csrc/rotated_iou.cu",
        "replaces": "jdet_tpu/ops/pallas_iou.py:148",
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": [B, K, N],
        "model": type(model).__name__,
        "device_ms": device_ms,
        "device_ms_by_kernel": kernels,
        "back_to_back_ms": b2b_ms,
        "old_route_ms": old_ms,
    }


def as_sets(got, want, rel=0.0, matched_scores=False):
    """Two detection dicts (CPU tensors) as sets: the share of `got`'s
    valid boxes within 1e-2 px (plus `rel` of their larger side) of one
    of `want`'s, the valid counts, and the largest difference of the
    sorted valid scores over the shorter list, or (`matched_scores`) of
    the scores of each matched box and its nearest box in `want`."""
    gb, wb = got["boxes"][got["valid"]], want["boxes"][want["valid"]]
    dist = torch.cdist(gb[:, :4].double(), wb[:, :4].double(), p=float("inf"))
    near, nearest = dist.min(1)
    side = (gb[:, 2:4] - gb[:, :2]).abs().amax(1) if gb.shape[1] == 4 else gb[:, 2:4].amax(1)
    matched = near <= 1e-2 + rel * side.double()
    if matched_scores:
        score_err = (got["scores"][got["valid"]][matched]
                     - want["scores"][want["valid"]][nearest[matched]]).abs().max().item()
    else:
        gs = got["scores"][got["valid"]].sort(descending=True).values
        ws = want["scores"][want["valid"]].sort(descending=True).values
        n = min(len(gs), len(ws))
        score_err = (gs[:n] - ws[:n]).abs().max().item()
    return matched.double().mean().item(), (len(gb), len(wb)), score_err


def check_rcnn_card_against_cpu(cfg, rik, grads=False, bf16=True):
    """The full-width Oriented R-CNN or ReDet with the same random weights
    on the card and on the CPU, B=1 at 512², on a batch without near ties
    in any assignment, the samplers fed the same draws (`Draws`): the
    network outputs, the proposals, the losses and `predict`, then 2
    train steps (with `grads`, instead, the gradients of the loss forward
    from the one state, held to `GRAD_LIMITS`: an Adam step divides each
    gradient by its own size, so a gradient near 0 takes a full step in
    either direction and two devices' steps are not comparable); and, with
    `bf16` (one config per head family takes it), the model under the
    bf16 policy within this run's f32 - bf16 gap. The RPN's class conv is
    drawn with std 0.05 (0.01 at init), and the proposals are compared as sets: each card box within
    1e-2 px of one of the CPU's, the sorted scores within 1e-4. Scores a
    few ulps apart still trade places between the devices, and a
    proposal's place decides which sampler draw it takes, so past the
    RPN the card takes the CPU's proposals (recorded call by call): the
    losses, `predict` and the train steps then compare one to one.
    `predict`'s detections are compared as sets too: its NMS at IoU 0.1
    over 2000 overlapping RoIs chains each suppression to the next.

    ReDet: the card also takes the CPU's refined RoIs (stage 1 to stage
    2, recorded the same way). Its float32 RPN outputs sit ~5e-5 of their
    largest value from a float64-policy run on either device (16
    bottlenecks of C8 convs), and a train step from weights that differ
    that little moves them apart by up to half of a parameter's change.
    So each of its 2 train steps starts from the same state on both
    devices: after step 1 the card takes the CPU's parameters and
    momentum, and each step's change is held to fixed limits
    (`REDET_STEP_LIMITS`)."""
    from jdet_torch.models.builder import build_detector
    from jdet_torch.models.nn import compute_dtype_scope
    from jdet_torch.parallel import make_device_normalizer
    from jdet_torch.utils.general import parse_losses

    normalize = make_device_normalizer(**cfg["device_normalize"])
    # each CPU model before the models it feeds its proposals to
    runs = {"f32_cpu": ("cpu", None), "f32_card": ("cuda", None)}
    if bf16:
        runs.update(bf16_cpu=("cpu", torch.bfloat16), bf16_card=("cuda", torch.bfloat16))
    redet = cfg["model"]["type"] == "ReDet"
    recorders = ("f32_cpu", "bf16_cpu")
    models = {}
    for name, (dev, dtype) in runs.items():
        with compute_dtype_scope(dtype):
            models[name] = build_detector(cfg["model"], device=dev, seed=1, load_pretrained=False)
    randomize_constants(models["f32_cpu"])
    w = models["f32_cpu"].rpn_head.rpn_cls.weight
    with torch.no_grad():
        w.copy_(torch.as_tensor(np.random.RandomState(6).normal(0.0, 0.05, tuple(w.shape))))
        # Gliding's glide and ratio FCs at std 0.05 (0.001 at init): every
        # glide near 0.5 makes every quad a rhombus, whose equal edges tie
        # in `poly_to_rbox`
        head = models["f32_cpu"].bbox_head
        for i, name in enumerate(("fc_fix", "fc_ratio")):
            fc = getattr(head, name, None)
            if fc is not None:
                fc.weight.copy_(torch.as_tensor(np.random.RandomState(8 + i).normal(
                    0.0, 0.05, tuple(fc.weight.shape))))
    if is_redet(models["f32_cpu"]):
        images, _ = synth_batch(1, 512, seed=4, uint8=True)
        calibrate_inner_norms(models["f32_cpu"], normalize(torch.as_tensor(images)))
    for name in runs:
        models[name].load_state_dict(models["f32_cpu"].state_dict())
    start = {n: p.detach().clone() for n, p in models["f32_cpu"].named_parameters()}

    margin_of = (redet_margin if is_redet(models["f32_cpu"]) else
                 hbb_rcnn_margin if is_hbb_rcnn(models["f32_cpu"]) else orcnn_margin)
    family = f'{type(models["f32_cpu"]).__name__} on {type(models["f32_cpu"].backbone).__name__}'

    def margin(seed):
        images, targets = synth_batch(1, 512, seed=seed, uint8=True)
        return margin_of(models["f32_cpu"], targets, normalize(torch.as_tensor(images)))

    seed = next(s for s in range(5, 100) if margin(s) > 1e-5)
    images, targets = synth_batch(1, 512, seed=seed, uint8=True)
    out = {}
    t0 = time.perf_counter()
    rois = None
    recorded = {None: [], torch.bfloat16: []}
    refined = {None: [], torch.bfloat16: []}
    nms_inputs = {None: [], torch.bfloat16: []}
    hbb = is_hbb_rcnn(models["f32_cpu"])
    for name, m in models.items():
        dev, dtype = runs[name]
        key = torch.bfloat16 if dtype is torch.bfloat16 else None
        x, t = to_device(images, targets, dev)
        x = normalize(x)
        launches = launch_counts(rik)
        props = proposals_of(m, x)
        own = m.rpn_head.get_proposals
        if name in recorders:
            m.rpn_head.get_proposals = lambda outs, own=own, log=recorded[key]: (
                log.append(own(outs)) or log[-1])
        else:
            m.rpn_head.get_proposals = lambda outs, log=iter(recorded[key]), dev=dev: {
                k: v.to(dev) for k, v in next(log).items()}
        if redet:
            own = m.bbox_head._refine
            if name in recorders:
                m.bbox_head._refine = lambda rois, reg, own=own, log=refined[key]: (
                    log.append(own(rois, reg)) or log[-1])
            else:
                m.bbox_head._refine = lambda rois, reg, log=iter(refined[key]), dev=dev: (
                    next(log).to(dev))
        if hbb:
            # FasterRCNN-OBB's and Gliding's ~300-1,500 untrained
            # detections, scores near 1/16, chain through the final NMS at
            # IoU 0.1, where boxes that differ by ~3e-6 of their scale
            # between the devices can flip a link (Gliding's pass through
            # `poly_to_rbox` of glided quads): the card's NMS (K1's matrix
            # route) takes the CPU's boxes and scores
            own = m.bbox_head._final_nms
            if name in recorders:
                m.bbox_head._final_nms = lambda b, s, t=None, own=own, log=nms_inputs[key]: (
                    log.append((b, s)) or own(b, s, t))
            else:
                m.bbox_head._final_nms = lambda b, s, t=None, own=own, log=nms_inputs[key], \
                    dev=dev: own(*(x.to(dev) for x in log.pop(0)), t)
        if rois is None:
            rois = (props["boxes"].cpu(), props["valid"].cpu())
        with torch.no_grad():
            feats = m.extract_feat(x)
            rpn = torch.cat([o.float().flatten().cpu() for lvl in m.rpn_head(feats) for o in lvl])
            head = roi_head_outputs(m, feats, rois[0].to(dev), rois[1].to(dev))
        m.train()
        loss_out = type(m).loss(m, x, t, rand=Draws(7, dev))
        losses = {k: v.item() for k, v in loss_out.items()}
        grad = None
        if grads:
            m.zero_grad(set_to_none=True)
            parse_losses(loss_out)[0].backward()
            grad = {n: p.grad.detach().cpu().clone() for n, p in m.named_parameters()
                    if p.grad is not None}
            m.zero_grad(set_to_none=True)
        del loss_out
        m.eval()
        det = {k: v.cpu() for k, v in m.predict(x).items()}
        step, opt = build_trainer(cfg, m, augment=False)[:2]
        replay_draws(m, 100, dev)
        steps, after = [], []
        for it in range(0 if grads else 2):
            steps.append({k: v.item()
                          for k, v in step(*to_device(images, targets, dev), it).items()})
            after.append({n: p.detach().cpu().clone() for n, p in m.named_parameters()
                          if p.requires_grad})
            if redet and it == 0:
                if name == "f32_cpu":
                    cpu_state = sgd_state(m, opt)
                elif name == "f32_card":
                    load_sgd_state(m, opt, cpu_state)
        out[name] = dict(props={k: v.cpu() for k, v in props.items()}, rpn=rpn, head=head,
                         losses=losses, det=det, steps=steps, after=after,
                         params=after[-1] if after else None, grads=grad)
        if dev == "cuda":
            got = {k: v - launches[k] for k, v in launch_counts(rik).items()}
            n_losses = 1 if grads else 3
            want = {"rotated_iou_rect": 1, "rotated_iou_generic": 0,
                    **{k: n * n_losses for k, n in fused_per_loss(m).items()}}
            check(got == want,
                  f"{family} {name}: not {fused_per_loss(m)} fused launches per loss forward "
                  f"and train step and 1 K1 matrix launch per predict: {got}")
        log(f"{family} card vs cpu at 512², B=1: {name} done at "
            f"{time.perf_counter() - t0:.1f} s: losses {losses}, steps {steps}, valid "
            f"proposals {int(props['valid'].sum())}, detections {int(det['valid'].sum())}")

    # ReDet's boxes: 1e-2 px plus 1e-3 of the box's larger side (its RPN
    # outputs carry float32's ~5e-5 on either device)
    rel = 1e-3 if redet else 0.0
    card, cpu = out["f32_card"], out["f32_cpu"]
    same_slots = (torch.equal(card["props"]["valid"], cpu["props"]["valid"])
                  and (card["props"]["boxes"] - cpu["props"]["boxes"]).abs().max().item() <= 1e-2)
    # FasterRCNN-OBB's and Gliding's hbb RPNs keep up to 2000 of ~7,000
    # candidates at 512²: a candidate whose score or IoU sits within the
    # devices' ~1e-6 of the top-k cut or the NMS threshold trades places
    # with its neighbour on some seeds (1 of 2000 on the first card run),
    # which shifts the sorted scores past it; their scores are held box by
    # box on the matched boxes instead
    props_match = as_sets(card["props"], cpu["props"], rel, matched_scores=hbb)
    det_match = as_sets(card["det"], cpu["det"], rel)
    # max abs error over the largest magnitude
    errs = {k: ((card[k] - cpu[k]).abs().max() / cpu[k].abs().max()).item()
            for k in ("rpn", "head")}
    # ReDet's RPN outputs: 2e-4, ~3x the 7.0e-5 of PERF.md §6
    bounds = {"rpn": 2e-4 if redet else 1e-5, "head": 1e-5}
    log(f"{family} card vs cpu at 512², B=1, batch seed {seed}: RPN and RoI head "
        f"outputs' max error over their largest value {json.dumps(errs)}; proposals slot for "
        f"slot {same_slots}, as sets (share matched, counts, score err: "
        f"{'of matched boxes' if hbb else 'sorted'}) {props_match}; "
        f"detections as sets {det_match}")
    check(all(errs[k] <= bounds[k] for k in errs), f"network outputs differ: {errs}")
    for what, (share, (n_got, n_want), score_err) in (("proposals", props_match),
                                                      ("detections", det_match)):
        check(n_want > 0 and share >= 0.999 and n_got == n_want and score_err <= 1e-4,
              f"{what} differ: {share}, {n_got} vs {n_want}, {score_err}")
    # each loss within 1e-4 of the CPU's (1e-3 in the train steps)
    pairs = [(f"{k}", cpu["losses"][k], card["losses"][k], 1e-4) for k in cpu["losses"]]
    pairs += [(f"step {it} {k}", cpu["steps"][it][k], card["steps"][it][k], 1e-3)
              for it in range(len(cpu["steps"])) for k in cpu["steps"][it]]
    for what, want, got, tol in pairs:
        check(abs(got - want) <= tol * abs(want),
              f"{what}: card {got} cpu {want} (bound {tol * abs(want)})")
    # each trainable tensor after the steps, and its change in them (far
    # below its values): the largest error over the CPU's largest value,
    # within 1e-3 for the values and 5e-2 for the changes (a change of 0
    # exactly), and the changes' RMS error over the CPU change's RMS within
    # 2e-2. The card's float32 convolutions (cuDNN's, FFT algorithms among
    # them) put a backbone tensor's change up to ~1.5% of its largest
    # value and ~0.8% of its RMS off the CPU's. Oriented R-CNN: after the 2
    # steps, from the same start. ReDet: each step from the same state, to
    # REDET_STEP_LIMITS.
    def param_errs(got_params, want_params, was_params):
        """Per trainable tensor, the error of `got_params` against
        `want_params`: of the values and of the changes from
        `was_params` over the wanted largest, of the changes' RMS over
        the wanted RMS."""
        worst = {"value": {}, "change": {}, "change_rms": {}}
        for n, want in want_params.items():
            got, was = got_params[n], was_params[n]
            for what, g, w, norm in (("value", got, want, torch.amax),
                                     ("change", got - was, want - was, torch.amax),
                                     ("change_rms", got - was, want - was,
                                      torch.linalg.vector_norm)):
                scale = norm(w.abs()).item()
                worst[what][n] = norm((g - w).abs()).item() / scale if scale else (
                    0.0 if torch.equal(g, w) else float("inf"))
        return worst

    if grads:
        held = []
        worst = {"grad": {}, "grad_rms": {}}
        for n, want in cpu["grads"].items():
            got = card["grads"][n]
            for what, norm in (("grad", torch.amax), ("grad_rms", torch.linalg.vector_norm)):
                scale = norm(want.abs()).item()
                worst[what][n] = norm((got - want).abs()).item() / scale if scale else (
                    0.0 if torch.equal(got, want) else float("inf"))
        top = {what: max(errs.items(), key=lambda kv: kv[1]) for what, errs in worst.items()}
        median = {what: float(np.median(list(errs.values()))) for what, errs in worst.items()}
        log(f"{family} gradients card vs cpu from one state: {len(worst['grad'])} tensors; "
            f"error over the CPU's gradient, largest and RMS: worst {top}, median "
            f"{json.dumps(median)}")
        check(set(card["grads"]) == set(cpu["grads"]) and len(cpu["grads"]) > 100,
              "the card and the CPU have gradients for different parameters")
        for what, tol in GRAD_LIMITS.items():
            bad = {n: e for n, e in worst[what].items() if not e <= tol}
            check(not bad, f"{family} gradient {what} off the CPU's by more than {tol}: {bad}")
    elif redet:
        held = [("step 1", card["after"][0], cpu["after"][0], start, REDET_STEP_LIMITS),
                ("step 2", card["after"][1], cpu["after"][1], cpu["after"][0],
                 REDET_STEP_LIMITS)]
    else:
        held = [("after 2 steps", card["params"], cpu["params"], start,
                 {"value": 1e-3, "change": 5e-2, "change_rms": 2e-2})]
    for when, got_params, want_params, was_params, limits in held:
        worst = param_errs(got_params, want_params, was_params)
        top = {what: max(errs.items(), key=lambda kv: kv[1]) for what, errs in worst.items()}
        median = {what: float(np.median(list(errs.values()))) for what, errs in worst.items()}
        log(f"{family} train card vs cpu, {when}: {len(want_params)} trainable parameters; "
            f"error over the CPU's, of the values, of the changes and of the changes' RMS: "
            f"worst {top}, median {json.dumps(median)}")
        for what, tol in limits.items():
            bad = {n: e for n, e in worst[what].items() if not e <= tol}
            check(not bad, f"parameter {what} {when} off the CPU's by more than {tol}: {bad}")

    if not bf16:
        return

    def rms(a):
        return float(torch.sqrt(torch.mean(torch.as_tensor(a, dtype=torch.float64) ** 2)))

    def losses(o):
        return torch.tensor(list(o["losses"].values())
                            + [v for lv in o["steps"] for v in lv.values()], dtype=torch.float64)

    def change(o):
        if grads:
            return torch.cat([o["grads"][n].flatten() for n in sorted(cpu["grads"])])
        return torch.cat([(p - start[n]).flatten() for n, p in o["params"].items()])

    bc, bp, f = out["bf16_card"], out["bf16_cpu"], out["f32_card"]
    rows = [("the losses" + ("" if grads else " of the loss forward and of 2 train steps"),
             losses(bc) - losses(bp), losses(f) - losses(bp)),
            ("the RPN's outputs", bc["rpn"] - bp["rpn"], f["rpn"] - bp["rpn"]),
            ("the RoI head's outputs", bc["head"] - bp["head"], f["head"] - bp["head"]),
            ("the gradients" if grads else "the 2 steps' parameter change",
             change(bc) - change(bp), change(f) - change(bp))]
    fractions = {what: rms(e) / rms(gap) for what, e, gap in rows}
    log(f"{family} bf16 card vs cpu: |card - cpu| over the f32 - bf16 gap: "
        + json.dumps(fractions))
    for what, frac in fractions.items():
        check(frac <= BF16_GAP_FACTOR,
              f"bf16 card vs cpu, {what}: {frac:.3f} of the f32 - bf16 gap apart")


def rcnn_serving_phase(model, rik, label, brief=False):
    """A two-stage model's serving path at B=2, 1024², once, with the launch
    counts read around it: the loss forward, `predict` at the config's
    test_cfg and with score_thr=0.0; then each phase and its parts timed.
    The predicts run with the expanded weights of the C8 convs cached, as
    the Runner's inference runs them (`cache_expanded_weights`; none in
    Oriented R-CNN), the loss forward without. Returns the launches."""
    from jdet_torch.models.equivariant import cache_expanded_weights

    head = model.bbox_head
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

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(rik)
    losses = loss_fwd()
    torch.cuda.synchronize()
    loss_launches = launch_counts(rik)
    cached = cache_expanded_weights(model)
    det = predict(test_cfg["score_thr"])
    det0 = predict(0.0)
    torch.cuda.synchronize()
    launches = launch_counts(rik)
    peak = torch.cuda.max_memory_allocated()
    label = f"{label} {type(model).__name__}"
    log(f"{label} serving path: launches {launches} (loss forward {loss_launches}), "
        f"peak memory {peak} bytes, {cached} expansions cached for predict")
    check(loss_launches == {"rotated_iou_rect": 0, "rotated_iou_generic": 0,
                            **fused_per_loss(model)},
          f"not {fused_per_loss(model)} fused assigner launches in the loss forward: "
          f"{loss_launches}")
    check(launches["rotated_iou_rect"] == 2 and launches["rotated_iou_generic"] == 0,
          f"not one K1 matrix launch per predict: {launches}")
    lv = {k: v.item() for k, v in losses.items()}
    log(f"{label} losses at 1024², B=2: {lv}")
    check(all(np.isfinite(v) for v in lv.values()) and all(v > 0 for v in lv.values()),
          f"non-finite or non-positive loss: {lv}")
    for name, d in (("predict", det), ("predict score_thr=0", det0)):
        shapes = {k: tuple(v.shape) for k, v in d.items()}
        log(f"{label} {name}: {shapes}, valid per image {d['valid'].sum(1).tolist()}")
        check(shapes["boxes"] == (2, 2000, 5) and shapes["polys"] == (2, 2000, 8),
              f"{name}: shapes {shapes}")
        check(all(torch.isfinite(d[k]).all().item() for k in ("boxes", "polys", "scores")),
              f"{name}: non-finite detections")
    v = det0["valid"]
    check(v.sum().item() > 0 and (det0["boxes"][v][:, 2:4] > 0).all().item()
          and ((det0["labels"][v] >= 0) & (det0["labels"][v] < 15)).all().item(),
          "no valid detections at score_thr=0.0, or bad ones")

    with torch.no_grad():
        feats = model.extract_feat(images)
        outs = model.rpn_head(feats)
        props = model.rpn_head.get_proposals(outs)
    # an untrained RPN proposes boxes near its anchors, of which neighbours
    # 4 px apart overlap at IoU ~0.78: Gliding's NMS at 0.7 over all
    # levels keeps fewer of them than one at 0.8 per level
    least = 200 if model.rpn_head.cross_level_nms else 1000
    check(props["valid"].sum(1).min().item() > least,
          f"fewer than {least} proposals per image: {props['valid'].sum(1).tolist()}")
    cand = nms_candidates()
    thr = test_cfg["score_thr"]
    times = {}
    with torch.no_grad():
        for name, fn in (
            ("predict_ms", lambda: predict(thr)),
            ("predict_score_thr0_ms", lambda: predict(0.0)),
            ("network_forward_no_grad_ms", lambda: model.rpn_head(model.extract_feat(images))),
            ("proposals_ms", lambda: model.rpn_head.get_proposals(outs)),
            ("roi_head_predict_ms", lambda: head.predict(feats, props)),
            ("nms_class_iou_ms", lambda: rik.box_iou_rotated_rect(cand, cand)),
        ):
            times[name] = median_ms(fn, *timing(brief))
    cache_expanded_weights(model, enable=False)
    times["loss_forward_ms"] = median_ms(loss_fwd, *timing(brief))
    log(f"{label} phases at 1024², B=2 (median of {timing(brief)[1]}): {json.dumps(times)}")
    head.test_cfg = test_cfg
    return launches


def orcnn_step_parts(cfg, model, label):
    """The parts of Oriented R-CNN's train step at its traffic (B=4, 1024²,
    512 gt slots, 64 real), each timed alone on the step's tensors: the
    RPN's hbb assignment (and its peak memory), its targets with the
    sampler and its losses, the proposals (decode, per-level NMS), the
    RoI sampling (the fused assigner and the sampler), the RoI align
    forward and forward + backward, and the FCs forward + backward."""
    from jdet_torch.models.boxes.anchor_target import anchor_target_batch
    from jdet_torch.models.boxes.assigner import max_iou_assign_hbb
    from jdet_torch.ops import rbox_to_hbox
    from jdet_torch.parallel import make_device_normalizer

    normalize = make_device_normalizer(**cfg["device_normalize"])
    images, t = to_device(*synth_batch(4, 1024, K=512, real=64, seed=3, uint8=True), "cuda")
    x = normalize(images)
    rpn, head = model.rpn_head, model.bbox_head
    model.train()
    with torch.no_grad():
        feats = model.extract_feat(x)
        outs = rpn(feats)
        props = rpn.get_proposals(outs)
    t = dict(t, gt_hboxes=rbox_to_hbox(t["gt_bboxes"]))
    anchors = torch.cat(rpn._level_anchors(outs))
    valid = torch.ones(anchors.shape[0], dtype=torch.bool, device="cuda")
    acfg = rpn.train_cfg["assigner"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        rois, rvalid, *_ = head._sample_rois(props["boxes"], props["valid"], t["gt_bboxes"],
                                             t["gt_mask"], t["gt_labels"], generator=gen)
    leaf = [f.detach().requires_grad_() for f in feats[:4]]
    cot = torch.randn(4, rois.shape[1], 7, 7, feats[0].shape[1], device="cuda",
                      dtype=feats[0].dtype)

    def align_fwd_bwd():
        out = head.roi_extractor(leaf, rois, rvalid)
        torch.autograd.grad(out, leaf, cot)

    with torch.no_grad():
        aligned = head.roi_extractor(feats, rois, rvalid).reshape(4, rois.shape[1], -1)
    aligned.requires_grad_()

    def fcs_fwd_bwd():
        y = aligned
        for fc in head.shared_fcs:
            y = torch.relu(fc(y))
        (head.fc_cls(y).float().sum() + head.fc_reg(y).float().sum()).backward()

    def hbb_assign():
        return max_iou_assign_hbb(anchors, t["gt_hboxes"], t["gt_mask"], t["gt_mask"].long(),
                                  anchor_mask=valid, **acfg)

    with torch.no_grad():
        times = {
            "rpn_hbb_assign_ms": median_ms(hbb_assign, warmup=2, iters=10),
            "rpn_hbb_assign_peak_bytes": peak_bytes(hbb_assign),
            "rpn_targets_ms": median_ms(lambda: anchor_target_batch(
                anchors, valid, t["gt_hboxes"], t["gt_mask"], t["gt_mask"].long(),
                assigner_cfg=acfg, sampler_cfg=rpn.train_cfg["sampler"], rotated=False,
                reg_decoded_bbox=True, generator=gen), warmup=2, iters=10),
            "rpn_targets_and_losses_ms": median_ms(lambda: rpn.loss(outs, t, generator=gen),
                                                   warmup=2, iters=10),
            "proposals_ms": median_ms(lambda: rpn.get_proposals(outs), warmup=2, iters=10),
            "roi_sampling_ms": median_ms(lambda: head._sample_rois(
                props["boxes"], props["valid"], t["gt_bboxes"], t["gt_mask"],
                t["gt_labels"], generator=gen), warmup=2, iters=10),
            "roi_align_forward_ms": median_ms(lambda: head.roi_extractor(feats, rois, rvalid),
                                              warmup=2, iters=10),
        }
    times["roi_align_forward_backward_ms"] = median_ms(align_fwd_bwd, warmup=2, iters=10)
    times["fcs_forward_backward_ms"] = median_ms(fcs_fwd_bwd, warmup=2, iters=10)
    model.zero_grad(set_to_none=True)
    log(f"{label} Oriented R-CNN step parts at 1024², B=4, K=512 (64 real), "
        f"{int(rvalid.sum())} sampled RoIs: {json.dumps(times)}")
    return times


def redet_step_parts(cfg, model, label):
    """The parts of ReDet's train step at its traffic (B=4, 1024², 512 gt
    slots, 64 real), each timed alone on the step's tensors: the weight
    expansions of the trainable C8 convs (forward, and forward +
    backward; the frozen stem's and layer1's stay cached), stage 1's
    sampling (the hbb assigner and the sampler), stage 2's (the fused
    assigner and the sampler), RiRoIAlign forward and forward + backward,
    and both stages' FCs forward + backward."""
    from jdet_torch.models.equivariant.econv import REConv2d, REConv2dLift
    from jdet_torch.ops import rbox_to_hbox
    from jdet_torch.parallel import make_device_normalizer

    normalize = make_device_normalizer(**cfg["device_normalize"])
    images, t = to_device(*synth_batch(4, 1024, K=512, real=64, seed=3, uint8=True), "cuda")
    x = normalize(images)
    rpn, head = model.rpn_head, model.bbox_head
    model.train()
    with torch.no_grad():
        feats = model.extract_feat(x)
        props = rpn.get_proposals(rpn(feats))
    gt_h = rbox_to_hbox(t["gt_bboxes"])
    gen = torch.Generator(device="cuda").manual_seed(0)

    def stage1_sampling():
        return head._sample_rois(props["boxes"], props["valid"], gt_h, t["gt_mask"],
                                 t["gt_labels"], generator=gen, gt_reg=t["gt_bboxes"])

    with torch.no_grad():
        rois, valid, *_ = stage1_sampling()
        refined = head._refine(rois, head._stage1_forward(feats, rois, valid)[1])

    def stage2_sampling():
        return head._sample_rois(refined, valid, t["gt_bboxes"], t["gt_mask"], t["gt_labels"],
                                 generator=gen, rotated=True, encode=head._encode2)

    with torch.no_grad():
        rois2, valid2, *_ = stage2_sampling()
    S = rois2.shape[1]
    leaf = [f.detach().requires_grad_() for f in feats[:4]]
    cot = torch.randn(4, S, 7, 7, feats[0].shape[1], device="cuda", dtype=feats[0].dtype)

    def riroi_fwd_bwd():
        out = head.roi_extractor2(leaf, rois2, valid2)
        torch.autograd.grad(out, leaf, cot)

    convs = [m for m in model.modules() if isinstance(m, (REConv2d, REConv2dLift))
             and m.weight.requires_grad]
    with torch.no_grad():
        w_cot = [torch.ones_like(m._expand()) for m in convs]

    def expansions_fwd_bwd():
        ws = [m._expand() for m in convs]
        torch.autograd.grad(ws, [m.weight for m in convs], w_cot)

    with torch.no_grad():
        aligned = [head.roi_extractor(feats, rois, valid).reshape(4, S, -1),
                   head.roi_extractor2(feats, rois2, valid2).reshape(4, S, -1)]
    for a in aligned:
        a.requires_grad_()

    def fcs_fwd_bwd():
        total = 0.0
        for a, fcs, cls, reg in ((aligned[0], head.shared_fcs, head.fc_cls, head.fc_reg),
                                 (aligned[1], head.shared_fcs2, head.fc_cls2, head.fc_reg2)):
            y = a
            for fc in fcs:
                y = torch.relu(fc(y))
            total = total + cls(y).float().sum() + reg(y).float().sum()
        total.backward()

    with torch.no_grad():
        times = {
            "weight_expansions_forward_ms": median_ms(lambda: [m._expand() for m in convs],
                                                      warmup=2, iters=10),
            "stage1_sampling_ms": median_ms(stage1_sampling, warmup=2, iters=10),
            "stage2_sampling_ms": median_ms(stage2_sampling, warmup=2, iters=10),
            "riroi_align_forward_ms": median_ms(lambda: head.roi_extractor2(feats, rois2, valid2),
                                                warmup=2, iters=10),
        }
    times["weight_expansions_forward_backward_ms"] = median_ms(expansions_fwd_bwd, warmup=2,
                                                               iters=10)
    times["riroi_align_forward_backward_ms"] = median_ms(riroi_fwd_bwd, warmup=2, iters=10)
    times["fcs_forward_backward_ms"] = median_ms(fcs_fwd_bwd, warmup=2, iters=10)
    model.zero_grad(set_to_none=True)
    log(f"{label} ReDet step parts at 1024², B=4, K=512 (64 real), {len(convs)} trainable C8 "
        f"convs, {int(valid.sum())} stage-1 and {int(valid2.sum())} stage-2 sampled RoIs: "
        f"{json.dumps(times)}")
    return times


def train_large_batch(cfg, model, rik, label, B=16, n_steps=5):
    """`n_steps` train steps at B=16 (the reference's bench batch,
    `bench.py:276`), 1024², 512 gt slots with 64 real: each step's time by
    CUDA events, the median of the last n_steps - 1, and the peak memory;
    the fused assigner's launches checked per step."""
    step, _, _, _ = build_trainer(cfg, model)
    images, targets = to_device(*synth_batch(B, 1024, K=512, real=64, seed=4, uint8=True),
                                "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(rik)
    ms, losses = [], []
    for it in range(n_steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        lv = step(images, targets, it)
        ev[1].record()
        ev[1].synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(lv["total_loss"].item())
    launches = launch_counts(rik)
    peak = torch.cuda.max_memory_allocated()
    log(f"{label} {type(model).__name__} train at B={B}, 1024²: step ms {ms} (median of the "
        f"last {n_steps - 1}: {float(np.median(ms[1:])):.2f}), peak memory {peak} bytes, "
        f"total losses {losses}, launches {launches}")
    check(all(np.isfinite(losses)), "non-finite loss at B=16")
    check(launches == {"rotated_iou_rect": 0, "rotated_iou_generic": 0,
                       **{k: n * n_steps for k, n in fused_per_loss(model).items()}},
          f"B={B}: not {fused_per_loss(model)} fused launches per step: {launches}")
    return launches


def redet_phases(rik):
    """ReDet ReResNet50-ReFPN at full width with random weights (its
    InnerBatchNorms' statistics calibrated on a batch): K1's fused route
    on its stage-2 candidates, card against CPU, then its paths in
    float32 and bf16 and its `run_net`. Returns the route's entry of the
    kernels line and the launches of each path."""
    from jdet_torch.config import load_cfg_file
    from jdet_torch.models.builder import build_detector
    from jdet_torch.models.nn import compute_dtype_scope
    from jdet_torch.parallel import make_device_normalizer

    redet_cfg = load_cfg_file(REDET_CONFIG)
    redet = build_detector(redet_cfg["model"], device="cuda", seed=0, load_pretrained=False)
    bb, rpn, head = redet.backbone, redet.rpn_head, redet.bbox_head
    images, _ = to_device(*synth_batch(2, 1024, seed=9, uint8=True), "cuda")
    n_norms = calibrate_inner_norms(
        redet, make_device_normalizer(**redet_cfg["device_normalize"])(images))
    log(f"ReDet: the running statistics of {n_norms} InnerBatchNorms set to a 1024² batch's")
    redet_state = {k: v.detach().clone() for k, v in redet.state_dict().items()}
    del images
    check(is_redet(redet) and bb.depth == 50 and bb.frozen_stages == 1
          and bb.out_channels == [256, 512, 1024, 2048]
          and tuple(bb.conv1.weight.shape) == (8, 3, 7, 7)
          and tuple(redet.neck.lateral_convs[3].weight.shape) == (32, 256, 8, 1, 1)
          and len(redet.neck.extra_convs) == 1 and (rpn.nms_pre, rpn.nms_post) == (2000, 2000)
          and rpn.reg_dim == 4 and tuple(head.shared_fcs[0].weight.shape) == (1024, 12544)
          and tuple(head.shared_fcs2[0].weight.shape) == (1024, 12544)
          and tuple(head.fc_cls2.weight.shape) == (16, 1024)
          and head.train_cfg["sampler"]["num"] == 512,
          "ReDet is not ReResNet50-ReFPN at full width")
    log(f"ReDet model: {sum(p.numel() for p in redet.parameters())} parameters")
    entry = check_assign_roi_kernel(rik, redet, redet_cfg, edge_cases=False)
    elapsed("check_assign_roi_kernel on ReDet")
    check_rcnn_card_against_cpu(redet_cfg, rik)
    elapsed("ReDet check_rcnn_card_against_cpu")
    paths = {"redet_serving": rcnn_serving_phase(redet, rik, "fp32", brief=True),
             "redet_train_5_steps": train_at_config_traffic(redet_cfg, redet, rik, "fp32",
                                                            n_steps=5, brief=True)}
    redet_step_parts(redet_cfg, redet, "fp32")
    elapsed("the ReDet fp32 paths")
    del redet, bb, rpn, head
    torch.cuda.empty_cache()
    with compute_dtype_scope(torch.bfloat16):
        redet_bf16 = build_detector(redet_cfg["model"], device="cuda", seed=0,
                                    load_pretrained=False)
    redet_bf16.load_state_dict(redet_state)
    del redet_state
    paths["redet_bf16_serving"] = rcnn_serving_phase(redet_bf16, rik, "bf16", brief=True)
    paths["redet_bf16_train_5_steps"] = train_at_config_traffic(
        redet_cfg, redet_bf16, rik, "bf16", n_steps=5, brief=True)
    elapsed("the ReDet bf16 paths")
    del redet_bf16
    torch.cuda.empty_cache()
    run_net_launches, _ = run_net_phase(
        rik, rik.BUILD_DIR / "redet_run_net", REDET_CONFIG,
        {"max_iou_assign_rect": 0, "max_iou_assign_rect_per_image": 1,
         "max_iou_assign_rect_per_image_masked": 1})
    elapsed("the ReDet run_net phase")
    paths["redet_run_net"] = run_net_launches
    return entry, paths


# ---------------------------------------------------------------------------
# The Rotated RetinaNet family's other configs
# ---------------------------------------------------------------------------

# config -> the head's assignment route: "fused" (K1's fused assigner),
# "atss" (the ATSS assigner on K1's matrix) or "hbb" (the max-IoU assigner
# on circumscribed hbbs, no kernel)
RETINA_VARIANTS = {
    "gwd_r50_fpn_1x_dota": "fused",
    "kld_r50_fpn_1x_dota": "fused",
    "kfiou_r50_fpn_1x_dota": "fused",
    "rsdet_r50_fpn_1x_dota": "fused",
    "atss_obb_r50_fpn_1x_dota": "atss",
    "csl_r50_fpn_1x_dota": "fused",
    "ld_r50_fpn_1x_dota": "fused",
    "rotated_retinanet_hbb_r50_fpn_1x_dota": "hbb",
    "rotated_retinanet_obb_r50v1d_fpn_1x_dota": "fused",
    "rotated_retinanet_obb_r50_fpn_1x_dota1_5": "fused",
}
CONFIG_DIR = Path(__file__).resolve().parent / "configs"
# the variants whose head is checked card against CPU in float32 (v1d and
# DOTA-1.5 have the main path's head; the family's bf16 check is the main
# RetinaNet's)
RETINA_HEAD_CHECKS = ("gwd_r50_fpn_1x_dota", "kld_r50_fpn_1x_dota", "kfiou_r50_fpn_1x_dota",
                      "rsdet_r50_fpn_1x_dota", "atss_obb_r50_fpn_1x_dota", "csl_r50_fpn_1x_dota",
                      "ld_r50_fpn_1x_dota", "rotated_retinanet_hbb_r50_fpn_1x_dota")


def variant_label(name):
    return name.replace("_fpn_1x_dota", "").replace("rotated_retinanet_", "")


def variant_launches_per_loss(route):
    """Launches of one loss forward (or train step) by route: the fused
    assigner once, K1's matrix once inside ATSS's assigner (counted apart
    from `predict`'s matrix launches, as rotated_iou_rect_atss), or
    neither."""
    return {"rotated_iou_rect": 0, "rotated_iou_generic": 0,
            "max_iou_assign_rect": int(route == "fused"),
            "max_iou_assign_rect_per_image": 0, "max_iou_assign_rect_per_image_masked": 0,
            "rotated_iou_rect_atss": int(route == "atss")}


def assigner_launches(counts, route):
    """`launch_counts` of a path that runs no `predict`, K1's matrix
    launches given to ATSS's route (they are its assigner's)."""
    counts = dict(counts, rotated_iou_rect_atss=0)
    if route == "atss":
        counts["rotated_iou_rect_atss"], counts["rotated_iou_rect"] = counts["rotated_iou_rect"], 0
    return counts


def check_variant_model(name, model):
    """The config's model at full width: R50-FPN 256 (R18 with an R50
    teacher for LD, ResNet-50-v1d for v1d), 4 + 4 tower convs of 256, 9
    anchors per location (1 for ATSS), 15 classes (16 on DOTA-1.5)."""
    head, bb = model.bbox_head, model.backbone
    ld = name.startswith("ld_")
    ok = (bb.depth == (18 if ld else 50) and model.neck.out_channels == 256
          and head.feat_channels == 256 and len(head.cls_convs) == 4
          and head.num_anchors == (1 if name.startswith("atss") else 9)
          and head.cls_out_channels == (16 if name.endswith("1_5") else 15))
    if ld:
        ok &= (model.teacher.backbone.depth == 50 and model.teacher.neck.out_channels == 256
               and head.reg_max == 8)
    if "v1d" in name:
        ok &= bb.deep_stem and bb.layer2[0].downsample.avg_pool_first
    check(ok, f"{name}: the model is not the config's at full width")


def variant_margin(head, targets, size, route):
    """Smallest distance, over every real gt of `targets`, between what
    decides its assignment and the threshold it is held to, on the CPU
    plain version: for the max-IoU routes `iou_margin` on the rotated IoU
    (the hbb IoU for "hbb"), for ATSS `atss_decisive`'s."""
    from jdet_torch.ops import box_iou_rotated, rbox_to_hbox
    from jdet_torch.ops.nms import hbb_iou_matrix

    sizes = [(size // s, size // s) for s in head.anchor_strides]
    anchors = head._flat_anchors(sizes, "cpu")
    margin = np.inf
    for gt, m in zip(targets["gt_bboxes"], targets["gt_mask"]):
        gt = torch.as_tensor(gt[m])
        if route == "atss":
            m = atss_decisive(anchors, gt, [h * w * head.num_anchors for h, w in sizes])[1]
        elif route == "hbb":
            m = iou_margin(hbb_iou_matrix(rbox_to_hbox(gt), rbox_to_hbox(anchors)))
        else:
            m = iou_margin(box_iou_rotated(gt, anchors))
        margin = min(margin, m)
    return margin


def atss_decisive(anchors, gts, num_level, tol=1e-5):
    """ATSS on the CPU plain IoU of gts (K, 5) (real ones) against anchors
    (N, 5): the (N,) mask of the anchors whose assignment no change below
    `tol` in an IoU (and 1e-3 px in a candidate's offset from its gt's
    sides) can flip, and the smallest such distance."""
    from jdet_torch.models.boxes.assigner import atss_candidates
    from jdet_torch.ops import box_iou_rotated_rect_reference

    ious = box_iou_rotated_rect_reference(gts, anchors)
    cand = atss_candidates(anchors, gts, num_level)
    ci = torch.gather(ious, -1, cand)
    thr = ci.mean(-1, keepdim=True) + torch.sqrt(((ci - ci.mean(-1, keepdim=True)) ** 2)
                                                 .mean(-1, keepdim=True))
    off = anchors[cand, :2] - gts[:, None, :2]
    c, s = torch.cos(gts[:, None, 4]), torch.sin(gts[:, None, 4])
    # the candidate's distance from its gt's sides, in the gt's frame
    side = torch.minimum((gts[:, None, 2] / 2 - (off[..., 0] * c + off[..., 1] * s).abs()).abs(),
                         (gts[:, None, 3] / 2 - (off[..., 1] * c - off[..., 0] * s).abs()).abs())
    pair = torch.minimum((ci - thr).abs() / tol, side / 1e-3)  # >= 1: decisive pair
    per_anchor = torch.full((anchors.shape[0],), float("inf"))
    per_anchor.scatter_reduce_(0, cand.flatten(), pair.flatten(), "amin")
    # two gts sharing a candidate: their IoUs there apart
    cand_iou = torch.full_like(ious, float("-inf")).scatter_(-1, cand, ci)
    top2 = cand_iou.topk(min(2, len(gts)), dim=0).values
    if len(gts) > 1:
        shared = torch.isfinite(top2[1])
        gap = torch.where(shared, (top2[0] - top2[1]) / tol, float("inf"))
        per_anchor = torch.minimum(per_anchor, gap)
    return per_anchor >= 1, per_anchor.min().item() * tol


def ld_kd_witness(head, outs, t_outs):
    """LD's KD term on the model's own outputs, whose student and teacher
    distributions are nearly equal with random weights: the term on the
    card and on the CPU in float32, and on the CPU in float64."""
    from jdet_torch.models.losses import knowledge_distillation_kl_div_loss

    n1 = head.reg_max + 1
    T = head.loss_ld_cfg.get("T", 10.0)
    w = head.loss_ld_cfg.get("loss_weight", 0.25)
    got = {}
    for side, dev, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                             ("cpu_f64", "cpu", torch.float64)):
        s = head._flatten_dist([tuple(t.to(dev, dtype) for t in lvl) for lvl in outs])
        t = head._flatten_dist([tuple(x.to(dev, dtype) for x in lvl) for lvl in t_outs])
        got[side] = (knowledge_distillation_kl_div_loss(s.reshape(-1, n1), t.reshape(-1, n1),
                                                         T=T) * w).item()
    return got


def variant_head_card_against_cpu(name, model, route, cfg):
    """The head of `model` on the card and a CPU copy of it, fed the same
    head outputs (the card's network forward at 512², B=2, taken to the
    CPU) and the same targets, from a batch without near ties in the
    assignment: each loss, and the gradients of their total with respect
    to each head output at each level, in float32. CSL's `predict` is
    compared as sets. LD's losses are the KD detector's on its teacher's outputs with a
    standard normal added to the teacher's distributions' logits: with
    random weights the two are nearly equal, the KD term ~1e-5 is a sum of
    differences of nearly equal log-softmaxes, and the card's float32
    rounding moves it by ~1e-3 of itself (`ld_kd_witness` reads that on
    the model's own outputs, beside the CPU's float32 and a float64 CPU
    run)."""
    import copy

    from jdet_torch.parallel import make_device_normalizer

    head = model.bbox_head
    cpu_head = copy.deepcopy(head).cpu()
    normalize = make_device_normalizer(**cfg["device_normalize"])
    seed = next(s for s in range(5, 100)
                if variant_margin(cpu_head, synth_batch(2, 512, seed=s)[1], 512, route) > 1e-5)
    images, targets = synth_batch(2, 512, seed=seed, uint8=True)
    x = normalize(torch.as_tensor(images, device="cuda"))
    model.eval()
    with torch.no_grad():
        outs = head(model.extract_feat(x))
        t_outs = (model.teacher.bbox_head(model.teacher.extract_feat(x))
                  if hasattr(model, "teacher") else None)
    model.train()
    if t_outs is not None:
        witness = ld_kd_witness(cpu_head, outs, t_outs)
        log(f"fp32 {name} KD term on the model's own outputs: card {witness['card']!r}, "
            f"cpu {witness['cpu']!r}, cpu float64 {witness['cpu_f64']!r}; card - float64 "
            f"{witness['card'] - witness['cpu_f64']:.3e}, cpu - float64 "
            f"{witness['cpu'] - witness['cpu_f64']:.3e}")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        t_outs = [(c, r + torch.randn(r.shape, generator=gen, device="cuda").to(r.dtype))
                  for c, r in t_outs]
    res = {}
    for side, dev, h in (("card", "cuda", head), ("cpu", "cpu", cpu_head)):
        leaves = [tuple(t.detach().to(dev).requires_grad_(True) for t in lvl) for lvl in outs]
        tg = {k: torch.as_tensor(v, device=dev) for k, v in targets.items()}
        if t_outs is None:
            losses = h.loss(leaves, tg)
        else:
            losses = h.loss_with_teacher(leaves, [tuple(t.to(dev) for t in lvl)
                                                  for lvl in t_outs], tg)
        sum(losses.values()).backward()
        # per output (cls, reg[, angle]) and level, its gradient
        res[side] = ({k: v.item() for k, v in losses.items()},
                     [t.grad.float().cpu() for lvl in leaves for t in lvl])
        if name.startswith("csl_"):
            test_cfg = h.test_cfg
            h.test_cfg = dict(test_cfg, score_thr=0.0)
            det = h.predict([tuple(t.to(dev) for t in lvl) for lvl in outs])
            res[side] += ({k: v.cpu() for k, v in det.items()},)
            h.test_cfg = test_cfg
    (lc, gc, *dc), (lp, gp, *dp) = res["card"], res["cpu"]
    # each loss's error over itself
    loss_err = max(abs(lc[k] - lp[k]) / max(abs(lp[k]), 1e-30) for k in lp)
    # each output's gradient error at each level over its largest there:
    # the levels without a positive see only the class loss's gradient
    # and (LD) the KD term's
    grad_err = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                   for a, b in zip(gc, gp))
    # transcendentals a few ulp apart on the two devices
    grad_bound = 1e-4
    log(f"fp32 {name} head card vs cpu at 512², B=2, batch seed {seed}: losses {lc} vs "
        f"{lp}, max loss error over itself {loss_err:.3e}, gradient error over each "
        f"output's largest at each level {grad_err:.3e}")
    check(all(np.isfinite(v) for v in lc.values()), f"{name}: a non-finite loss")
    check(loss_err <= 1e-4, f"{name}: losses off the CPU by {loss_err}")
    check(grad_err <= grad_bound, f"{name}: gradients off the CPU by {grad_err}")
    if t_outs is not None:
        check(lp["loss_ld"] > 1e-2, f"{name}: the KD term {lp['loss_ld']} is not clear of 0")
    if dc:
        share, (n_got, n_want), score_err = as_sets(dc[0], dp[0])
        log(f"fp32 {name} predict card vs cpu as sets: {share} matched, counts "
            f"{n_got} vs {n_want}, sorted score err {score_err:.2e}")
        # as check_card_against_cpu holds RetinaNet's: the NMS may decide a
        # pair within rounding of its IoU threshold (K1 against the plain
        # IoU) otherwise, and the sweep carries it on
        check(n_want > 0 and share >= 0.99 and abs(n_got - n_want) <= 0.01 * n_want
              and score_err <= 1e-4, f"{name}: predict differs from the CPU's")
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err}


def variant_paths(name, cfg, model, rik, route, label, n_steps=5):
    """The config's serving path at B=2, 1024² (the loss forward, then
    `predict` at its test_cfg, each once with the launch counts read around
    it, then timed, median of 3) and `n_steps` train steps at B=4, 1024²,
    K=512 with 64 real gts (each timed; the median, and the peak memory).
    Checks finite losses, the predict's shapes and the launches of each
    route. Returns the launches of each path and the times."""
    head = model.bbox_head
    want = variant_launches_per_loss(route)
    images, targets = to_device(*synth_batch(2, 1024), "cuda")

    def loss_fwd():
        model.train()
        out = model.loss(images, targets)
        model.eval()
        return out

    torch.cuda.synchronize()
    reset_launch_counts(rik)
    losses = loss_fwd()
    torch.cuda.synchronize()
    loss_launches = assigner_launches(launch_counts(rik), route)
    reset_launch_counts(rik)
    det = model.predict(images)
    torch.cuda.synchronize()
    predict_launches = {**launch_counts(rik), "rotated_iou_rect_atss": 0}
    lv = {k: v.item() for k, v in losses.items()}
    log(f"{label} {name} loss forward at 1024², B=2: {lv}; launches {loss_launches}; "
        f"predict launches {predict_launches}")
    check(loss_launches == want, f"{name}: loss forward launches {loss_launches}, not {want}")
    check(predict_launches == {**{k: 0 for k in want}, "rotated_iou_rect": 1},
          f"{name}: not one K1 matrix launch in predict: {predict_launches}")
    check(all(np.isfinite(v) for v in lv.values()), f"{name}: a non-finite loss")
    shapes = {k: tuple(v.shape) for k, v in det.items()}
    check(shapes["boxes"] == (2, 2000, 5) and shapes["polys"] == (2, 2000, 8)
          and all(torch.isfinite(det[k]).all().item() for k in ("boxes", "polys", "scores")),
          f"{name}: predict {shapes}, or non-finite detections")
    check(((det["labels"][det["valid"]] >= 0)
           & (det["labels"][det["valid"]] < head.cls_out_channels)).all().item(),
          f"{name}: bad labels")
    times = {"loss_forward_ms": median_ms(loss_fwd, warmup=1, iters=3)}
    with torch.no_grad():
        times["predict_ms"] = median_ms(lambda: model.predict(images), warmup=1, iters=3)
    del images, targets, losses, det

    # the train steps at the config's traffic
    step, _, _, _ = build_trainer(cfg, model)
    images, targets = to_device(*synth_batch(4, 1024, K=512, real=64, seed=3, uint8=True),
                                "cuda")
    teacher = ({k: v.clone() for k, v in model.teacher.state_dict().items()}
               if hasattr(model, "teacher") else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(rik)
    step_ms, per_step, step_losses = [], [], []
    for it in range(n_steps):
        before = launch_counts(rik)
        t0 = time.perf_counter()
        step_losses.append({k: v.item() for k, v in step(images, targets, it).items()})
        step_ms.append((time.perf_counter() - t0) * 1e3)  # .item() synchronized
        per_step.append(assigner_launches(
            {k: v - before[k] for k, v in launch_counts(rik).items()}, route))
    train_launches = assigner_launches(launch_counts(rik), route)
    times.update(train_step_ms=float(np.median(step_ms)),
                 train_step_ms_each=[round(t, 3) for t in step_ms],
                 peak_memory_bytes=torch.cuda.max_memory_allocated())
    log(f"{label} {name} train steps at 1024², B=4, K=512: losses {step_losses}; launches "
        f"{train_launches}; {json.dumps(times)}")
    check(all(np.isfinite(v) for lv in step_losses for v in lv.values()),
          f"{name}: a non-finite train loss")
    check(per_step == [want] * n_steps, f"{name}: launches per step {per_step}, not {want}")
    if teacher is not None:
        after = model.teacher.state_dict()
        changed = [k for k, v in teacher.items() if not torch.equal(after[k], v)]
        check(not changed, f"{name}: the teacher changed in training: {changed[:5]}")
        log(f"{label} {name}: the teacher's {len(teacher)} parameters and buffers are "
            f"bit-unchanged after {n_steps} train steps")
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          f"{name}: a parameter is not float32")
    return ({f"{variant_label(name)}_{label}_loss_forward": loss_launches,
             f"{variant_label(name)}_{label}_predict": predict_launches,
             f"{variant_label(name)}_{label}_train_{n_steps}_steps": train_launches}, times)


def check_atss_route(rik, head):
    """K1's matrix route inside ATSS's assigner at the train step's
    (4, 512, 21824): K1 against its plain version on the card; the
    assignment on the card against the CPU plain version on the decisive
    anchors; K1 timed per call and on the device, against its bound and
    its plain version. Returns its entry of the kernels line (launches
    filled in later)."""
    from jdet_torch.models.boxes.assigner import atss_assign_rotated

    sizes = [(1024 // s, 1024 // s) for s in head.anchor_strides]
    num_level = [h * w * head.num_anchors for h, w in sizes]
    anchors = head._flat_anchors(sizes, "cuda")
    _, t = synth_batch(4, 1024, K=512, real=64, seed=3)
    gts, mask, labels = (torch.as_tensor(t[k], device="cuda")
                         for k in ("gt_bboxes", "gt_mask", "gt_labels"))
    B, K, N = gts.shape[0], gts.shape[1], anchors.shape[0]
    check(N == 21824, f"expected 21,824 ATSS anchors at 1024², got {N}")
    parked = rik.park_masked_boxes(gts, mask).contiguous()
    got = rik.box_iou_rotated_rect(parked, anchors)
    want = rik.box_iou_rotated_rect_reference(parked, anchors)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    del got, want
    check(err <= 2e-4, f"ATSS route: K1 off its plain version by {err}")

    card = atss_assign_rotated(anchors, gts, mask, labels, num_level_anchors=num_level)
    real = int(mask.sum(1).max())
    check(bool(mask[:, :real].all()) and not mask[:, real:].any(), "real gts not first")
    t0 = time.perf_counter()
    cpu = atss_assign_rotated(anchors.cpu(), *(x[:, :real].cpu() for x in (gts, mask, labels)),
                              num_level_anchors=num_level)
    cpu_s = time.perf_counter() - t0
    ok = torch.stack([atss_decisive(anchors.cpu(), gts[b, :real].cpu(), num_level)[0]
                      for b in range(B)])
    disagree = {k: int((card[k].cpu()[ok] != cpu[k][ok]).sum()) for k in ("gt_inds", "labels")}
    mo_err = (card["max_overlaps"].cpu() - cpu["max_overlaps"]).abs().max().item()
    log(f"ATSS assigner ({B}, {K}, {N}), {real} real gts: vs the CPU plain version "
        f"({cpu_s:.1f} s): {int(ok.sum())} of {ok.numel()} anchors decisive, disagreements "
        f"there {disagree}, max_overlaps err {mo_err:.2e}, positives "
        f"{int((card['gt_inds'] > 0).sum())}")
    check(ok.float().mean() > 0.99 and not any(disagree.values()) and mo_err <= 2e-4,
          "ATSS: the card's assignment is off the CPU plain version")

    ms = median_ms(lambda: rik.box_iou_rotated_rect(parked, anchors), iters=20)
    plain_ms = median_ms(lambda: rik.box_iou_rotated_rect_reference(parked, anchors),
                         warmup=1, iters=3)
    assign_ms = median_ms(lambda: atss_assign_rotated(anchors, gts, mask, labels,
                                                      num_level_anchors=num_level))
    kernels, device_ms, _ = device_profile(lambda: rik.box_iou_rotated_rect(parked, anchors),
                                           expect=("rotated_iou_rect_kernel",))
    nbytes = (B * K * 5 + N * 5 + B * K * N) * 4
    touching = touching_pairs(gts, anchors, mask)
    bound_ms, bound_by = bound(nbytes, IOU_FLOPS_PER_TOUCHING_PAIR * touching)
    log(f"ATSS route, K1 matrix ({B}, {K}, {N}): {ms:.4f} ms per call, device {kernels}; "
        f"plain version {plain_ms:.4f} ms; the whole ATSS assignment {assign_ms:.4f} ms; "
        f"bound {bound_ms:.4f} ms by {bound_by} (bytes {nbytes}, {touching} touching pairs x "
        f"{IOU_FLOPS_PER_TOUCHING_PAIR} flops); K1 vs plain max_abs_err {err:.3e}")
    return {
        "name": "rotated_iou_rect_atss",
        "route": "cuda",
        "source": "jdet_torch/csrc/rotated_iou.cu",
        "replaces": "jdet_tpu/ops/pallas_iou.py:148",
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": [B, K, N],
        "device_ms": device_ms,
        "atss_assign_ms": assign_ms,
    }


def retina_variant_phases(rik):
    """Each of the Rotated RetinaNet family's other configs at full width
    with random weights: its head card against CPU (float32; KLD and CSL
    in bf16 too), its serving path and 5 train steps in float32 and bf16;
    K1's matrix route inside ATSS's assigner; and `run_net` on LD's
    config. Returns the ATSS route's entry of the kernels line, the
    launches of each path and the times."""
    from jdet_torch.config import load_cfg_file
    from jdet_torch.models.builder import build_detector
    from jdet_torch.models.nn import compute_dtype_scope

    paths, times, atss_entry = {}, {}, None
    for name, route in RETINA_VARIANTS.items():
        t0 = time.perf_counter()
        cfg = load_cfg_file(CONFIG_DIR / f"{name}.py")
        model = build_detector(cfg["model"], device="cuda", seed=0, load_pretrained=False)
        check_variant_model(name, model)
        if route == "atss":
            atss_entry = check_atss_route(rik, model.bbox_head)
        if name in RETINA_HEAD_CHECKS:
            variant_head_card_against_cpu(name, model, route, cfg)
        p, times[f"{name} fp32"] = variant_paths(name, cfg, model, rik, route, "fp32")
        paths.update(p)
        state = model.state_dict()
        del model
        torch.cuda.empty_cache()
        with compute_dtype_scope(torch.bfloat16):
            bf16 = build_detector(cfg["model"], device="cuda", seed=0, load_pretrained=False)
        bf16.load_state_dict(state)
        del state
        check(model_dtype(bf16) == torch.bfloat16, f"{name}: the bf16 model is not bf16")
        p, times[f"{name} bf16"] = variant_paths(name, cfg, bf16, rik, route, "bf16")
        paths.update(p)
        del bf16
        torch.cuda.empty_cache()
        elapsed(f"the {name} phases ({time.perf_counter() - t0:.1f} s)")

    # LD through the CLI: the builder's teacher, the optimizer's mask, and
    # checkpoints with the teacher's leaves
    root = rik.BUILD_DIR / "ld_run_net"
    ld_config = CONFIG_DIR / "ld_r50_fpn_1x_dota.py"
    launches, _ = run_net_phase(
        rik, root, ld_config,
        {"max_iou_assign_rect": 1, "max_iou_assign_rect_per_image": 0,
         "max_iou_assign_rect_per_image_masked": 0},
        model_override="model = dict(backbone=dict(pretrained=None), "
                       "teacher=dict(backbone=dict(pretrained=None)))")
    with open(root / "work" / "checkpoints" / "ckpt_1.pkl", "rb") as f:
        saved = pickle.load(f)["model"]
    start = build_detector(load_cfg_file(root / "smoke_cfg.py")["model"], device="cpu",
                           seed=0, load_pretrained=False).state_dict()
    teacher_keys = [k for k in start if k.startswith("teacher.")]
    changed = [k for k in teacher_keys if not np.array_equal(saved[k], start[k].numpy())]
    moved = not np.array_equal(saved["bbox_head.retina_reg.weight"],
                               start["bbox_head.retina_reg.weight"].numpy())
    log(f"run_net {ld_config.name}: the checkpoint holds {len(teacher_keys)} teacher leaves, "
        f"{len(changed)} of them changed by training; the student moved: {moved}")
    check(teacher_keys and not changed and moved,
          "run_net LD: the checkpoint's teacher changed, or the student did not train")
    paths["ld_run_net"] = {**launches, "rotated_iou_rect_atss": 0}
    elapsed("the LD run_net phase")
    return atss_entry, paths, times


def strip_rcnn_cfg():
    """`configs/strip_rcnn_stripnet_s_fpn_1x_dota.py` with its one
    override, rpn_head.type="OrientedRPNHead": as committed, its hbb
    `RPNHead` feeds (B, N, 4) proposals to `StripHead`, which fails in the
    reference and which the port refuses to build."""
    from jdet_torch.config import load_cfg_file

    cfg = load_cfg_file(STRIP_CONFIG)
    cfg["model"]["rpn_head"] = dict(cfg["model"]["rpn_head"], type="OrientedRPNHead")
    return cfg


def lsk_phases(rik, n_steps=5):
    """Oriented R-CNN LSKNet-S (from its config file, AdamW) and Strip
    R-CNN StripNet-S (`strip_rcnn_cfg`) at full width with random weights,
    each in float32 and under the bf16 policy: card against CPU at 512²
    (network outputs, proposals and detections as sets, the losses and
    the gradients from one state), the serving path at B=2 and `n_steps`
    train steps at the config's traffic with its peak memory, timed
    briefly. Returns the launches of each path."""
    from jdet_torch.config import load_cfg_file
    from jdet_torch.models.builder import build_detector
    from jdet_torch.models.nn import compute_dtype_scope

    paths = {}
    for key, cfg, name in (("lsknet", load_cfg_file(LSKNET_CONFIG), "LSKNet-S"),
                           ("strip", strip_rcnn_cfg(), "StripNet-S")):
        if key == "strip":
            log("Strip R-CNN StripNet-S: configs/strip_rcnn_stripnet_s_fpn_1x_dota.py with one "
                "override, rpn_head.type='OrientedRPNHead' (the committed hbb RPNHead fails in "
                "the reference's StripHead and is refused by the port)")
        model = build_detector(cfg["model"], device="cuda", seed=0, load_pretrained=False)
        bb, rpn, head = model.backbone, model.rpn_head, model.bbox_head
        check(type(bb).__name__ == ("LSKNet" if key == "lsknet" else "StripNet")
              and bb.out_channels == [64, 128, 320, 512]
              and [len(s) for s in bb.stages] == [2, 2, 4, 2] and model.neck.out_channels == 256
              and (rpn.nms_pre, rpn.nms_post) == (2000, 2000) and rpn.box_dim == 5
              and tuple(head.shared_fcs[0].weight.shape) == (1024, 12544)
              and head.train_cfg["sampler"]["num"] == 512 and cfg["optimizer"]["type"] == "AdamW",
              f"{name} is not at full width with AdamW")
        log(f"{name} {type(model).__name__}: {sum(p.numel() for p in model.parameters())} "
            f"parameters, {sum(p.numel() for p in bb.parameters())} in the backbone")
        # bf16 card against CPU on the LSKNet/StripNet backbones' own bf16
        # arithmetic (GELU and sigmoid step by step, LayerNorm2d, the BN's
        # rsqrt): LSKNet-S's; on the two-stage head: Oriented R-CNN R50's
        check_rcnn_card_against_cpu(cfg, rik, grads=True, bf16=key == "lsknet")
        elapsed(f"{name} card vs cpu")
        paths[f"{key}_serving"] = rcnn_serving_phase(model, rik, f"fp32 {name}", brief=True)
        paths[f"{key}_train_{n_steps}_steps"] = train_at_config_traffic(
            cfg, model, rik, f"fp32 {name}", n_steps=n_steps, brief=True)
        del model, bb, rpn, head
        torch.cuda.empty_cache()
        with compute_dtype_scope(torch.bfloat16):
            model = build_detector(cfg["model"], device="cuda", seed=0, load_pretrained=False)
        paths[f"{key}_bf16_serving"] = rcnn_serving_phase(model, rik, f"bf16 {name}", brief=True)
        paths[f"{key}_bf16_train_{n_steps}_steps"] = train_at_config_traffic(
            cfg, model, rik, f"bf16 {name}", n_steps=n_steps, brief=True)
        del model
        torch.cuda.empty_cache()
        elapsed(f"the {name} phases")
    return paths


def counting_sweep(rounds):
    """`jdet_torch.ops.nms_rotated._greedy_sweep`, step for step, that
    appends its number of fixpoint rounds (host syncs) to `rounds`."""
    def sweep(overlap, valid):
        n = overlap.shape[-1]
        tri = torch.ones(n, n, dtype=torch.bool, device=overlap.device).triu(1)
        m = overlap & tri & valid[..., :, None] & valid[..., None, :]
        keep, k = valid, 0
        while True:
            k += 1
            new = valid & ~(m & keep[..., :, None]).any(dim=-2)
            if torch.equal(new, keep):
                rounds.append(k)
                return keep
            keep = new
    return sweep


def proposal_rounds(rpn, outs):
    """`rpn.get_proposals(outs)` with the hbb NMS's sweep counted: its
    proposals (equal to the plain call's) and its fixpoint rounds."""
    from jdet_torch.ops import nms as nms_module

    rounds = []
    real = nms_module._greedy_sweep
    nms_module._greedy_sweep = counting_sweep(rounds)
    try:
        props = rpn.get_proposals(outs)
    finally:
        nms_module._greedy_sweep = real
    want = rpn.get_proposals(outs)
    check(all(torch.equal(props[k], want[k]) for k in want),
          "the counted NMS sweep gave other proposals")
    return props, rounds


def hbb_rcnn_step_parts(cfg, model, label):
    """The parts of FasterRCNN-OBB's or Gliding Vertex's train step at its
    traffic (B=4, 1024², 512 gt slots, 64 real), each timed alone on the
    step's tensors: the proposals (decode, hbb NMS: Gliding's one NMS over
    all levels' 8,768 candidates per image, with its fixpoint rounds), the
    RoI sampling (the hbb assigner and the sampler), the hbb RoI align
    forward and forward + backward, and the FCs forward + backward."""
    from jdet_torch.ops import rbox_to_hbox
    from jdet_torch.parallel import make_device_normalizer

    normalize = make_device_normalizer(**cfg["device_normalize"])
    images, t = to_device(*synth_batch(4, 1024, K=512, real=64, seed=3, uint8=True), "cuda")
    x = normalize(images)
    B = x.shape[0]
    rpn, head = model.rpn_head, model.bbox_head
    model.train()
    with torch.no_grad():
        feats = model.extract_feat(x)
        outs = rpn(feats)
        props, rounds = proposal_rounds(rpn, outs)
    gt_h = rbox_to_hbox(t["gt_bboxes"])
    gen = torch.Generator(device="cuda").manual_seed(0)

    def sampling():
        return head._sample_rois(props["boxes"], props["valid"], gt_h, t["gt_mask"],
                                 t["gt_labels"], generator=gen, gt_reg=t["gt_bboxes"])

    with torch.no_grad():
        rois, rvalid, *_ = sampling()
    S = rois.shape[1]
    leaf = [f.detach().requires_grad_() for f in feats[:4]]
    cot = torch.randn(B, S, 7, 7, feats[0].shape[1], device="cuda", dtype=feats[0].dtype)

    def align_fwd_bwd():
        torch.autograd.grad(head.roi_extractor(leaf, rois, rvalid), leaf, cot)

    with torch.no_grad():
        aligned = head.roi_extractor(feats, rois, rvalid).reshape(B, S, -1)
    aligned.requires_grad_()
    fcs = [fc for fc in (head.fc_cls, head.fc_reg, getattr(head, "fc_fix", None),
                         getattr(head, "fc_ratio", None)) if fc is not None]

    def fcs_fwd_bwd():
        y = aligned
        for fc in head.shared_fcs:
            y = torch.relu(fc(y))
        sum(fc(y).float().sum() for fc in fcs).backward()

    with torch.no_grad():
        times = {
            "proposals_ms": median_ms(lambda: rpn.get_proposals(outs), warmup=2, iters=10),
            "roi_sampling_ms": median_ms(sampling, warmup=2, iters=10),
            "roi_align_forward_ms": median_ms(lambda: head.roi_extractor(feats, rois, rvalid),
                                              warmup=2, iters=10),
        }
    times["roi_align_forward_backward_ms"] = median_ms(align_fwd_bwd, warmup=2, iters=10)
    times["fcs_forward_backward_ms"] = median_ms(fcs_fwd_bwd, warmup=2, iters=10)
    times["proposals_nms_fixpoint_rounds"] = rounds
    times["proposals_per_image"] = props["valid"].sum(1).tolist()
    model.zero_grad(set_to_none=True)
    nms_kind = "one NMS over all levels" if rpn.cross_level_nms else "an NMS per level"
    log(f"{label} {type(model).__name__} step parts at 1024², B=4, K=512 (64 real), "
        f"{nms_kind} at {rpn.nms_thresh}, {int(rvalid.sum())} sampled RoIs: "
        f"{json.dumps(times)}")
    return times


def hbb_rcnn_phases(rik, n_steps=5):
    """FasterRCNN-OBB and Gliding Vertex R50-FPN, each from its config file
    at full width with random weights, in float32 and under the bf16
    policy: card against CPU at 512² (network outputs, proposals and
    detections as sets, the losses and 2 train steps on the same sampler
    draws; FasterRCNN-OBB's bf16 within the f32 - bf16 gap), the serving
    path at B=2, and `n_steps` train steps at the config's traffic, timed
    briefly; Gliding's step parts in
    float32 (the cross-level NMS with its rounds, the RoI sampling). Then
    Gliding's ra90_balance config from its file: 2 steps with its device
    flip and rot90. Returns the launches of each path."""
    from jdet_torch.config import load_cfg_file
    from jdet_torch.models.builder import build_detector
    from jdet_torch.models.nn import compute_dtype_scope

    paths = {}
    for key, path, det, rpn_type, head_type in (
            ("faster", FASTER_CONFIG, "FasterRCNNOBB", "RPNHead", "FasterrcnnHead"),
            ("gliding", GLIDING_CONFIG, "GlidingVertex", "GlidingRPNHead", "GlidingHead")):
        cfg = load_cfg_file(path)
        model = build_detector(cfg["model"], device="cuda", seed=0, load_pretrained=False)
        rpn, head = model.rpn_head, model.bbox_head
        check(type(model).__name__ == det and type(rpn).__name__ == rpn_type
              and type(head).__name__ == head_type and model.backbone.depth == 50
              and model.neck.out_channels == 256 and (rpn.nms_pre, rpn.nms_post) == (2000, 2000)
              and rpn.box_dim == 4 and rpn.cross_level_nms == (key == "gliding")
              and tuple(head.shared_fcs[0].weight.shape) == (1024, 12544)
              and head.train_cfg["sampler"]["num"] == 512,
              f"{det} is not R50-FPN at full width")
        log(f"{det} model: {sum(p.numel() for p in model.parameters())} parameters, RPN NMS "
            f"{'across levels' if rpn.cross_level_nms else 'per level'} at {rpn.nms_thresh}")
        # bf16 card against CPU on the hbb heads: FasterRCNN-OBB's
        check_rcnn_card_against_cpu(cfg, rik, bf16=key == "faster")
        elapsed(f"{det} card vs cpu")
        paths[f"{key}_serving"] = rcnn_serving_phase(model, rik, "fp32", brief=True)
        paths[f"{key}_train_{n_steps}_steps"] = train_at_config_traffic(
            cfg, model, rik, "fp32", n_steps=n_steps, brief=True)
        if key == "gliding":
            hbb_rcnn_step_parts(cfg, model, "fp32")
        del model, rpn, head
        torch.cuda.empty_cache()
        with compute_dtype_scope(torch.bfloat16):
            model = build_detector(cfg["model"], device="cuda", seed=0, load_pretrained=False)
        paths[f"{key}_bf16_serving"] = rcnn_serving_phase(model, rik, "bf16", brief=True)
        paths[f"{key}_bf16_train_{n_steps}_steps"] = train_at_config_traffic(
            cfg, model, rik, "bf16", n_steps=n_steps, brief=True)
        del model
        torch.cuda.empty_cache()
        elapsed(f"the {det} phases")

    # ra90_balance: the same model, flip and rot90 inside the step
    cfg = load_cfg_file(GLIDING_RA90_CONFIG)
    check(cfg["device_augment"] == dict(flip_h=0.5, rot90=1.0)
          and cfg["dataset"]["train"]["balance_category"] is True,
          "the ra90_balance config lost its augment or its balance")
    model = build_detector(cfg["model"], device="cuda", seed=0, load_pretrained=False)
    step = build_trainer(cfg, model)[0]
    images, targets = to_device(*synth_batch(4, 1024, K=512, real=64, seed=3, uint8=True),
                                "cuda")
    torch.cuda.synchronize()
    reset_launch_counts(rik)
    losses = [{k: v.item() for k, v in step(images, targets, it).items()} for it in range(2)]
    torch.cuda.synchronize()
    paths["gliding_ra90_train_2_steps"] = launch_counts(rik)
    log(f"gliding ra90_balance, 2 steps with device flip_h 0.5 and rot90 1.0 at B=4, 1024²: "
        f"losses {losses}, launches {paths['gliding_ra90_train_2_steps']}")
    check(all(np.isfinite(v) for lv in losses for v in lv.values()),
          "ra90_balance: a non-finite loss")
    check(not any(paths["gliding_ra90_train_2_steps"].values()),
          "ra90_balance: a kernel launch on a path that assigns horizontal boxes only")
    del model, step
    torch.cuda.empty_cache()
    return paths


def s2anet_ridet_r101_phases(rik, ridet_steps=5, r101_steps=5):
    """S2ANet with the RIDet ODM loss (`s2anet_r50_fpn_1x_dota_ridet.py`):
    card against CPU at 512² (head outputs, losses and 2 train steps), then
    `ridet_steps` train steps at the config's traffic in float32 and bf16. S2ANet R101
    (`s2anet_r101_fpn_1x_dota.py`): the serving path in float32, and
    `r101_steps` train steps in float32 and bf16. Returns the launches of
    each path."""
    from jdet_torch.config import load_cfg_file
    from jdet_torch.models.builder import build_detector
    from jdet_torch.models.nn import compute_dtype_scope

    paths = {}
    ridet_cfg = load_cfg_file(RIDET_CONFIG)
    model = build_detector(ridet_cfg["model"], device="cuda", seed=0, load_pretrained=False)
    head = model.bbox_head
    check(is_s2anet(model) and model.backbone.depth == 50
          and head.loss_cfgs["odm_bbox"]["type"] == "ridet"
          and head.train_cfg["odm_cfg"]["reg_decoded_bbox"] is True,
          "the RIDet config lost its loss")
    # bf16 card against CPU on S2ANet's head: S2ANet R50's
    check_s2anet_card_against_cpu(ridet_cfg, rik)
    elapsed("S2ANet RIDet card vs cpu")
    paths[f"s2anet_ridet_train_{ridet_steps}_steps"] = train_at_config_traffic(
        ridet_cfg, model, rik, "fp32 RIDet", n_steps=ridet_steps, brief=True)
    del model, head
    torch.cuda.empty_cache()
    with compute_dtype_scope(torch.bfloat16):
        model = build_detector(ridet_cfg["model"], device="cuda", seed=0, load_pretrained=False)
    paths[f"s2anet_ridet_bf16_train_{ridet_steps}_steps"] = train_at_config_traffic(
        ridet_cfg, model, rik, "bf16 RIDet", n_steps=ridet_steps, brief=True)
    del model
    torch.cuda.empty_cache()
    elapsed("the S2ANet RIDet phases")

    r101_cfg = load_cfg_file(S2ANET_R101_CONFIG)
    for dtype, label in ((None, "fp32 R101"), (torch.bfloat16, "bf16 R101")):
        with compute_dtype_scope(dtype):
            model = build_detector(r101_cfg["model"], device="cuda", seed=0,
                                   load_pretrained=False)
        check(is_s2anet(model) and model.backbone.depth == 101
              and len(model.backbone.layer3) == 23, "S2ANet is not on ResNet-101")
        if dtype is None:
            log(f"S2ANet R101 model: {sum(p.numel() for p in model.parameters())} parameters")
        tag = "s2anet_r101" + ("_bf16" if dtype else "")
        if dtype is None:
            paths[f"{tag}_serving"] = serving_phase(model, rik, label, brief=True)
        paths[f"{tag}_train_{r101_steps}_steps"] = train_at_config_traffic(
            r101_cfg, model, rik, label, n_steps=r101_steps, brief=True)
        del model
        torch.cuda.empty_cache()
    elapsed("the S2ANet R101 phases")
    return paths


def single_stage_phases(rik, n_steps=5):
    """R3Det, Rotated FCOS and H2RBox R50-FPN, each from its config file
    at full width with random weights: R3Det's per-image fused route on
    its refine stage's candidates (the refined boxes of a real stage-1
    forward, IoU 0.6 / 0.5); card against CPU at 512², B=1 (the loss
    forward in float32, then 2 SGD steps or, for H2RBox's AdamW, the
    gradients from one state, on a batch without near ties in any
    assignment or point target; `check_train_card_against_cpu`); the
    serving path at B=2 and `n_steps` train steps
    at the config's traffic with the config's optimizer, in float32 and
    bf16, timed briefly (PERF.md holds their step parts and profiles).
    Returns R3Det's entry of the kernels line and the launches of each
    path."""
    from jdet_torch.config import load_cfg_file
    from jdet_torch.models.builder import build_detector
    from jdet_torch.models.nn import compute_dtype_scope

    paths, entry = {}, None
    for key, path, det, head_type in (("r3det", R3DET_CONFIG, "R3Det", "R3DetHead"),
                                      ("fcos", FCOS_CONFIG, "FCOS", "FCOSHead"),
                                      ("h2rbox", H2RBOX_CONFIG, "H2RBox", "H2RBoxHead")):
        cfg = load_cfg_file(path)
        model = build_detector(cfg["model"], device="cuda", seed=0, load_pretrained=False)
        head = model.bbox_head
        tower = head.cls_convs[0].conv.weight.shape
        if key == "r3det":
            width = (head.cls_out_channels == 15 and head.num_anchors == 9
                     and len(head.refine_cls_convs) == len(head.refine_reg_convs) == 2
                     and tuple(head.frm.conv_5_1.weight.shape) == (256, 256, 5, 1))
        else:
            width = (head.num_classes == 15 and head.cls_convs[0].norm.num_groups == 32
                     and len(head.scales) == 5)
        check(type(model).__name__ == det and type(head).__name__ == head_type
              and model.backbone.depth == 50 and model.neck.out_channels == 256
              and len(head.cls_convs) == len(head.reg_convs) == 4
              and tuple(tower) == (256, 256, 3, 3) and width,
              f"{det} is not R50-FPN at full width")
        log(f"{det} model: {sum(p.numel() for p in model.parameters())} parameters, optimizer "
            f"{cfg['optimizer']['type']}")
        if key == "r3det":
            entry, (images, _, _) = check_assign_per_image_kernel(
                rik, model, cfg, thr=dict(head.refine_train_cfg["assigner"]), edge_cases=False)
            del images
            elapsed("check_assign_per_image_kernel on R3Det")
        check_train_card_against_cpu(cfg, rik, loss_forward=True)
        elapsed(f"{det} card vs cpu")
        paths[f"{key}_serving"] = serving_phase(model, rik, "fp32", brief=True)
        paths[f"{key}_train_{n_steps}_steps"] = train_at_config_traffic(
            cfg, model, rik, "fp32", n_steps=n_steps, brief=True)
        state = model.state_dict()
        del model, head
        torch.cuda.empty_cache()
        with compute_dtype_scope(torch.bfloat16):
            model = build_detector(cfg["model"], device="cuda", seed=0, load_pretrained=False)
        model.load_state_dict(state)
        del state
        paths[f"{key}_bf16_serving"] = serving_phase(model, rik, "bf16", brief=True)
        paths[f"{key}_bf16_train_{n_steps}_steps"] = train_at_config_traffic(
            cfg, model, rik, "bf16", n_steps=n_steps, brief=True)
        del model
        torch.cuda.empty_cache()
        elapsed(f"the {det} phases")
    return entry, paths


# RepPoints -----------------------------------------------------------------

def reppoints_sets(model, images):
    """The init and the refine point sets (B, A, 18) of a train-mode
    forward of `images` without gradients (what `loss` sees), with the
    points' centres and strides."""
    head = model.bbox_head
    was_training = model.training
    model.train()
    with torch.no_grad():
        outs = head(model.extract_feat(images))
    model.train(was_training)
    B = images.shape[0]
    pts, strides = head._points([tuple(o[0].shape[-2:]) for o in outs], images.device)
    centers, strides = torch.cat(pts), torch.cat(strides)
    sets = [head._decode_points(head._flatten(outs, i, 18), centers, strides).reshape(B, -1, 18)
            for i in (1, 2)]
    return sets[0], sets[1], centers, strides


def reppoints_margin(model, targets, images):
    """`utils/edge_cases.py::refine_margin` of the refine assignment's
    convex IoU on the init sets of a forward of `images`."""
    from jdet_torch.ops.box_convert import rbox_to_poly
    from jdet_torch.ops.convex import convex_iou_batched
    from jdet_torch.utils.edge_cases import refine_margin

    pts_i = reppoints_sets(model, images)[0]
    mask = torch.as_tensor(targets["gt_mask"], device=pts_i.device)
    polys = rbox_to_poly(torch.as_tensor(targets["gt_bboxes"], device=pts_i.device).float())
    ov = convex_iou_batched(pts_i, polys, mask)
    return refine_margin(ov.cpu().numpy(), mask.cpu().numpy())


def rect_corner_gap(a, b):
    """Per rbox pair (N, 5): the largest distance from a corner of `a` to
    the nearest corner of `b`, whichever corner each list starts at."""
    from jdet_torch.ops.box_convert import rbox_to_poly

    ca, cb = (rbox_to_poly(x.double()).reshape(-1, 4, 2) for x in (a, b))
    return (ca[:, :, None] - cb[:, None]).norm(dim=-1).amin(-1).amax(-1)


def check_reppoints_convex_ops(model, cfg):
    """RepPoints' plain convex ops on the card against the CPU at the train
    step's shapes: the init and refine point sets of a real forward at
    B=4, 1024², K=512 (64 real gts per image), on the first batch seed
    whose refine assignment has no near tie (`refine_margin` above 1e-5).
    The refine assignment (`max_convex_iou_assign`): the convex IoU's
    zeros identical, its values within 1e-6 + 1e-4 of the CPU's, gt_inds
    and labels identical; its ms and the device bytes it holds at its
    peak. `convex_giou` at the loss's pairs (each gt's init candidate;
    the refine positives' budget of M = 4,096 per image, padded pairs
    with zero weight) with the gradient of the weighted loss: values
    within 1e-5, gradients within 1e-4 of the largest, no NaN among the
    padded pairs. `min_area_rect` of every refine set: the area within
    1e-4 plus 8 float32 ulps of the image coordinates times w + h (an
    untrained set is sub-pixel, its sides measured to the ulps of a
    coordinate near 1024), and, as a polygon whatever corner it starts at,
    the corners within 1e-3 px + 16 ulps + 1e-3 of the set's size on
    every set whose rectangle is decisive (`rect_decisive`): near-equal
    candidate areas pick edges apart on the two devices. Returns the
    numbers."""
    from jdet_torch.models.boxes.assigner import convex_assign_init, max_convex_iou_assign
    from jdet_torch.ops.box_convert import rbox_to_poly
    from jdet_torch.ops.convex import convex_giou, convex_iou_batched, min_area_rect
    from jdet_torch.ops.topk import stable_topk
    from jdet_torch.parallel import make_device_normalizer
    from jdet_torch.utils.edge_cases import refine_margin

    normalize = make_device_normalizer(**cfg["device_normalize"])
    for seed in range(3, 40):
        images, targets = to_device(*synth_batch(4, 1024, K=512, real=64, seed=seed, uint8=True),
                                    "cuda")
        pts_i, pts_r, centers, strides = reppoints_sets(model, normalize(images))
        mask, labels = targets["gt_mask"], targets["gt_labels"]
        polys = rbox_to_poly(targets["gt_bboxes"].float())
        ov = convex_iou_batched(pts_i, polys, mask)
        margin = refine_margin(ov.cpu().numpy(), mask.cpu().numpy())
        if margin > 1e-5:
            break
    else:
        raise RuntimeError("chip_smoke: no RepPoints batch without near ties in 37 seeds")

    out = {"batch_seed": seed, "refine_margin": margin}
    base = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    card = max_convex_iou_assign(pts_i, polys, mask, labels)
    torch.cuda.synchronize()
    out["refine_assign_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    out["refine_assign_ms"] = median_ms(
        lambda: max_convex_iou_assign(pts_i, polys, mask, labels), 1, 5)
    cpu_args = [a.cpu() for a in (pts_i, polys, mask, labels)]
    t0 = time.perf_counter()
    cpu = max_convex_iou_assign(*cpu_args)
    out["refine_assign_cpu_ms"] = 1e3 * (time.perf_counter() - t0)
    ov_cpu = convex_iou_batched(*cpu_args[:3])
    real = mask.cpu()[..., None].expand_as(ov_cpu)
    ov_card = ov.cpu()
    out["real_pairs"] = int(real.sum())
    out["nonzero_pairs"] = int((ov_cpu[real] > 0).sum())
    check(torch.equal((ov_card == 0) & real, (ov_cpu == 0) & real),
          "RepPoints: the card's convex IoU has other zeros than the CPU's")
    err = (ov_card - ov_cpu).abs()[real]
    out["iou_max_abs_err"] = err.max().item()
    check((err <= 1e-6 + 1e-4 * ov_cpu[real]).all().item(),
          f"RepPoints: convex IoU card vs cpu {out['iou_max_abs_err']}")
    for k in ("gt_inds", "labels"):
        check(torch.equal(card[k].cpu(), cpu[k]), f"RepPoints refine assignment: {k} differ")
    out["refine_positives"] = int((cpu["gt_inds"] > 0).sum())

    # convex_giou and its gradient at the loss's pairs
    B, K = mask.shape
    ai = convex_assign_init(centers, torch.log2(strides), polys, mask)
    M = min(pts_r.shape[1], 8 * K)
    top_s, top_idx = stable_topk(torch.where(card["gt_inds"] > 0, card["max_overlaps"],
                                             float("-inf")), M)
    sel_gt = (torch.gather(card["gt_inds"], 1, top_idx) - 1).clamp(0, K - 1)
    pairs = {
        "init": (torch.gather(pts_i, 1, ai["cand_idx"].reshape(B, -1, 1).expand(-1, -1, 18)),
                 polys, ai["cand_win"].reshape(B, -1).float()),
        "refine": (torch.gather(pts_r, 1, top_idx[..., None].expand(-1, -1, 18)),
                   torch.gather(polys, 1, sel_gt[..., None].expand(-1, -1, 8)),
                   torch.isfinite(top_s).float())}
    for name, (sets, gts, w) in pairs.items():
        res = {}
        for dev in ("cuda", "cpu"):
            x = sets.reshape(-1, 18).detach().to(dev).requires_grad_()
            g = convex_giou(x, gts.reshape(-1, 8).to(dev))
            ((1 - g) * w.reshape(-1).to(dev)).sum().backward()
            res[dev] = (g.detach().cpu(), x.grad.cpu())
        (gc, dc), (gp, dp) = res["cuda"], res["cpu"]
        check(torch.isfinite(dc).all().item() and torch.isfinite(gc).all().item(),
              f"RepPoints {name} GIoU: non-finite values or gradients on the card")
        out[f"{name}_giou_pairs"] = int(gc.numel())
        out[f"{name}_giou_weighted"] = int((w > 0).sum())
        out[f"{name}_giou_max_abs_err"] = (gc - gp).abs().max().item()
        out[f"{name}_giou_grad_err_of_largest"] = (
            (dc - dp).abs().max().item() / max(dp.abs().max().item(), 1e-30))
        check(out[f"{name}_giou_max_abs_err"] <= 1e-5
              and out[f"{name}_giou_grad_err_of_largest"] <= 1e-4,
              f"RepPoints {name} GIoU card vs cpu: {out}")

    # min_area_rect of every refine set
    sets = pts_r.reshape(-1, 9, 2)
    rc, rp = min_area_rect(sets).cpu(), min_area_rect(sets.cpu())
    area_c, area_p = (r[:, 2].double() * r[:, 3].double() for r in (rc, rp))
    # the rotated coordinates of a sub-pixel set at ~1000 px keep a few
    # float32 ulps of the image coordinate (1.2e-4 px at 1024) per side
    ulp = sets.abs().amax().item() * 2.0 ** -23
    area_tol = 1e-4 * area_p + 8 * ulp * (rp[:, 2] + rp[:, 3]).double()
    out["rect_area_max_err_of_tol"] = ((area_c - area_p).abs() / area_tol).max().item()
    check(out["rect_area_max_err_of_tol"] <= 1.0,
          f"RepPoints min_area_rect: areas card vs cpu at {out['rect_area_max_err_of_tol']:.3f} "
          f"of the tolerance")
    size = (sets.amax(1) - sets.amin(1)).amax(-1).cpu().double()
    agree = rect_corner_gap(rc, rp) <= 1e-3 + 16 * ulp + 1e-3 * size
    decisive = rect_decisive(sets.cpu())
    out["rect_corners_agree_share"] = agree.double().mean().item()
    out["rect_decisive_share"] = decisive.double().mean().item()
    check(decisive.any().item() and agree[decisive].all().item(),
          f"RepPoints min_area_rect: corners card vs cpu differ on "
          f"{int((~agree & decisive).sum())} of {int(decisive.sum())} decisive sets")
    return out


def rect_decisive(sets):
    """(N,) point sets (N, n, 2) whose least-area rectangle no rounding can
    turn: in float64, every candidate edge whose direction differs by
    more than 1e-3 rad (modulo pi/2, the same rectangle) from the best's
    gives an area at least 1% larger."""
    from jdet_torch.ops.convex import _prev_next_valid, _take, convex_hull_mask

    _, keep, p = convex_hull_mask(sets.double())
    _, nxt = _prev_next_valid(keep)
    edge = _take(p, nxt) - p
    theta = torch.atan2(edge[..., 1], edge[..., 0])
    c, s = torch.cos(-theta)[..., None], torch.sin(-theta)[..., None]
    x, y = p[..., None, :, 0], p[..., None, :, 1]
    rx, ry = c * x - s * y, s * x + c * y
    v = keep[..., None, :]
    inf = float("inf")
    areas = ((torch.where(v, rx, -inf).amax(-1) - torch.where(v, rx, inf).amin(-1))
             * (torch.where(v, ry, -inf).amax(-1) - torch.where(v, ry, inf).amin(-1)))
    areas = torch.where(keep, areas, inf)
    best, arg = areas.min(-1)
    turn = torch.remainder(theta - torch.gather(theta, -1, arg[:, None]), np.pi / 2)
    other = keep & (torch.minimum(turn, np.pi / 2 - turn) > 1e-3)
    second = torch.where(other, areas, inf).amin(-1)
    return (second - best) > 1e-2 * best


def retina_poly_giou_phase(cfg):
    """The main RetinaNet with `loss_bbox=dict(type="poly_giou")` at the
    train step's traffic (B=4, 1024², K=512, 64 real gts): the loss
    forward and one train step, timed (medians of 3 after 1), with the
    peak memory of each. Returns the numbers."""
    import copy

    from jdet_torch.models.builder import build_detector

    cfg = copy.deepcopy(cfg)
    cfg["model"]["bbox_head"]["loss_bbox"] = dict(type="poly_giou", loss_weight=1.0)
    model = build_detector(cfg["model"], device="cuda", seed=0, load_pretrained=False)
    check(model.bbox_head.loss_bbox_cfg["type"] == "poly_giou", "not the poly_giou head")
    step, _, normalize, _ = build_trainer(cfg, model, augment=False)
    images, targets = to_device(*synth_batch(4, 1024, K=512, real=64, seed=3, uint8=True),
                                "cuda")
    x = normalize(images)
    model.train()
    losses = {k: v.item() for k, v in model.loss(x, targets).items()}
    check(all(np.isfinite(v) for v in losses.values()) and losses["loss_bbox"] > 0,
          f"RetinaNet poly_giou losses {losses}")
    out = {"losses": losses,
           "loss_forward_peak_bytes": peak_bytes(lambda: model.loss(x, targets)),
           "loss_forward_ms": median_ms(lambda: model.loss(x, targets), 1, 3)}
    counter = iter(range(10**6))
    out["train_step_peak_bytes"] = peak_bytes(lambda: step(images, targets, next(counter)))
    out["train_step_ms"] = median_ms(lambda: step(images, targets, next(counter)), 1, 3)
    log(f"RetinaNet poly_giou at 1024², B=4, K=512: {json.dumps(out)}")
    del model
    torch.cuda.empty_cache()
    return out


def reppoints_phases(rik, n_steps=5):
    """Rotated RepPoints R50-FPN from `configs/rotated_reppoints_r50_fpn_
    1x_dota.py` at full width with random weights: its convex ops on the
    card against the CPU (`check_reppoints_convex_ops`); card against CPU
    at 512², B=1 (the float32 loss forward rtol 1e-4, then 2 SGD steps
    at lr 0.008, each parameter within 1e-4 of its tensor's largest
    value), and once under the bf16 policy within sqrt(2) of the f32 -
    bf16 gap (two independent bf16 roundings);
    the serving path at B=2 and `n_steps` train steps at B=4, 1024², K=512
    (64 real) in float32 and bf16, timed briefly; then the main
    RetinaNet's `poly_giou` loss at the same traffic. No fused launch on
    any of its paths, one K1 matrix launch per `predict`. Returns the
    launches of each path."""
    from jdet_torch.config import load_cfg_file
    from jdet_torch.models.builder import build_detector
    from jdet_torch.models.nn import compute_dtype_scope

    cfg = load_cfg_file(REPPOINTS_CONFIG)
    check(cfg["optimizer"]["type"] == "SGD" and cfg["optimizer"]["lr"] == 0.008,
          f"RepPoints optimizer {cfg['optimizer']}")
    model = build_detector(cfg["model"], device="cuda", seed=0, load_pretrained=False)
    head = model.bbox_head
    check(is_reppoints(model) and type(head).__name__ == "RotatedRepPointsHead"
          and model.backbone.depth == 50 and model.neck.out_channels == 256
          and len(head.cls_convs) == len(head.reg_convs) == 3
          and tuple(head.cls_convs[0].conv.weight.shape) == (256, 256, 3, 3)
          and head.cls_convs[0].norm.num_groups == 32 and head.num_points == 9
          and head.num_classes == 15 and tuple(head.pts_init_out.weight.shape) == (18, 256, 1, 1)
          and head.gradient_mul == 0.1 and head.point_base_scale == 4
          and head.refine_assign_cfg == dict(pos_iou_thr=0.4, neg_iou_thr=0.3, min_pos_iou=0.0),
          "RepPoints is not R50-FPN at full width")
    log(f"RepPoints model: {sum(p.numel() for p in model.parameters())} parameters")
    ops = check_reppoints_convex_ops(model, cfg)
    log(f"RepPoints convex ops card vs cpu at 1024², B=4, K=512 (64 real): {json.dumps(ops)}")
    elapsed("RepPoints convex ops")
    check_train_card_against_cpu(cfg, rik, loss_forward=True, param_tol=1e-4)
    elapsed("RepPoints card vs cpu")
    # two bf16 results whose roundings are independent lie sqrt(2) gaps
    # apart: RepPoints' three GroupNorm convs per tower, in bf16 on cuDNN
    # and on oneDNN, read 1.04 of the gap on the class outputs (the BN
    # families' agree within 1.0)
    check_bf16_card_against_cpu(cfg, rik, gap_factor=2 ** 0.5)
    elapsed("RepPoints bf16 card vs cpu")
    paths = {"reppoints_serving": serving_phase(model, rik, "fp32", brief=True),
             f"reppoints_train_{n_steps}_steps": train_at_config_traffic(
                 cfg, model, rik, "fp32", n_steps=n_steps, brief=True)}
    state = model.state_dict()
    del model, head
    torch.cuda.empty_cache()
    with compute_dtype_scope(torch.bfloat16):
        model = build_detector(cfg["model"], device="cuda", seed=0, load_pretrained=False)
    model.load_state_dict(state)
    del state
    paths["reppoints_bf16_serving"] = serving_phase(model, rik, "bf16", brief=True)
    paths[f"reppoints_bf16_train_{n_steps}_steps"] = train_at_config_traffic(
        cfg, model, rik, "bf16", n_steps=n_steps, brief=True)
    del model
    torch.cuda.empty_cache()
    elapsed("the RepPoints phases")
    return paths


def vis_test_phase(rik, root, n_tiles=8):
    """`python -m jdet_torch.tools.run_net --task vis_test` on the card, in
    this process, on `n_tiles` synthetic 1024² tiles with the main config
    (random weights, the class conv's bias raised to 0.0 through
    `pretrained_weights`, so that untrained scores, sigmoid(0) = 0.5, pass
    the visualizer's 0.3; `max_per_img` 100): each tile written to
    work_dir/vis as a PNG of its size, its pixels changed where the boxes
    are drawn, and one K1 matrix launch per predict batch (one image
    each). Returns the launches."""
    import shutil

    from jdet_torch.config import load_cfg_file
    from jdet_torch.data.image_io import imread
    from jdet_torch.data.synthetic import make_synthetic_dota
    from jdet_torch.models.builder import build_detector
    from jdet_torch.runner.checkpoint import save_checkpoint
    from jdet_torch.tools import run_net

    shutil.rmtree(root, ignore_errors=True)
    img_dir, ann = make_synthetic_dota(str(root / "dota"), n_images=n_tiles, size=1024, seed=5)
    model = build_detector(load_cfg_file(CONFIG)["model"], device="cuda", seed=0,
                           load_pretrained=False)
    with torch.no_grad():
        model.bbox_head.retina_cls.bias.zero_()
    ckpt = root / "raised_class_bias.pkl"
    save_checkpoint(str(ckpt), model)
    del model
    data = dict(annotations_file=ann, images_dir=img_dir, num_workers=0)
    cfg_file = root / "vis_cfg.py"
    cfg_file.write_text("\n".join([
        f"_base_ = [{str(CONFIG)!r}]",
        "model = dict(backbone=dict(pretrained=None), bbox_head=dict(test_cfg=dict("
        "max_per_img=100)))",
        f"dataset = dict(train={data!r}, val={data!r}, test=dict(images_dir={img_dir!r}))",
        f"images_dir = {img_dir!r}",
        "dataset_type = 'DOTA'",
        f"pretrained_weights = {str(ckpt)!r}",
        f"work_dir = {str(root / 'work')!r}",
    ]) + "\n")
    torch.cuda.synchronize()
    reset_launch_counts(rik)
    t0 = time.perf_counter()
    run_net.main(["--config-file", str(cfg_file), "--task", "vis_test"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launch_counts(rik)
    tiles = sorted(f for f in os.listdir(img_dir) if f.endswith(".png"))
    vis = root / "work" / "vis"
    written = sorted(os.listdir(vis)) if vis.exists() else []
    changed = [int((imread(str(vis / f)) != imread(os.path.join(img_dir, f))).any(-1).sum())
               for f in written]
    log(f"vis_test: {run_s:.2f} s for {len(written)} images of {len(tiles)}, pixels drawn per "
        f"image {changed}, launches {launches}")
    check(written == tiles, f"vis_test wrote {written}, not the tiles {tiles}")
    check(all(imread(str(vis / f)).shape == (1024, 1024, 3) for f in written),
          "vis_test: a written image is not 1024 x 1024 RGB")
    check(min(changed) > 1000, f"vis_test drew too little: {changed}")
    check(launches == {"rotated_iou_rect": n_tiles, "max_iou_assign_rect": 0,
                       "max_iou_assign_rect_per_image": 0,
                       "max_iou_assign_rect_per_image_masked": 0, "rotated_iou_generic": 0},
          f"vis_test: not one K1 matrix launch per predict batch ({n_tiles}): {launches}")
    return launches


def torchvision_names(state):
    """A port ResNet's state dict under torchvision's names."""
    return {k.replace(".downsample.conv.", ".downsample.0.")
             .replace(".downsample.bn.", ".downsample.1."): v for k, v in state.items()}


def jdet_names(model):
    """A port RetinaNet's state dict under JDet's names: torchvision's in
    the backbone, the FPN's convs inside ConvModules (`.conv.`) and its
    extra convs appended to `fpn_convs`."""
    n_fpn = len(model.neck.fpn_convs)
    out = {}
    for k, v in model.state_dict().items():
        head, rest = k.split(".", 1)
        if head == "backbone":
            k = "backbone." + next(iter(torchvision_names({rest: 0})))
        elif head == "neck":
            kind, i, leaf = rest.split(".")
            if kind == "extra_convs":
                kind, i = "fpn_convs", int(i) + n_fpn
            k = f"neck.{kind}.{i}.conv.{leaf}"
        out[k] = v.detach().cpu().numpy()
    return out


def mmcls_names(state):
    """A port LSKNet's state dict under mmcls's names."""
    out = {}
    for k, v in state.items():
        for ours, theirs in (("patch_embeds.", "patch_embed"), ("stages.", "block"),
                             ("stage_norms.", "norm")):
            if k.startswith(ours):
                i, rest = k[len(ours):].split(".", 1)
                k = f"{theirs}{int(i) + 1}.{rest}"
        k = (k.replace(".gate.", ".spatial_gating_unit.")
             .replace(".mlp.dwconv.", ".mlp.dwconv.dwconv.")
             .replace(".ls1", ".layer_scale_1").replace(".ls2", ".layer_scale_2"))
        out[k] = v
    return out


def check_same_state(got, want, what):
    bad = [k for k, v in want.items() if not torch.equal(got[k].detach().cpu(), v.cpu())]
    check(set(got) == set(want) and not bad, f"{what}: tensors differ from the file's: {bad[:5]}")


def weight_import_phase(full_cfg, rik):
    """Weight import on the card, from files written here from a seed (no
    download): a torchvision-named ResNet-50 `.pth` (torch.save) as the
    main RetinaNet's `backbone.pretrained`; a JDet payload ({"meta":
    {"jdet_version"}, "model"}) of the whole detector through
    `Runner.load`, then its loss forward and `predict` on the card against
    the CPU (K1's fused and matrix routes); `python -m
    jdet_torch.tools.convert_weights --family lsknet_s` on an mmcls-named
    LSKNet-S state dict, its output as the LSKNet-S config's
    `backbone.pretrained`. Each import is held tensor for tensor to the
    file. Returns the launches of the loss forward and `predict`."""
    import copy

    from jdet_torch.config import load_cfg_file
    from jdet_torch.models.backbones import LSKNet
    from jdet_torch.models.builder import build_detector
    from jdet_torch.runner import Runner

    root = rik.BUILD_DIR / "weight_import"
    root.mkdir(parents=True, exist_ok=True)
    mcfg = copy.deepcopy(full_cfg["model"])
    mcfg["backbone"]["pretrained"] = None
    src = build_detector(mcfg, device="cpu", seed=3, load_pretrained=False)
    randomize_constants(src)
    gen = torch.Generator().manual_seed(3)
    tv = {k: v.clone() for k, v in torchvision_names(src.backbone.state_dict()).items()}
    tv["fc.weight"] = torch.randn(1000, 2048, generator=gen) * 0.01
    tv["fc.bias"] = torch.zeros(1000)
    pth = root / "resnet50_torchvision.pth"
    torch.save(tv, pth)
    t0 = time.perf_counter()
    model = build_detector(dict(mcfg, backbone=dict(mcfg["backbone"], pretrained=str(pth))),
                           device="cuda", seed=0)
    check_same_state(model.backbone.state_dict(), src.backbone.state_dict(),
                     "backbone.pretrained from a torchvision .pth")
    log(f"weight import: torchvision ResNet-50 .pth ({pth.stat().st_size} bytes) as "
        f"backbone.pretrained, build and load {time.perf_counter() - t0:.2f} s")
    del model

    payload = root / "jdet_retinanet_ckpt_12.pkl"
    with open(payload, "wb") as f:
        pickle.dump({"meta": {"jdet_version": "0.2.0", "epoch": 12}, "model": jdet_names(src)}, f)
    rcfg = dict(full_cfg, model=mcfg, dataset={}, work_dir=str(root / "runner"),
                pretrained_weights=None, resume=None, resume_path=None)
    runner = Runner(rcfg, device="cuda")
    t0 = time.perf_counter()
    meta = runner.load(str(payload))
    check(meta.get("epoch") == 12 and runner.epoch == 12, f"the payload's meta: {meta}")
    check_same_state(runner.model.state_dict(), src.state_dict(), "Runner.load of a JDet payload")
    log(f"weight import: JDet payload ({payload.stat().st_size} bytes) through Runner.load "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    reset_launch_counts(rik)
    check_card_against_cpu(runner.model, src)
    torch.cuda.synchronize()
    launches = launch_counts(rik)
    check(launches == {"rotated_iou_rect": 1, "max_iou_assign_rect": 1,
                       "max_iou_assign_rect_per_image": 0,
                       "max_iou_assign_rect_per_image_masked": 0, "rotated_iou_generic": 0},
          f"the imported detector's loss forward and predict: launches {launches}")
    del runner, src

    lsk = LSKNet(arch="s", generator=torch.Generator().manual_seed(5))
    randomize_constants(lsk)
    mm = {k: v.clone() for k, v in mmcls_names(lsk.state_dict()).items()}
    mm["head.weight"] = torch.randn(1000, 512, generator=gen) * 0.01
    mm["head.bias"] = torch.zeros(1000)
    mm_path, out = root / "lsknet_s_mmcls.pth", root / "lsknet_s.jtorch.pkl"
    torch.save({"state_dict": mm}, mm_path)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "jdet_torch.tools.convert_weights", "--src",
                           str(mm_path), "--family", "lsknet_s", "--out", str(out), "--strict"],
                          capture_output=True, text=True, timeout=300,
                          cwd=Path(__file__).resolve().parent)
    check(proc.returncode == 0, f"convert_weights failed: {proc.stderr[-2000:]}")
    log(f"weight import: convert_weights --family lsknet_s {time.perf_counter() - t0:.2f} s: "
        f"{proc.stdout.strip()}")
    lcfg = load_cfg_file(LSKNET_CONFIG)["model"]
    lcfg["backbone"]["pretrained"] = str(out)
    model = build_detector(lcfg, device="cuda", seed=0)
    check_same_state(model.backbone.state_dict(), lsk.state_dict(),
                     "backbone.pretrained from the converted LSKNet-S")
    del model
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# SSD300 on COCO, the codecs, COCO from disk and the SSDD+ / FAIR1M converters


def ssd_config():
    """`configs/ssd300_coco.py` with `backbone.pretrained` dropped (the VGG16
    checkpoint is not in the checkout)."""
    from jdet_torch.config import load_cfg_file

    cfg = load_cfg_file(SSD_CONFIG)
    cfg["model"]["backbone"]["pretrained"] = None
    return cfg


def draw_ssd_weights(model, seed=4):
    """SSD's weights from a seed, drawn so that its untrained `predict`
    does work: the backbone's and the neck's convs He-scaled (std
    sqrt(2 / fan_in), the first conv's also divided by the images' root
    mean square, biases N(0, 0.05)), so that the activations stay near
    unit scale through VGG's sixteen ReLUs; then, on a batch drawn from
    the same seed, each level's head convs scaled to its feature's root
    mean square r: the class convs at 2 / (r sqrt(fan_in)), the box convs
    at 0.2 / (r sqrt(fan_in)), biases 0. Class logits then spread with a
    standard deviation near 2: at the initializer's scales every class
    score sits near 1/81, below the config's score_thr of 0.02; drawn so,
    thousands of candidates per image pass it."""
    gen = torch.Generator().manual_seed(seed)
    head = model.bbox_head
    x = torch.as_tensor(ssd_batch(1, seed=seed)[0])
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("bbox_head.") or name.endswith("l2norm.weight"):
                continue
            if p.dim() == 4:
                # the first conv also divides by the images' scale
                scale = x.pow(2).mean().sqrt().item() if name == "backbone.blocks.0.0.weight" else 1
                p.copy_(torch.randn(p.shape, generator=gen) * (2.0 / p[0].numel()) ** 0.5 / scale)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        feats = model.extract_feat(x.to(next(model.parameters()).device))
        for lvl, f in enumerate(feats):
            r = f.float().pow(2).mean().sqrt().item()
            for convs, gain in ((head.cls_convs, 2.0), (head.reg_convs, 0.2)):
                w = convs[lvl].weight
                w.copy_(torch.randn(w.shape, generator=gen) * (gain / (r * w[0].numel() ** 0.5)))
                convs[lvl].bias.zero_()


def ssd_batch(B, seed=0, size=300, K=32, real=8, num_classes=80):
    """Float images as the config's Normalize leaves them (BGR, mean
    subtracted, std 1) of uint8 noise, and zero-angle gts (gt_bboxes
    (B, K, 5), 1-based labels, mask) on a 300² canvas."""
    rng = np.random.RandomState(seed)
    mean = np.asarray([103.53, 116.28, 123.675], np.float32)
    images = rng.randint(0, 256, (B, size, size, 3)).astype(np.float32) - mean
    gt = np.zeros((B, K, 5), np.float32)
    mask = np.zeros((B, K), bool)
    labels = np.zeros((B, K), np.int64)
    for b in range(B):
        mask[b, :real] = True
        gt[b, :real, 0] = rng.uniform(40, size - 40, real)
        gt[b, :real, 1] = rng.uniform(40, size - 40, real)
        gt[b, :real, 2] = rng.uniform(16, 200, real)
        gt[b, :real, 3] = rng.uniform(16, 200, real)
        labels[b, :real] = rng.randint(1, num_classes + 1, real)
    return images, {"gt_bboxes": gt, "gt_labels": labels, "gt_mask": mask}


def ssd_margins(model, images, targets):
    """On the CPU model: the smallest distance of a valid gt-anchor hbb IoU
    from the assigner's 0.5, and the smallest relative gap between the
    last negative the hard-negative cut keeps and the first it drops, over
    the batch. (A gt's best anchors often tie exactly, anchors of one size
    inside a larger gt; the hbb IoU is the same float operations on both
    devices, so such ties break alike. The negatives' losses come from
    convolutions that sum in another order on each device.)"""
    from jdet_torch.models.boxes.anchor_target import anchor_target_batch
    from jdet_torch.ops.box_convert import rbox_to_hbox

    head = model.bbox_head
    with torch.no_grad():
        cls, _, anchors = head._flatten(head(model.extract_feat(images)))
        gt_h = rbox_to_hbox(targets["gt_bboxes"])
        tgt, _, _ = anchor_target_batch(
            anchors, torch.ones(len(anchors), dtype=torch.bool), gt_h, targets["gt_mask"],
            targets["gt_labels"], target_means=head.target_means, target_stds=head.target_stds,
            assigner_cfg=dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.0), rotated=False)
        lbl = torch.where(tgt["labels"] > 0, tgt["labels"] - 1, head.num_classes).long()
        ce = -torch.gather(torch.log_softmax(cls, -1), -1, lbl[..., None])[..., 0]
    a, g = anchors.double(), gt_h.double()
    lt = torch.maximum(a[None, None, :, :2], g[:, :, None, :2])
    rb = torch.minimum(a[None, None, :, 2:], g[:, :, None, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area = lambda b: (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])  # noqa: E731
    iou = inter / (area(a)[None, None] + area(g)[:, :, None] - inter)
    thr_gap = (iou - 0.5).abs()[targets["gt_mask"]].min().item()
    neg_gap = 1.0
    for b in range(ce.shape[0]):
        neg = torch.sort(ce[b][tgt["neg_mask"][b]], descending=True).values
        k = head.neg_pos_ratio * max(int(tgt["pos_mask"][b].sum()), 1)
        neg_gap = min(neg_gap, ((neg[k - 1] - neg[k]) / neg[k - 1]).item())
    return thr_gap, neg_gap


def ssd_nms_candidates(model, images):
    """The per-class candidates that SSD's `predict` hands K1's matrix
    route, as `multiclass_nms_rotated` builds them: (B * 80, 512, 5)
    axis-aligned rboxes (the classes' top 512 by score, -inf scores
    parked) and their validity."""
    from jdet_torch.ops.box_convert import delta2hbox, hbox_to_rbox
    from jdet_torch.ops.topk import stable_topk

    head, cfg = model.bbox_head, model.bbox_head.test_cfg
    with torch.no_grad():
        cls, reg, anchors = head._flatten(head(model.extract_feat(images)))
        scores = torch.softmax(cls, -1)[..., :head.num_classes]
        _, topk = stable_topk(scores.amax(-1), min(cfg["nms_pre"], anchors.shape[0]))
        scores = torch.gather(scores, 1, topk[..., None].expand(-1, -1, scores.shape[-1]))
        deltas = torch.gather(reg, 1, topk[..., None].expand(-1, -1, 4))
        boxes = hbox_to_rbox(delta2hbox(anchors[topk], deltas, head.target_means,
                                        head.target_stds))
        B, n, C = scores.shape
        K = min(n, 512)
        sT = torch.where(scores > cfg["score_thr"], scores, float("-inf")).transpose(1, 2)
        top_s, top_i = stable_topk(sT, K)
        b = torch.gather(boxes[:, None].expand(B, C, n, 5), 2,
                         top_i[..., None].expand(B, C, K, 5))
    return b.reshape(B * C, K, 5).contiguous(), torch.isfinite(top_s).reshape(B * C, K)


def hbb_self_iou(rboxes):
    """The exact IoU (float64) of axis-aligned rboxes (theta 0 or pi/2)
    against each other: (M, K, 5) -> (M, K, K)."""
    r = rboxes.double()
    swap = (r[..., 4].abs() > 1.0)[..., None]
    wh = torch.where(swap, r[..., [3, 2]], r[..., 2:4])
    lo, hi = r[..., :2] - wh / 2, r[..., :2] + wh / 2
    inter = (torch.minimum(hi[:, :, None], hi[:, None]) - torch.maximum(lo[:, :, None], lo[:, None])
             ).clamp(min=0).prod(-1)
    area = wh.prod(-1)
    return inter / (area[:, :, None] + area[:, None] - inter)


def check_ssd_iou_kernel(rik, model):
    """K1's matrix route on SSD's real candidates at B=8: (640, 512, 512)
    axis-aligned boxes, many with shared or coinciding edges (decoded
    from one anchor grid). Against its plain version and against the exact
    hbb IoU; on the pairs of valid candidates whose exact IoU lies more
    than 1e-4 from `nms_iou_thr` (0.45), K1 takes the NMS's decision of
    the exact IoU. Timed against the plain version, with its bound.
    Returns the numbers for K1's entry of the kernels line."""
    images = torch.as_tensor(ssd_batch(8, seed=11)[0], device="cuda")
    cand, valid = ssd_nms_candidates(model, images)
    M, K = cand.shape[:2]
    got = rik.box_iou_rotated_rect(cand, cand)

    def plain():  # the plain version's pair-shaped temporaries, 80 classes at a time
        return torch.cat([rik.box_iou_rotated_rect_reference(c, c) for c in cand.split(80)])

    want = plain()
    torch.cuda.synchronize()
    err_plain = (got - want).abs().max().item()
    del want
    pair = valid[:, :, None] & valid[:, None, :]
    thr = model.bbox_head.test_cfg["nms_iou_thr"]
    err_exact, near, flips, n_pairs = 0.0, 0, 0, int(pair.sum())
    for lo in range(0, M, 40):  # the exact IoU in float64, 40 classes at a time
        exact = hbb_self_iou(cand[lo:lo + 40])
        p = pair[lo:lo + 40]
        g = got[lo:lo + 40].double()
        err_exact = max(err_exact, (g - exact)[p].abs().max().item() if p.any() else 0.0)
        decisive = p & ((exact - thr).abs() > 1e-4)
        near += int((p & ~decisive).sum())
        flips += int(((g > thr) != (exact > thr))[decisive].sum())
    log(f"SSD NMS self-IoU on K1 ({M}, {K}, {K}): {int(valid.sum())} valid candidates, "
        f"{n_pairs} valid pairs; max_abs_err vs plain {err_plain:.3e}, vs exact hbb IoU "
        f"{err_exact:.3e}; {near} pairs within 1e-4 of {thr}, decisions flipped on the "
        f"others: {flips}")
    check(err_plain <= 2e-4 and err_exact <= 2e-4 and flips == 0,
          f"K1 on SSD's candidates: {err_plain}, {err_exact}, {flips} flipped decisions")
    check(int(valid.sum()) >= 100 * 8, "SSD's candidates: fewer than 100 per image")
    ms = median_ms(lambda: rik.box_iou_rotated_rect(cand, cand))
    plain_ms = median_ms(plain, warmup=1, iters=3)
    nbytes = (2 * M * K * 5 + M * K * K) * 4
    touching = touching_pairs(cand, cand)
    bound_ms, bound_by = bound(nbytes, IOU_FLOPS_PER_TOUCHING_PAIR * touching)
    log(f"SSD NMS self-IoU ({M}, {K}, {K}): K1 {ms:.4f} ms, plain version {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} (bytes {nbytes}, {touching} touching pairs)")
    return {"ssd_shape": [M, K, K], "ssd_ms": ms, "ssd_plain_ms": plain_ms,
            "ssd_bound_ms": bound_ms, "ssd_bound_by": bound_by,
            "ssd_max_abs_err": max(err_plain, err_exact)}


def ssd_trainer(cfg, model):
    """The config's SGD (lr 2e-3, momentum 0.9, weight decay 5e-4, no
    clipping) with its StepLR warmup, and the train step on host-normalized
    images (SSD's config normalizes on the host)."""
    from jdet_torch.optim import build_lr_schedule, build_optimizer
    from jdet_torch.parallel import build_train_step

    ocfg, scfg = cfg["optimizer"], cfg["scheduler"]
    schedule = build_lr_schedule(
        ocfg["lr"], scheduler_type=scfg["type"], milestones=scfg["milestones"],
        gamma=scfg.get("gamma", 0.1), steps_per_epoch=STEPS_PER_EPOCH,
        max_steps=cfg["max_epoch"] * STEPS_PER_EPOCH, warmup=scfg["warmup"],
        warmup_iters=scfg["warmup_iters"], warmup_ratio=scfg["warmup_ratio"])
    opt = build_optimizer(model, opt_type=ocfg["type"], lr_schedule=schedule,
                          momentum=ocfg["momentum"], weight_decay=ocfg["weight_decay"],
                          grad_clip=ocfg.get("grad_clip"))
    return build_train_step(model, opt), opt


def ssd_card_against_cpu(cfg, rik):
    """SSD300 on the card against the CPU, the same drawn weights, B=2 at
    300² on a batch without near ties (`ssd_margins` above 1e-6 and 1e-4):
    the
    float32 loss forward (rtol 1e-4), `predict` on the card's head outputs
    on both devices (the same detections: matched boxes, counts, scores
    within 1e-5) and each device's own `predict` as sets, then 2 SGD steps
    (losses rtol 1e-4, every parameter within 1e-4 of its tensor's
    largest). Then the bf16 model on the card against the CPU's, B=1:
    the losses and the head's class and box outputs within this run's
    f32 - bf16 gap."""
    from jdet_torch.models.builder import build_detector
    from jdet_torch.models.nn import compute_dtype_scope

    cpu = build_detector(cfg["model"], device="cpu", seed=0, load_pretrained=False)
    draw_ssd_weights(cpu)
    card = build_detector(cfg["model"], device="cuda", seed=0, load_pretrained=False)
    card.load_state_dict(cpu.state_dict())
    seed = next(s for s in range(20) if np.all(np.greater(ssd_margins(
        cpu, *to_device(*ssd_batch(2, seed=s), "cpu")), (1e-6, 1e-4))))
    images, targets = ssd_batch(2, seed=seed)
    out = {}
    for name, m in (("cpu", cpu), ("card", card)):
        x, t = to_device(images, targets, "cpu" if m is cpu else "cuda")
        losses = {k: v.item() for k, v in m.loss(x, t).items()}
        with torch.no_grad():
            outs = m.bbox_head(m.extract_feat(x))
            det = {k: v.cpu() for k, v in m.predict(x).items()}
        out[name] = (losses, det, outs)
    for k, v in out["cpu"][0].items():
        check(abs(out["card"][0][k] - v) <= 1e-4 * abs(v), f"SSD {k}: card {out['card'][0][k]} "
              f"cpu {v}")
    card_outs = [tuple(o.cpu() for o in lvl) for lvl in out["card"][2]]
    with torch.no_grad():
        on_cpu = {k: v.cpu() for k, v in cpu.bbox_head.predict(card_outs).items()}
        on_card = {k: v.cpu() for k, v in card.bbox_head.predict(out["card"][2]).items()}
    same = as_sets(on_card, on_cpu, matched_scores=True)
    own = as_sets(out["card"][1], out["cpu"][1], rel=1e-4)
    log(f"SSD card vs cpu at 300², B=2 (batch seed {seed}): losses card {out['card'][0]} cpu "
        f"{out['cpu'][0]}; predict on the card's head outputs (matched share, counts, score "
        f"err) {same}; each device's own predict {own}")
    check(same[0] == 1.0 and same[1][0] == same[1][1] >= 200 and same[2] <= 1e-5,
          f"SSD predict on the same head outputs: {same}")
    check(own[0] >= 0.95 and abs(own[1][0] - own[1][1]) <= 0.05 * own[1][1],
          f"SSD predict, each device's own: {own}")
    start = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    steps = {}
    for name, m in (("cpu", cpu), ("card", card)):
        step, _ = ssd_trainer(cfg, m)
        x, t = to_device(images, targets, "cpu" if m is cpu else "cuda")
        steps[name] = [{k: v.item() for k, v in step(x, t, it).items()} for it in range(2)]
    worst = 0.0
    for (n, p), q in zip(cpu.named_parameters(), card.parameters()):
        worst = max(worst, ((q.detach().cpu() - p.detach()).abs().max()
                            / p.detach().abs().max().clamp(min=1e-30)).item())
    moved = max((p.detach() - start[n]).abs().max().item() for n, p in cpu.named_parameters())
    log(f"SSD 2 SGD steps card vs cpu: losses card {steps['card']} cpu {steps['cpu']}, "
        f"worst parameter error {worst:.3e} of its tensor's largest (largest change {moved:.3e})")
    for a, b in zip(steps["card"], steps["cpu"]):
        check(all(abs(a[k] - b[k]) <= 1e-4 * abs(b[k]) for k in b), "SSD steps' losses differ")
    check(worst <= 1e-4 and moved > 0, f"SSD steps: parameters {worst} apart")
    del cpu, card
    torch.cuda.empty_cache()

    # bf16: the card's and the CPU's bf16 models within the f32 - bf16 gap
    models = {}
    for name, dev, dtype in (("bf16_card", "cuda", torch.bfloat16),
                             ("bf16_cpu", "cpu", torch.bfloat16), ("f32_card", "cuda", None)):
        with compute_dtype_scope(dtype):
            models[name] = build_detector(cfg["model"], device=dev, seed=0,
                                          load_pretrained=False)
    draw_ssd_weights(models["bf16_cpu"], seed=5)
    for name in ("bf16_card", "f32_card"):
        models[name].load_state_dict(models["bf16_cpu"].state_dict())
    images1, targets1 = ssd_batch(1, seed=seed)
    res = {}
    for name, m in models.items():
        x, t = to_device(images1, targets1, "cpu" if name == "bf16_cpu" else "cuda")
        losses = torch.tensor([v.item() for v in m.loss(x, t).values()], dtype=torch.float64)
        with torch.no_grad():
            outs = m.bbox_head(m.extract_feat(x))
        res[name] = (losses, [torch.cat([lvl[i].float().flatten().cpu() for lvl in outs])
                              for i in (0, 1)])

    def rms(a):
        return float(torch.sqrt(torch.mean(torch.as_tensor(a, dtype=torch.float64) ** 2)))

    c, p, f = (res[k] for k in ("bf16_card", "bf16_cpu", "f32_card"))
    fractions = {"losses": rms(c[0] - p[0]) / rms(f[0] - p[0]),
                 "class outputs": rms(c[1][0] - p[1][0]) / rms(f[1][0] - p[1][0]),
                 "box outputs": rms(c[1][1] - p[1][1]) / rms(f[1][1] - p[1][1])}
    log(f"SSD bf16 card vs cpu at 300², B=1: losses card {c[0].tolist()} cpu {p[0].tolist()} "
        f"f32 {f[0].tolist()}; |card - cpu| over the f32 - bf16 gap: {json.dumps(fractions)}")
    for what, frac in fractions.items():
        check(frac <= BF16_GAP_FACTOR, f"SSD bf16 card vs cpu, {what}: {frac:.3f} of the gap")
    del models
    torch.cuda.empty_cache()


def ssd_serving_phase(model, rik, label, B=8, brief=False):
    """SSD's loss forward and `predict` at the config's val batch (B=8,
    300²), once with the launch counters read around them (one K1 matrix
    launch per `predict`, nothing in the loss), then timed."""
    x, t = to_device(*ssd_batch(B, seed=3), "cuda")
    torch.cuda.synchronize()
    reset_launch_counts(rik)
    model.train()
    losses = {k: v.item() for k, v in model.loss(x, t).items()}
    model.eval()
    torch.cuda.synchronize()
    loss_launches = launch_counts(rik)
    with torch.no_grad():
        det = model.predict(x)
    torch.cuda.synchronize()
    launches = launch_counts(rik)
    check(sum(loss_launches.values()) == 0, f"{label} SSD loss forward launched {loss_launches}")
    check(launches["rotated_iou_rect"] == 1 and sum(launches.values()) == 1,
          f"{label} SSD predict: not one K1 matrix launch: {launches}")
    valid = det["valid"].sum(1).tolist()
    check(all(np.isfinite(v) and v > 0 for v in losses.values()), f"SSD losses {losses}")
    check(det["boxes"].shape == (B, 200, 5) and min(valid) > 0
          and all(torch.isfinite(det[k][det["valid"]]).all().item()
                  for k in ("boxes", "scores", "polys"))
          and ((det["labels"][det["valid"]] >= 0) & (det["labels"][det["valid"]] < 80)).all(),
          f"{label} SSD predict: valid {valid}")

    def loss_fwd():
        model.train()
        out = model.loss(x, t)
        model.eval()
        return out

    head = model.bbox_head
    with torch.no_grad():
        outs = head(model.extract_feat(x))
        times = {"loss_forward_ms": median_ms(loss_fwd, *timing(brief)),
                 "predict_ms": median_ms(lambda: model.predict(x), *timing(brief)),
                 "network_forward_no_grad_ms": median_ms(
                     lambda: head(model.extract_feat(x)), *timing(brief)),
                 "head_predict_ms": median_ms(lambda: head.predict(outs), *timing(brief))}
    log(f"{label} SSD300 at B={B}: losses {losses}, valid per image {valid}, "
        f"{json.dumps(times)}")
    return launches


def ssd_train_phase(cfg, model, rik, label, B=32, n_steps=5):
    """`n_steps` train steps at the config's traffic (B=32, 300², 32 gt
    slots with 8 real), the launch counters read around them (nothing),
    then the step timed (median ms), its parts (the loss forward, the
    backward, the optimizer), its device busy share and busiest kernels
    over 3 profiled steps, and its peak memory."""
    step, opt = ssd_trainer(cfg, model)
    x, t = to_device(*ssd_batch(B, seed=1), "cuda")
    model.train()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(rik)
    logs = [{k: v.item() for k, v in step(x, t, it).items()} for it in range(n_steps)]
    torch.cuda.synchronize()
    launches = launch_counts(rik)
    peak = torch.cuda.max_memory_allocated()
    check(sum(launches.values()) == 0, f"{label} SSD train: launches {launches}")
    check(all(np.isfinite(v) for lv in logs for v in lv.values()), f"{label} SSD losses {logs}")
    it = iter(range(n_steps, 10 ** 6))
    times = {"step_ms": median_ms(lambda: step(x, t, next(it)), 2, 10)}

    def fwd():
        return sum(model.loss(x, t).values())

    times["loss_forward_ms"] = median_ms(fwd, 2, 5)

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        fwd().backward()

    times["forward_backward_ms"] = median_ms(fwd_bwd, 2, 5)
    times["backward_ms"] = times["forward_backward_ms"] - times["loss_forward_ms"]
    times["optimizer_ms"] = median_ms(opt.step, 2, 5)
    kernels, device_ms, wall_ms = device_profile(lambda: step(x, t, next(it)), iters=3)
    times.update(profiled_step_device_ms=device_ms, profiled_step_wall_ms=wall_ms,
                 device_busy_share=device_ms / wall_ms, peak_memory_bytes=peak)
    log(f"{label} SSD300 train at B={B}, 300²: losses {[round(lv['total_loss'], 4) for lv in logs]}"
        f"; {json.dumps(times)}")
    log(f"{label} SSD300 step, the 8 busiest kernels, device ms: "
        + json.dumps(dict(list(kernels.items())[:8])))
    model.zero_grad(set_to_none=True)
    model.eval()
    return launches


def ssd_phases(rik):
    """SSD300-VGG16 from `configs/ssd300_coco.py` at full width (VGG16,
    300², 80 classes) with weights drawn from a seed (`draw_ssd_weights`):
    card against CPU (`ssd_card_against_cpu`), K1 on its real candidates
    (`check_ssd_iou_kernel`), the serving path at B=8 and 5 train steps
    at B=32 in float32 and bf16. Returns (K1's SSD numbers, the launches
    of each path)."""
    from jdet_torch.models.builder import build_detector
    from jdet_torch.models.nn import compute_dtype_scope

    cfg = ssd_config()
    model = build_detector(cfg["model"], device="cuda", seed=0, load_pretrained=False)
    head = model.bbox_head
    n_anchors = head.anchors([(s, s) for s in (38, 19, 10, 5, 3, 1)], "cuda").shape[0]
    check(type(model).__name__ == "SSD" and type(model.backbone).__name__ == "SSDVGG"
          and tuple(model.backbone.fc6.weight.shape) == (1024, 512, 3, 3)
          and model.neck.out_channels == [512, 1024, 512, 256, 256, 256]
          and head.num_classes == 80 and n_anchors == 8732
          and tuple(head.cls_convs[0].weight.shape) == (4 * 81, 512, 3, 3),
          "SSD is not SSD300-VGG16 with 80 classes")
    draw_ssd_weights(model)
    log(f"SSD300 model: {sum(p.numel() for p in model.parameters())} parameters, "
        f"{n_anchors} anchors")
    ssd_card_against_cpu(cfg, rik)
    elapsed("SSD card vs cpu")
    k1 = check_ssd_iou_kernel(rik, model)
    paths = {"ssd_serving": ssd_serving_phase(model, rik, "fp32"),
             "ssd_train_5_steps": ssd_train_phase(cfg, model, rik, "fp32")}
    state = model.state_dict()
    del model, head
    torch.cuda.empty_cache()
    with compute_dtype_scope(torch.bfloat16):
        model = build_detector(cfg["model"], device="cuda", seed=0, load_pretrained=False)
    model.load_state_dict(state)
    paths["ssd_bf16_serving"] = ssd_serving_phase(model, rik, "bf16")
    paths["ssd_bf16_train_5_steps"] = ssd_train_phase(cfg, model, rik, "bf16")
    del model, state
    torch.cuda.empty_cache()
    elapsed("the SSD phases")
    return k1, paths


def codec_phase():
    """Every fixture of `tests/data/torch_codecs/` decoded by the port's
    JPEG and TIFF readers (no cv2 here) to the SHA-256 digest that
    `tests/make_codec_fixtures.py` took from cv2; then the decode of a
    640x480 4:2:0 JPEG and of the 1000x1000 LZW TIFF timed (median ms of
    20, the files in the page cache)."""
    import hashlib

    from jdet_torch.data import image_codecs, image_io

    t0 = time.perf_counter()
    image_codecs.build()
    build_s = time.perf_counter() - t0
    with open(CODEC_FIXTURES / "digests.json") as f:
        digests = json.load(f)
    for name, want in digests.items():
        image = image_io.imread(str(CODEC_FIXTURES / name))
        got = hashlib.sha256(np.ascontiguousarray(image).tobytes()).hexdigest()
        check(got == want["sha256"] and list(image.shape) == want["shape"],
              f"{name} does not decode to cv2's pixels")

    def ms_per_image(path, n=20):
        times = []
        for _ in range(n + 2):
            t = time.perf_counter()
            image_io.imread(str(path))
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times[2:]))

    times = {"jpeg_420_640x480_ms": ms_per_image(CODEC_FIXTURES / "baseline_420_640x480.jpg"),
             "tiff_lzw_1000x1000_ms": ms_per_image(
                 CODEC_FIXTURES / "lzw_predictor_1000x1000.tif"),
             "library_build_s": build_s}
    log(f"codecs: {len(digests)} fixtures decode to cv2's digests; {json.dumps(times)}")
    return times


def coco_runner_phase(rik, root, copies=3, B=4):
    """The Runner on a COCO-style tree written over the JPEG fixtures
    (`copies` of each, `make_coco_tree`: 80 categories on sparse ids): one
    epoch of SSD300 with the config's whole augmentation stack
    (PhotoMetricDistortion, Expand, MinIoURandomCrop, Resize, RandomFlip,
    Normalize) and its val through `COCODataset.evaluate`, 2 spawned
    loader workers. Reports the iteration times and loader wait, and the
    JPEG decode ms. One K1 matrix launch per val batch, nothing in
    training."""
    import copy
    import shutil

    from jdet_torch.data import image_io
    from jdet_torch.data.synthetic import make_coco_tree
    from jdet_torch.runner import Runner

    shutil.rmtree(root, ignore_errors=True)
    jpegs = sorted(str(p) for p in CODEC_FIXTURES.glob("*.jpg"))
    img_dir, ann = make_coco_tree(str(root), jpegs * copies, seed=0)
    cfg = copy.deepcopy(ssd_config())
    for split in ("train", "val", "test"):
        d = cfg["dataset"][split]
        check(d.pop("anno_file", None) is not None, "the config no longer sets anno_file")
        d.update(annotations_file=ann, images_dir=img_dir, num_workers=2, batch_size=B)
    cfg.update(name="coco_smoke", work_dir=str(root / "work"), max_epoch=1, eval_interval=1,
               checkpoint_interval=1, log_interval=1)
    runner = Runner(cfg, device="cuda")
    draw_ssd_weights(runner.model)
    logged = []
    real_log = runner.logger.log
    runner.logger.log = lambda d: (logged.append(d), real_log(d))
    n_images = len(runner.train_dataset)
    iters = n_images // B
    torch.cuda.synchronize()
    reset_launch_counts(rik)
    t0 = time.perf_counter()
    runner.train_epoch()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = launch_counts(rik)
    t0 = time.perf_counter()
    runner.val()
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    launches = launch_counts(rik)
    losses = [d for d in logged if "total_loss" in d]
    evals = [d for d in logged if "eval/coco_mAP" in d]
    n_val = -(-len(runner.val_dataset) // B)
    check(len(losses) == iters and all(np.isfinite(d["total_loss"]) for d in losses),
          f"COCO runner: {len(losses)} logged iterations of {iters}, or a non-finite loss")
    check(len(evals) == 1 and len([k for k in evals[0] if k.startswith("eval/coco_")]) == 9
          and all(0.0 <= v <= 1.0 for k, v in evals[0].items() if k.startswith("eval/coco_")),
          f"COCO val: {evals}")
    check(sum(train_launches.values()) == 0 and launches["rotated_iou_rect"] == n_val
          and sum(launches.values()) == n_val,
          f"COCO runner: {train_launches} in training, {launches} after val ({n_val} batches)")
    its = runner.iteration_times[-1]
    decode = []
    for path in jpegs:
        t = time.perf_counter()
        image_io.imread(path)
        decode.append((time.perf_counter() - t) * 1e3)
    times = {"images": n_images, "iterations": iters, "train_epoch_s": train_s, "val_s": val_s,
             "iteration_ms_median": 1e3 * float(np.median([t for _, t in its])),
             "loader_wait_ms_median": 1e3 * float(np.median([w for w, _ in its])),
             "loader_wait_ms_mean": 1e3 * float(np.mean([w for w, _ in its])),
             "jpeg_decode_ms_per_fixture": decode}
    log(f"COCO from disk, SSD300 B={B}: losses {[round(d['total_loss'], 4) for d in losses]}, "
        f"val {json.dumps({k: v for k, v in evals[0].items() if k.startswith('eval/')})}; "
        f"{json.dumps(times)}")
    runner.close()
    return launches


def convert_phase(root):
    """The `convert` step of the committed SSDD+ and FAIR1M-1.5 configs
    through `python -m jdet_torch.tools.preprocess`, each config's paths
    pointed at source trees written here over the codec fixtures (SSDD+:
    the JPEGs and XML with rotated boxes; FAIR1M: the TIFFs and FAIR XML),
    then FAIR1M's tiling at the config's 1024 / 200; then a FAIR1M-1.5
    submission csv through `python -m jdet_torch.tools.merge_results` from
    a test pkl of tile detections drawn from a seed."""
    import shutil

    from jdet_torch.data.synthetic import make_fair_tree, make_ssdd_tree

    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    jpegs = sorted(str(p) for p in CODEC_FIXTURES.glob("*.jpg"))
    tiffs = sorted(str(p) for p in CODEC_FIXTURES.glob("*.tif"))
    img_dir, ann_dir = make_ssdd_tree(str(root / "ssdd_plus"), jpegs, seed=0)
    fair_src = str(root / "fair1m")
    make_fair_tree(fair_src, tiffs, seed=1)
    ssdd_out, fair_dota, fair_tiles = (str(root / n) for n in ("ssdd_dota", "fair_dota",
                                                               "fair_tiles"))
    # the SSDD+ config inherits the DOTA base's tiling tasks, which SSDD
    # does not need (its converter resizes to 512): they are emptied
    configs = {
        "ssdd_plus.py": (SSDD_PLUS_CONFIG, (
            f"preprocess = dict(convert=dict(tasks=[dict(image_dir={img_dir!r}, "
            f"label_dir={ann_dir!r}, out_dir={ssdd_out!r})]), tasks=[])\n")),
        "fair1m.py": (FAIR1M_CONFIG, (
            f"preprocess = dict(convert=dict(tasks=[dict(in_dir={fair_src!r}, "
            f"out_dir={fair_dota!r})]), tasks=[dict(image_dir={fair_dota + '/images'!r}, "
            f"label_dir={fair_dota + '/labelTxt'!r}, out_dir={fair_tiles!r})])\n")),
    }
    times = {}
    for name, (base, body) in configs.items():
        path = root / name
        path.write_text(f"_base_ = [{str(base)!r}]\n" + body)
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "jdet_torch.tools.preprocess", "--config-file",
                        str(path)], check=True, cwd=str(ROOT), timeout=600)
        times[f"{name}_s"] = time.perf_counter() - t0
    with open(os.path.join(ssdd_out, "labels.pkl"), "rb") as f:
        ssdd = pickle.load(f)
    pngs = sorted(os.listdir(os.path.join(ssdd_out, "images")))
    check(len(pngs) == len(jpegs) and len(ssdd) > 0 and all(
        (r["width"], r["height"]) == (512, 512) for r in ssdd),
        f"SSDD+ convert: {len(pngs)} images, {len(ssdd)} records")
    with open(os.path.join(fair_tiles, "labels.pkl"), "rb") as f:
        fair = pickle.load(f)
    dota_pngs = sorted(os.listdir(os.path.join(fair_dota, "images")))
    check(dota_pngs == [f"P{i:04d}.png" for i in range(1, len(tiffs) + 1)] and len(fair) > 0
          and all((r["width"], r["height"]) == (1024, 1024) for r in fair),
          f"FAIR1M convert: {dota_pngs}, {len(fair)} tile records")
    # a FAIR1M-1.5 submission from tile detections
    rng = np.random.RandomState(2)
    results = []
    for r in fair:
        n = 16
        results.append(({"polys": rng.uniform(0, 1024, (n, 8)).astype(np.float32),
                         "scores": rng.rand(n).astype(np.float32),
                         "labels": rng.randint(0, 10, n), "valid": rng.rand(n) < 0.8},
                        {"filename": r["filename"]}))
    pkl = root / "test_1.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(results, f)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "jdet_torch.tools.merge_results", "--results",
                    str(pkl), "--out-dir", str(root / "merged"), "--dataset-type",
                    "FAIR1M_1_5", "--name", "fair1m"], check=True, cwd=str(ROOT), timeout=600)
    times["merge_results_s"] = time.perf_counter() - t0
    lines = (root / "merged" / "fair1m.csv").read_text().splitlines()
    check(len(lines) > 0 and all(len(line.split(",")) == 11 and line.split(",")[0].endswith(".tif")
                                 for line in lines), f"FAIR1M csv: {lines[:2]}")
    log(f"convert: SSDD+ {len(pngs)} images / {len(ssdd)} records at 512²; FAIR1M "
        f"{len(dota_pngs)} scenes -> {len(fair)} tiles; csv {len(lines)} lines; "
        f"{json.dumps(times)}")



def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-generic", metavar="CU", action="append", default=[],
                    help="another copy of rotated_iou.cu whose generic kernel is "
                         "timed against the checkout's in turns (repeatable)")
    args = ap.parse_args()
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
    from jdet_torch.models.nn import compute_dtype_scope
    from jdet_torch.ops import polygon_native
    from jdet_torch.ops import rotated_iou_kernel as rik

    # both libraries at once: nvcc for the kernels, g++ for the polygon
    # library the evaluation and the merge run on
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(b) for b in (rik.build, polygon_native.build)]
        lib, poly_lib = (b.result() for b in builds)
    log(f"build: {time.perf_counter() - t0:.2f} s ({lib._name}, {poly_lib._name})")
    log(Path(lib._name).with_suffix(".log").read_text().strip())

    full_cfg = load_cfg_file(CONFIG)
    cfg = full_cfg["model"]
    model = build_detector(cfg, device="cuda", seed=0, load_pretrained=False)
    head = model.bbox_head
    check(model.backbone.depth == 50 and model.neck.out_channels == 256
          and len(head.cls_convs) == 4 and head.num_anchors == 9
          and head.cls_out_channels == 15, "model is not R50-FPN at full width")
    log(f"model: {sum(p.numel() for p in model.parameters())} parameters")

    entry = check_iou_kernel(rik, head)
    anchors = head._flat_anchors([(1024 // st, 1024 // st) for st in head.anchor_strides],
                                 "cuda")
    assign_entry = check_assign_kernel(rik, anchors)
    elapsed('check_assign_kernel')
    generic_entry, generic_gts = check_generic_kernel(rik, anchors, args.old_generic)
    elapsed('check_generic_kernel')

    cpu_model = build_detector(cfg, device="cpu", seed=0, load_pretrained=False)
    check_card_against_cpu(model, cpu_model)
    elapsed('check_card_against_cpu')
    del cpu_model

    serving_launches = serving_phase(model, rik, "fp32")
    elapsed('serving_phase')

    # K2's path: its entry point on the main path's operands, once
    from jdet_torch.ops import box_iou_rotated_generic

    torch.cuda.synchronize()
    reset_launch_counts(rik)
    iou = box_iou_rotated_generic(generic_gts, anchors)
    torch.cuda.synchronize()
    generic_launches = launch_counts(rik)
    log(f"generic iou path: launches {generic_launches}, output {tuple(iou.shape)}")
    check(generic_launches["rotated_iou_generic"] == 1, "the entry point did not launch K2")
    check(iou.shape == (2, 32, 196416) and torch.isfinite(iou).all().item()
          and ((iou >= 0) & (iou <= 1 + 1e-5)).all().item(), "K2's entry point: bad IoU")
    del iou

    check_train_card_against_cpu(full_cfg, rik)
    elapsed('check_train_card_against_cpu')
    train_launches = train_at_config_traffic(full_cfg, model, rik, "fp32")
    elapsed('train_at_config_traffic')
    del model, head

    # the same paths under the bf16 policy, the precision of the
    # reference's training and benchmark entry points
    check_bf16_card_against_cpu(full_cfg, rik)
    elapsed('check_bf16_card_against_cpu')
    with compute_dtype_scope(torch.bfloat16):
        bf16_model = build_detector(cfg, device="cuda", seed=0, load_pretrained=False)
    bf16_serving_launches = serving_phase(bf16_model, rik, "bf16")
    bf16_train_launches = train_at_config_traffic(full_cfg, bf16_model, rik, "bf16")
    elapsed('train_at_config_traffic')
    del bf16_model
    torch.cuda.empty_cache()

    # S2ANet R50-FPN at full width: its kernel route (the fused assigner on
    # per-image refined anchors), its AlignConv and ORConv, then its paths
    # in float32 and bf16
    s2a_cfg = load_cfg_file(S2ANET_CONFIG)
    s2a = build_detector(s2a_cfg["model"], device="cuda", seed=0, load_pretrained=False)
    head = s2a.bbox_head
    check(type(s2a).__name__ == "S2ANet" and s2a.backbone.depth == 50
          and s2a.neck.out_channels == 256 and len(head.fam_cls_convs) == 2
          and len(head.odm_reg_convs) == 2 and head.cls_out_channels == 15
          and tuple(head.or_conv.weight.shape) == (32, 256, 1, 3, 3)
          and tuple(head.align_conv.deform_conv.weight.shape) == (256, 256, 3, 3),
          "S2ANet is not R50-FPN at full width")
    log(f"S2ANet model: {sum(p.numel() for p in s2a.parameters())} parameters")
    per_image_entry, (images, _, anchors) = check_assign_per_image_kernel(rik, s2a, s2a_cfg)
    elapsed('check_assign_per_image_kernel')
    from jdet_torch.parallel import make_device_normalizer

    check_align_and_orconv(s2a, make_device_normalizer(**s2a_cfg["device_normalize"])(
        torch.as_tensor(images, device="cuda")), anchors)
    del images, anchors
    check_s2anet_card_against_cpu(s2a_cfg, rik)
    elapsed('check_s2anet_card_against_cpu')
    s2a_serving_launches = serving_phase(s2a, rik, "fp32", brief=True)
    s2a_train_launches = train_at_config_traffic(s2a_cfg, s2a, rik, "fp32", n_steps=5, brief=True)
    elapsed('train_at_config_traffic')
    del s2a, head
    check_bf16_card_against_cpu(s2a_cfg, rik)
    with compute_dtype_scope(torch.bfloat16):
        s2a_bf16 = build_detector(s2a_cfg["model"], device="cuda", seed=0, load_pretrained=False)
    s2a_bf16_serving_launches = serving_phase(s2a_bf16, rik, "bf16", brief=True)
    s2a_bf16_train_launches = train_at_config_traffic(s2a_cfg, s2a_bf16, rik, "bf16",
                                                      n_steps=5, brief=True)
    elapsed('train_at_config_traffic')
    del s2a_bf16
    torch.cuda.empty_cache()
    run_net_launches, _ = run_net_phase(rik, rik.BUILD_DIR / "s2anet_run_net")
    elapsed('run_net_phase')

    # Oriented R-CNN R50-FPN at full width: its kernel route (the fused
    # assigner on per-image proposals with per-image masks), card against
    # CPU, then its paths in float32 and bf16, at B=4 and at B=16
    orcnn_cfg = load_cfg_file(ORCNN_CONFIG)
    orcnn = build_detector(orcnn_cfg["model"], device="cuda", seed=0, load_pretrained=False)
    rpn, head = orcnn.rpn_head, orcnn.bbox_head
    check(is_orcnn(orcnn) and orcnn.backbone.depth == 50 and orcnn.neck.out_channels == 256
          and len(orcnn.neck.extra_convs) == 0 and (rpn.nms_pre, rpn.nms_post) == (2000, 2000)
          and rpn.num_anchors == 3 and tuple(head.shared_fcs[0].weight.shape) == (1024, 12544)
          and tuple(head.fc_cls.weight.shape) == (16, 1024)
          and head.train_cfg["sampler"]["num"] == 512,
          "Oriented R-CNN is not R50-FPN at full width")
    log(f"Oriented R-CNN model: {sum(p.numel() for p in orcnn.parameters())} parameters")
    roi_entry = check_assign_roi_kernel(rik, orcnn, orcnn_cfg)
    elapsed('check_assign_roi_kernel')
    check_rcnn_card_against_cpu(orcnn_cfg, rik)
    elapsed('check_rcnn_card_against_cpu')
    orcnn_serving_launches = rcnn_serving_phase(orcnn, rik, "fp32", brief=True)
    orcnn_train_launches = train_at_config_traffic(orcnn_cfg, orcnn, rik, "fp32",
                                                   n_steps=5, brief=True)
    orcnn_step_parts(orcnn_cfg, orcnn, "fp32")
    orcnn_b16_launches = train_large_batch(orcnn_cfg, orcnn, rik, "fp32", n_steps=3)
    elapsed('train_large_batch')
    del orcnn, rpn, head
    torch.cuda.empty_cache()
    with compute_dtype_scope(torch.bfloat16):
        orcnn_bf16 = build_detector(orcnn_cfg["model"], device="cuda", seed=0,
                                    load_pretrained=False)
    orcnn_bf16_serving_launches = rcnn_serving_phase(orcnn_bf16, rik, "bf16", brief=True)
    orcnn_bf16_train_launches = train_at_config_traffic(orcnn_cfg, orcnn_bf16, rik, "bf16",
                                                        n_steps=5, brief=True)
    orcnn_bf16_b16_launches = train_large_batch(orcnn_cfg, orcnn_bf16, rik, "bf16", n_steps=3)
    elapsed('train_large_batch bf16')
    del orcnn_bf16
    torch.cuda.empty_cache()
    orcnn_run_net_launches, _ = run_net_phase(
        rik, rik.BUILD_DIR / "orcnn_run_net", ORCNN_CONFIG,
        {"max_iou_assign_rect": 0, "max_iou_assign_rect_per_image": 1,
         "max_iou_assign_rect_per_image_masked": 1})
    elapsed("the Oriented R-CNN run_net phase")

    redet_entry, redet_paths = redet_phases(rik)

    # the Rotated RetinaNet family's other configs, K1's route inside ATSS's
    # assigner, and LD's run_net
    atss_entry, variant_paths_, variant_times = retina_variant_phases(rik)
    log(f"Rotated RetinaNet variants, serving and train times: {json.dumps(variant_times)}")

    # LSKNet-S and StripNet-S on the two-stage heads with AdamW, and weight
    # import from torchvision, JDet and mmcls files
    lsk_paths = lsk_phases(rik)
    import_launches = weight_import_phase(full_cfg, rik)
    elapsed("the weight import phase")

    # FasterRCNN-OBB and Gliding Vertex (hbb proposals, no fused route),
    # S2ANet's RIDet loss and ResNet-101, and vis_test
    hbb_paths = hbb_rcnn_phases(rik)
    s2a_more_paths = s2anet_ridet_r101_phases(rik)
    # R3Det, Rotated FCOS and H2RBox, timed briefly
    r3det_entry, single_paths = single_stage_phases(rik)
    # Rotated RepPoints (its convex ops, plain PyTorch), and the main
    # RetinaNet's poly_giou loss at the train step's traffic
    reppoints_paths = reppoints_phases(rik)
    retina_poly_giou_phase(full_cfg)
    elapsed("the RetinaNet poly_giou phase")
    vis_launches = vis_test_phase(rik, rik.BUILD_DIR / "vis_test")
    elapsed("the vis_test phase")
    # SSD300 on COCO (K1's matrix route on 80 classes of axis-aligned
    # candidates), the codecs, COCO from disk and the converters
    codec_phase()
    ssd_k1, ssd_paths = ssd_phases(rik)
    coco_launches = coco_runner_phase(rik, rik.BUILD_DIR / "coco_smoke")
    elapsed("the COCO runner phase")
    convert_phase(rik.BUILD_DIR / "convert_smoke")
    elapsed("the convert phase")

    runner_launches = runner_phase(full_cfg, rik, rik.BUILD_DIR / "runner_dota")
    elapsed('runner_phase')
    tiling_launches, tiling_eval_launches = tiling_phase(full_cfg, rik,
                                                         rik.BUILD_DIR / "tiling_dota")
    elapsed("tiling_phase")

    # launches per path: serving (loss forward + 2 predicts), K2's entry
    # point, training (20 steps), each of those in bf16, the Runner's
    # run() (8 train iterations, 2 vals and a test of 4 predict batches
    # each), the epoch on the preprocessed tiles (3 iterations) and its
    # val and test (3 predict batches each)
    paths = {"serving": serving_launches, "generic_iou": generic_launches,
             "train_20_steps": train_launches, "bf16_serving": bf16_serving_launches,
             "bf16_train_20_steps": bf16_train_launches,
             "s2anet_serving": s2a_serving_launches,
             "s2anet_train_5_steps": s2a_train_launches,
             "s2anet_bf16_serving": s2a_bf16_serving_launches,
             "s2anet_bf16_train_5_steps": s2a_bf16_train_launches,
             "s2anet_run_net": run_net_launches, "runner": runner_launches,
             "tiling_epoch": tiling_launches, "tiling_val_test": tiling_eval_launches,
             "orcnn_serving": orcnn_serving_launches,
             "orcnn_train_5_steps": orcnn_train_launches,
             "orcnn_train_b16_3_steps": orcnn_b16_launches,
             "orcnn_bf16_serving": orcnn_bf16_serving_launches,
             "orcnn_bf16_train_5_steps": orcnn_bf16_train_launches,
             "orcnn_bf16_train_b16_3_steps": orcnn_bf16_b16_launches,
             "orcnn_run_net": orcnn_run_net_launches, **redet_paths, **variant_paths_,
             **lsk_paths, "weight_import_loss_predict": import_launches, **hbb_paths,
             **s2a_more_paths, **single_paths, **reppoints_paths, "vis_test": vis_launches,
             **ssd_paths, "ssd_coco_runner": coco_launches}
    kernels = [entry, assign_entry, per_image_entry, r3det_entry, roi_entry, redet_entry,
               atss_entry, generic_entry]
    for e in kernels:
        # the RoI route has an entry per model and shape: each counts its
        # own model's paths; K1's matrix launches inside ATSS's assigner
        # are counted apart, as rotated_iou_rect_atss
        own = {"OrientedRCNN": ("orcnn", "lsknet", "strip"), "ReDet": ("redet",),
               "S2ANet": ("s2anet",), "R3Det": ("r3det",)}.get(e.get("model"), "")
        e["launches_by_path"] = {p: route_launches(n).get(e["name"], 0)
                                 for p, n in paths.items() if p.startswith(own)}
        e["launches"] = sum(e["launches_by_path"].values())
    check(all(n["max_iou_assign_rect_per_image"] == 0 for p, n in paths.items()
              if not p.startswith(("orcnn", "s2anet", "redet", "lsknet", "strip", "r3det"))),
          "a per-image fused launch outside S2ANet's, R3Det's and the two-stage models' paths")
    check(all(n["max_iou_assign_rect_per_image_masked"] == (
        n["max_iou_assign_rect_per_image"]
        if p.startswith(("orcnn", "redet", "lsknet", "strip")) else 0)
        for p, n in paths.items()),
          "a per-image launch without per-image masks on an Oriented R-CNN or ReDet path, "
          "or one with them elsewhere")
    check(all(n["max_iou_assign_rect"] == n["max_iou_assign_rect_per_image"] == 0
              and n["rotated_iou_rect"] == (2 if p.endswith("serving") else 0)
              for p, n in paths.items() if p.startswith("reppoints")),
          f"RepPoints' paths: a fused launch, or not one K1 matrix launch per predict: "
          f"{ {p: n for p, n in paths.items() if p.startswith('reppoints')} }")
    check(roi_entry["launches"] > 0 and redet_entry["launches"] > 0
          and r3det_entry["launches"] > 0, "the RoI route or R3Det's per-image route was not "
          "launched on a main path")
    entry.update(ssd_k1)
    check(all(n == {"rotated_iou_rect": 1 if p.endswith("serving") else 0,
                    "max_iou_assign_rect": 0, "max_iou_assign_rect_per_image": 0,
                    "max_iou_assign_rect_per_image_masked": 0, "rotated_iou_generic": 0}
              for p, n in paths.items() if p.startswith("ssd_") and p != "ssd_coco_runner"),
          f"SSD's paths: not one K1 matrix launch per predict and nothing else: "
          f"{ {p: n for p, n in paths.items() if p.startswith('ssd_')} }")
    check(atss_entry["launches"] == 2 * (1 + 5),
          f"ATSS's route: {atss_entry['launches']} launches, not one per loss forward and "
          f"train step in float32 and bf16")
    log(f"profiler windows: {len(MARKERS_DROPPED)}, markers dropped in each {MARKERS_DROPPED}")
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card_line()}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
