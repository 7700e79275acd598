"""jdet_torch — the PyTorch/CUDA port of jdet_tpu.

The port mirrors `jdet_tpu`'s module tree and keeps its public contracts:
images come in as (B, H, W, 3) NHWC float32, targets as padded
`gt_bboxes (B, K, 5)` / `gt_labels (B, K)` (1-based) / `gt_mask (B, K)`,
and detections go out as a fixed-size dict of `boxes`, `polys`, `scores`,
`labels` (0-based) and `valid`. Inside, convolutions run NCHW on cuDNN.

The package imports neither JAX nor `jdet_tpu`; what it needs from the
reference's framework-free modules is copied here. Every kernel that the
reference wrote in Pallas is a hand-written CUDA kernel under `csrc/`,
built on first use (see `jdet_torch/ops/rotated_iou_kernel.py`).
"""
