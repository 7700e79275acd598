"""Pairwise rotated IoU of gts against anchors: the hand-written CUDA
kernels of `csrc/rotated_iou.cu`, their wrappers, and their plain PyTorch
versions.

- `box_iou_rotated_rect` replaces `jdet_tpu/ops/pallas_iou.py::
  _iou_kernel_rect` (:148), launched there by `_pallas_iou_2d` (:300) for
  the anchor assigner. Anchors are shared (N, 5) or per image (B, N, 5):
  the NMS's per-class self-IoU takes the second form.
- `launch_max_iou_assign_rect` runs the max-IoU assigner fused onto the
  same IoU, so that the (B, K, N) matrix is never written, on shared
  (N, 5) or per-image (B, N, 5) anchors (S2ANet's ODM assigns on its
  per-image refined anchors; Oriented R-CNN's RoI head on its per-image
  proposals, with a (B, N) mask and without the low-quality match), one
  launch for the batch; with `gt_max_assign_all=False` each gt claims
  only its first anchor at its max IoU (the first-claim branch, a third
  pass). Its wrapper,
  with the plain version for CPU tensors, is
  `jdet_torch/models/boxes/assigner.py::max_iou_assign_rotated`: the plain
  version is the assigner composed on the IoU matrix, which lives there.
- `box_iou_rotated_generic` replaces `_iou_kernel` (:219, with
  `_green_sum` :43 and `_planar_rows` :249), the body that
  `box_iou_rotated_pallas(..., kernel="generic")` (:329) runs. No default
  path reaches it. Its kernel skips the clip on the pairs of
  `generic_early_out_pairs`, where the plain version gives exactly 0.

Also here: `park_masked_boxes` (:290), `FAR_CENTER`, and `edges_green_sum`,
the Liang-Barsky Green sum that the generic kernel and the differentiable
path of `box_iou_rotated.py` share.

Each box is expanded to the rows of `_rect_rows` (the reference's
`_planar_rows_rect` :268): the 4 center-relative corner x's, 4 corner
y's, cx, cy, w/2, h/2, cos, sin, area. Keeping the corners relative to
each box's own center keeps fp32 precise at image coordinates ~1e3: per
pair, the other box is only shifted by the center offset. The plain
version expands in PyTorch; the kernel reads the (cx, cy, w, h, theta)
boxes and expands them itself.

The kernels are built with nvcc from the source in the checkout on first
use, into `build/` at the repository root, keyed by a hash of the source
and flags, and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PAR_EPS = 1e-12
# center beyond which a box is treated as "parked" padding: a parked gt
# fails the circle pre-test against every anchor and skips the clip math
FAR_CENTER = -1e6

# kernel launches made by `box_iou_rotated_rect`, by
# `launch_max_iou_assign_rect` on shared anchors and on per-image anchors
# (of these, the ones with a per-image anchor mask also in
# ASSIGN_PER_IMAGE_MASK_LAUNCHES), by its first-claim branch
# (gt_max_assign_all=False, on either anchor layout, counted only in
# ASSIGN_FIRST_CLAIM_LAUNCHES), and by `box_iou_rotated_generic`; callers
# may reset them
LAUNCHES = 0
ASSIGN_LAUNCHES = 0
ASSIGN_PER_IMAGE_LAUNCHES = 0
ASSIGN_PER_IMAGE_MASK_LAUNCHES = 0
ASSIGN_FIRST_CLAIM_LAUNCHES = 0
GENERIC_LAUNCHES = 0

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "rotated_iou.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_lib = None


def park_masked_boxes(boxes, mask):
    """Move masked (padding) rboxes to FAR_CENTER with zero size; their
    IoU is 0 either way, and parked far away they take the kernel's
    early-out."""
    far = boxes.new_tensor([FAR_CENTER, FAR_CENTER, 0.0, 0.0, 0.0])
    return torch.where(mask[..., None], boxes, far)


def _rect_rows(boxes):
    """(..., M, 5) -> (..., M, 15): relx0-3, rely0-3, cx, cy, w/2, h/2,
    cos, sin, area."""
    cx, cy, w, h, a = boxes.unbind(-1)
    cos = torch.cos(a)
    sin = torch.sin(a)
    cos2 = cos * 0.5
    sin2 = sin * 0.5
    x0 = -sin2 * h - cos2 * w
    y0 = cos2 * h - sin2 * w
    x1 = sin2 * h - cos2 * w
    y1 = -cos2 * h - sin2 * w
    rows = [x0, x1, -x0, -x1, y0, y1, -y0, -y1, cx, cy, w * 0.5, h * 0.5,
            cos, sin, w * h]
    return torch.stack(rows, dim=-1)


def _rect_clip_green(px, py, w2, h2, tol_xy):
    """Green contributions of edges (px, py) clipped to the axis-aligned
    rect [-w2, w2] x [-h2, h2]. Edges collinear with the rect's boundary
    get weight 1/2, so identical boxes give IoU 1.

    Returns (sum cross(u, v), sum (v-u)_x, sum (v-u)_y)."""
    total = 0.0
    sum_dx = 0.0
    sum_dy = 0.0
    for i in range(4):
        ax, ay = px[i], py[i]
        bx, by = px[(i + 1) % 4], py[(i + 1) % 4]
        dx, dy = bx - ax, by - ay

        par_x = dx.abs() <= tol_xy
        par_y = dy.abs() <= tol_xy
        inv_x = 1.0 / torch.where(par_x, 1.0, dx)
        inv_y = 1.0 / torch.where(par_y, 1.0, dy)
        t1 = (-w2 - ax) * inv_x
        t2 = (w2 - ax) * inv_x
        t3 = (-h2 - ay) * inv_y
        t4 = (h2 - ay) * inv_y
        tl_x = torch.minimum(t1, t2)
        th_x = torch.maximum(t1, t2)
        tl_y = torch.minimum(t3, t4)
        th_y = torch.maximum(t3, t4)
        t_lo = torch.maximum(
            torch.where(par_x, 0.0, tl_x), torch.where(par_y, 0.0, tl_y)
        ).clamp(min=0.0)
        t_hi = torch.minimum(
            torch.where(par_x, 1.0, th_x), torch.where(par_y, 1.0, th_y)
        ).clamp(max=1.0)
        # an axis-parallel edge must lie inside that axis' slab
        in_x = (ax >= -w2 - tol_xy) & (ax <= w2 + tol_xy)
        in_y = (ay >= -h2 - tol_xy) & (ay <= h2 + tol_xy)
        alive = (~par_x | in_x) & (~par_y | in_y)
        col = (par_x & ((ax.abs() - w2).abs() <= tol_xy)) | (
            par_y & ((ay.abs() - h2).abs() <= tol_xy)
        )
        keep = alive & (t_lo < t_hi)
        wgt = torch.where(col, 0.5, 1.0)
        w_span = torch.where(keep, wgt * (t_hi - t_lo), 0.0)
        ux = ax + t_lo * dx
        uy = ay + t_lo * dy
        vx = ax + t_hi * dx
        vy = ay + t_hi * dy
        total = total + torch.where(keep, wgt * (ux * vy - vx * uy), 0.0)
        sum_dx = sum_dx + w_span * dx
        sum_dy = sum_dy + w_span * dy
    return total, sum_dx, sum_dy


def box_iou_rotated_rect_reference(gts, anchors):
    """Plain PyTorch version of the kernel: the same rect-frame math on
    pair-shaped (B, K, N) tensors. gts (K, 5) or (B, K, 5), anchors (N, 5)
    or, with (B, K, 5) gts, (B, N, 5) -> (K, N) or (B, K, N) float32."""
    g = _rect_rows(gts.float())
    g = g if gts.dim() == 3 else g[None]
    a = _rect_rows(anchors.float())
    a = a[:, None] if anchors.dim() == 3 else a  # (B, 1, N, 15) or (N, 15)

    def gcol(c):
        return g[..., c:c + 1]  # (B, K, 1)

    def arow(c):
        return a[..., c]  # (B, 1, N) or (N,)

    gcx, gcy, gw2, gh2 = gcol(8), gcol(9), gcol(10), gcol(11)
    acx, acy, aw2, ah2 = arow(8), arow(9), arow(10), arow(11)
    dx_c = acx - gcx  # (B, K, N)
    dy_c = acy - gcy
    # w2 + h2 >= half-diagonal, so rsum bounds the max overlap distance
    rsum = (gw2 + gh2) + (aw2 + ah2)
    touching = dx_c * dx_c + dy_c * dy_c < rsum * rsum

    gcos, gsin, g_area = gcol(12), gcol(13), gcol(14)
    acos, asin, a_area = arow(12), arow(13), arow(14)
    # anchor corners in the gt frame: R(-tg) @ (a_rel + d)
    pax, pay = [], []
    for c in range(4):
        wx = arow(c) + dx_c
        wy = arow(4 + c) + dy_c
        pax.append(gcos * wx + gsin * wy)
        pay.append(gcos * wy - gsin * wx)
    # gt corners in the anchor frame: R(-ta) @ (g_rel - d)
    pgx, pgy = [], []
    for c in range(4):
        wx = gcol(c) - dx_c
        wy = gcol(4 + c) - dy_c
        pgx.append(acos * wx + asin * wy)
        pgy.append(acos * wy - asin * wx)

    scale = torch.maximum(gw2 + gh2, aw2 + ah2)
    tol = 1e-5 * scale + _PAR_EPS
    s1, d1x_l, d1y_l = _rect_clip_green(pax, pay, gw2, gh2, tol)
    s2, _, _ = _rect_clip_green(pgx, pgy, aw2, ah2, tol)
    # origin correction: direction 1 used origin g_c (gt frame), direction
    # 2 origin a_c; for the closed loop the mismatch contributes
    # cross(O1 - O2, D1), D1 = direction 1's sum(v - u) in world axes
    d1x = gcos * d1x_l - gsin * d1y_l
    d1y = gsin * d1x_l + gcos * d1y_l
    corr = dy_c * d1x - dx_c * d1y
    s = s1 + s2 + corr
    inter = (0.5 * s).clamp(min=0.0)
    union = g_area + a_area - inter
    out = torch.where(
        touching & (union > 1e-9), inter / union.clamp(min=1e-9), 0.0
    )
    return out if gts.dim() == 3 else out[0]


def edges_green_sum(px, py, qx, qy):
    """Sum of cross(u, v) over P's edges clipped to rectangle Q.

    Q's interior is {p : cross(q_edge_j, p - q_j) >= 0} for all j."""
    qvx = [qx[(j + 1) % 4] - qx[j] for j in range(4)]
    qvy = [qy[(j + 1) % 4] - qy[j] for j in range(4)]

    total = 0.0
    for i in range(4):
        ax, ay = px[i], py[i]
        bx, by = px[(i + 1) % 4], py[(i + 1) % 4]
        dx, dy = bx - ax, by - ay

        t_lo = torch.zeros_like(ax)
        t_hi = torch.ones_like(ax)
        alive = torch.ones_like(ax, dtype=torch.bool)
        on_boundary = torch.zeros_like(ax, dtype=torch.bool)
        for j in range(4):
            # f(t) = cross(qv_j, p(t) - q_j) = f0 + t * df  must stay >= 0
            rx = ax - qx[j]
            ry = ay - qy[j]
            f0 = qvx[j] * ry - rx * qvy[j]
            df = qvx[j] * dy - dx * qvy[j]
            qnorm = qvx[j].abs() + qvy[j].abs()
            par = df.abs() <= 1e-6 * qnorm * (dx.abs() + dy.abs()) + _PAR_EPS
            col = par & (
                f0.abs() <= 1e-5 * qnorm * (rx.abs() + ry.abs()) + _PAR_EPS
            )
            # an edge collinear with a clip line is shared boundary: each
            # polygon counts it with weight 1/2
            on_boundary = on_boundary | col
            alive = alive & (~par | col | (f0 >= 0))
            tstar = -f0 / torch.where(par, 1.0, df)
            t_lo = torch.where(~par & (df > 0), torch.maximum(t_lo, tstar), t_lo)
            t_hi = torch.where(~par & (df < 0), torch.minimum(t_hi, tstar), t_hi)

        keep = alive & (t_lo < t_hi)
        w = torch.where(on_boundary, 0.5, 1.0)
        ux = ax + t_lo * dx
        uy = ay + t_lo * dy
        vx = ax + t_hi * dx
        vy = ay + t_hi * dy
        total = total + torch.where(keep, w * (ux * vy - vx * uy), 0.0)
    return total


def box_iou_rotated_generic_reference(gts, anchors):
    """Plain PyTorch version of the generic kernel: general quad-quad
    clipping in each pair's midpoint frame, no early-out. gts (K, 5) or
    (B, K, 5), anchors (N, 5) -> (K, N) or (B, K, N) float32."""
    g = _rect_rows(gts.float())
    g = g if gts.dim() == 3 else g[None]
    a = _rect_rows(anchors.float())
    # pair midframe: anchor corners +d/2, gt corners -d/2, d = a_c - g_c
    hdx = 0.5 * (a[:, 8] - g[..., 8:9])  # (B, K, N)
    hdy = 0.5 * (a[:, 9] - g[..., 9:10])
    pax = [a[:, c] + hdx for c in range(4)]
    pay = [a[:, 4 + c] + hdy for c in range(4)]
    pgx = [g[..., c:c + 1] - hdx for c in range(4)]
    pgy = [g[..., 4 + c:5 + c] - hdy for c in range(4)]
    s = edges_green_sum(pax, pay, pgx, pgy) + edges_green_sum(pgx, pgy, pax, pay)
    inter = (0.5 * s).clamp(min=0.0)
    union = g[..., 14:15] + a[:, 14] - inter
    out = torch.where(union > 1e-9, inter / union.clamp(min=1e-9), 0.0)
    return out if gts.dim() == 3 else out[0]


def generic_early_out_pairs(gts, anchors):
    """The pairs that the generic kernel writes as 0 without the clip:
    their circles (radius w/2 + h/2) do not touch, and neither box is
    degenerate at the pair's scale, min(w, h) > 1e-3 * (1 + |dx| + |dy| +
    r_g + r_a). Rounded op by op as the kernel rounds it (`csrc/
    rotated_iou.cu::generic_early_out`, whose note shows why the clip gives
    exactly 0 there). gts (K, 5) or (B, K, 5), anchors (N, 5) -> bool
    (K, N) or (B, K, N). For tests and for counting the kernel's work."""
    g = gts.float() if gts.dim() == 3 else gts.float()[None]
    a = anchors.float()
    gw, gh = g[..., 2:3], g[..., 3:4]  # (B, K, 1)
    aw, ah = a[:, 2], a[:, 3]  # (N,)
    rg = gw * 0.5 + gh * 0.5
    ra = aw * 0.5 + ah * 0.5
    dx = a[:, 0] - g[..., 0:1]  # (B, K, N)
    dy = a[:, 1] - g[..., 1:2]
    rsum = rg + ra
    apart = dx * dx + dy * dy >= rsum * rsum
    lim = 1e-3 * ((((1.0 + dx.abs()) + dy.abs()) + rg) + ra)
    out = apart & (torch.minimum(gw, gh) > lim) & (torch.minimum(aw, ah) > lim)
    return out if gts.dim() == 3 else out[0]


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = path if path and os.path.exists(path) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required")
    return path


def build():
    """Compile `csrc/rotated_iou.cu` (once per source hash) and load it.
    Returns the loaded library; the nvcc log sits beside it as `.log`."""
    global _lib
    if _lib is not None:
        return _lib
    flags = " ".join(NVCC_FLAGS).encode()
    key = hashlib.sha256(SOURCE.read_bytes() + flags).hexdigest()[:16]
    so = BUILD_DIR / f"rotated_iou_{key}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    # (pointers..., ints..., stream): see the extern "C" functions of SOURCE
    signatures = {
        "rotated_iou_rect": [ptr] * 3 + [i32] * 3 + [i64, ptr],
        "rotated_iou_generic": [ptr] * 3 + [i32] * 3 + [ptr],
        "max_iou_assign_rect": [ptr] * 9 + [i32] * 3 + [i64] * 2 + [f32] * 3 + [i32] * 2 + [ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _run(kernel, device, *args):
    """Call the library's `kernel` with `args` on the current stream of
    `device`; raise on the CUDA error it returns."""
    fn = getattr(build(), kernel)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")


def _check_device(*tensors):
    """Raise unless all tensors share one CPU or CUDA device. True for
    CPU tensors, which go to the plain versions; False for CUDA tensors."""
    device = tensors[0].device
    for t in tensors[1:]:
        if t.device != device:
            raise ValueError(f"operands on {device} and {t.device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cpu"


def _check_operands(gts, anchors, batched_anchors=False):
    """Raise on what the matrix kernels do not take (per-image anchors
    only where `batched_anchors`). True for CPU tensors, False for CUDA
    tensors."""
    if gts.dim() not in (2, 3) or gts.shape[-1] != 5:
        raise ValueError(f"gts must be (K, 5) or (B, K, 5), got {tuple(gts.shape)}")
    per_image = batched_anchors and gts.dim() == 3 and anchors.dim() == 3
    if anchors.shape[-1] != 5 or not (
        anchors.dim() == 2 or (per_image and anchors.shape[0] == gts.shape[0])
    ):
        want = "(N, 5) or (B, N, 5) with (B, K, 5) gts" if batched_anchors else "(N, 5)"
        raise ValueError(f"anchors must be {want}, got {tuple(anchors.shape)} "
                         f"against gts {tuple(gts.shape)}")
    if gts.dtype != torch.float32 or anchors.dtype != torch.float32:
        raise TypeError(f"float32 only, got {gts.dtype} / {anchors.dtype}")
    if not (gts.is_contiguous() and anchors.is_contiguous()):
        raise ValueError("gts and anchors must be contiguous")
    return _check_device(gts, anchors)


def _launch(kernel, gts, anchors):
    """Run the library's matrix `kernel` on checked CUDA operands, one
    launch for the whole batch (none for an empty output)."""
    g = gts if gts.dim() == 3 else gts[None]
    B, K, _ = g.shape
    N = anchors.shape[-2]
    if B > 65535 or K > 4 * 65535 or N >= 1 << 31:
        raise ValueError(f"shape out of the kernel's grid: B={B} K={K} N={N}")
    out = torch.empty((B, K, N), device=gts.device, dtype=torch.float32)
    if out.numel():
        args = [g.data_ptr(), anchors.data_ptr(), out.data_ptr(), B, K, N]
        if kernel == "rotated_iou_rect":
            args.append(N * 5 if anchors.dim() == 3 else 0)  # anchor batch stride
        _run(kernel, gts.device, *args)
    return out if gts.dim() == 3 else out[0]


def box_iou_rotated_rect(gts, anchors):
    """Pairwise rotated IoU, gts (K, 5) or (B, K, 5) against anchors
    (N, 5) or, with (B, K, 5) gts, per-image anchors (B, N, 5) -> (K, N)
    or (B, K, N) float32, forward only.

    A CUDA tensor launches the rect kernel (one launch for the whole batch)
    or raises; a CPU tensor goes to `box_iou_rotated_rect_reference`."""
    global LAUNCHES
    if _check_operands(gts, anchors, batched_anchors=True):
        return box_iou_rotated_rect_reference(gts, anchors)
    out = _launch("rotated_iou_rect", gts, anchors)
    if out.numel():
        LAUNCHES += 1
    return out


def check_assign_operands(gt_bboxes, gt_mask, gt_labels, anchors, anchor_mask=None):
    """Raise on what the fused assigner does not take: gt_bboxes (K, 5)
    or (B, K, 5) float32 contiguous with K >= 1, gt_mask bool and
    gt_labels integer of gt_bboxes' leading shape, anchors (N, 5) or, with
    (B, K, 5) gts, per-image (B, N, 5), float32 contiguous, anchor_mask
    bool (N,) or (B, N) (one mask per image, on either anchor layout), or
    None. True for CPU tensors, False for CUDA tensors."""
    lead = tuple(gt_bboxes.shape[:-1])
    if gt_bboxes.dim() not in (2, 3) or gt_bboxes.shape[-1] != 5 or lead[-1] == 0:
        raise ValueError(f"gt_bboxes must be (K, 5) or (B, K, 5) with K >= 1, "
                         f"got {tuple(gt_bboxes.shape)}")
    per_image = (anchors.dim() == 3 and gt_bboxes.dim() == 3
                 and anchors.shape[0] == gt_bboxes.shape[0])
    if anchors.shape[-1] != 5 or not (anchors.dim() == 2 or per_image):
        raise ValueError(f"anchors must be (N, 5) or (B, N, 5) with (B, K, 5) gts, "
                         f"got {tuple(anchors.shape)} against gts {tuple(gt_bboxes.shape)}")
    if tuple(gt_mask.shape) != lead or tuple(gt_labels.shape) != lead:
        raise ValueError(f"gt_mask {tuple(gt_mask.shape)} and gt_labels "
                         f"{tuple(gt_labels.shape)} must be {lead}")
    mask_shapes = [(anchors.shape[-2],)]
    if gt_bboxes.dim() == 3:
        mask_shapes.append((gt_bboxes.shape[0], anchors.shape[-2]))
    if anchor_mask is not None and tuple(anchor_mask.shape) not in mask_shapes:
        raise ValueError(f"anchor_mask must be {' or '.join(map(str, mask_shapes))}, got "
                         f"{tuple(anchor_mask.shape)}")
    if gt_bboxes.dtype != torch.float32 or anchors.dtype != torch.float32:
        raise TypeError(f"float32 boxes only, got {gt_bboxes.dtype} / {anchors.dtype}")
    if gt_mask.dtype != torch.bool or (anchor_mask is not None and anchor_mask.dtype != torch.bool):
        raise TypeError("gt_mask and anchor_mask must be bool")
    if gt_labels.dtype.is_floating_point or gt_labels.dtype == torch.bool:
        raise TypeError(f"gt_labels must be integer, got {gt_labels.dtype}")
    if not (gt_bboxes.is_contiguous() and anchors.is_contiguous()):
        raise ValueError("gt_bboxes and anchors must be contiguous")
    masks = [] if anchor_mask is None else [anchor_mask]
    return _check_device(gt_bboxes, gt_mask, gt_labels, anchors, *masks)


def _launch_assign(gt_bboxes, gt_mask, gt_labels, anchors, anchor_mask,
                   pos_iou_thr, neg_iou_thr, min_pos_iou, match_low_quality,
                   gt_max_assign_all=True):
    """Run the passes of the fused assigner on checked operands (one
    call, none for an empty output)."""
    squeeze = gt_bboxes.dim() == 2
    g = gt_bboxes[None] if squeeze else gt_bboxes
    B, K, _ = g.shape
    N = anchors.shape[-2]
    if B > 65535 or N >= 1 << 31:
        raise ValueError(f"shape out of the kernel's grid: B={B} N={N}")
    dev = gt_bboxes.device
    # held until the launch returns, as are the outputs and the scratch
    gt_mask = gt_mask.reshape(B, K).contiguous()
    gt_labels = gt_labels.reshape(B, K).long().contiguous()
    anchor_mask = None if anchor_mask is None else anchor_mask.contiguous()
    out = {
        "gt_inds": torch.empty((B, N), device=dev, dtype=torch.int64),
        "max_overlaps": torch.empty((B, N), device=dev, dtype=torch.float32),
        "labels": torch.empty((B, N), device=dev, dtype=torch.int64),
    }
    if B * N:
        # the gts' max IoU bits, then per image a flag "some anchor is
        # unmasked"; for the first-claim branch, each gt's claimed anchor and
        # each image's first unmasked one
        first = match_low_quality and not gt_max_assign_all
        scratch = torch.zeros((B * K + B) * (2 if first else 1), device=dev,
                              dtype=torch.int32)
        am = 0 if anchor_mask is None else anchor_mask.data_ptr()
        _run("max_iou_assign_rect", dev,
             g.data_ptr(), gt_mask.data_ptr(), gt_labels.data_ptr(),
             anchors.data_ptr(), am, scratch.data_ptr(),
             out["gt_inds"].data_ptr(), out["max_overlaps"].data_ptr(),
             out["labels"].data_ptr(), B, K, N,
             N * 5 if anchors.dim() == 3 else 0,  # anchor batch stride
             N if anchor_mask is not None and anchor_mask.dim() == 2 else 0,
             pos_iou_thr, neg_iou_thr, min_pos_iou, int(bool(match_low_quality)),
             int(bool(gt_max_assign_all)))
    return {k: v[0] for k, v in out.items()} if squeeze else out


def launch_max_iou_assign_rect(gt_bboxes, gt_mask, gt_labels, anchors,
                               anchor_mask=None, pos_iou_thr=0.5,
                               neg_iou_thr=0.4, min_pos_iou=0.0,
                               match_low_quality=True, gt_max_assign_all=True):
    """The max-IoU assigner fused onto the rect IoU, CUDA tensors only:
    one call of the fused kernel for the batch, counted in
    ASSIGN_LAUNCHES for shared (N, 5) anchors and in
    ASSIGN_PER_IMAGE_LAUNCHES for per-image (B, N, 5) ones (with a shared
    (N,) or a per-image (B, N) anchor mask; the latter also in
    ASSIGN_PER_IMAGE_MASK_LAUNCHES), or, with the low-quality match and
    gt_max_assign_all=False (each gt claims only its first anchor at its
    max), only in ASSIGN_FIRST_CLAIM_LAUNCHES. Returns the dict of
    `assign_wrt_overlaps` (gt_inds, max_overlaps, labels), each (N,) or
    (B, N). Operands as `check_assign_operands` takes them; without
    `match_low_quality` no gt claims its best anchors.

    Callers take `jdet_torch.models.boxes.assigner.max_iou_assign_rotated`,
    which sends CPU tensors to the plain version."""
    global ASSIGN_LAUNCHES, ASSIGN_PER_IMAGE_LAUNCHES, ASSIGN_PER_IMAGE_MASK_LAUNCHES
    global ASSIGN_FIRST_CLAIM_LAUNCHES
    if check_assign_operands(gt_bboxes, gt_mask, gt_labels, anchors, anchor_mask):
        raise ValueError("CUDA tensors only: the plain version is "
                         "jdet_torch.models.boxes.assigner.max_iou_assign_rotated")
    out = _launch_assign(gt_bboxes, gt_mask, gt_labels, anchors, anchor_mask,
                         pos_iou_thr, neg_iou_thr, min_pos_iou, match_low_quality,
                         gt_max_assign_all)
    if out["gt_inds"].numel():
        if match_low_quality and not gt_max_assign_all:
            ASSIGN_FIRST_CLAIM_LAUNCHES += 1
        elif anchors.dim() == 3:
            ASSIGN_PER_IMAGE_LAUNCHES += 1
            if anchor_mask is not None and anchor_mask.dim() == 2:
                ASSIGN_PER_IMAGE_MASK_LAUNCHES += 1
        else:
            ASSIGN_LAUNCHES += 1
    return out


def box_iou_rotated_generic(gts, anchors):
    """The same IoU by general quad-quad clipping, the counterpart of
    `box_iou_rotated_pallas(..., kernel="generic")`: gts (K, 5) or
    (B, K, 5) against anchors (N, 5) -> (K, N) or (B, K, N) float32,
    forward only.

    A CUDA tensor launches the generic kernel (one launch for the whole
    batch) or raises; a CPU tensor goes to
    `box_iou_rotated_generic_reference`."""
    global GENERIC_LAUNCHES
    if _check_operands(gts, anchors):
        return box_iou_rotated_generic_reference(gts, anchors)
    out = _launch("rotated_iou_generic", gts, anchors)
    if out.numel():
        GENERIC_LAUNCHES += 1
    return out
