"""YOLOv5: the yaml-style CSP network, the Detect head, the v5 loss and
`predict`, NCHW.

Port of `jdet_tpu/models/detectors/yolo.py` (`YOLOV5S` :41,
`make_divisible` :82, `ConvBnAct` :86, `Focus` :123, `Bottleneck` :137,
`C3` :149, `SPP` :169, `Detect` :182, `parse_model` :212, `YOLO` :262,
`_bce_none` / `_bce_mean` / `_ciou_cxcywh` :554-591). Images come in as
(B, H, W, 3) float, the reference's batch contract, and are permuted to
NCHW once; `Detect`'s maps leave as (B, H, W, na * no), the layout the
loss and `predict` reshape.

- SiLU is `x * sigmoid(x)` with `layers.sigmoid`, as XLA expands
  `jax.nn.silu` (step by step in a lower dtype; `F.silu` rounds once).
- The BNs take flax's epsilon 1e-3 and momentum 0.97 (`layers.BatchNorm2d`
  with `flax_momentum`): YOLO trains its running statistics.
- `Focus` orders its channels as the reference's reshape does,
  (dy * 2 + dx) * C + c, not as upstream YOLOv5's slices.
- The loss gathers the predictions at the matched cells by index (the
  reference's one-hot matmul at HIGHEST precision is the same gather) and
  scatter-maxes the objectness target; CIoU's alpha and the objectness
  target's IoU are detached, as in the reference.
- `predict` decodes every level, cuts to `nms_pre` with `ops/topk.py::
  stable_topk` (ties to the lower index, as `jax.lax.top_k`), and runs one
  batched hbb NMS (`ops/nms.py`) for all images, each class apart by a
  coordinate offset.

The anchors are a float32 buffer of `Detect` (the reference keeps them as
a state leaf, so the model EMA averages them with the weights).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import MODELS
from ..layers import BatchNorm2d, Conv2d, lecun_normal_init, max_pool, resize_nearest, sigmoid
from ...ops.nms import nms
from ...ops.topk import stable_topk

# yolov5s spec (the reference's configs/yolov5s.yaml layout)
YOLOV5S = dict(
    nc=80,
    depth_multiple=0.33,
    width_multiple=0.50,
    anchors=[
        [10, 13, 16, 30, 33, 23],
        [30, 61, 62, 45, 59, 119],
        [116, 90, 156, 198, 373, 326],
    ],
    backbone=[
        [-1, 1, "Focus", [64, 3]],
        [-1, 1, "Conv", [128, 3, 2]],
        [-1, 3, "C3", [128]],
        [-1, 1, "Conv", [256, 3, 2]],
        [-1, 9, "C3", [256]],
        [-1, 1, "Conv", [512, 3, 2]],
        [-1, 9, "C3", [512]],
        [-1, 1, "Conv", [1024, 3, 2]],
        [-1, 1, "SPP", [1024, [5, 9, 13]]],
        [-1, 3, "C3", [1024, False]],
    ],
    head=[
        [-1, 1, "Conv", [512, 1, 1]],
        [-1, 1, "Upsample", [2]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],
        [-1, 1, "Conv", [256, 1, 1]],
        [-1, 1, "Upsample", [2]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 3, "C3", [256, False]],
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 14], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 10], 1, "Concat", [1]],
        [-1, 3, "C3", [1024, False]],
        [[17, 20, 23], 1, "Detect", []],
    ],
)


def make_divisible(x, divisor=8):
    return max(int(math.ceil(x / divisor) * divisor), divisor)


def silu(x):
    """`jax.nn.silu`, x * sigmoid(x), as XLA computes it."""
    return x * sigmoid(x)


class ConvBnAct(nn.Module):
    """Conv (no bias, symmetric k // 2 pads) + BN + SiLU; `fuse()` folds
    the BN into the conv for inference."""

    def __init__(self, c1, c2, k=1, s=1, *, generator=None):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, bias=False, padding=k // 2, generator=generator)
        self.bn = BatchNorm2d(c2, eps=1e-3, flax_momentum=0.97)
        self.fused = False

    def forward(self, x):
        x = self.conv(x)
        return silu(x if self.fused else self.bn(x))

    @torch.no_grad()
    def fuse(self):
        """Fold the BN into the conv's weight and a new bias, in the
        reference's operations (`yolo.py:106-120`)."""
        bn = self.bn
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        self.conv.weight.mul_(scale[:, None, None, None])
        self.conv.bias = nn.Parameter(bn.bias - bn.running_mean * scale)
        self.fused = True


class Focus(nn.Module):
    """Space to depth, then a conv: channel (dy * 2 + dx) * C + c holds
    pixel (2y + dy, 2x + dx) of channel c."""

    def __init__(self, c1, c2, k=1, *, generator=None):
        super().__init__()
        self.conv = ConvBnAct(c1 * 4, c2, k, 1, generator=generator)

    def forward(self, x):
        B, C, H, W = x.shape
        x = x.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 3, 5, 1, 2, 4)
        return self.conv(x.reshape(B, 4 * C, H // 2, W // 2))


class Bottleneck(nn.Module):
    def __init__(self, c1, c2, shortcut=True, e=0.5, *, generator=None):
        super().__init__()
        ch = int(c2 * e)
        self.cv1 = ConvBnAct(c1, ch, 1, 1, generator=generator)
        self.cv2 = ConvBnAct(ch, c2, 3, 1, generator=generator)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        out = self.cv2(self.cv1(x))
        return x + out if self.add else out


class C3(nn.Module):
    """CSP bottleneck with 3 convs."""

    def __init__(self, c1, c2, n=1, shortcut=True, e=0.5, *, generator=None):
        super().__init__()
        ch = int(c2 * e)
        self.cv1 = ConvBnAct(c1, ch, 1, 1, generator=generator)
        self.cv2 = ConvBnAct(c1, ch, 1, 1, generator=generator)
        self.cv3 = ConvBnAct(2 * ch, c2, 1, 1, generator=generator)
        self.m = nn.ModuleList(
            [Bottleneck(ch, ch, shortcut, 1.0, generator=generator) for _ in range(n)])

    def forward(self, x):
        y1 = self.cv1(x)
        for b in self.m:
            y1 = b(y1)
        return self.cv3(torch.cat([y1, self.cv2(x)], 1))


class SPP(nn.Module):
    """Max pools of 5, 9 and 13 at stride 1 with flax's 'SAME' (-inf)
    padding, concatenated with their input."""

    def __init__(self, c1, c2, ks=(5, 9, 13), *, generator=None):
        super().__init__()
        ch = c1 // 2
        self.cv1 = ConvBnAct(c1, ch, 1, 1, generator=generator)
        self.cv2 = ConvBnAct(ch * (len(ks) + 1), c2, 1, 1, generator=generator)
        self.ks = tuple(ks)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [max_pool(x, k, 1, "SAME") for k in self.ks], 1))


class Detect(nn.Module):
    """Per-level 1x1 output convs (na * (nc + 5) maps) and the anchors in
    pixels, (nl, na, 2)."""

    def __init__(self, nc, anchors, ch, *, generator=None):
        super().__init__()
        self.nc = nc
        self.no = nc + 5
        self.nl = len(anchors)
        self.na = len(anchors[0]) // 2
        self.register_buffer("anchors_px", torch.from_numpy(
            np.asarray(anchors, np.float32).reshape(self.nl, self.na, 2)))
        self.m = nn.ModuleList([
            Conv2d(c, self.no * self.na, 1, kernel_init=lecun_normal_init, generator=generator)
            for c in ch])
        self.stride = None  # filled by YOLO

    @torch.no_grad()
    def init_biases(self, img_size=640):
        """The prior-probability bias init, in float32 numpy as the
        reference computes it."""
        for conv, s in zip(self.m, self.stride):
            b = conv.bias.detach().cpu().numpy().astype(np.float32).reshape(self.na, -1)
            b[:, 4] += math.log(8 / (img_size / s) ** 2)
            b[:, 5:] += math.log(0.6 / (self.nc - 0.99))
            conv.bias.copy_(torch.from_numpy(b.reshape(-1)))

    def forward(self, feats):
        """(B, H, W, na * no) per level."""
        return [m(f).permute(0, 2, 3, 1) for m, f in zip(self.m, feats)]


def parse_model(spec, ch_in=3, *, generator=None):
    """The layer list of a v5 yaml dict: (layers, routes, save), where a
    layer is a module, ("upsample", factor) or ("concat",)."""
    gd = spec["depth_multiple"]
    gw = spec["width_multiple"]
    layers, routes, ch = [], [], []
    save = set()
    for i, (f, n, mtype, args) in enumerate(spec["backbone"] + spec["head"]):
        n = max(round(n * gd), 1) if n > 1 else n

        def src_ch(j):
            return ch_in if i == 0 else ch[j]

        if mtype in ("Conv", "Focus", "C3", "SPP", "Bottleneck"):
            c1 = src_ch(f if isinstance(f, int) else f[0])
            c2 = make_divisible(args[0] * gw, 8)
            if mtype == "Conv":
                m = ConvBnAct(c1, c2, *args[1:], generator=generator)
            elif mtype == "Focus":
                m = Focus(c1, c2, *args[1:], generator=generator)
            elif mtype == "C3":
                m = C3(c1, c2, n, *args[1:], generator=generator)
            elif mtype == "SPP":
                m = SPP(c1, c2, *args[1:], generator=generator)
            else:
                m = Bottleneck(c1, c2, *args[1:], generator=generator)
        elif mtype == "Upsample":
            c2 = src_ch(f)
            m = ("upsample", args[0])
        elif mtype == "Concat":
            c2 = sum(src_ch(x) for x in f)
            m = ("concat",)
        elif mtype == "Detect":
            c2 = 0
            m = Detect(spec["nc"], spec["anchors"], [src_ch(x) for x in f], generator=generator)
        else:
            raise ValueError(mtype)
        layers.append(m)
        routes.append(f)
        if isinstance(f, (list, tuple)):
            save.update(x for x in f if x != -1)
        elif f != -1:
            save.add(f)
        ch.append(c2)
    return layers, routes, save


def _out_size(m, size):
    """The spatial size after module `m`: a stride-s conv with k // 2 pads,
    Focus's halving, size-keeping blocks."""
    if isinstance(m, Focus):
        return _out_size(m.conv, size // 2)
    if isinstance(m, ConvBnAct):
        k, s = m.conv.kernel_size[0], m.conv.stride
        return (size + 2 * (k // 2) - k) // s + 1
    return size


@MODELS.register_module()
class YOLO(nn.Module):
    def __init__(self, cfg=None, nc=80, imgsz=640, boxlg=0.05, clslg=0.5, objlg=1.0,
                 anchor_t=4.0, label_smoothing=0.0, conf_thres=0.001, iou_thres=0.65,
                 nms_pre=2048, max_per_img=300, *, generator=None):
        super().__init__()
        spec = dict(YOLOV5S if cfg is None else cfg)
        if nc:
            spec["nc"] = nc
        self.nc = spec["nc"]
        layers, routes, save = parse_model(spec, generator=generator)
        modules = [m for m in layers if isinstance(m, nn.Module)]
        # the reference's state names the Detect module `detect`, not
        # `layers.<last>`: the others are `layers`
        self.layers = nn.ModuleList(modules[:-1])
        self.detect = modules[-1]
        if not isinstance(self.detect, Detect):
            raise ValueError("the spec's last module is not Detect")
        # static routing plan: (kind, module index or argument, from)
        self._plan = []
        mi = 0
        for m, f in zip(layers, routes):
            if isinstance(m, nn.Module):
                self._plan.append(("mod", mi, f))
                mi += 1
            else:
                self._plan.append((m[0], m[1] if len(m) > 1 else None, f))
        self._save = save
        # strides from the feature sizes of a 256² input, as the reference
        # takes them from an abstract forward (yolo.py:307-312)
        self.detect.stride = [256 // s for s in self._feature_sizes(256)]
        self.detect.init_biases(imgsz)
        nl = self.detect.nl
        self.box_gain = boxlg * 3.0 / nl
        self.cls_gain = clslg * self.nc / 80.0 * 3.0 / nl
        self.obj_gain = objlg * (imgsz / 640) ** 2 * 3.0 / nl
        self.anchor_t = anchor_t
        self.cp = 1.0 - 0.5 * label_smoothing
        self.cn = 0.5 * label_smoothing
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.nms_pre = nms_pre
        self.max_per_img = max_per_img
        self.gr = 1.0

    def _module(self, i):
        return self.detect if i == len(self.layers) else self.layers[i]

    def _feature_sizes(self, size):
        """The sizes of the maps Detect reads, for a size x size input."""
        sizes, cur = {}, size
        for i, (kind, arg, f) in enumerate(self._plan):
            src = cur if f == -1 or isinstance(f, (list, tuple)) else sizes[f]
            if kind == "mod":
                m = self._module(arg)
                if isinstance(m, Detect):
                    return [cur if j == -1 else sizes[j] for j in f]
                cur = _out_size(m, src)
            elif kind == "upsample":
                cur = src * arg
            if i in self._save:
                sizes[i] = cur
        raise RuntimeError("spec has no Detect layer")

    # -- network ----------------------------------------------------------
    def _forward_backbone(self, x):
        outs = {}
        cur = x
        for i, (kind, arg, f) in enumerate(self._plan):
            if kind == "mod":
                m = self._module(arg)
                if isinstance(m, Detect):
                    return [outs[j] if j != -1 else cur for j in f]
                cur = m(cur if f == -1 else outs[f])
            elif kind == "upsample":
                src = cur if f == -1 else outs[f]
                cur = resize_nearest(src, (src.shape[2] * arg, src.shape[3] * arg))
            elif kind == "concat":
                cur = torch.cat([cur if j == -1 else outs[j] for j in f], 1)
            if i in self._save:
                outs[i] = cur
        raise RuntimeError("spec has no Detect layer")

    def forward(self, images):
        """Images (B, H, W, 3) -> per level (B, H / s, W / s, na * no)."""
        feats = self._forward_backbone(images.permute(0, 3, 1, 2).contiguous())
        return self.detect(feats)

    # -- training ---------------------------------------------------------
    def loss(self, images, targets, generator=None):
        """The v5 loss at fixed shapes. targets: `gt_hboxes` (B, K, 4) xyxy
        pixels (from the rotated `gt_bboxes` where absent), `gt_labels`
        (B, K) 1-based, `gt_mask` (B, K). `generator` is unused: nothing
        here draws."""
        preds = [p.float() for p in self.forward(images)]
        B = images.shape[0]
        K = targets["gt_mask"].shape[1]
        hb = targets.get("gt_hboxes")
        if hb is None:
            from ...ops.box_convert import rbox_to_hbox

            hb = rbox_to_hbox(targets["gt_bboxes"])
        gt_cxy = (hb[..., :2] + hb[..., 2:4]) / 2
        gt_wh = (hb[..., 2:4] - hb[..., :2]).clamp(min=1e-3)
        gmask = targets["gt_mask"].bool()
        cls0 = (targets["gt_labels"].long() - 1).clamp(0, self.nc - 1)

        det = self.detect
        na, no = det.na, det.no
        balance = [4.0, 1.0, 0.4, 0.1][:det.nl]
        lbox = lobj = lcls = 0.0
        for i, p in enumerate(preds):
            s = det.stride[i]
            H, W = p.shape[1:3]
            pm = p.reshape(B, H * W, na, no)
            anchors_grid = det.anchors_px[i] / s
            gxy = gt_cxy / s
            gwh = gt_wh / s
            # wh-ratio anchor match
            r = gwh[:, :, None, :] / anchors_grid[None, None]
            match = torch.maximum(r, 1.0 / r).amax(-1) < self.anchor_t
            # the centre cell and its two nearest neighbours (x and y)
            gi0 = gxy[..., 0].floor().long().clamp(0, W - 1)
            gj0 = gxy[..., 1].floor().long().clamp(0, H - 1)
            frac = gxy - torch.stack([gi0, gj0], -1).float()
            left, up = frac[..., 0] < 0.5, frac[..., 1] < 0.5
            dx = torch.where(left, -1, 1)
            dy = torch.where(up, -1, 1)
            vx = torch.where(left, gxy[..., 0] > 1.0, gxy[..., 0] < W - 1.0)
            vy = torch.where(up, gxy[..., 1] > 1.0, gxy[..., 1] < H - 1.0)
            gi = torch.stack([gi0, (gi0 + dx).clamp(0, W - 1), gi0], -1)
            gj = torch.stack([gj0, gj0, (gj0 + dy).clamp(0, H - 1)], -1)
            valid = torch.stack([torch.ones_like(vx), vx, vy], -1) & gmask[:, :, None]
            cell = (gj * W + gi).reshape(B, K * 3)  # variant axis innermost
            txy = (gxy[:, :, None, :] - torch.stack([gi, gj], -1).float()).reshape(B, K * 3, 1, 2)
            match = (match[:, :, None, :] & valid[:, :, :, None]).reshape(B, K * 3, na)
            gwh3 = gwh[:, :, None, :].expand(B, K, 3, 2).reshape(B, K * 3, 2)
            # the predictions at the matched cells
            ps = torch.gather(pm, 1, cell[:, :, None, None].expand(B, K * 3, na, no))

            pxy = sigmoid(ps[..., :2]) * 2.0 - 0.5
            pwh = (sigmoid(ps[..., 2:4]) * 2.0) ** 2 * anchors_grid[None, None]
            iou = _ciou_cxcywh(
                torch.cat([pxy, pwh], -1),
                torch.cat([txy.expand(pxy.shape), gwh3[:, :, None, :].expand(pwh.shape)], -1))
            mf = match.float()
            n_pos = mf.sum().clamp(min=1.0)
            lbox = lbox + ((1.0 - iou) * mf).sum() / n_pos

            # the objectness target: the detached IoU, scatter-maxed
            tgt_val = ((1.0 - self.gr) + self.gr * iou.detach().clamp(min=0.0)) * mf
            idx = (cell[:, :, None] * na + torch.arange(na, device=cell.device)).reshape(B, -1)
            tobj = torch.zeros(B, H * W * na, device=p.device).scatter_reduce(
                1, idx, tgt_val.reshape(B, -1), "amax").reshape(B, H * W, na)
            lobj = lobj + balance[i] * _bce_mean(pm[..., 4], tobj)

            if self.nc > 1:
                cls3 = cls0[:, :, None].expand(B, K, 3).reshape(B, K * 3)
                tcls = F.one_hot(cls3, self.nc).float() * (self.cp - self.cn) + self.cn
                cls_logits = ps[..., 5:]
                bce = _bce_none(cls_logits, tcls[:, :, None].expand(cls_logits.shape))
                lcls = lcls + (bce * mf[..., None]).sum() / (n_pos * self.nc)

        return {
            "box_loss": lbox * self.box_gain * B,
            "obj_loss": lobj * self.obj_gain * B,
            "cls_loss": lcls * self.cls_gain * B,
        }

    # -- inference --------------------------------------------------------
    @torch.no_grad()
    def predict(self, images, targets=None):
        return self.predict_from_outputs(self.forward(images))

    @torch.no_grad()
    def predict_from_outputs(self, preds):
        """The detections of Detect's outputs: {boxes (B, max_per_img, 4)
        xyxy, scores, labels (0-based, -1 where empty), valid}."""
        preds = [p.float() for p in preds]
        B = preds[0].shape[0]
        det = self.detect
        zs = []
        for i, p in enumerate(preds):
            s = det.stride[i]
            H, W = p.shape[1:3]
            y = sigmoid(p.reshape(B, H, W, det.na, det.no))
            ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=p.device),
                                    torch.arange(W, dtype=torch.float32, device=p.device),
                                    indexing="ij")
            grid = torch.stack([xs, ys], -1)[None, :, :, None, :]
            xy = (y[..., :2] * 2.0 - 0.5 + grid) * s
            wh = (y[..., 2:4] * 2.0) ** 2 * det.anchors_px[i][None, None, None]
            conf = y[..., 4:5] * y[..., 5:]
            zs.append(torch.cat([xy, wh, conf], -1).reshape(B, -1, 4 + self.nc))
        z = torch.cat(zs, 1)
        boxes = torch.stack([z[..., 0] - z[..., 2] / 2, z[..., 1] - z[..., 3] / 2,
                             z[..., 0] + z[..., 2] / 2, z[..., 1] + z[..., 3] / 2], -1)
        best, label = z[..., 4:].max(-1)
        best, sel = stable_topk(best, min(self.nms_pre, best.shape[1]))
        boxes = torch.gather(boxes, 1, sel[..., None].expand(*sel.shape, 4))
        label = torch.gather(label, 1, sel)
        valid = best > self.conf_thres
        # each class apart: offset by the label times the image's span
        span = boxes.amax((1, 2)) - boxes.amin((1, 2)) + 1.0
        off = boxes + (label.to(boxes.dtype) * span[:, None])[..., None]
        order, keep = nms(off, best, self.iou_thres, valid=valid)
        sel = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices[:, :self.max_per_img]
        idx = torch.gather(order, 1, sel)
        v = torch.gather(keep, 1, sel)
        return {
            "boxes": torch.where(v[..., None], torch.gather(
                boxes, 1, idx[..., None].expand(*idx.shape, 4)), 0.0),
            "scores": torch.where(v, torch.gather(best, 1, idx), 0.0),
            "labels": torch.where(v, torch.gather(label, 1, idx), -1),
            "valid": v,
        }

    def fuse(self):
        """Fold every ConvBnAct's BN into its conv (inference only)."""
        for m in self.modules():
            if isinstance(m, ConvBnAct) and not m.fused:
                m.fuse()
        return self


def _bce_none(logits, t):
    return logits.clamp(min=0) - logits * t + torch.log1p(torch.exp(-logits.abs()))


def _bce_mean(logits, t):
    return _bce_none(logits, t).mean()


def _ciou_cxcywh(p, t, eps=1e-7):
    """CIoU of (..., 4) cxcywh boxes; alpha detached."""
    px1 = p[..., 0] - p[..., 2] / 2
    py1 = p[..., 1] - p[..., 3] / 2
    px2 = p[..., 0] + p[..., 2] / 2
    py2 = p[..., 1] + p[..., 3] / 2
    tx1 = t[..., 0] - t[..., 2] / 2
    ty1 = t[..., 1] - t[..., 3] / 2
    tx2 = t[..., 0] + t[..., 2] / 2
    ty2 = t[..., 1] + t[..., 3] / 2
    iw = (torch.minimum(px2, tx2) - torch.maximum(px1, tx1)).clamp(min=0)
    ih = (torch.minimum(py2, ty2) - torch.maximum(py1, ty1)).clamp(min=0)
    inter = iw * ih
    union = p[..., 2] * p[..., 3] + t[..., 2] * t[..., 3] - inter + eps
    iou = inter / union
    cw = torch.maximum(px2, tx2) - torch.minimum(px1, tx1)
    ch = torch.maximum(py2, ty2) - torch.minimum(py1, ty1)
    c2 = cw * cw + ch * ch + eps
    rho2 = (p[..., 0] - t[..., 0]) ** 2 + (p[..., 1] - t[..., 1]) ** 2
    v = (4 / math.pi ** 2) * (
        torch.atan(t[..., 2] / t[..., 3].clamp(min=eps))
        - torch.atan(p[..., 2] / p[..., 3].clamp(min=eps))
    ) ** 2
    alpha = (v / (1 - iou + v).clamp(min=eps)).detach()
    return iou - rho2 / c2 - alpha * v
