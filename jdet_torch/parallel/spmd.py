"""The device-side input pipeline and the train step, on one card.

Port of `jdet_tpu/parallel/spmd.py` (`make_device_normalizer` :72,
`make_device_augmenter` :91, `build_train_step` :181) for one device.
Batches arrive as NHWC uint8 on the card; the flips, rotations and the
normalization run there, inside the step. The mesh, batch sharding,
`psum_scalar_metrics` and `prefetch_to_device` wait for a data-parallel
slice.
"""
from __future__ import annotations

import math

import torch

from ..models.equivariant import cache_frozen_expansions
from ..ops.box_convert import norm_angle
from ..utils.general import parse_losses


def make_device_normalizer(mean, std, to_bgr=False):
    """Return normalize(images) -> (x - mean) * (1 / std) in float32, on
    the batch's device; `to_bgr` reverses the channels first. The
    constants are copied to a device once, at its first batch. Under a
    bf16 policy the first conv casts the normalized batch, as in the
    reference."""
    mean = torch.tensor(mean, dtype=torch.float32)
    inv_std = 1.0 / torch.tensor(std, dtype=torch.float32)
    on_device = {}

    def normalize(images):
        dev = images.device
        if dev not in on_device:
            on_device[dev] = (mean.to(dev), inv_std.to(dev))
        m, s = on_device[dev]
        x = images.float()
        if to_bgr:
            x = x.flip(-1)
        return (x - m) * s

    return normalize


def make_device_augmenter(flip_h=0.0, flip_v=0.0, rot90=0.0):
    """Device-side geometric augmentation of NHWC batches.

    Returns aug(images, targets, generator) -> (images_f32, targets). Each
    image is flipped horizontally with probability `flip_h`, vertically
    with `flip_v`, and with probability `rot90` rotated by k*90 degrees,
    k uniform in {0, 1, 2, 3}; the draws come from `generator`, a
    `torch.Generator` on the batch's device. The gt-box math is the
    reference's (RotatedRandomFlip / RandomRotateAug, same `norm_angle`
    convention), on a square canvas for rot90."""

    def aug(images, targets, generator):
        B, H, W, _ = images.shape
        dev = images.device
        gb = targets["gt_bboxes"]

        def draw(p):
            return torch.rand(B, generator=generator, device=dev) < p

        if flip_h:
            do = draw(flip_h)
            images = torch.where(do[:, None, None, None], images.flip(2), images)
            fb = torch.stack([
                W - gb[..., 0] - 1, gb[..., 1], gb[..., 2], gb[..., 3],
                norm_angle(math.pi - gb[..., 4]),
            ], -1)
            gb = torch.where(do[:, None, None], fb, gb)
        if flip_v:
            do = draw(flip_v)
            images = torch.where(do[:, None, None, None], images.flip(1), images)
            fb = torch.stack([
                gb[..., 0], H - gb[..., 1] - 1, gb[..., 2], gb[..., 3],
                norm_angle(-gb[..., 4]),
            ], -1)
            gb = torch.where(do[:, None, None], fb, gb)
        if rot90:
            if H != W:
                raise ValueError(f"rot90 needs a square canvas, got {H}x{W}")
            k_rot = torch.where(
                draw(rot90),
                torch.randint(0, 4, (B,), generator=generator, device=dev),
                0,
            )
            sel = k_rot[:, None, None, None]
            rotated = images
            for k in (1, 2, 3):
                rotated = torch.where(sel == k, torch.rot90(images, k, (1, 2)), rotated)
            images = rotated
            # boxes: rotate centers by -k*90deg about the canvas center
            # (rot90 is CCW in array space = CW in y-down image coords)
            theta = -k_rot.float() * (math.pi / 2)
            c = torch.cos(theta)[:, None]
            s = torch.sin(theta)[:, None]
            cx0 = (W - 1) / 2.0
            cy0 = (H - 1) / 2.0
            x = gb[..., 0] - cx0
            y = gb[..., 1] - cy0
            rb = torch.stack([
                c * x - s * y + cx0,
                s * x + c * y + cy0,
                gb[..., 2], gb[..., 3],
                norm_angle(gb[..., 4] + theta[:, None]),
            ], -1)
            gb = torch.where((k_rot > 0)[:, None, None], rb, gb)

        targets = dict(targets)
        targets["gt_bboxes"] = gb
        return images.float(), targets

    return aug


def build_train_step(model, optimizer, preprocess=None, augment=None, seed=0):
    """Build the train step on `model`'s device.

    Returns ``step(images, targets, it) -> log_vars``. Each call makes a
    `torch.Generator` on the batch's device seeded from (seed, it): fresh
    draws every step, the counterpart of the reference's
    ``fold_in(root_key, it)`` (JAX's random streams do not carry over).
    It augments (`augment`, drawing from the generator first), normalizes
    (`preprocess`), runs ``model.loss(images, targets, generator=...)``
    (a two-stage model's samplers draw from the same generator next;
    single-stage models draw nothing), `parse_losses`,
    backward, and `optimizer.step()` (clip, weight decay, momentum SGD at
    the scheduled lr). log_vars holds detached 0-dim tensors on the
    device: the step itself copies nothing to or from the host.

    Building the step drops every expanded-weight cache of the model's
    equivariant and ORN convs and fills those of the frozen backbone
    stages (`models/equivariant::cache_frozen_expansions`, as the
    reference Runner's `_build_train_step` does): their weights never
    change, so they are expanded once and not at every step.
    """
    cache_frozen_expansions(model)

    def step(images, targets, it):
        model.train()
        generator = torch.Generator(device=images.device)
        # the CPU generator keeps only a seed's low 32 bits: mix the seed
        # into them (an odd multiplier), not above them
        generator.manual_seed((seed * 0x9E3779B1 + it) % 2**64)
        if augment is not None:
            images, targets = augment(images, targets, generator)
        if preprocess is not None:
            images = preprocess(images)
        losses = model.loss(images, targets, generator=generator)
        total, log_vars = parse_losses(losses)
        optimizer.zero_grad()
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in log_vars.items()}

    return step
