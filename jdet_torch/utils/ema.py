"""Model EMA: an exponential moving average of every float tensor of a
model's state dict (parameters and BN statistics alike; integer buffers
are copied), with the warmup-ramped decay d = decay * (1 - exp(-updates /
2000)) taken after the counter's increment.

Port of `jdet_tpu/utils/ema.py` (`ModelEMA` :22). The reference's jitted
update receives d as a float32 scalar and computes e * d + (1 - d) * c;
XLA on the CPU, where the tests hold the port to it, contracts that into
fma(e, d, (1 - d) * c): 1 - d and its product with c rounded to float32,
then one fused multiply-add. The port computes the same on either device:
d rounded to float32, (1 - d) * c in float32, then e * d + that in
float64 (the product of two floats is exact there), rounded once to
float32. The EMA's float tensors are views into one flat buffer, so that
an update is a handful of kernels whatever the number of tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch


class ModelEMA:
    def __init__(self, model=None, decay=0.9999, updates=0, state=None):
        """The EMA of `model`'s state dict, or of `state` ({name: tensor},
        e.g. from a checkpoint) on the model's device where both are
        given."""
        src = model.state_dict() if state is None else state
        device = None
        if model is not None:
            device = next(iter(model.state_dict().values())).device
        state = {k: torch.as_tensor(v).detach().to(device or "cpu") for k, v in src.items()}
        floats = [k for k, v in state.items() if v.is_floating_point()]
        self._flat = torch.cat([state[k].float().reshape(-1) for k in floats]) if floats else None
        self.ema, off = {}, 0
        for k, v in state.items():
            if k in floats:
                self.ema[k] = self._flat[off:off + v.numel()].view(v.shape)
                off += v.numel()
            else:
                self.ema[k] = v.clone()
        self._floats = floats
        self.decay = decay
        self.updates = updates

    def ramped_decay(self):
        return self.decay * (1 - math.exp(-self.updates / 2000))

    @torch.no_grad()
    def update(self, model):
        """Blend the model's current state into the EMA."""
        self.updates += 1
        d = np.float32(self.ramped_decay())
        one_minus = float(np.float32(1.0) - d)
        cur = model.state_dict()
        if self._flat is not None:
            c = torch.cat([cur[k].reshape(-1) for k in self._floats])
            blend = self._flat.double() * float(d) + (c * one_minus).double()
            self._flat.copy_(blend)
        for k, e in self.ema.items():
            if not e.is_floating_point():
                e.copy_(cur[k])
        return self.ema

    def state_dict(self):
        return self.ema
