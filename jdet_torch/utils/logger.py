"""Run loggers: timestamped text file, TensorBoard scalars, composite.

Port of `jdet_tpu/utils/logger.py`: `TextLogger` writes `k: v` lines
with a timestamp; `TensorboardLogger` writes scalars keyed on `iter`
through `torch.utils.tensorboard`; `RunLogger` composes the two and
prints to the console. TensorBoard is optional, as in the reference
(:54): where it cannot be imported, `RunLogger` prints that it is
disabled and goes on without it.
"""
from __future__ import annotations

import os
import time


class TextLogger:
    def __init__(self, work_dir):
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(
            work_dir, f"log_{time.strftime('%Y%m%d_%H%M%S')}.txt"
        )

    def log(self, data):
        line = time.strftime("%Y-%m-%d %H:%M:%S") + " " + ", ".join(
            f"{k}: {v}" for k, v in data.items()
        )
        with open(self.path, "a") as f:
            f.write(line + "\n")


class TensorboardLogger:
    def __init__(self, work_dir):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(os.path.join(work_dir, "tensorboard"))

    def log(self, data):
        step = int(data.get("iter", 0))
        for k, v in data.items():
            if isinstance(v, (int, float)) and k != "iter":
                self.writer.add_scalar(k, v, step)
        self.writer.flush()


class RunLogger:
    def __init__(self, work_dir):
        self.loggers = [TextLogger(work_dir)]
        try:
            self.loggers.append(TensorboardLogger(work_dir))
        except ImportError as e:
            print(f"[logger] TensorboardLogger disabled: {e}", flush=True)

    def log(self, data):
        data = {
            k: (round(float(v), 5) if hasattr(v, "dtype") or isinstance(v, float) else v)
            for k, v in data.items()
        }
        for lg in self.loggers:
            lg.log(data)
        self.print_on_screen(data)

    def print_on_screen(self, data):
        print(", ".join(f"{k}: {v}" for k, v in data.items()), flush=True)
