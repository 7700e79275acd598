"""Time a detector config's paths on the CUDA card, as `chip_smoke.py`'s
main path times them: the loss forward and `predict` at B=2, 1024², and
the train step at B=4, 1024² with 512 gt slots of which 64 are real
(augmentation on, 20 steps first). Each reading is the median of 10
CUDA-event timings after warm-up. Random weights from a seed, float32
(TF32 off, as `chip_smoke.py` sets it) or under the bf16 compute policy.
Prints one JSON line.

    python3 -m jdet_torch.tools.time_paths \
        configs/rotated_retinanet_obb_r50_fpn_1x_dota.py [--bf16] \
        [--against ROOT] [--rounds N] [--paths predict,...]

With `--against ROOT` it also loads the `jdet_torch` package of the
checkout at ROOT under another name, builds the same model from the same
seed there, and times the two in one process, round by round, the order
alternating (A B, B A, ...), so that the host's drift falls on both.
`--paths` times only the named ones of `loss_forward`, `predict` and
`train_step` (the 20 steps first only with `train_step`).
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

STEPS_PER_EPOCH = 1000
PATHS = ("loss_forward", "predict", "train_step")


def synth_batch(B, size, K=32, real=8, seed=0, uint8=False):
    """Images and padded targets as `chip_smoke.synth_batch` makes them."""
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
    return (torch.as_tensor(images, device="cuda"),
            {"gt_bboxes": torch.as_tensor(gt, device="cuda"),
             "gt_labels": torch.as_tensor(labels, device="cuda"),
             "gt_mask": torch.as_tensor(mask, device="cuda")})


def median_ms(fn, warmup, iters=10):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def load_package(root, name):
    """The `jdet_torch` package of the checkout at `root`, as module `name`
    (its modules import one another relatively)."""
    init = Path(root).resolve() / "jdet_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return pkg


class Paths:
    """One package's model of the config and its three timed paths."""

    def __init__(self, pkg, cfg, bf16, paths=PATHS):
        mod = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
        with mod("models.nn").compute_dtype_scope(torch.bfloat16 if bf16 else None):
            self.model = mod("models.builder").build_detector(
                cfg["model"], device="cuda", seed=0, load_pretrained=False)
        optim, parallel = mod("optim"), mod("parallel")
        ocfg, scfg = cfg["optimizer"], cfg["scheduler"]
        # the config's train step, mapped as `chip_smoke.build_trainer` maps it
        schedule = optim.build_lr_schedule(
            ocfg["lr"], scheduler_type=scfg["type"], milestones=scfg["milestones"],
            gamma=scfg["gamma"], steps_per_epoch=STEPS_PER_EPOCH,
            max_steps=cfg["max_epoch"] * STEPS_PER_EPOCH, warmup=scfg["warmup"],
            warmup_iters=scfg["warmup_iters"], warmup_ratio=scfg["warmup_ratio"])
        opt = optim.build_optimizer(
            self.model, opt_type=ocfg["type"], lr_schedule=schedule,
            momentum=ocfg["momentum"], weight_decay=ocfg["weight_decay"],
            grad_clip=ocfg["grad_clip"], frozen_stages=cfg["model"]["backbone"]["frozen_stages"])
        self.step = parallel.build_train_step(
            self.model, opt, preprocess=parallel.make_device_normalizer(**cfg["device_normalize"]),
            augment=parallel.make_device_augmenter(**cfg["device_augment"]), seed=cfg["seed"])
        self.serve_batch = synth_batch(2, 1024)
        self.train_batch = synth_batch(4, 1024, K=512, real=64, seed=3, uint8=True)
        self.it = 0
        self.paths = paths
        for _ in range(20 if "train_step" in paths else 0):
            self.train_step()

    def loss_forward(self):
        self.model.train()
        out = self.model.loss(*self.serve_batch)
        self.model.eval()
        return out

    def predict(self):
        with torch.no_grad():
            return self.model.predict(self.serve_batch[0])

    def train_step(self):
        self.it += 1
        return self.step(*self.train_batch, self.it - 1)

    def time(self):
        return {f"{p}_ms": median_ms(getattr(self, p), warmup=3 if p == "train_step" else 2)
                for p in self.paths}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("config")
    parser.add_argument("--bf16", action="store_true", help="the bf16 compute policy")
    parser.add_argument("--against", default=None,
                        help="root of another checkout, timed in turn with this one")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--paths", default=",".join(PATHS),
                        help="comma-separated paths to time, of " + ", ".join(PATHS))
    args = parser.parse_args(argv)
    paths = tuple(args.paths.split(","))
    if not set(paths) <= set(PATHS):
        parser.error(f"--paths takes {', '.join(PATHS)}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    here = Path(__file__).resolve().parents[2]
    if str(here) not in sys.path:
        sys.path.insert(0, str(here))
    cfg = importlib.import_module("jdet_torch.config").load_cfg_file(args.config)
    roots = {"this": here}
    if args.against:
        load_package(args.against, "jdet_torch_against")
        roots["against"] = Path(args.against).resolve()
    timed = {k: Paths("jdet_torch" if k == "this" else "jdet_torch_against", cfg, args.bf16,
                      paths) for k in roots}
    rounds = {k: [] for k in roots}
    for r in range(args.rounds):
        for k in (list(roots) if r % 2 == 0 else list(roots)[::-1]):
            rounds[k].append(timed[k].time())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out = {"config": args.config, "policy": "bf16" if args.bf16 else "fp32", "card": card}
    for k, rs in rounds.items():
        out[k] = {"root": str(roots[k]),
                  **{m: float(np.median([r[m] for r in rs])) for m in rs[0]},
                  "rounds": rs}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
