"""Runner: builds everything from a config and drives train/val/test on
one device.

Port of `jdet_tpu/runner/runner.py` (constructor :47-199, `run` :283,
`train_epoch` :296, `_run_inference` :340, `val` :418, `test` :429,
`run_on_images` :450, `profile` :465, `test_time` :494,
`save`/`load`/`resume` :526-572,
`_unflip_dets` :574, `_meta_light` :600). The config is a plain dict
(`jdet_torch.config`).

Host batches come from the dataset's DataLoader, pinned when the device
is the card, and are copied with `non_blocking=True`. The train step
never synchronises: its losses stay on the device and are read with
`.item()` only every `log_interval` iterations, as the reference reads
them only when it logs.

Keys the port cannot honour raise instead of being ignored:
`scheduler.groups` (per-group schedules) and `ema`.
"""
from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from .. import data as _data  # noqa: F401 — registers DATASETS/TRANSFORMS
from ..config import get_cfg, save_cfg
from ..models.builder import build_detector
from ..models.equivariant import cache_expanded_weights, cache_frozen_expansions
from ..optim import build_lr_schedule, build_optimizer
from ..parallel import build_train_step, make_device_augmenter, make_device_normalizer
from ..utils.general import build_file, check_interval, search_ckpt, set_random_seed
from ..utils.logger import RunLogger
from ..utils.registry import DATASETS, build_from_cfg
from .checkpoint import load_checkpoint, save_checkpoint


class Runner:
    def __init__(self, cfg=None, device="cuda"):
        """Build the model, datasets, optimizer, schedule and logger from
        `cfg` (the global config if None) on `device`. The default is the
        card: it raises where CUDA is missing; pass device="cpu" to run
        on the CPU."""
        self.device = torch.device(device)
        # pinned host batches make the copies to the card asynchronous
        self.pin_memory = self.device.type == "cuda"
        if self.pin_memory and not torch.cuda.is_available():
            raise RuntimeError(
                "Runner: device 'cuda' requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        cfg = get_cfg() if cfg is None else cfg
        self.cfg = cfg
        scfg = dict(cfg.get("scheduler") or {})
        if cfg.get("ema"):
            raise NotImplementedError("ema: model EMA is not ported to jdet_torch yet")
        if scfg.get("groups"):
            raise NotImplementedError(
                "scheduler.groups: per-group lr schedules are not ported to jdet_torch yet")
        self.work_dir = os.path.abspath(cfg.get("work_dir") or "exp/default")
        self.max_epoch = cfg.get("max_epoch") or 0
        self.max_iter = cfg.get("max_iter") or 0
        if not (self.max_epoch or self.max_iter):
            raise ValueError("the config needs max_epoch or max_iter")
        self.checkpoint_interval = cfg.get("checkpoint_interval") or 1
        self.eval_interval = cfg.get("eval_interval")
        self.log_interval = cfg.get("log_interval") or 50
        self.seed = cfg.get("seed") or 0
        if cfg.get("seed") is not None:
            set_random_seed(cfg["seed"])

        self.model = build_detector(cfg["model"], device=self.device, seed=self.seed)

        ds_cfg = cfg.get("dataset") or {}

        def dataset(split):
            return build_from_cfg(ds_cfg[split], DATASETS) if ds_cfg.get(split) else None

        self.train_dataset = dataset("train")
        self.val_dataset = dataset("val")
        self.test_dataset = dataset("test")

        steps_per_epoch = self.train_dataset.num_batches if self.train_dataset else 1
        if not self.max_iter:
            self.max_iter = self.max_epoch * steps_per_epoch
        if not self.max_epoch:
            self.max_epoch = max(1, self.max_iter // max(steps_per_epoch, 1))

        ocfg = dict(cfg.get("optimizer") or {"type": "SGD", "lr": 0.01})
        self.lr_schedule = build_lr_schedule(
            ocfg.get("lr", 0.01),
            scheduler_type=scfg.get("type", "StepLR"),
            milestones=scfg.get("milestones", ()),
            gamma=scfg.get("gamma", 0.1),
            steps_per_epoch=steps_per_epoch,
            max_steps=self.max_iter,
            warmup=scfg.get("warmup"),
            warmup_iters=scfg.get("warmup_iters", 500),
            warmup_ratio=scfg.get("warmup_ratio", 1.0 / 3),
            min_lr=scfg.get("min_lr", 0.0),
            power=scfg.get("power", 1.0),
        )
        self.optimizer = build_optimizer(
            self.model,
            opt_type=ocfg.get("type", "SGD"),
            lr_schedule=self.lr_schedule,
            momentum=ocfg.get("momentum", 0.9),
            weight_decay=ocfg.get("weight_decay", 0.0001),
            grad_clip=ocfg.get("grad_clip"),
            frozen_stages=cfg["model"].get("backbone", {}).get("frozen_stages"),
            param_groups=ocfg.get("param_groups"),
        )
        dn = cfg.get("device_normalize")
        self._preprocess = make_device_normalizer(
            dn.get("mean", [0.0, 0.0, 0.0]), dn.get("std", [1.0, 1.0, 1.0]),
            dn.get("to_bgr", False)) if dn else None
        da = cfg.get("device_augment")
        self._augment = make_device_augmenter(
            flip_h=da.get("flip_h", 0.0), flip_v=da.get("flip_v", 0.0),
            rot90=da.get("rot90", 0.0)) if da else None
        self._train_step = build_train_step(
            self.model, self.optimizer, preprocess=self._preprocess,
            augment=self._augment, seed=self.seed)

        self.logger = RunLogger(self.work_dir)
        self.epoch = 0
        self.iter = 0
        # per train epoch, (loader wait s, iteration s) of each iteration,
        # on the host's clock
        self.iteration_times = []
        save_cfg(os.path.join(self.work_dir, "config.json"), cfg)
        if cfg.get("pretrained_weights"):
            self.load(cfg["pretrained_weights"], model_only=True)
        if cfg.get("resume_path") or cfg.get("resume"):
            self.resume()

    @property
    def finish(self):
        return self.epoch >= self.max_epoch

    def _to_device(self, batch):
        images = batch["images"].to(self.device, non_blocking=True)
        targets = {k: v.to(self.device, non_blocking=True) for k, v in batch["targets"].items()}
        return images, targets

    # ------------------------------------------------------------------
    def run(self):
        self.logger.print_on_screen({"work_dir": self.work_dir, "max_epoch": self.max_epoch})
        while not self.finish:
            self.train_epoch()
            if check_interval(self.epoch, self.eval_interval):
                self.val()
            if check_interval(self.epoch, self.checkpoint_interval):
                self.save()
        self.test()

    def train_epoch(self):
        start = time.time()
        n_img = 0
        times = []
        batches = iter(self.train_dataset.batches(
            epoch=self.epoch, seed=self.seed, pin_memory=self.pin_memory))
        while not (self.max_iter and self.iter >= self.max_iter):
            t0 = time.perf_counter()
            item = next(batches, None)
            if item is None:
                break
            wait = time.perf_counter() - t0
            images, targets = self._to_device(item[0])
            log_vars = self._train_step(images, targets, self.iter)
            self.iter += 1
            n_img += images.shape[0]
            if check_interval(self.iter, self.log_interval):
                dt = time.time() - start
                eta = (self.max_iter - self.iter) * dt / (len(times) + 1)
                self.logger.log({
                    "name": self.cfg.get("name"),
                    "epoch": self.epoch,
                    "iter": self.iter,
                    "lr": float(self.lr_schedule(self.iter)),
                    "fps": round(n_img / max(dt, 1e-9), 2),
                    "eta_min": round(eta / 60, 1),
                    **{k: v.item() for k, v in log_vars.items()},
                })
            times.append((wait, time.perf_counter() - t0))
        self.epoch += 1
        self.iteration_times.append(times)

    # ------------------------------------------------------------------
    def _run_inference(self, dataset):
        """Eval-mode predict over `dataset`, with the flips of `flip_test`
        (reference runner.py:340) as extra passes whose detections are
        unflipped back. Returns [(det of numpy arrays, meta)].

        The expanded weights of the equivariant and ORN convs are cached
        from the current weights for the pass (the reference's
        `cache_expanded_weights` around inference), and afterwards only
        the frozen stages' stay cached, as the train step wants them."""
        self.model.eval()
        cache_expanded_weights(self.model)
        flip_modes = list(self.cfg.get("flip_test") or [])
        results = []
        for batch, metas in dataset.batches(pin_memory=self.pin_memory):
            images, targets = self._to_device(batch)
            sf = targets["scale_factor"]
            variants = [(None, images)]
            for mode in flip_modes:
                v = images
                if "H" in mode:
                    v = v.flip(2)
                if "V" in mode:
                    v = v.flip(1)
                variants.append((mode, v))
            for mode, imgs in variants:
                x = self._preprocess(imgs) if self._preprocess is not None else imgs.float()
                det = self.model.predict(x, {"scale_factor": sf})
                det = {k: v.cpu().numpy() for k, v in det.items()}
                if mode is not None:
                    det = _unflip_dets(det, mode, images.shape[2], images.shape[1])
                for i, meta in enumerate(metas):
                    results.append(({k: v[i] for k, v in det.items()}, meta))
        cache_frozen_expansions(self.model)
        return results

    def val(self):
        if self.val_dataset is None:
            return {}
        results = self._run_inference(self.val_dataset)
        metrics = self.val_dataset.evaluate(results, self.work_dir, self.epoch)
        self.logger.log({"iter": self.iter, **metrics})
        return metrics

    def test(self):
        """Predict over the test dataset; write work_dir/test/test_<epoch>.pkl
        and, where the dataset writes one, the submission."""
        if self.test_dataset is None:
            return None
        results = self._run_inference(self.test_dataset)
        path = build_file(self.work_dir, f"test/test_{self.epoch}.pkl")
        with open(path, "wb") as f:
            pickle.dump([(det, _meta_light(meta)) for det, meta in results], f)
        if hasattr(self.test_dataset, "save_submission"):
            self.test_dataset.save_submission(results, os.path.join(self.work_dir, "submission"))
        return path

    def run_on_images(self, images_dir, save_dir=None):
        """Predict over the images of `images_dir` (an `ImageDataset` of
        `dataset_type`, with the test split's transforms and canvas) and,
        where `save_dir` is given, write them with their detections drawn
        (`utils/visualization.py::visualize_results`). Returns the
        results."""
        from ..data.dota import ImageDataset
        from ..utils.visualization import visualize_results

        test_cfg = dict((self.cfg.get("dataset") or {}).get("test") or {})
        ds = ImageDataset(images_dir=images_dir,
                          dataset_type=self.cfg.get("dataset_type") or "DOTA",
                          transforms=test_cfg.get("transforms"),
                          image_size=test_cfg.get("image_size", (1024, 1024)))
        results = self._run_inference(ds)
        if save_dir:
            visualize_results(results, ds.CLASSES, images_dir, save_dir)
        return results

    def profile(self, n_steps=10, out_dir=None):
        """Record `n_steps` train steps on one batch under `torch.profiler`
        (host and, on the card, CUDA activity), after one step outside
        the trace, and write a Chrome trace into `out_dir` (default
        work_dir/profile). The steps train the model, as the reference's
        do. Returns the trace's path."""
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        out_dir = out_dir or os.path.join(self.work_dir, "profile")
        os.makedirs(out_dir, exist_ok=True)
        batch, _ = next(iter(self.train_dataset.batches(pin_memory=self.pin_memory)))
        images, targets = self._to_device(batch)
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._train_step(images, targets, 0)
        sync()
        with torch_profile(activities=activities) as prof:
            for i in range(n_steps):
                self._train_step(images, targets, i + 1)
            sync()
        path = os.path.join(out_dir, "train_steps_trace.json")
        prof.export_chrome_trace(path)
        self.logger.print_on_screen({"profile_trace": path})
        return path

    def test_time(self, warmup=10, rerun=100):
        """Train steps per second on one repeated batch, as images/s
        (reference runner.py:494), synchronised around the timed loop."""
        batch, _ = next(iter(self.train_dataset.batches(pin_memory=self.pin_memory)))
        images, targets = self._to_device(batch)
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        for it in range(warmup):
            self._train_step(images, targets, it)
        sync()
        t0 = time.perf_counter()
        for it in range(warmup, warmup + rerun):
            self._train_step(images, targets, it)
        sync()
        fps = rerun * images.shape[0] / (time.perf_counter() - t0)
        self.logger.print_on_screen({"FPS": round(fps, 2)})
        return fps

    # ------------------------------------------------------------------
    def save(self):
        path = build_file(self.work_dir, f"checkpoints/ckpt_{self.epoch}.pkl")
        meta = {
            "epoch": self.epoch,
            "iter": self.iter,
            "max_epoch": self.max_epoch,
            "max_iter": self.max_iter,
            "config": self.cfg,
        }
        return save_checkpoint(path, self.model, self.optimizer, meta)

    def load(self, path, model_only=False):
        meta = load_checkpoint(path, self.model, self.optimizer, model_only)
        # the frozen stages' expansions, from the loaded weights
        cache_frozen_expansions(self.model)
        if not model_only:
            self.epoch = meta.get("epoch", 0)
            self.iter = meta.get("iter", 0)
        return meta

    def resume(self):
        path = self.cfg.get("resume_path") or search_ckpt(self.work_dir)
        if path and os.path.exists(path):
            self.load(path)
            self.logger.print_on_screen({"resumed": path})

    def close(self):
        """Stop the datasets' loader workers."""
        for ds in (self.train_dataset, self.val_dataset, self.test_dataset):
            if ds is not None:
                ds.close()


def _unflip_dets(det, mode, width, height):
    """Map detections from a flipped image back (data_merge.py:14-27
    unflip semantics; rbox flip formulas from transforms.py:393-398)."""
    boxes = det["boxes"].copy()
    polys = det["polys"].copy()
    if "H" in mode:
        boxes[..., 0] = width - boxes[..., 0] - 1
        boxes[..., 4] = (np.pi - boxes[..., 4] + np.pi / 4) % np.pi - np.pi / 4
        polys[..., 0::2] = width - polys[..., 0::2] - 1
    if "V" in mode:
        boxes[..., 1] = height - boxes[..., 1] - 1
        boxes[..., 4] = (-boxes[..., 4] + np.pi / 4) % np.pi - np.pi / 4
        polys[..., 1::2] = height - polys[..., 1::2] - 1
    det["boxes"] = boxes
    det["polys"] = polys
    return det


def _meta_light(meta):
    return {
        k: v
        for k, v in meta.items()
        if k in ("filename", "img_id", "img_size", "scale_factor")
    }
