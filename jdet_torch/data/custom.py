"""Dataset base: `labels.pkl` annotations -> fixed-shape batches.

Port of `jdet_tpu/data/custom.py` (`CustomDataset`): mmdet-style
`labels.pkl` records {filename, width, height, ann{bboxes (n, 5) rotated,
labels (n,), bboxes_ignore, labels_ignore}}; images without gts are
filtered (:99-109); the optional uint8 tile cache (:76-80, :124-152);
`load_sample` :154; the fixed-shape `collate` :184 (the README batch
contract: images padded to the static canvas, gts padded to `max_gt` with
a mask, `image_dtype="uint8"` shipping raw pixels); the per-epoch plan
`_plan_batches` :236 with the reference's `default_rng(seed + epoch)`
shuffle; and the per-sample generator of :270, so that the port's batches
equal the reference's.

`batches()` is a `torch.utils.data.DataLoader` over the planned index
batches (`batch_size=None`, order kept): worker processes decode,
transform and collate, the main process receives tensors (pinned when
asked). Workers are spawned, never forked: a forked worker of a process
that holds threads (a CUDA context, JAX's runtime in the tests) can hang,
as the reference's `_get_pool` (:283-297) warns. They persist across
epochs.
"""
from __future__ import annotations

import hashlib
import os
import pickle

import numpy as np
import torch

from ..utils.registry import DATASETS
from .image_io import imread
from .transforms import Compose, rbox_to_poly_np

_META_KEYS = (
    "img_size", "ori_img_size", "scale_factor", "filename", "img_id", "flip",
    "pad_shape", "polys", "polys_ignore", "labels",
)


def _to_torch(item):
    """A collated (batch, metas) with the batch's arrays as tensors; metas
    stay numpy. Runs in the loader's worker (module level, so it pickles)."""
    batch, metas = item
    return {
        "images": torch.from_numpy(batch["images"]),
        "targets": {k: torch.from_numpy(v) for k, v in batch["targets"].items()},
    }, metas


class _EpochPlan(torch.utils.data.Sampler):
    """The loader's sampler: the (index batch, epoch, seed) work items of
    the epoch set last, read in order."""

    def __init__(self):
        self.work = []

    def __iter__(self):
        return iter(self.work)

    def __len__(self):
        return len(self.work)


class _BatchLoader(torch.utils.data.Dataset):
    """`dataset[(index batch, epoch, seed)]` -> one collated batch."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __getitem__(self, work):
        return self.dataset._load_batch(work)


@DATASETS.register_module()
class CustomDataset:
    CLASSES = None

    def __init__(
        self,
        annotations_file=None,
        images_dir="",
        transforms=None,
        batch_size=1,
        num_workers=2,
        shuffle=False,
        filter_empty_gt=True,
        max_gt=128,
        image_size=(1024, 1024),
        classes=None,
        drop_last=True,
        shard_by_process=False,
        image_dtype="float32",
        image_cache=None,
    ):
        if shard_by_process:
            raise NotImplementedError(
                "shard_by_process: the port runs on one card; sharding batches "
                "across processes waits for the data-parallel slice")
        self.image_dtype = image_dtype
        self.images_dir = images_dir
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.shuffle = shuffle
        self.max_gt = max_gt
        self.image_size = tuple(image_size)  # (w, h) static batch canvas
        self.drop_last = drop_last
        if classes is not None:
            self.CLASSES = classes
        self.transforms = (
            transforms
            if isinstance(transforms, Compose)
            else Compose(transforms or [])
        )
        self.img_infos = []
        if annotations_file is not None:
            with open(annotations_file, "rb") as f:
                self.img_infos = pickle.load(f)
        if filter_empty_gt:
            self.img_infos = [
                a
                for a in self.img_infos
                if a.get("ann", {}).get("bboxes") is not None
                and len(a["ann"]["bboxes"]) > 0
            ]
        self.image_cache = image_cache
        self.annotations_file = annotations_file
        self._cache_mm = None
        self._cache_valid = None
        self._loader = None

    def __len__(self):
        return len(self.img_infos)

    @property
    def num_batches(self):
        n = len(self) // self.batch_size
        if not self.drop_last and len(self) % self.batch_size:
            n += 1
        return n

    # ------------------------------------------------------------------
    @property
    def image_cache_path(self):
        """The tile cache's file. "auto" puts it beside the annotations
        pkl, keyed by a digest of the image list and the canvas, so that
        datasets that filter or repeat images differently (train and val
        of one pkl) never read each other's slots."""
        if self.image_cache != "auto":
            return self.image_cache
        if self.annotations_file is None:
            return None
        key = hashlib.sha1(repr(
            ([a["filename"] for a in self.img_infos], self.image_size)).encode()).hexdigest()
        return f"{self.annotations_file}.{key[:12]}.tilecache.npy"

    def _cache(self):
        """The pre-decoded uint8 tile cache (reference :124-152): a memmap
        of (n, H, W, 3) pixels and a memmap of per-slot valid flags,
        created on first use. Only images whose decoded size equals the
        canvas are cached, so the cache holds pre-transform pixels and every
        random transform still sees the original image."""
        path = self.image_cache_path
        if self._cache_mm is None and path:
            W, H = self.image_size
            shape = (len(self.img_infos), H, W, 3)
            vpath = path + ".valid"
            mm = np.load(path, mmap_mode="r+") if os.path.exists(path) else None
            if mm is None or mm.shape != shape or not os.path.exists(vpath):
                mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint8, shape=shape)
                valid = np.lib.format.open_memmap(
                    vpath, mode="w+", dtype=np.uint8, shape=(shape[0],))
                valid[:] = 0
                valid.flush()
            self._cache_mm = mm
            self._cache_valid = np.load(vpath, mmap_mode="r+")
        return self._cache_mm

    def _read_image(self, idx, info):
        mm = self._cache()
        if mm is not None and self._cache_valid[idx]:
            return np.asarray(mm[idx])
        img = imread(os.path.join(self.images_dir, info["filename"]))
        if mm is not None and img.shape[:2] == mm.shape[1:3]:
            mm[idx] = img
            self._cache_valid[idx] = 1
        return img

    def load_sample(self, idx, rng=None):
        info = self.img_infos[idx]
        img = self._read_image(idx, info)
        ann = info.get("ann", {})
        rboxes = np.asarray(ann.get("bboxes", np.zeros((0, 5))), np.float32).reshape(-1, 5)
        labels = np.asarray(ann.get("labels", np.zeros((0,))), np.int32).reshape(-1)
        rboxes_ignore = np.asarray(
            ann.get("bboxes_ignore", np.zeros((0, 5))), np.float32
        ).reshape(-1, 5)
        polys = rbox_to_poly_np(rboxes)
        target = {
            "rboxes": rboxes,
            "labels": labels,
            "rboxes_ignore": rboxes_ignore,
            "polys": polys,
            "polys_ignore": rbox_to_poly_np(rboxes_ignore),
            "hboxes": np.stack(
                [polys[:, 0::2].min(1), polys[:, 1::2].min(1),
                 polys[:, 0::2].max(1), polys[:, 1::2].max(1)], 1
            ) if len(polys) else np.zeros((0, 4), np.float32),
            "img_size": (img.shape[1], img.shape[0]),
            "ori_img_size": (img.shape[1], img.shape[0]),
            "scale_factor": 1.0,
            "filename": info["filename"],
            "img_id": idx,
        }
        img, target = self.transforms(img, target, rng=rng)
        return img, target

    # ------------------------------------------------------------------
    def collate(self, samples):
        """Fixed-shape batch: images to the static canvas, gts to max_gt.
        With `image_dtype="uint8"` the images stay raw pixels, to be
        normalized on the card (the Runner's `device_normalize`)."""
        B = len(samples)
        W, H = self.image_size
        img_dt = np.uint8 if self.image_dtype == "uint8" else np.float32
        images = np.zeros((B, H, W, 3), img_dt)
        gt_bboxes = np.zeros((B, self.max_gt, 5), np.float32)
        gt_labels = np.zeros((B, self.max_gt), np.int32)
        gt_mask = np.zeros((B, self.max_gt), bool)
        metas = []
        for i, (img, t) in enumerate(samples):
            h, w = img.shape[:2]
            images[i, : min(h, H), : min(w, W)] = img[:H, :W]
            k = min(len(t["rboxes"]), self.max_gt)
            if k:
                gt_bboxes[i, :k] = t["rboxes"][:k]
                gt_labels[i, :k] = t["labels"][:k]
                gt_mask[i, :k] = True
            metas.append({k2: t.get(k2) for k2 in _META_KEYS})
        batch = {
            "images": images,
            "targets": {
                "gt_bboxes": gt_bboxes,
                "gt_labels": gt_labels,
                "gt_mask": gt_mask,
                "scale_factor": np.asarray(
                    [m["scale_factor"] for m in metas], np.float32
                ),
            },
        }
        return batch, metas

    # ------------------------------------------------------------------
    def _plan_batches(self, epoch, seed):
        """Per-epoch index batches, shuffled from default_rng(seed + epoch)
        (reference :236)."""
        order = np.arange(len(self))
        rng = np.random.default_rng(seed + epoch)
        if self.shuffle:
            rng.shuffle(order)
        n = len(order)
        if self.drop_last:
            n = (n // self.batch_size) * self.batch_size
        return [
            order[i : i + self.batch_size]
            for i in range(0, n, self.batch_size)
        ]

    def _load_batch(self, work):
        """Decode + transform + collate one batch (runs in a worker)."""
        batch_idx, epoch, seed = work
        samples = [
            self.load_sample(
                int(i), np.random.default_rng((seed * 100003 + epoch) * 1000003 + int(i))
            )
            for i in batch_idx
        ]
        return self.collate(samples)

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_loader"] = None  # workers get the dataset, not its loader
        d["_cache_mm"] = None  # workers re-open the memmaps lazily
        d["_cache_valid"] = None
        return d

    def batches(self, epoch=0, seed=0, pin_memory=False):
        """The epoch's collated batches in planned order, as a DataLoader
        that yields ({"images", "targets"} of tensors, metas).
        num_workers > 0 spawns that many persistent workers at the first
        call; pin_memory pins the tensors for non-blocking copies to the
        card."""
        self._cache()  # create the cache files before any worker opens them
        if self._loader is not None and self._loader.pin_memory != pin_memory:
            self.close()
        if self._loader is None:
            n = self.num_workers or 0
            self._loader = torch.utils.data.DataLoader(
                _BatchLoader(self), batch_size=None, sampler=_EpochPlan(),
                num_workers=n, collate_fn=_to_torch, pin_memory=pin_memory,
                multiprocessing_context="spawn" if n > 0 else None,
                persistent_workers=n > 0, prefetch_factor=2 if n > 0 else None,
            )
        self._loader.sampler.work = [
            (b, epoch, seed) for b in self._plan_batches(epoch, seed)]
        return self._loader

    def close(self):
        """Stop the loader's worker processes, if it started any."""
        if self._loader is not None and self._loader._iterator is not None:
            self._loader._iterator._shutdown_workers()
        self._loader = None

    def evaluate(self, results, work_dir=None, epoch=None, **kw):
        raise NotImplementedError
