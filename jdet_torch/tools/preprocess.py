"""Tile a DOTA-style dataset and write its labels.pkl.

    python -m jdet_torch.tools.preprocess --config-file <cfg> [--clear]

The port of `tools/preprocess.py`, with the same arguments: it reads the
config's `preprocess` section (or `dataset.preprocess`): `dataset_type`,
`subsize`, `gap`, `rates`, `iou_thresh` and `tasks`, each task an
`image_dir`, an optional `label_dir` and an `out_dir`. Each task's scenes
are tiled into out_dir/images and out_dir/labelTxt
(`jdet_torch/data/devkits/tiling.py`), and a task with labels gets
out_dir/labels.pkl. `--clear` removes each out_dir first. A `convert`
step runs before the tiling, as `tools/preprocess.py:36-59` runs it
(`convert` below, on `data/devkits/converters.py`).
"""
from __future__ import annotations

import argparse
import os
import shutil


def convert(conv, classes):
    """The section's `convert` step: SSDD / SSDD+ trees (JPEG + XML) become
    DOTA trees resized to `resize`² with a labels.pkl each (no tiling);
    FAIR / FAIR1M_1_5 trees (TIFF + XML) become DOTA trees, tiled next by
    the section's tasks."""
    from jdet_torch.data.devkits.converters import fair_to_dota, ssdd_to_dota
    from jdet_torch.data.devkits.tiling import convert_to_pkl

    ctype = conv["type"]
    if ctype in ("SSDD", "SSDD+"):
        for task in conv["tasks"]:
            out_path = task["out_dir"]
            print(f"[preprocess] ssdd_to_dota -> {out_path}", flush=True)
            ssdd_to_dota(task["image_dir"], task["label_dir"], out_path,
                         resize=conv.get("resize", 512), plus=ctype == "SSDD+")
            convert_to_pkl(out_path, os.path.join(out_path, "labels.pkl"), classes,
                           filter_empty_gt=task.get("filter_empty_gt", True))
    elif ctype in ("FAIR", "FAIR1M_1_5"):
        for task in conv["tasks"]:
            print(f"[preprocess] fair_to_dota -> {task['out_dir']}", flush=True)
            fair_to_dota(task["in_dir"], task["out_dir"])
    else:
        raise ValueError(f"unknown convert type {ctype!r}: SSDD, SSDD+, FAIR or FAIR1M_1_5")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--clear", action="store_true", help="remove existing outputs first")
    args = parser.parse_args(argv)

    from jdet_torch.config import init_cfg
    from jdet_torch.config.constants import get_classes_by_name
    from jdet_torch.data.devkits.tiling import convert_to_pkl, process

    cfg = init_cfg(args.config_file)
    pcfg = cfg.get("preprocess") or (cfg.get("dataset") or {}).get("preprocess")
    if not pcfg:
        raise ValueError(f"{args.config_file}: the config needs a `preprocess` section")
    classes = get_classes_by_name(pcfg.get("dataset_type", "DOTA"))
    conv = pcfg.get("convert")
    if conv:
        convert(conv, classes)

    written = []
    for task in pcfg.get("tasks", []):
        out_dir = task["out_dir"]
        if args.clear and os.path.exists(out_dir):
            shutil.rmtree(out_dir)
        print(f"[preprocess] tiling {task['image_dir']} -> {out_dir}", flush=True)
        tiles = process(
            task["image_dir"], task.get("label_dir"), out_dir,
            subsize=pcfg.get("subsize", 1024), gap=pcfg.get("gap", 200),
            rates=tuple(pcfg.get("rates", [1.0])), thresh=pcfg.get("iou_thresh", 0.7),
        )
        written.append(tiles)
        if task.get("label_dir"):
            pkl = os.path.join(out_dir, "labels.pkl")
            convert_to_pkl(out_dir, pkl, classes,
                           filter_empty_gt=task.get("filter_empty_gt", True))
            print(f"[preprocess] wrote {pkl}", flush=True)
    return written


if __name__ == "__main__":
    main()
