"""Merge a test pickle of tile detections into whole-image DOTA
submission files.

    python -m jdet_torch.tools.merge_results --results <test_N.pkl> \
        --out-dir DIR [--dataset-type DOTA] [--nms-thr 0.1] [--zip FILE]

The port of `tools/merge_results.py` for DOTA: tile names
`name__rate__left___up` map back to the original image, per-image
per-class polygon NMS merges the overlaps, and one `Task1_<class>.txt`
per class is written (and zipped with --zip). The FAIR1M conversions
(`finalize_submission`) are not ported yet.
"""
from __future__ import annotations

import argparse
import pickle


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--results", required=True, help="test_*.pkl path")
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--dataset-type", default="DOTA")
    parser.add_argument("--nms-thr", type=float, default=0.1)
    parser.add_argument("--zip", default=None)
    args = parser.parse_args(argv)
    if args.dataset_type in ("FAIR", "FAIR1M_1_5"):
        parser.error("FAIR1M submissions need the converters, which jdet_torch has "
                     "not ported yet")

    from jdet_torch.config.constants import get_classes_by_name
    from jdet_torch.data.devkits.result_merge import merge_results, write_dota_submission

    classes = get_classes_by_name(args.dataset_type)
    with open(args.results, "rb") as f:
        results = pickle.load(f)
    merged = merge_results(results, classes, iou_thr=args.nms_thr)
    files = write_dota_submission(merged, classes, args.out_dir, zip_path=args.zip)
    print(f"wrote {len(files)} submission files to {args.out_dir}")
    return files


if __name__ == "__main__":
    main()
