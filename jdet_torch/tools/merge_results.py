"""Merge a test pickle of tile detections into whole-image DOTA
submission files.

    python -m jdet_torch.tools.merge_results --results <test_N.pkl> \
        --out-dir DIR [--dataset-type DOTA] [--nms-thr 0.1] [--zip FILE] \
        [--images-dir DIR] [--name NAME]

The port of `tools/merge_results.py` for DOTA: tile names
`name__rate__left___up` map back to the original image, per-image
per-class polygon NMS merges the overlaps, and one `Task1_<class>.txt`
per class is written (and zipped with --zip). For `--dataset-type FAIR`
and `FAIR1M_1_5` the txts are then converted as `tools/merge_results.py:47-49`
converts them (`data/devkits/converters.py::finalize_submission`): FAIR to
per-image XML zipped, FAIR1M_1_5 to `<out-dir>/<name>.csv`.
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
    parser.add_argument("--images-dir", default="",
                        help="test images dir (the FAIR conversions key every image, "
                        "even one without detections)")
    parser.add_argument("--name", default="submission", help="submission artifact name")
    args = parser.parse_args(argv)

    from jdet_torch.config.constants import get_classes_by_name
    from jdet_torch.data.devkits.result_merge import merge_results, write_dota_submission

    classes = get_classes_by_name(args.dataset_type)
    with open(args.results, "rb") as f:
        results = pickle.load(f)
    merged = merge_results(results, classes, iou_thr=args.nms_thr)
    fair = args.dataset_type in ("FAIR", "FAIR1M_1_5")
    files = write_dota_submission(merged, classes, args.out_dir,
                                  zip_path=None if fair else args.zip)
    print(f"wrote {len(files)} submission files to {args.out_dir}")
    if fair:
        from jdet_torch.data.devkits.converters import finalize_submission

        artifact = finalize_submission(args.out_dir, args.out_dir, args.name,
                                       args.dataset_type, images_dir=args.images_dir,
                                       zip_path=args.zip)
        print(f"submission artifact: {artifact}")
    return files


if __name__ == "__main__":
    main()
