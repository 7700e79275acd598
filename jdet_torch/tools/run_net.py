"""Train, validate or test a model from a config file.

    python -m jdet_torch.tools.run_net --config-file <cfg> \
        --task {train,val,test,test_time,vis_test} [--save_dir DIR] [--cpu]

The port of `tools/run_net.py`, with the same arguments. It runs on the
CUDA card, and raises where there is none, unless `--cpu` is given.
`--task vis_test` predicts over the config's `images_dir` and writes the
images with their detections drawn to `work_dir/vis`.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config-file", required=True)
    parser.add_argument(
        "--task", default="train",
        choices=["train", "val", "test", "vis_test", "test_time"],
    )
    parser.add_argument("--save_dir", default=None)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = parser.parse_args(argv)

    from jdet_torch.config import init_cfg
    from jdet_torch.runner import Runner

    cfg = init_cfg(args.config_file)
    if args.save_dir:
        cfg["work_dir"] = args.save_dir
    runner = Runner(cfg, device="cpu" if args.cpu else "cuda")
    try:
        if args.task == "train":
            runner.run()
        elif args.task == "val":
            print(runner.val())
        elif args.task == "test":
            print(runner.test())
        elif args.task == "test_time":
            print(runner.test_time())
        else:
            runner.run_on_images(cfg.get("images_dir"), os.path.join(runner.work_dir, "vis"))
    finally:
        runner.close()


if __name__ == "__main__":
    main()
