"""Train, validate or test a model from a config file.

    python -m jdet_torch.tools.run_net --config-file <cfg> \
        --task {train,val,test,test_time} [--save_dir DIR] [--cpu]

The port of `tools/run_net.py`, with the same arguments. It runs on the
CUDA card, and raises where there is none, unless `--cpu` is given.
`--task vis_test` needs the visualizer, which is not ported yet.
"""
from __future__ import annotations

import argparse


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
    if args.task == "vis_test":
        parser.error("--task vis_test needs the result visualizer, which jdet_torch "
                     "has not ported yet")

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
        else:
            print(runner.test_time())
    finally:
        runner.close()


if __name__ == "__main__":
    main()
