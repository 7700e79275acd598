"""Convert torchvision, jittor and JDet weight files into jdet_torch
checkpoints, with no JAX.

    # an ImageNet backbone (.pth or .pkl) -> a file for backbone.pretrained
    python -m jdet_torch.tools.convert_weights --src resnet50.pth \
        --family resnet50 --out work/pretrained/resnet50.jtorch.pkl

    # a JDet detector checkpoint -> a checkpoint for Runner.load / resume
    python -m jdet_torch.tools.convert_weights --src ckpt_12.pkl \
        --config-file configs/s2anet_r50_fpn_1x_dota.py \
        --out work/s2anet_imported.jtorch.pkl

The counterpart of the JAX package's `tools/convert_weights.py` (the same
arguments and families), writing the port's own checkpoint format
(`runner/checkpoint.py`), built on `models/pretrained.py`. It runs on
the CPU. `backbone.pretrained` and `Runner.load` also take the source
files themselves; a converted file loads without converting again.
"""
from __future__ import annotations

import argparse
import os
import pickle

FAMILIES = {
    "resnet18": dict(type="ResNet", depth=18),
    "resnet34": dict(type="ResNet", depth=34),
    "resnet50": dict(type="ResNet", depth=50),
    "resnet101": dict(type="ResNet", depth=101),
    "resnet50_v1d": dict(type="ResNet_v1d", depth=50),
    "resnet101_v1d": dict(type="ResNet_v1d", depth=101),
    "reresnet50": dict(type="ReResNet", depth=50, base_fields=8),
    "lsknet_t": dict(type="LSKNet", arch="t"),
    "lsknet_s": dict(type="LSKNet", arch="s"),
    "stripnet_s": dict(type="StripNet", arch="s"),
    "vgg16": dict(type="SSDVGG"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help=".pth/.pkl source weights")
    ap.add_argument("--family", choices=sorted(FAMILIES),
                    help="backbone family (for ImageNet state dicts)")
    ap.add_argument("--config-file", help="detector config (for full detector checkpoints)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--strict", action="store_true", help="fail on unmatched source keys")
    args = ap.parse_args(argv)
    if not (args.config_file or args.family):
        ap.error("pass --family (backbone) or --config-file (detector)")

    import torch

    from jdet_torch.models import pretrained
    from jdet_torch.runner.checkpoint import VERSION, save_checkpoint

    if args.config_file:
        from jdet_torch.config import load_cfg_file
        from jdet_torch.models.builder import build_detector

        cfg = load_cfg_file(args.config_file)
        # backbone.pretrained is skipped: the checkpoint replaces every weight
        model = build_detector(dict(cfg["model"]), device="cpu", seed=0, load_pretrained=False)
        loaded, missing, unexpected = pretrained.import_jdet_checkpoint(
            model, args.src, strict=args.strict)
        save_checkpoint(args.out, model, meta={"imported_from": args.src})
    else:
        from jdet_torch.models import backbones  # noqa: F401 (registration)
        from jdet_torch.utils.registry import BACKBONES

        bcfg = dict(FAMILIES[args.family])
        model = BACKBONES.get(bcfg.pop("type"))(generator=torch.Generator().manual_seed(0),
                                               **bcfg)
        mapping = pretrained.backbone_to_flat(model, pretrained.load_blob(args.src))
        loaded, missing, unexpected = pretrained.assign_state(model, mapping,
                                                              strict=args.strict)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "wb") as f:
            pickle.dump({"meta": {"jdet_torch_version": VERSION, "family": args.family,
                                  "imported_from": args.src},
                         "model": {k: v.numpy() for k, v in model.state_dict().items()}},
                        f, protocol=4)
    print(f"loaded {len(loaded)} tensors -> {args.out} ({len(missing)} model params left "
          f"at init, {len(unexpected)} source keys unused)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
