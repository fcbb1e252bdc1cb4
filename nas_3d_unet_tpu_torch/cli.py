"""Command-line interface: preprocess / search / train / predict.

Counterpart of `nas_3d_unet_tpu/cli.py`, reading a JSON config with dotted
overrides:

    python -m nas_3d_unet_tpu_torch preprocess -c config.json
    python -m nas_3d_unet_tpu_torch search     -c config.json -o search.epochs=5
    python -m nas_3d_unet_tpu_torch train      -c config.json -o train.epochs=2
    python -m nas_3d_unet_tpu_torch predict    -c config.json -o infer.overlap=0.25

`search` writes `metrics.jsonl`, its checkpoints and `genotype.json` under
`search.checkpoint_dir`; `train` and `predict` read the genotype at
`train.genotype_path` (the flagship's when there is none).  Every command
runs on the card (`--device cuda`, the default) and fails where there is
none; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from .utils.config import load_config, parse_overrides
from .utils.device import resolve_device


def _load_cfg(args):
    return load_config(args.config, parse_overrides(args.override))


def _genotype(cfg, warn: bool):
    from .models.genotype import Genotype, default_genotype

    if os.path.exists(cfg.train.genotype_path):
        return Genotype.load(cfg.train.genotype_path)
    if warn:
        print(json.dumps({"event": "warn",
                          "msg": f"genotype {cfg.train.genotype_path} not "
                                 "found; using default_genotype"}))
    return default_genotype(cfg.model.n_nodes)


def cmd_preprocess(args, device) -> int:
    from .data.preprocess import preprocess_dataset

    cfg = _load_cfg(args)
    outs = preprocess_dataset(cfg.data.raw_dir, cfg.data.processed_dir,
                              cfg.data.modalities, cfg.data.seg_suffix,
                              workers=args.workers)
    print(json.dumps({"event": "preprocess_done", "patients": len(outs),
                      "out_dir": cfg.data.processed_dir}))
    return 0


def cmd_search(args, device) -> int:
    from .data.pipeline import dataset_paths
    from .models.unet import make_supernet
    from .search.bilevel import Searcher

    cfg = _load_cfg(args)
    sc = cfg.search
    searcher = Searcher(make_supernet(cfg.model, cfg.data.num_classes), cfg,
                        dataset_paths(cfg.data.processed_dir),
                        log_path=os.path.join(sc.checkpoint_dir,
                                              "metrics.jsonl"),
                        device=device)
    searcher.search()
    print(json.dumps({"event": "search_done",
                      "genotype": os.path.join(sc.checkpoint_dir,
                                               "genotype.json")}))
    return 0


def cmd_train(args, device) -> int:
    from .data.pipeline import dataset_paths
    from .models.unet import make_derived
    from .train.loop import Trainer

    cfg = _load_cfg(args)
    net = make_derived(cfg.model, cfg.data.num_classes,
                       _genotype(cfg, warn=True))
    log = os.path.join(cfg.train.checkpoint_dir, "metrics.jsonl")
    trainer = Trainer(net, cfg, dataset_paths(cfg.data.processed_dir),
                      log_path=log, device=device)
    trainer.train()
    print(json.dumps({"event": "train_done",
                      "ckpt_dir": cfg.train.checkpoint_dir}))
    return 0


def cmd_predict(args, device) -> int:
    from .infer.predict import predict_dataset
    from .infer.sliding import SlidingWindowPredictor
    from .models.unet import make_derived
    from .train.checkpoint import (latest_checkpoint, load_checkpoint,
                                   load_params)

    cfg = _load_cfg(args)
    # the fp32 body by default; head, logits and stitch stay fp32 either way
    net = make_derived(cfg.model, cfg.data.num_classes,
                       _genotype(cfg, warn=False),
                       dtype_override=cfg.infer.dtype)
    ckpt_dir = cfg.infer.checkpoint_dir
    best = os.path.join(ckpt_dir, "best.npz")
    found = latest_checkpoint(ckpt_dir)
    path = best if os.path.exists(best) else (found[1] if found else None)
    if path is None:
        raise SystemExit(f"no checkpoint under {ckpt_dir}")
    load_params(net, load_checkpoint(path))
    predictor = SlidingWindowPredictor(
        net.to(device), cfg.infer.patch_size, cfg.infer.overlap,
        cfg.infer.batch_size, cfg.data.num_classes,
        label_mode=cfg.data.label_mode)
    results = predict_dataset(predictor, cfg.data.processed_dir,
                              cfg.infer.output_dir, cfg.infer.threshold)
    done = {"event": "predict_done", "patients": len(results)}
    dices = [r["dice"] for r in results if "dice" in r]
    if dices:
        done["mean_dice"] = {k: float(np.mean([d[k] for d in dices]))
                             for k in ("WT", "TC", "ET")}
    print(json.dumps(done))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nas_3d_unet_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (("preprocess", cmd_preprocess), ("search", cmd_search),
                     ("train", cmd_train), ("predict", cmd_predict)):
        sp = sub.add_parser(name)
        sp.add_argument("-c", "--config", default=None,
                        help="JSON config path")
        sp.add_argument("-o", "--override", action="append", default=[],
                        help="dotted config override, e.g. model.depth=4")
        sp.add_argument("--device", default="cuda",
                        help="cuda (default; fails without a card) or cpu")
        sp.add_argument("--debug-nans", action="store_true",
                        help="autograd anomaly detection: raise at the "
                             "first NaN")
        if name == "preprocess":
            sp.add_argument("-w", "--workers", type=int, default=0)
        sp.set_defaults(fn=fn)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    ctx = (torch.autograd.detect_anomaly(check_nan=True) if args.debug_nans
           else contextlib.nullcontext())
    with ctx:
        return args.fn(args, device)


if __name__ == "__main__":
    sys.exit(main())
