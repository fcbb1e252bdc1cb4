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

Data parallelism: launched by torchrun, one rank per card,

    python -m torch.distributed.run --nproc_per_node N \
        -m nas_3d_unet_tpu_torch train -c config.json

every rank runs the command on `cuda:LOCAL_RANK` (with `--device cpu`, on
the CPU over gloo) over its share of the patients, `parallel.data_parallel`
× `parallel.spatial_parallel` = N (`parallel/mesh.py`); rank 0 alone
preprocesses, writes checkpoints and `genotype.json`, and prints the
`*_done` events.  Spatial sharding, the volume's D axis in slabs over S
ranks of the same patches (`parallel/spatial.py`):

    python -m torch.distributed.run --nproc_per_node N \
        -m nas_3d_unet_tpu_torch {train,search,predict} -c config.json \
        -o parallel.spatial_parallel=S

`train` and `search` need `data.patch_size`'s D to be a multiple of
S·2^depth with at least 2 planes in the deepest slab, and `search` the
first-order step (`search.unrolled` is refused, ROADMAP.md item 9c);
`predict` shards the stitch's buffers, with labels bit-identical to one
process.
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

from .parallel import mesh as dp
from .utils.config import load_config, parse_overrides
from .utils.device import resolve_device


def _load_cfg(args):
    return load_config(args.config, parse_overrides(args.override))


def _mesh(cfg):
    return dp.make_mesh(cfg.parallel.data_parallel,
                        cfg.parallel.spatial_parallel)


def _done(record: dict) -> None:
    """A `*_done` event, printed by rank 0; under a process group with
    its world size and backend."""
    if dp.is_initialized():
        record.update(world=dp.world_size(),
                      backend=str(torch.distributed.get_backend()))
    if dp.is_main():
        print(json.dumps(record))


def _genotype(cfg, warn: bool):
    from .models.genotype import Genotype, default_genotype

    if os.path.exists(cfg.train.genotype_path):
        return Genotype.load(cfg.train.genotype_path)
    if warn and dp.is_main():
        print(json.dumps({"event": "warn",
                          "msg": f"genotype {cfg.train.genotype_path} not "
                                 "found; using default_genotype"}))
    return default_genotype(cfg.model.n_nodes)


def cmd_preprocess(args, device) -> int:
    from .data.preprocess import preprocess_dataset

    cfg = _load_cfg(args)
    if dp.is_main():
        outs = preprocess_dataset(cfg.data.raw_dir, cfg.data.processed_dir,
                                  cfg.data.modalities, cfg.data.seg_suffix,
                                  workers=args.workers)
        _done({"event": "preprocess_done", "patients": len(outs),
               "out_dir": cfg.data.processed_dir})
    dp.barrier()
    return 0


def cmd_search(args, device) -> int:
    from .data.pipeline import dataset_paths
    from .models.unet import make_supernet
    from .search.bilevel import Searcher

    cfg = _load_cfg(args)
    sc = cfg.search
    mesh = _mesh(cfg)
    searcher = Searcher(make_supernet(cfg.model, cfg.data.num_classes), cfg,
                        dataset_paths(cfg.data.processed_dir,
                                      mesh.data_rank, mesh.data_world),
                        log_path=os.path.join(sc.checkpoint_dir,
                                              "metrics.jsonl"),
                        device=device, mesh=mesh)
    searcher.search()
    _done({"event": "search_done",
           "genotype": os.path.join(sc.checkpoint_dir, "genotype.json")})
    return 0


def cmd_train(args, device) -> int:
    from .data.pipeline import dataset_paths
    from .models.unet import make_derived
    from .train.loop import Trainer

    cfg = _load_cfg(args)
    mesh = _mesh(cfg)
    net = make_derived(cfg.model, cfg.data.num_classes,
                       _genotype(cfg, warn=True))
    log = os.path.join(cfg.train.checkpoint_dir, "metrics.jsonl")
    trainer = Trainer(net, cfg, dataset_paths(cfg.data.processed_dir,
                                              mesh.data_rank,
                                              mesh.data_world),
                      log_path=log, device=device, mesh=mesh)
    trainer.train()
    _done({"event": "train_done", "ckpt_dir": cfg.train.checkpoint_dir})
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
                              cfg.infer.output_dir, cfg.infer.threshold,
                              mesh=_mesh(cfg))
    done = {"event": "predict_done", "patients": len(results)}
    dices = [r["dice"] for r in results if "dice" in r]
    if dices:
        done["mean_dice"] = {k: float(np.mean([d[k] for d in dices]))
                             for k in ("WT", "TC", "ET")}
    _done(done)
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
    started = not dp.is_initialized()
    dp.maybe_initialize_distributed(args.device)
    started = started and dp.is_initialized()
    try:
        device = resolve_device(args.device)
        ctx = (torch.autograd.detect_anomaly(check_nan=True)
               if args.debug_nans else contextlib.nullcontext())
        with ctx:
            return args.fn(args, device)
    finally:
        if started:                 # the group this call set up
            dp.destroy()


if __name__ == "__main__":
    sys.exit(main())
