"""Typed configuration tree, read from JSON.

Counterpart of `nas_3d_unet_tpu/utils/config.py`: the same frozen
dataclasses with the same fields, defaults and checks, `config_from_dict`,
`load_config` and `apply_overrides`.  The file format is JSON (the root
`config.json` holds the values of the JAX package's `config.yml`); every key
the JAX package accepts is accepted here, so one configuration loads in both.

Values that ask for something the port does not do are refused when the
dataclass is built, with the `ROADMAP.md` item that would bring it:
`train.steps_per_call` > 1, and `search.unrolled` with
`parallel.spatial_parallel` > 1 (item 9c).  Spatial sharding also needs a
`data.patch_size` D that slabs split evenly (`parallel/spatial.py`
`check_slab`: a multiple of spatial_parallel · 2^depth, at least 2 planes
in the deepest slab).  `parallel.data_parallel` loads whatever it is, as in
the JAX package, and `make_mesh` (`parallel/mesh.py`) refuses a layout
whose data × spatial is not the world size of the process group (1
without one).  `model.packed` is read and has no
effect: it selects a TPU layout that the port runs as logical NDHWC.
`search.unrolled` with `model.use_pallas` loads here and is refused by the
`Searcher` (`search/bilevel.py`).
"""

from __future__ import annotations

import ast
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from ..parallel.spatial import check_slab


def _refuse(bad: bool, what: str, where: str) -> None:
    if bad:
        raise ValueError(f"{what} is not supported by the PyTorch port "
                         f"({where})")


@dataclass(frozen=True)
class DataConfig:
    """Paths + preprocessing/patching knobs."""

    raw_dir: str = "data/brats_raw"           # contains HGG/ and LGG/ patient dirs
    processed_dir: str = "data/brats_h5"      # per-patient store (.npz here)
    modalities: Tuple[str, ...] = ("t1", "t1ce", "t2", "flair")
    seg_suffix: str = "seg"
    patch_size: Tuple[int, int, int] = (128, 128, 128)
    batch_size: int = 1
    val_fraction: float = 0.2
    # augmentation
    flip_prob: float = 0.5                    # per spatial axis
    intensity_shift: float = 0.1              # additive jitter, std-units
    intensity_scale: float = 0.1              # multiplicative jitter amplitude
    # label encoding: "regions" = sigmoid over (WT, TC, ET); "classes" = softmax over 4
    label_mode: str = "regions"
    num_classes: int = 0                      # 0 = auto: 3 (regions) / 4 (classes)
    seed: int = 0

    def __post_init__(self):
        if self.label_mode not in ("regions", "classes"):
            raise ValueError(f"label_mode must be 'regions' or 'classes', "
                             f"got {self.label_mode!r}")
        required = 3 if self.label_mode == "regions" else 4
        if self.num_classes == 0:
            object.__setattr__(self, "num_classes", required)
        elif self.num_classes != required:
            raise ValueError(
                f"label_mode={self.label_mode!r} requires num_classes="
                f"{required}, got {self.num_classes}")


@dataclass(frozen=True)
class ModelConfig:
    """Derived-net shape."""

    in_channels: int = 4                      # BraTS modalities
    base_channels: int = 16                   # node channels at full resolution
    depth: int = 3                            # number of down cells (and up cells)
    n_nodes: int = 3                          # intermediate nodes per cell
    norm: str = "group"                       # "group" | "instance" | "none"
    gn_groups: int = 8
    # activation checkpointing per cell; remat_edges per supernet edge
    # (None: follow remat)
    remat: bool = False
    remat_edges: bool | None = None
    # compute dtype for activations; params/accum stay fp32
    dtype: str = "bfloat16"
    use_pallas: bool = False                  # the K3/K4/K6/K7 routing
    merge_ops: bool = True                    # exact op merging in derived cells
    packed: bool = True                       # a TPU layout: read, no effect


@dataclass(frozen=True)
class SearchConfig:
    """DARTS bilevel search (`search/bilevel.py`)."""

    epochs: int = 50
    steps_per_epoch: int = 250
    w_lr: float = 3e-4
    w_weight_decay: float = 1e-4
    alpha_lr: float = 3e-4
    alpha_weight_decay: float = 1e-3
    unrolled: bool = False
    xi: float = 0.0
    augment_val: bool = False
    warmup_epochs: int = 5
    partial_channels: int = 1
    batch_size: int = 0
    val_steps: int = 8
    checkpoint_dir: str = "ckpt/search"
    checkpoint_every: int = 1
    tensorboard: bool = False
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """Derived-architecture training."""

    epochs: int = 300
    steps_per_epoch: int = 250
    steps_per_call: int = 1
    # gradient accumulation: 0 = full-batch gradient; m > 0 = the mean over
    # size-m slices, each through its own forward and backward
    microbatch: int = 0
    lr: float = 3e-4
    weight_decay: float = 1e-4
    lr_patience: int = 30                     # plateau epochs before lr drop
    lr_factor: float = 0.5
    min_lr: float = 1e-6
    checkpoint_dir: str = "ckpt/train"
    checkpoint_every: int = 1
    genotype_path: str = "ckpt/search/genotype.json"
    tensorboard: bool = False                 # mirror metrics to <ckpt>/tb
    seed: int = 0

    def __post_init__(self):
        _refuse(self.steps_per_call > 1,
                f"train.steps_per_call={self.steps_per_call}",
                "ROADMAP.md queue 1, not ported by decision")


@dataclass(frozen=True)
class InferConfig:
    """Sliding-window whole-volume inference."""

    patch_size: Tuple[int, int, int] = (128, 128, 128)
    overlap: float = 0.5                      # stride = patch * (1 - overlap)
    batch_size: int = 2
    threshold: float = 0.5                    # region-prob threshold
    # activation dtype of the network body during inference; the head,
    # logits and stitch stay fp32
    dtype: str = "float32"
    output_dir: str = "predictions"
    checkpoint_dir: str = "ckpt/train"


@dataclass(frozen=True)
class ParallelConfig:
    """Device layout: one rank per device, data × spatial ranks;
    `make_mesh` (`parallel/mesh.py`) holds the product to the world size
    of the run that builds it."""

    data_axis: str = "data"
    spatial_axis: str = "spatial"
    data_parallel: int = -1                   # -1 = every rank left
    spatial_parallel: int = 1                 # D-slabs of one row set


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    infer: InferConfig = field(default_factory=InferConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def __post_init__(self):
        sp = self.parallel.spatial_parallel
        if sp > 1:
            _refuse(self.search.unrolled,
                    f"search.unrolled with parallel.spatial_parallel={sp}",
                    "ROADMAP.md queue 1, item 9c, the second-order search "
                    "under spatial sharding")
            check_slab(self.data.patch_size[0], sp, self.model.depth,
                       "data.patch_size D")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)


_SECTIONS = {
    "data": DataConfig,
    "model": ModelConfig,
    "search": SearchConfig,
    "train": TrainConfig,
    "infer": InferConfig,
    "parallel": ParallelConfig,
}


def _coerce(cls: type, raw: dict) -> Any:
    """Build a dataclass from a raw dict, coercing lists to tuples."""
    kwargs = {}
    fields = {f.name for f in dataclasses.fields(cls)}
    for key, val in raw.items():
        if key not in fields:
            raise KeyError(f"unknown config key {cls.__name__}.{key}")
        kwargs[key] = tuple(val) if isinstance(val, list) else val
    return cls(**kwargs)


def config_from_dict(raw: dict) -> Config:
    extra = set(raw) - set(_SECTIONS)
    if extra:
        raise KeyError(f"unknown config sections: {sorted(extra)}")
    return Config(**{name: _coerce(cls, raw[name])
                     for name, cls in _SECTIONS.items()
                     if raw.get(name) is not None})


def load_config(path: Optional[str] = None,
                overrides: Optional[dict] = None) -> Config:
    """Load a JSON config; apply dotted-path overrides like
    {"model.depth": 4}."""
    raw: dict = {}
    if path is not None:
        with open(path) as f:
            raw = json.load(f) or {}
    cfg = config_from_dict(raw)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg


def apply_overrides(cfg: Config, overrides: dict) -> Config:
    """Apply {"section.key": value} overrides, returning a new Config."""
    raw = cfg.to_dict()
    # to_dict() carries the mode-resolved num_classes; a label_mode override
    # must re-trigger auto-resolution unless num_classes is set explicitly
    if "data.label_mode" in overrides and "data.num_classes" not in overrides:
        raw["data"]["num_classes"] = 0
    for dotted, val in overrides.items():
        section, _, key = dotted.partition(".")
        if not key or section not in raw:
            raise KeyError(f"bad override path {dotted!r}")
        if key not in raw[section]:
            raise KeyError(f"unknown config key {dotted!r}")
        raw[section][key] = val
    return config_from_dict(raw)


def parse_overrides(pairs: Optional[List[str]]) -> dict:
    """["section.key=value", ...] → {"section.key": value}; a value is a
    Python literal where it parses as one, else a plain string."""
    out = {}
    for pair in pairs or []:
        key, eq, val = pair.partition("=")
        if not eq:
            raise SystemExit(f"bad override {pair!r}; expected "
                             "section.key=value")
        try:
            out[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            out[key] = val
    return out
