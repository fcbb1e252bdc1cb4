"""The port's JSON config (nas_3d_unet_tpu_torch/utils/config.py) against
the JAX package's YAML config: the same values, defaults and overrides,
compared exactly as dicts (tuples and lists normalised), the norms it
accepts, and the settings the port refuses."""

import json

import pytest

from nas_3d_unet_tpu.cli import _parse_overrides as jax_parse_overrides
from nas_3d_unet_tpu.utils import config as jcfg
from nas_3d_unet_tpu_torch.utils import config as tcfg
from tests.torch_helpers import ROOT
from tests.torch_helpers import one_torch_thread  # noqa: F401


def _norm(obj):
    """Tuples as lists, recursively."""
    if isinstance(obj, dict):
        return {k: _norm(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_norm(v) for v in obj]
    return obj


def test_config_json_holds_the_values_of_config_yml():
    port = tcfg.load_config(str(ROOT / "config.json")).to_dict()
    ref = jcfg.load_config(str(ROOT / "config.yml")).to_dict()
    assert _norm(port) == _norm(ref)


def test_defaults_are_the_reference_defaults():
    assert _norm(tcfg.Config().to_dict()) == _norm(jcfg.Config().to_dict())
    assert json.loads(tcfg.Config().to_json()) == _norm(
        jcfg.Config().to_dict())


OVERRIDES = [
    ["model.depth=2", "data.patch_size=(8, 8, 8)", "train.lr=1e-3"],
    ["data.label_mode=classes", "infer.overlap=0.25", "model.dtype=float32"],
    ["data.label_mode=classes", "data.num_classes=4",
     "train.checkpoint_dir=/tmp/x", "model.use_pallas=True"],
    ["parallel.data_parallel=1", "search.partial_channels=2",
     "model.packed=False", "train.genotype_path=g.json"],
]


@pytest.mark.parametrize("pairs", OVERRIDES, ids=range(len(OVERRIDES)))
def test_overrides_give_equal_configs(pairs):
    ov = tcfg.parse_overrides(pairs)
    assert ov == jax_parse_overrides(pairs)
    port = tcfg.load_config(str(ROOT / "config.json"), ov).to_dict()
    ref = jcfg.load_config(str(ROOT / "config.yml"), ov).to_dict()
    assert _norm(port) == _norm(ref)


@pytest.mark.parametrize("bad", [{"model.nope": 1}, {"nope.x": 1},
                                 {"model": 1}])
def test_unknown_keys_raise(bad):
    with pytest.raises(KeyError):
        tcfg.load_config(None, bad)
    with pytest.raises(KeyError):
        jcfg.load_config(None, bad)


REFUSED = [({"train.steps_per_call": 2}, "not ported by decision"),
           ({"parallel.data_parallel": 2}, r"world size 1\b.*item 9a"),
           # spatial sharding: a patch D slabs do not split evenly at the
           # model's depth, and one whose deepest slab is under 2 planes
           ({"parallel.spatial_parallel": 2, "data.patch_size": (24,) * 3},
            r"patch_size D 24 .* multiple of 2·2\^3 = 16"),
           ({"parallel.spatial_parallel": 8, "data.patch_size": (64,) * 3},
            r"at least 2 planes in the deepest slab"),
           # the second-order search under spatial sharding
           ({"parallel.spatial_parallel": 2, "search.unrolled": True},
            "item 9c"),
           # a layout whose data × spatial is not the world (1 here)
           ({"parallel.spatial_parallel": 4}, "must divide the world size 1"),
           ({"parallel.spatial_parallel": 2, "parallel.data_parallel": 1},
            "must divide the world size 1")]


@pytest.mark.parametrize("ov,item", REFUSED, ids=[str(o) for o, _ in REFUSED])
def test_unported_settings_are_refused(ov, item):
    """The JAX package accepts each of these; the port names the
    ROADMAP.md item that would bring it: when the config loads, or, for a
    data axis other than the world's (here one rank, without a process
    group), when the mesh is built from it, as the JAX package checks its
    layout."""
    from nas_3d_unet_tpu_torch.parallel.mesh import make_mesh

    jcfg.load_config(None, ov)
    with pytest.raises(ValueError, match=item):
        par = tcfg.load_config(None, ov).parallel
        make_mesh(par.data_parallel, par.spatial_parallel)


PORTED = [{"model.remat": True}, {"model.remat_edges": True},
          {"model.remat": True, "model.remat_edges": False},
          {"parallel.data_parallel": 1}, {"parallel.data_parallel": -1},
          {"parallel.spatial_parallel": 2}, {"parallel.spatial_parallel": 4},
          {"parallel.spatial_parallel": 2, "data.patch_size": (32,) * 3}]


@pytest.mark.parametrize("ov", PORTED, ids=[str(o) for o in PORTED])
def test_ported_layout_settings_load(ov):
    """Activation checkpointing, the data axis over every rank (one rank
    here, without a process group) and spatial sharding with a patch that
    its slabs split evenly load in both packages alike."""
    port = tcfg.load_config(None, ov).to_dict()
    assert _norm(port) == _norm(jcfg.load_config(None, ov).to_dict())


def test_data_parallel_must_be_the_world_size():
    """Any other size than -1 or the world's is refused, naming the world
    size (`parallel/mesh.py` `check_layout`)."""
    from nas_3d_unet_tpu_torch.parallel.mesh import check_layout

    assert check_layout(-1, 1, world=4) == check_layout(4, 1, world=4) == 4
    for bad in (0, 2, 8):
        with pytest.raises(ValueError, match="world size 4"):
            check_layout(bad, 1, world=4)


@pytest.mark.parametrize("norm", ["group", "instance", "none"])
def test_every_norm_loads(norm):
    """`model.norm` takes the JAX package's three norms."""
    assert tcfg.load_config(None, {"model.norm": norm}).model.norm == norm
    assert jcfg.load_config(None, {"model.norm": norm}).model.norm == norm


def test_label_mode_checks_match():
    for ov in ({"data.label_mode": "x"},
               {"data.label_mode": "classes", "data.num_classes": 3}):
        with pytest.raises(ValueError):
            tcfg.load_config(None, ov)
        with pytest.raises(ValueError):
            jcfg.load_config(None, ov)
