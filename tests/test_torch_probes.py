"""The port's probes (nas_3d_unet_tpu_torch/experiments/) against the JAX
era's Pallas probes, on CPU, where each wrapper takes its plain twin.

E2 (`experiments/r3_pg_variants.py`): the module is imported by path with
`jax.config.update` stubbed (its top lines repoint the compile cache) and
its geometry cut to NB 3, H 4, HP 6, WP 8, RC 16, KE 8, M 32; `k_full`,
`k_c6`, `k_nodot` and `k_mt` run through `pallas_call(interpret=True)`
with the module's own `specs()`.  The twin is held to nodot exactly and to
the others within 1 bf16 ulp of max(|ref|, 2⁻⁸): both sum the same fp32
products, in orders that may differ, and round once.  `k_fold` as the TPU
script calls it cannot run on this jaxlib (it captures the module-global
ac2 as a constant), so a wrapper kernel takes ac2 as an input, sets the
global to the traced value and runs `k_fold`'s own body; fold1536's twin
is held to that to the same 1 ulp.
E1 (`experiments/r3_dma_probe.py` runs its probe at import): its
`copy_kernel` is taken out with `ast` and run in interpret mode at
(64, 128); the twin must be bit-equal.
"""

import ast
import importlib.util
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nas_3d_unet_tpu_torch.experiments import r3_dma_probe, r3_pg_variants
from nas_3d_unet_tpu_torch.ops import _cuda
from tests.torch_helpers import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(NB=3, H=4, HP=6, WP=8, RC=16, KE=8, M=32)
ULP_FLOOR = 2.0 ** -8


@pytest.fixture(scope="module")
def ref():
    """experiments/r3_pg_variants.py at the small geometry."""
    spec = importlib.util.spec_from_file_location(
        "_r3_pg_variants_ref", ROOT / "experiments" / "r3_pg_variants.py")
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(jax.config, "update", lambda *a, **k: None):
        spec.loader.exec_module(mod)
    for name, value in SMALL.items():
        setattr(mod, name, value)
    return mod


def _call(ref, kernel, scratch=False, extra_specs=()):
    return pl.pallas_call(
        kernel, grid=(ref.NB,), in_specs=ref.specs(ref.KE) + list(extra_specs),
        out_specs=pl.BlockSpec((1, ref.M, ref.RC), lambda bd: (bd, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((ref.NB, ref.M, ref.RC), jnp.bfloat16),
        scratch_shapes=([pltpu.VMEM((ref.M, 1536), jnp.bfloat16)]
                        if scratch else []),
        interpret=True)


def _operands(seed=0, g=SMALL):
    """(x, xe, ac, ae, ac2) as JAX bf16 arrays and the same bits in torch."""
    rng = np.random.default_rng(seed)
    rows = g["HP"] * g["WP"]
    shapes = [((g["NB"], rows, g["RC"]), 1.0), ((g["NB"], rows, g["KE"]), 1.0),
              ((3, 3, g["RC"], g["RC"]), .05), ((3, 3, g["KE"], g["RC"]), .05),
              ((1536, g["RC"]), .05)]
    jx = [jnp.asarray((rng.standard_normal(s) * c).astype(np.float32),
                      jnp.bfloat16) for s, c in shapes]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
          for a in jx]
    return jx, tx


def _ulps(got, want):
    """|got − want| in bf16 ulps of max(|want|, 2⁻⁸)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), ULP_FLOOR))) - 7)
    return np.abs(got - want) / ulp


def _np(t):
    return t.double().numpy()


@pytest.mark.parametrize("variant,kernel", [
    ("full", "k_full"), ("c6", "k_c6"), ("nodot", "k_nodot"),
    ("mt4", "k_mt")])
def test_pg_twin_matches_the_pallas_variant(ref, variant, kernel):
    (x, xe, ac, ae, _), (tx, txe, tac, tae, tac2) = _operands()
    want = _call(ref, getattr(ref, kernel))(x, x, x, xe, xe, xe, ac, ae)
    want = np.asarray(want.astype(jnp.float32))
    _cuda.LAUNCHES.clear()
    got = r3_pg_variants.pg(variant, tx, txe, tac, tae, tac2, ref.WP)
    assert not _cuda.LAUNCHES          # a CPU tensor never counts a launch
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    if variant == "nodot":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        assert _ulps(got.float().numpy(), want).max() <= 1.0


def _full_formula(x, xe, ac, ae, wp, m, pad):
    """k_full in float64 numpy; the planes clipped (the probe's specs) or,
    with pad, zero beyond the last."""
    nb = x.shape[0]
    y = np.zeros((nb, m, ac.shape[-1]))
    for bd in range(nb):
        for kh in range(3):
            for k in range(3):
                p = bd + k
                if p >= nb:
                    if pad:
                        continue
                    p = nb - 1
                y[bd] += x[p, kh * wp:kh * wp + m] @ ac[k, kh]
                y[bd] += xe[p, kh * wp:kh * wp + m] @ ae[k, kh]
    return y


def test_pg_twin_clips_the_high_planes():
    """P_k = clip(bd + k, 0, NB − 1): planes NB − 2 and NB − 1 re-read
    plane NB − 1, which a zero pad would not."""
    _, (x, xe, ac, ae, ac2) = _operands(seed=1)
    wp, m = SMALL["WP"], SMALL["M"]
    got = r3_pg_variants.pg_twin("full", x, xe, ac, ae, ac2, wp)
    args = (_np(x), _np(xe), _np(ac), _np(ae), wp, m)
    clip, pad = _full_formula(*args, pad=False), _full_formula(*args, pad=True)
    assert _ulps(got.float().numpy(), clip).max() <= 1.0
    np.testing.assert_array_equal(clip[0], pad[0])
    for bd in (1, 2):                  # NB − 2 and NB − 1 at NB = 3
        assert _ulps(got[bd].float().numpy(), pad[bd]).max() > 100


def test_fold_twin_matches_the_k_fold_formula(ref):
    """fold1536's twin against `k_fold`'s own body in interpret mode, with
    ac2 passed in: xcat = 9 centre slices, 9 edge slices (each in (kh, k)
    order), zeros to 1536 columns; y = xcat @ ac2."""
    (x, xe, ac, ae, ac2), (tx, txe, tac, tae, tac2) = _operands(seed=2)

    def k_fold_ac2_in(x0, x1, x2, e0, e1, e2, ac_, ae_, ac2_, o, xcat):
        ref.ac2_global = ac2_[...]          # a traced value, not a constant
        ref.k_fold(x0, x1, x2, e0, e1, e2, ac_, ae_, o, xcat)

    ac2_spec = pl.BlockSpec((1536, ref.RC), lambda bd: (0, 0),
                            memory_space=pltpu.VMEM)
    with mock.patch.object(ref, "ac2_global", None):
        want = _call(ref, k_fold_ac2_in, scratch=True, extra_specs=[ac2_spec])(
            x, x, x, xe, xe, xe, ac, ae, ac2)
    want = np.asarray(want.astype(jnp.float32))
    got = r3_pg_variants.pg("fold1536", tx, txe, tac, tae, tac2, ref.WP)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _ulps(got.float().numpy(), want).max() <= 1.0


def test_this_jaxlib_rejects_k_fold(ref):
    """k_fold captures the module-global ac2; JAX refuses that, and the
    TPU script's `run` swallowed the error.  The day this passes without
    raising, fold1536 has a reference to run against."""
    (x, xe, ac, ae, ac2), _ = _operands()
    with mock.patch.object(ref, "ac2_global", ac2), \
            pytest.raises(Exception, match="captures constants"):
        _call(ref, ref.k_fold, scratch=True)(x, x, x, xe, xe, xe, ac, ae)


def _copy_kernel():
    """`copy_kernel` of experiments/r3_dma_probe.py, without running the
    probe that module runs at import."""
    path = ROOT / "experiments" / "r3_dma_probe.py"
    tree = ast.parse(path.read_text(), str(path))
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "copy_kernel")
    ns = {}
    exec(compile(ast.Module([fn], []), str(path), "exec"), ns)
    return ns["copy_kernel"]


@pytest.mark.parametrize("rpb", [8, 16, 32, 64])
def test_copy_twin_matches_the_pallas_copy(rpb):
    rows, lanes = 64, 128
    a = np.random.default_rng(rpb).standard_normal((rows, lanes))
    x = jnp.asarray(a.astype(np.float32), jnp.bfloat16)
    spec = pl.BlockSpec((rpb, lanes), lambda i: (i, 0),
                        memory_space=pltpu.VMEM)
    want = pl.pallas_call(
        _copy_kernel(), grid=(rows // rpb,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((rows, lanes), jnp.bfloat16),
        interpret=True)(x)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    _cuda.LAUNCHES.clear()
    got = r3_dma_probe.copy_rows(tx, rpb)
    assert not _cuda.LAUNCHES
    assert got.dtype == torch.bfloat16 and got.data_ptr() != tx.data_ptr()
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_wrappers_refuse_bad_input():
    x = torch.zeros(64, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        r3_dma_probe.copy_rows(x, 48)           # 64 rows, not a multiple
    with pytest.raises(ValueError):
        r3_dma_probe.copy_rows(torch.zeros(64, 12), 16)
    with pytest.raises(ValueError, match="no kernel"):
        r3_dma_probe.copy_rows(x.to("meta"), 16)
    _, (tx, txe, tac, tae, tac2) = _operands()
    wp = SMALL["WP"]
    with pytest.raises(ValueError):
        r3_pg_variants.pg("full8", tx, txe, tac, tae, tac2, wp)
    with pytest.raises(ValueError):
        r3_pg_variants.pg("full", tx, txe[:, 1:], tac, tae, tac2, wp)
    with pytest.raises(ValueError):
        r3_pg_variants.pg("fold1536", tx, txe, tac, tae, None, wp)
    with pytest.raises(ValueError, match="no kernel"):
        r3_pg_variants.pg("full", *(t.to("meta") for t in
                                    (tx, txe, tac, tae, tac2)), wp)


@pytest.mark.parametrize("variant", r3_pg_variants.VARIANTS)
def test_library_call_computes_the_variant(variant):
    """The one PyTorch call timed beside a variant computes its function:
    nodot's gather bit-equal to the twin, the GEMM of a concat (full, mt4,
    c6 of their slices, fold1536 its own) within 1 bf16 ulp."""
    _, ops = _operands(seed=3)
    call = r3_pg_variants.library(variant, *ops, SMALL["WP"])
    assert set(r3_pg_variants.LIBRARY) == set(r3_pg_variants.VARIANTS)
    want = r3_pg_variants.pg_twin(variant, *ops, SMALL["WP"])
    got = call().reshape(want.shape)        # the GEMM gives (NB·M, RC)
    if variant == "nodot":
        assert torch.equal(got, want)
    else:
        assert _ulps(got.float().numpy(), want.float().numpy()).max() <= 1.0


@pytest.mark.parametrize("module", [r3_dma_probe, r3_pg_variants],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_main_raises_without_a_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])


def test_work_gives_the_bounds_at_the_level0_geometry():
    """flops and bytes per call at NB = 128: the bounds the probes print."""
    from nas_3d_unet_tpu_torch.utils.bounds import bound_ms

    # fold1536 at full's K = 1440: its 96 zero columns cannot change y
    want = {"full": (96.64e9, 0.0977), "mt4": (96.64e9, 0.0977),
            "c6": (51.54e9, 0.0521), "fold1536": (96.64e9, 0.0977),
            "nodot": (0.0, 0.0399)}
    for variant, (flops, ms) in want.items():
        f, b = r3_pg_variants.work(variant)
        assert f == pytest.approx(flops, rel=1e-3)
        assert bound_ms(b, f)[0] == pytest.approx(ms, rel=2e-3)
    x = torch.empty(r3_dma_probe.ROWS, r3_dma_probe.LANES,
                    dtype=torch.bfloat16, device="meta")
    assert r3_dma_probe.copy_bytes(x) == 2 ** 27              # 128 MiB
    assert bound_ms(2 ** 27)[0] == pytest.approx(0.0401, rel=1e-2)
