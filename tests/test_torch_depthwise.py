"""The depthwise 3³ conv of SepConv (nas_3d_unet_tpu_torch/ops/depthwise.py;
on the CPU its plain twins) against PyTorch's grouped conv and the JAX
package's depthwise op, its three autograd Functions in float64
(gradcheck, gradgradcheck), SepConv against the grouped-conv route it
replaced, the D-slab pads, and the kernel route's launches.

The JAX side is `packed_depthwise3` on the unpacked layout (r = 1), the
op the JAX package's SepConv runs on its default packed path; its
gradients are `jax.vjp`.  Tolerances: fp32 values 2e-5 (sums of 27 terms
in another order), dw 1e-4 (sums over a whole volume).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nas_3d_unet_tpu.ops.packed import packed_depthwise3, standard_layout
from nas_3d_unet_tpu_torch.ops import _cuda, conv3d, depthwise, primitives
from nas_3d_unet_tpu_torch.ops.conv3d import same_pad
from nas_3d_unet_tpu_torch.parallel import spatial
from tests.torch_helpers import one_torch_thread  # noqa: F401

EDGES = {"odd": (5, 6, 7), "even": (8, 6, 4)}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _grouped(x, w, stride):
    """PyTorch's grouped conv with lax's SAME pads, NDHWC in and out."""
    pads = []
    for n in reversed(x.shape[1:4]):
        pads += same_pad(n, 3, stride, 1)
    y = F.conv3d(F.pad(x.permute(0, 4, 1, 2, 3), pads),
                 w.permute(4, 3, 0, 1, 2), stride=stride, groups=x.shape[-1])
    return y.permute(0, 2, 3, 4, 1)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("c", [1, 3, 16, 48])
@pytest.mark.parametrize("edges", sorted(EDGES))
@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_matches_grouped_conv_and_jax(stride, edges, c):
    """y, dx and dw against the grouped conv (autograd) and JAX (vjp);
    batch 2 at odd channel counts, 1 else; lax's SAME pads at stride 2
    are (1, 1) on an odd edge and (0, 1) on an even one."""
    batch = 2 if c % 2 else 1
    shape = (batch, *EDGES[edges], c)
    x, w = _rand(shape, c + stride), _rand((3, 3, 3, 1, c), 7, 0.3)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    _cuda.DEPTHWISE_LAUNCHES.clear()
    y = depthwise.depthwise3(xt, wt, stride)
    g = _rand(tuple(y.shape), 9)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    assert not _cuda.DEPTHWISE_LAUNCHES     # the CPU never launches
    assert y.is_contiguous()

    xr = torch.from_numpy(x).requires_grad_()
    wr = torch.from_numpy(w).requires_grad_()
    yr = _grouped(xr, wr, stride)
    dxr, dwr = torch.autograd.grad(yr, (xr, wr), torch.from_numpy(g))
    assert torch.equal(y, yr)               # the twin is the grouped conv
    _close(dx, dxr, 2e-5)
    _close(dw, dwr, 1e-4)

    def jf(a, b):
        return packed_depthwise3(a, b, standard_layout(1, c), w_in=shape[3],
                                 stride=stride)

    yj, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    dxj, dwj = vjp(jnp.asarray(g))
    assert y.shape == yj.shape
    _close(y.detach(), yj, 2e-5)
    _close(dx, dxj, 2e-5)
    _close(dw, dwj, 1e-4)


# (stride, x's D H W, pads before, pads after): lax's SAME pads of odd and
# even edges, and a D-slab's (x with its halo, D pads 0, and at stride 2 a
# last plane the conv never reads: an after pad of -1)
GEOMS = [(1, (4, 5, 3), (1, 1, 1), (1, 1, 1)),
         (2, (4, 5, 3), (0, 1, 1), (1, 1, 1)),
         (1, (5, 4, 3), (0, 1, 1), (0, 1, 1)),
         (2, (6, 4, 5), (0, 0, 1), (0, 1, 1))]


def _functions(g, c):
    """DW, DWT and DWW of g as (name, fn, input shapes)."""
    x, y, w = (1, *g.x, c), (1, *g.y, c), (3, 3, 3, 1, c)
    return [("DW", lambda a, b: depthwise._DW.apply(a, b, g), (x, w)),
            ("DWT", lambda a, b: depthwise._DWT.apply(a, b, g), (y, w)),
            ("DWW", lambda a, b: depthwise._DWW.apply(a, b, g), (x, y))]


@pytest.mark.parametrize("fn_i", [0, 1, 2], ids=["DW", "DWT", "DWW"])
@pytest.mark.parametrize("geom", range(len(GEOMS)))
def test_functions_gradcheck_and_gradgradcheck(geom, fn_i):
    """Each Function's backward is the others' forwards: first and second
    derivatives against finite differences in float64."""
    stride, dhw, lo, hi = GEOMS[geom]
    g = depthwise.geometry(dhw, stride, lo, hi)
    _, fn, shapes = _functions(g, 2)[fn_i]
    gen = torch.Generator().manual_seed(geom * 3 + fn_i)
    args = [torch.randn(s, generator=gen, dtype=torch.float64,
                        requires_grad=True) for s in shapes]
    assert torch.autograd.gradcheck(fn, args)
    assert torch.autograd.gradgradcheck(fn, args)


@pytest.mark.parametrize("geom", range(len(GEOMS)))
def test_twins_are_adjoints(geom):
    """<DW(x, w), dy> = <x, DWT(dy, w)> = <w, DWW(x, dy)>, exactly enough
    in float64, at every geometry, the slab's too."""
    stride, dhw, lo, hi = GEOMS[geom]
    g = depthwise.geometry(dhw, stride, lo, hi)
    gen = torch.Generator().manual_seed(geom)
    x = torch.randn((2, *g.x, 3), generator=gen, dtype=torch.float64)
    w = torch.randn((3, 3, 3, 1, 3), generator=gen, dtype=torch.float64)
    dy = torch.randn((2, *g.y, 3), generator=gen, dtype=torch.float64)
    a = (depthwise.dw(x, w, g) * dy).sum()
    b = (x * depthwise.dwt(dy, w, g)).sum()
    c = (w * depthwise.dww(x, dy, g)).sum()
    assert torch.allclose(a, b, rtol=1e-12) and torch.allclose(a, c,
                                                              rtol=1e-12)


def _old_sepconv(m, x):
    """SepConv as it ran before: the depthwise conv on the grouped-conv
    route of `conv3d_same` with plain autograd."""
    c = x.shape[-1]
    y = conv3d.conv3d_same(x, m.dw.kernel.to(x.dtype), m.stride, groups=c)
    pw = m.pw.kernel.to(x.dtype).view(c, -1)
    return primitives._norm_relu(m.norm, y @ pw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_sepconv_matches_the_grouped_conv_route(stride, dtype):
    """SepConv's output and gradients as they were on the grouped conv's
    route: the same forward bits, gradients within the sums' order."""
    torch.manual_seed(stride)
    m = primitives.SepConv(16, 24, stride, gn_groups=8)
    for p in m.parameters():
        p.data.normal_(0, 0.3)
    x0 = torch.randn(2, 6, 7, 8, 16).to(dtype)
    outs = []
    for fn in (m.forward, lambda x: _old_sepconv(m, x)):
        m.zero_grad()
        x = x0.clone().requires_grad_()
        y = fn(x)
        y.float().square().sum().backward()
        outs.append([y.detach(), x.grad, m.dw.kernel.grad,
                     m.pw.kernel.grad])
    assert torch.equal(outs[0][0], outs[1][0])
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(outs[0][1:], outs[1][1:]):
        _close(a.float() / b.float().abs().max(),
               b.float() / b.float().abs().max(), tol)


@pytest.mark.parametrize("d", [6, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_slab_pads(stride, d, monkeypatch):
    """On a D-slab the conv takes x with the halo lax's global pads ask
    for and a D pad of 0: one slab of a one-rank group (its halo the
    global ends' zeros) gives the unsharded conv, forward and backward."""
    x0 = torch.from_numpy(_rand((1, d, 5, 6, 16), d))
    w = torch.from_numpy(_rand((3, 3, 3, 1, 16), 3, 0.3))
    runs = []
    for slab in (None, spatial.Slab(0, 1)):
        monkeypatch.setattr(spatial, "current", lambda s=slab: s)
        monkeypatch.setattr(spatial, "halo_d",
                            lambda x, lo, hi, fill, s: F.pad(
                                x, (0, 0, 0, 0, 0, 0, lo, hi)))
        x = x0.clone().requires_grad_()
        y = depthwise.depthwise3(x, w, stride)
        (dx,) = torch.autograd.grad(y.square().sum(), x)
        runs.append((y.detach(), dx))
    assert torch.equal(runs[0][0], runs[1][0])
    _close(runs[1][1], runs[0][1], 1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_kernel_route_launches_its_kernels_alone(stride, monkeypatch):
    """With the kernels taken for CPU tensors (the launches recorded, not
    run): the forward launches dw3_fwd, the backward dw3_dgrad, dw3_wgrad
    and dw3_wsum, each once, with the plan's grid; they count in
    DEPTHWISE_LAUNCHES, not LAUNCHES; no grouped conv runs."""
    calls = []

    def run(fn, dev, *args, counter=_cuda.LAUNCHES):
        calls.append((fn, args))
        counter[fn] += 1

    def no_conv(*a, **k):
        raise AssertionError("the kernel route ran a library conv")

    monkeypatch.setattr(_cuda, "run", run)
    monkeypatch.setattr(_cuda, "dispatch", lambda name, *ts: False)
    for name in ("conv3d", "conv_transpose3d"):
        monkeypatch.setattr(F, name, no_conv)
    monkeypatch.setattr(torch.nn.grad, "conv3d_weight", no_conv)
    _cuda.LAUNCHES.clear()
    _cuda.DEPTHWISE_LAUNCHES.clear()
    x = torch.zeros((1, 8, 7, 6, 32), requires_grad=True)
    w = torch.zeros((3, 3, 3, 1, 32), requires_grad=True)
    y = depthwise.depthwise3(x, w, stride)
    y.backward(torch.zeros_like(y))
    assert [f for f, _ in calls] == ["dw3_fwd_f32", "dw3_dgrad_f32",
                                     "dw3_wgrad_f32", "dw3_wsum_f32"]
    assert _cuda.DEPTHWISE_LAUNCHES == collections.Counter(
        {f: 1 for f, _ in calls})
    assert not _cuda.LAUNCHES
    lo = [same_pad(n, 3, stride, 1)[0] for n in (8, 7, 6)]
    g = depthwise.geometry((8, 7, 6), stride, lo,
                           [same_pad(n, 3, stride, 1)[1] for n in (8, 7, 6)])
    ints = (1, 32, 8, 7, 6, *g.y, stride, *lo)
    p = depthwise.plan("fwd", 1, 32, g, 1)
    assert calls[0][1][3:] == (*ints, 1, p.nchunk)
    p = depthwise.plan("wgrad", 1, 32, g, 1)
    assert calls[2][1][3:] == (*ints, 1, p.nchunk, p.nblk)
    assert calls[3][1][2:] == (p.nblk, 27 * 32)


@pytest.mark.parametrize("kernel", ["fwd", "dgrad", "wgrad"])
@pytest.mark.parametrize("stride", [1, 2])
def test_plans_cover_the_grid(kernel, stride):
    """At the flagship's and odd shapes: D chunks of at least MIN_PLANES
    planes (or one chunk) that cover the owned grid, enough blocks where
    the planes allow; dw at most MIN_BLOCKS blocks, each with an item."""
    for c, dhw, n in ((16, (128,) * 3, 1), (32, (64,) * 3, 2),
                      (128, (32,) * 3, 1), (48, (19, 24, 21), 2),
                      (3, (5, 6, 7), 1)):
        pads = [same_pad(v, 3, stride, 1) for v in dhw]
        g = depthwise.geometry(dhw, stride, [a for a, _ in pads],
                               [b for _, b in pads])
        vec = int(c % 16 == 0)
        p = depthwise.plan(kernel, n, c, g, vec)
        own = g.x if kernel == "dgrad" else g.y
        assert 1 <= p.nchunk <= own[0]
        assert p.nchunk == 1 or own[0] // p.nchunk >= depthwise.MIN_PLANES
        slices = -(-c // (16 if vec else 8))
        if kernel == "wgrad":
            tiles = depthwise._tiles(g.y[1], g.y[2], stride)
            items = tiles * n * p.nchunk
            assert 1 <= p.nblk <= items
            assert p.nblk * slices <= max(depthwise.MIN_BLOCKS, slices)
        else:
            assert p.nblk == 0
