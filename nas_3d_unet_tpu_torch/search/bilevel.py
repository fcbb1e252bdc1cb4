"""DARTS bilevel search: the α-step, the w-step, warmup and the Searcher.

Counterpart of `nas_3d_unet_tpu/search/bilevel.py`: `make_search_step`
(:58), `make_warmup_step` (:154), `alpha_summary` (:180) and `Searcher`
(:190).  A search step, first-order as the reference runs it:
  1. α-step: the supernet's loss on a val-split batch, its gradient with
     respect to α alone, an AdamW step on α (`alpha_lr`,
     `alpha_weight_decay`);
  2. w-step: the loss on a train-split batch under the updated α, its
     gradient with respect to the weights alone, an AdamW step on w
     (`w_lr`, `w_weight_decay`).
Warmup epochs run the w-step alone, α frozen.  The α-step switches
`requires_grad` off on the weights (and the w-step takes α's softmax
without a graph), so neither backward computes the other's gradients: a
kernel's autograd Function skips dW (or dx) for an input that needs none.

In bf16 an α gradient is, per (edge, op), the full-volume sum of g·y
with the op's bf16 output y: as in JAX, where the weight is cast to the
activations' dtype (`cell.py` `_weighted`), each product is rounded to
bf16 and the sum once more; the port accumulates the sum in fp32 (the JAX
package on the CPU accumulates it in bf16, which the port does not
follow).

`make_search_step_unrolled` (:102) is the second-order step
(`search.unrolled`): the α-step takes ∇_α L_val(w − ξ·∇_w L_train(w, α), α)
through the virtual weights, every supernet parameter moved by ξ times its
train gradient with no optimizer in between, then the w-step runs as
above.  The inner gradient is taken with `create_graph`, so the α
gradient differentiates the backwards of the default path's Functions (K1
and K1-dx, K2, the GroupNorm with its K5 sums): each is twice
differentiable.  The `use_pallas` Functions (K6, K7, K4, K3) are not, and
the step refuses a net that holds them (`ROADMAP.md` queue 1, item 14).
`search.partial_channels` > 1 (PC-DARTS) builds the `Searcher`'s supernet
with that `pc_k` (`models/cell.py`).

The model runs eagerly; there is no jit or donation.  Data parallelism
(`parallel/mesh.py`, the reference's `bilevel.py:254-300`): with a `Mesh`
each data index runs its own rows of the global train and val batches,
and both steps average their gradients (and losses) over the data axis
before AdamW.  In the second-order step the inner gradient is averaged
inside the graph (`Mesh.all_reduce_mean`), so the virtual step is the
global batch's and each rank's α gradient holds every rank's
Hessian-vector terms; the α gradients are then averaged as the
first-order ones are.  Spatial sharding (`parallel/spatial.py`) runs the
first-order and warmup steps as the train step does (`cut_slab`, the
sharded-D context, w's and α's gradients summed over the spatial group);
the second-order step refuses it (`ROADMAP.md` queue 1, item 9c): its
inner gradient and the differentiated GroupNorm backward would need the
spatial sums inside the recorded graph.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from .. import bridge
from ..data.pipeline import (PatchGenerator, PatientCache, Prefetcher,
                             split_patients)
from ..metrics.losses import get_loss_fn
from ..models.genotype import Genotype, alpha_shapes, init_alphas, \
    parse_alphas
from ..models.unet import arch_weights_from_alphas
from ..train.checkpoint import (latest_checkpoint, load_checkpoint,
                                optimizer_state, restore_optimizer_state,
                                restore_train_state, save_checkpoint,
                                train_state)
from ..parallel import spatial
from ..parallel.mesh import Mesh, is_main, local_batch_size, make_mesh
from ..train.loop import (augmenter, cut_slab, evaluate, loss_and_grads,
                          make_eval_step, warn_stream_geometry_mismatch)
from ..train.optim import AdamW, make_optimizer
from ..utils.device import resolve_device
from ..utils.logging import MetricsLogger
from ..utils.params import count_params


class ArchBound(nn.Module):
    """A supernet with its architecture weights bound: `forward(x)` is
    `net(x, arch_weights)`, its parameters the supernet's."""

    def __init__(self, net: nn.Module,
                 arch_weights: Optional[Mapping[str, torch.Tensor]] = None):
        super().__init__()
        self.net = net
        self.arch_weights = arch_weights

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x, self.arch_weights)


@contextlib.contextmanager
def _frozen(params: Sequence[torch.Tensor]):
    """`requires_grad` off on `params` for the block."""
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _w_update(bound: ArchBound, w_opt: AdamW, x: torch.Tensor,
              y: torch.Tensor, loss_fn: Callable,
              alphas: Mapping[str, torch.Tensor],
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One w-step under `alphas` (no graph to α) on this rank's slab (in
    the sharded-D context of `mesh`'s slab), its gradients reduced over
    `mesh`; returns the loss (averaged too)."""
    with torch.no_grad():
        bound.arch_weights = arch_weights_from_alphas(alphas)
    with spatial.sharded_d(None if mesh is None else mesh.slab):
        loss, grads = loss_and_grads(bound, x, y, loss_fn)
    if mesh is not None:
        mesh.all_reduce_mean_([*grads, loss], slab_parts=len(grads))
    w_opt.step(grads)
    return loss


def _alpha_update(a_opt: AdamW, a_grads: Sequence[torch.Tensor],
                  val_loss: torch.Tensor,
                  mesh: Optional[Mesh]) -> torch.Tensor:
    """An AdamW step on α from `a_grads` (one per α leaf, zeros for the
    leaves the loss does not reach), averaged over `mesh`'s ranks with the
    val loss; returns the val loss, detached (averaged too)."""
    a_grads = [g.contiguous() for g in a_grads]
    val_loss = val_loss.detach().clone()
    if mesh is not None:
        mesh.all_reduce_mean_([*a_grads, val_loss], slab_parts=len(a_grads))
    a_opt.step(a_grads)
    return val_loss


def make_search_step(net: nn.Module, w_opt: AdamW, a_opt: AdamW,
                     alphas: Mapping[str, torch.Tensor],
                     augment: Optional[dict] = None,
                     label_mode: str = "regions", augment_val: bool = False,
                     gen: Optional[torch.Generator] = None,
                     mesh: Optional[Mesh] = None):
    """(x_tr, y_tr, x_val, y_val) → {"train_loss", "val_loss"} (0-d fp32
    tensors); updates α (`alphas`, the leaf tensors `a_opt` holds, in
    place) and then the weights (`w_opt`'s, the supernet's).  `mesh`: the
    batches are this data index's rows of the global ones (full D: under
    spatial sharding the step cuts this rank's slab), and both steps
    average over the data axis.

    `augment`: None, or dict(flip_prob=…, intensity_shift=…,
    intensity_scale=…) for the train batch; `augment_val` also augments
    the val batch (the reference runs none there, so α's gradients come
    from clean batches by default).  Draws come from `gen`, a generator on
    the net's device that the caller keeps, train batch first."""
    loss_fn = get_loss_fn(label_mode)
    aug = augmenter(augment, gen, mesh)
    bound = ArchBound(net)
    slab = None if mesh is None else mesh.slab

    def step(x_tr, y_tr, x_val, y_val) -> Dict[str, torch.Tensor]:
        x_tr, y_tr = aug(x_tr, y_tr)
        if augment_val:
            x_val, y_val = aug(x_val, y_val)
        x_tr, y_tr, x_val, y_val = cut_slab(slab, net, x_tr, y_tr, x_val,
                                            y_val)
        # (1) architecture step on the val batch, the weights frozen
        with _frozen(w_opt.params), spatial.sharded_d(slab):
            val_loss = loss_fn(net(x_val, arch_weights_from_alphas(alphas)),
                               y_val)
            a_grads = torch.autograd.grad(val_loss, a_opt.params,
                                          allow_unused=True,
                                          materialize_grads=True)
        val_loss = _alpha_update(a_opt, a_grads, val_loss, mesh)
        # (2) weight step on the train batch, under the updated α
        train_loss = _w_update(bound, w_opt, x_tr, y_tr, loss_fn, alphas,
                               mesh)
        return {"train_loss": train_loss, "val_loss": val_loss}

    return step


def unrolled_alpha_grads(net: nn.Module, alphas: Mapping[str, torch.Tensor],
                         a_params: Sequence[torch.Tensor], xi: float,
                         x_tr, y_tr, x_val, y_val, loss_fn: Callable,
                         mesh: Optional[Mesh] = None
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(L_val(w − ξ·∇_w L_train(w, α), α), its gradient in each of
    `a_params`, the leaf α tensors `alphas` holds): the JAX step's
    `val_after_virtual_step` (`bilevel.py:128-132`) and its gradient.
    The virtual weights cover every parameter of `net`, which runs on them
    through `functional_call`; the inner gradient keeps its graph, so the
    α gradient holds the Hessian-vector term.  `mesh`: the inner gradient
    is the mean over the ranks, taken inside the graph; the loss and the α
    gradients returned are this rank's (the step averages them)."""
    names, params = zip(*net.named_parameters())
    aw = arch_weights_from_alphas(alphas)
    g_w = torch.autograd.grad(loss_fn(net(x_tr, aw), y_tr), params,
                              create_graph=True)
    if mesh is not None:
        g_w = mesh.all_reduce_mean(g_w)
    w_virt = {n: p - xi * g for n, p, g in zip(names, params, g_w)}
    val_loss = loss_fn(functional_call(net, w_virt, (x_val, aw)), y_val)
    a_grads = torch.autograd.grad(val_loss, a_params, allow_unused=True,
                                  materialize_grads=True)
    return val_loss.detach(), list(a_grads)


def make_search_step_unrolled(net: nn.Module, w_opt: AdamW, a_opt: AdamW,
                              alphas: Mapping[str, torch.Tensor], xi: float,
                              augment: Optional[dict] = None,
                              label_mode: str = "regions",
                              augment_val: bool = False,
                              gen: Optional[torch.Generator] = None,
                              mesh: Optional[Mesh] = None):
    """The second-order DARTS step (`search.unrolled`): as
    `make_search_step`, but the α-step's gradient is that of the val loss
    after a virtual w-step of size `xi` (`unrolled_alpha_grads`); the
    w-step then runs under the updated α.  Refuses a `use_pallas` net,
    whose kernels' Functions are not twice differentiable, and a mesh
    with spatial sharding."""
    if mesh is not None and mesh.spatial > 1:
        raise ValueError(
            "search.unrolled with parallel.spatial_parallel="
            f"{mesh.spatial} (the second-order step on D-slabs) is not "
            "supported by the PyTorch port (ROADMAP.md queue 1, item 9c)")
    if any(getattr(m, "use_pallas", False) or getattr(m, "k6", False)
           for m in net.modules()):
        raise ValueError(
            "search.unrolled with model.use_pallas (the second-order step "
            "through the use_pallas kernels) is not supported by the "
            "PyTorch port (ROADMAP.md queue 1, item 14)")
    loss_fn = get_loss_fn(label_mode)
    aug = augmenter(augment, gen, mesh)
    bound = ArchBound(net)

    def step(x_tr, y_tr, x_val, y_val) -> Dict[str, torch.Tensor]:
        x_tr, y_tr = aug(x_tr, y_tr)
        if augment_val:
            x_val, y_val = aug(x_val, y_val)
        # (1) architecture step on the unrolled objective
        val_loss, a_grads = unrolled_alpha_grads(
            net, alphas, a_opt.params, xi, x_tr, y_tr, x_val, y_val, loss_fn,
            mesh)
        val_loss = _alpha_update(a_opt, a_grads, val_loss, mesh)
        # (2) weight step on the train batch, under the updated α
        train_loss = _w_update(bound, w_opt, x_tr, y_tr, loss_fn, alphas,
                               mesh)
        return {"train_loss": train_loss, "val_loss": val_loss}

    return step


def make_warmup_step(net: nn.Module, w_opt: AdamW,
                     alphas: Mapping[str, torch.Tensor],
                     augment: Optional[dict] = None,
                     label_mode: str = "regions",
                     gen: Optional[torch.Generator] = None,
                     mesh: Optional[Mesh] = None):
    """(x_tr, y_tr) → {"train_loss", "val_loss" (0)}: the w-step alone,
    α frozen (the warmup epochs)."""
    loss_fn = get_loss_fn(label_mode)
    aug = augmenter(augment, gen, mesh)
    bound = ArchBound(net)
    slab = None if mesh is None else mesh.slab

    def step(x_tr, y_tr) -> Dict[str, torch.Tensor]:
        x_tr, y_tr = cut_slab(slab, net, *aug(x_tr, y_tr))
        loss = _w_update(bound, w_opt, x_tr, y_tr, loss_fn, alphas, mesh)
        return {"train_loss": loss, "val_loss": torch.zeros_like(loss)}

    return step


def alpha_summary(alphas: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """Mean softmax entropy per α group — the search-health signal."""
    out = {}
    for name, a in alphas.items():
        p = torch.softmax(a.detach().float(), dim=-1)
        ent = -(p * torch.log(p + 1e-9)).sum(-1)
        out[f"entropy_{name}"] = float(ent.mean())
    return out


def _numpy(alphas: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in alphas.items()}


class Searcher:
    """The supernet search loop: warmup epochs, then bilevel epochs, an
    α-split eval per bilevel epoch, checkpoints with the genotype, and
    trajectory-exact resume from the latest checkpoint.

    `supernet`: a `SuperNet`, moved to `device` (None: the card); `cfg`: a
    `Config`; `data_paths`: the patients' `.npz` files, split into a
    w-part and an α-part (`split_patients`).  `search.partial_channels`
    > 1 rebuilds the supernet with that `pc_k` (`SuperNet.clone`);
    `search.unrolled` takes the second-order step, with ξ = `search.xi`,
    or `search.w_lr` where that is 0.  The train batch is flipped
    and jittered inside the step, with draws from the Searcher's generator
    (saved in every checkpoint); the patch streams never augment on the
    host.  `mesh`: the layout (None: `make_mesh` from `cfg.parallel`); the
    search batch is the global one, each data index's streams are offset
    by 100003·(data index) (the ranks of a spatial group read the same
    patches and cut their slabs in the steps), every rank starts from rank
    0's state, the α-split eval is averaged over the data axis and rank 0
    writes `genotype.json`."""

    def __init__(self, supernet: nn.Module, cfg, data_paths: Sequence[str],
                 log_path: Optional[str] = None,
                 device: torch.device | str | None = None,
                 mesh: Optional[Mesh] = None):
        sc, dc = cfg.search, cfg.data
        # partial channels: the supernet rebuilt with that pc_k, so that
        # every consumer below (steps, eval, init) sees one architecture
        if sc.partial_channels > 1:
            supernet = supernet.clone(pc_k=sc.partial_channels)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh or make_mesh(cfg.parallel.data_parallel,
                                      cfg.parallel.spatial_parallel)
        self.net = supernet.to(self.device)
        self.alphas = {k: torch.zeros(s, device=self.device,
                                      requires_grad=True)
                       for k, s in sorted(alpha_shapes(
                           cfg.model.n_nodes).items())}
        self.w_opt = make_optimizer(self.net.parameters(), sc.w_lr,
                                    sc.w_weight_decay)
        self.a_opt = make_optimizer(self.alphas.values(), sc.alpha_lr,
                                    sc.alpha_weight_decay)
        self.gen = torch.Generator(device=self.device)
        aug = dict(flip_prob=dc.flip_prob, intensity_shift=dc.intensity_shift,
                   intensity_scale=dc.intensity_scale)
        self.augment_val = bool(sc.augment_val)
        if sc.unrolled:
            xi = sc.xi if sc.xi > 0 else sc.w_lr        # `bilevel.py:221`
            self.search_step = make_search_step_unrolled(
                self.net, self.w_opt, self.a_opt, self.alphas, xi, aug,
                dc.label_mode, self.augment_val, gen=self.gen,
                mesh=self.mesh)
        else:
            self.search_step = make_search_step(
                self.net, self.w_opt, self.a_opt, self.alphas, aug,
                dc.label_mode, self.augment_val, gen=self.gen,
                mesh=self.mesh)
        self.warmup_step = make_warmup_step(self.net, self.w_opt,
                                            self.alphas, aug, dc.label_mode,
                                            gen=self.gen, mesh=self.mesh)
        # the α-split eval: loss and per-region Dice with the current α
        # frozen (the reference's `Searching.validate`)
        self.bound = ArchBound(self.net)
        self.eval_step = make_eval_step(self.bound, label_mode=dc.label_mode,
                                        mesh=self.mesh)
        self.logger = MetricsLogger(
            log_path, tb_dir=(os.path.join(sc.checkpoint_dir, "tb")
                              if sc.tensorboard else None))
        w_paths, a_paths = split_patients(data_paths, dc.val_fraction,
                                          dc.seed)
        self.w_cache = PatientCache(w_paths, dc.label_mode)
        self.a_cache = PatientCache(a_paths or w_paths, dc.label_mode)
        self.patch = dc.patch_size
        # search.batch_size overrides data.batch_size (0 = inherit); it is
        # the global batch, each rank streaming its slice
        self.batch = sc.batch_size or dc.batch_size
        self.local_batch = local_batch_size(self.batch, "search batch size",
                                            world=self.mesh.data_world)
        self.step = 0
        self._resume_meta: dict = {}

    def init_state(self, seed: int) -> None:
        """Weights at flax's initialiser scales from `seed`, α from
        `init_alphas` on a CPU generator seeded with `seed`, fresh AdamW
        states, the augmentation generator seeded with `seed`."""
        bridge.load_flax_params(self.net,
                                bridge.random_flax_params(self.net, seed))
        g = torch.Generator()
        g.manual_seed(seed)
        with torch.no_grad():
            for k, a in init_alphas(g, self.cfg.model.n_nodes).items():
                self.alphas[k].copy_(a)
        sc = self.cfg.search
        for opt, lr in ((self.w_opt, sc.w_lr), (self.a_opt, sc.alpha_lr)):
            for m in opt.mu + opt.nu:
                m.zero_()
            opt.count, opt.lr = 0, lr
        self.gen.manual_seed(seed)
        self.step = 0

    def state(self) -> Dict[str, np.ndarray]:
        """The search state as a checkpoint's arrays
        (`train/checkpoint.py`)."""
        out = train_state(self.net, self.w_opt, self.step, self.gen)
        out.update({f"alphas/{k}": v.detach().cpu().numpy().copy()
                    for k, v in self.alphas.items()})
        out.update(optimizer_state(self.a_opt, self.alphas, "a_opt"))
        return out

    def resume_or_init(self, seed: int) -> None:
        self.init_state(seed)
        self._resume_meta = {}
        sc = self.cfg.search
        ckpt = latest_checkpoint(sc.checkpoint_dir)
        if ckpt is None:
            return
        step, path = ckpt
        arrays = load_checkpoint(path)
        self.step = restore_train_state(arrays, self.net, self.w_opt,
                                        self.gen)
        with torch.no_grad():
            for k, a in self.alphas.items():
                a.copy_(torch.from_numpy(arrays[f"alphas/{k}"]))
        restore_optimizer_state(arrays, self.a_opt, list(self.alphas),
                                "a_opt")
        meta_path = os.path.join(sc.checkpoint_dir, "metadata.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                self._resume_meta = json.load(f)
        self.logger.log(event="resume", step=step, path=path)

    def sync_state(self) -> None:
        """Every rank takes rank 0's weights, α and both AdamW states."""
        self.mesh.broadcast_([*self.net.parameters(), *self.w_opt.mu,
                              *self.w_opt.nu, *self.alphas.values(),
                              *self.a_opt.mu, *self.a_opt.nu])

    def search(self, epochs: Optional[int] = None,
               steps_per_epoch: Optional[int] = None
               ) -> Tuple[Dict[str, np.ndarray], Optional[Genotype]]:
        """Search to `epochs` (default `search.epochs`), resuming from the
        latest checkpoint; returns the final state (`state()`) and the
        genotype of the last epoch run (None if none ran)."""
        sc = self.cfg.search
        n = self.cfg.model.n_nodes
        epochs = sc.epochs if epochs is None else epochs
        spe = sc.steps_per_epoch if steps_per_epoch is None \
            else steps_per_epoch
        self.resume_or_init(sc.seed)
        self.sync_state()
        warn_stream_geometry_mismatch(self._resume_meta, self.logger,
                                      steps_per_epoch=spe,
                                      val_steps=sc.val_steps,
                                      warmup_epochs=sc.warmup_epochs)
        self.logger.log(event="model", params=count_params(self.net),
                        alphas=sum(a.numel() for a in self.alphas.values()))
        start_epoch = self.step // spe
        # counter-based streams positioned by the restored step make the
        # resume trajectory-exact: g_w advances every step, g_a and g_eval
        # only in bilevel epochs
        non_warm = max(0, start_epoch - sc.warmup_epochs)
        # a data index's streams offset by 100003·(data index)
        # (`bilevel.py:254-300`)
        seed = sc.seed + 100003 * self.mesh.data_rank
        g_w = PatchGenerator(self.w_cache, self.patch, self.local_batch,
                             seed=seed + 101, augment=False,
                             start_step=self.step)
        g_a = PatchGenerator(self.a_cache, self.patch, self.local_batch,
                             seed=seed + 202, augment=False,
                             start_step=non_warm * spe)
        # its own generator: g_a is drained by pf_a's thread
        g_eval = PatchGenerator(self.a_cache, self.patch, self.local_batch,
                                seed=seed + 303, augment=False,
                                start_step=non_warm * sc.val_steps)
        pf_w = Prefetcher(g_w, self.device, depth=2)
        pf_a = Prefetcher(g_a, self.device, depth=2)
        genotype = None
        try:
            for epoch in range(start_epoch, epochs):
                warm = epoch < sc.warmup_epochs
                t0 = time.perf_counter()
                tr: List[torch.Tensor] = []
                va: List[torch.Tensor] = []
                for _ in range(spe):
                    x_tr, y_tr = pf_w.next()
                    if warm:
                        m = self.warmup_step(x_tr, y_tr)
                    else:
                        x_val, y_val = pf_a.next()
                        m = self.search_step(x_tr, y_tr, x_val, y_val)
                    self.step += 1
                    tr.append(m["train_loss"])
                    va.append(m["val_loss"])
                tr[-1].item()               # waits for the epoch's steps
                pps = spe * self.batch / (time.perf_counter() - t0)
                genotype = parse_alphas(_numpy(self.alphas), n)
                rec = dict(event="epoch", epoch=epoch, warmup=warm,
                           augment_val=self.augment_val,
                           train_loss=float(np.mean([v.item() for v in tr])),
                           val_loss=float(np.mean([v.item() for v in va])),
                           patches_per_sec=pps, **alpha_summary(self.alphas))
                if not warm:
                    val = self.evaluate(g_eval, sc.val_steps)
                    rec.update(eval_loss=val["loss"], dice_wt=val["dice_wt"],
                               dice_tc=val["dice_tc"], dice_et=val["dice_et"])
                self.logger.log(**rec)
                if (epoch + 1) % sc.checkpoint_every == 0 \
                        or epoch == epochs - 1:
                    if is_main():                       # `bilevel.py:372`
                        os.makedirs(sc.checkpoint_dir, exist_ok=True)
                        genotype.save(os.path.join(sc.checkpoint_dir,
                                                   "genotype.json"))
                    save_checkpoint(
                        sc.checkpoint_dir, self.step, self.state(),
                        metadata={"epoch": epoch, "steps_per_epoch": spe,
                                  "val_steps": sc.val_steps,
                                  "warmup_epochs": sc.warmup_epochs,
                                  "config": self.cfg.to_dict()})
        finally:
            pf_w.close()
            pf_a.close()
        return self.state(), genotype

    def evaluate(self, gen: PatchGenerator,
                 val_steps: int) -> Dict[str, float]:
        """Frozen-α supernet eval on the α-split: mean loss and per-region
        Dice over `val_steps` batches, averaged over the ranks."""
        with torch.no_grad():
            self.bound.arch_weights = arch_weights_from_alphas(self.alphas)
        return evaluate(self.eval_step, gen, val_steps, self.device,
                        self.mesh)
