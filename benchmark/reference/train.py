"""The plain reference of a training step and of a first-order DARTS
search step: the batch the step draws, its augmentation, the loss, the
gradients and AdamW, in fp32.

Batches: batch k of a patch stream with seed s is drawn from numpy's
`default_rng((s, k))`: per sample the patient index, then the three crop
starts; the crop's labels {0, 1, 2, 4} become the regions WT (label > 0),
TC (1 or 4) and ET (4).  Augmentation draws from a torch generator, per
batch: the flips (B, 3) as rand < p, then the shift and the scale (B, 1,
1, 1, C) as uniforms, in that order; x·scale + shift after the flips.
Loss: soft Dice (smooth 1, per sample and region, over the voxels) plus
the mean binary cross-entropy of the sigmoid region logits.  AdamW with
optax's defaults (b1 0.9, b2 0.999, eps 1e-8) and decay on every
parameter.  A search step (DARTS' first-order bilevel step): α takes an
AdamW step on the loss of a validation batch with the weights fixed, then
the weights take one on the augmented train batch under the updated α.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .net import Net, Params, arch_weights

B1, B2, EPS = 0.9, 0.999, 1e-8


def crop_batch(patients: Sequence[Mapping], seed: int, k: int, patch,
               batch: int):
    """Batch k of the patch stream with `seed`: (x (B, p, p, p, C) fp32,
    y (B, p, p, p, 3) fp32 regions), numpy.  Every patient holds a patch."""
    rng = np.random.default_rng((seed, k))
    xs, ys = [], []
    for _ in range(batch):
        rec = patients[rng.integers(0, len(patients))]
        shape = rec["image"].shape[:3]
        st = [int(rng.integers(0, max(1, s - p + 1)))
              for s, p in zip(shape, patch)]
        sl = tuple(slice(a, a + p) for a, p in zip(st, patch))
        xs.append(rec["image"][sl])
        lab = rec["label_u8"][sl]
        ys.append(np.stack([lab > 0, (lab == 1) | (lab == 4), lab == 4],
                           -1).astype(np.float32))
    return np.stack(xs).astype(np.float32), np.stack(ys)


def augment(gen: torch.Generator, x: torch.Tensor, y: torch.Tensor,
            flip_prob: float, intensity_shift: float,
            intensity_scale: float):
    """(x, y) flipped per sample and axis, x jittered per sample and
    modality, with draws from `gen` (on x's device)."""
    b, c = x.shape[0], x.shape[-1]
    dev = gen.device
    flip = torch.rand((b, 3), generator=gen, device=dev) < flip_prob
    shift = (torch.rand((b, 1, 1, 1, c), generator=gen, device=dev) * 2
             - 1) * intensity_shift
    scale = 1.0 + (torch.rand((b, 1, 1, 1, c), generator=gen, device=dev)
                   * 2 - 1) * intensity_scale
    flip = flip.cpu()
    xs, ys = [], []
    for i in range(b):
        axes = [a for a in range(3) if flip[i, a]]
        xs.append(x[i].flip(axes) if axes else x[i])
        ys.append(y[i].flip(axes) if axes else y[i])
    return torch.stack(xs) * scale + shift, torch.stack(ys)


def loss_fn(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Soft Dice + binary cross-entropy on (B, D, H, W, 3) region logits."""
    z = logits.float().reshape(logits.shape[0], -1, logits.shape[-1])
    t = y.float().reshape(z.shape)
    p = torch.sigmoid(z)
    dice = (2 * (p * t).sum(1) + 1) / (p.sum(1) + t.sum(1) + 1)
    bce = F.binary_cross_entropy_with_logits(z, t)
    return (1 - dice).mean() + bce


class AdamW:
    """AdamW (optax's order: moments, bias corrections, u + decay·p)."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 weight_decay: float):
        self.params, self.lr, self.wd = list(params), lr, weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.count += 1
        c1, c2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(B1).add_(g, alpha=1 - B1)
            v.mul_(B2).addcmul_(g, g, value=1 - B2)
            u = (m / c1) / ((v / c2).sqrt() + EPS)
            p.sub_(self.lr * (u + self.wd * p))


def leaves(names: Sequence[str], weights: Mapping[str, torch.Tensor],
           device) -> Dict[str, torch.Tensor]:
    """Leaf fp32 tensors on `device` that need gradients, by name."""
    return {n: weights[n].to(device, torch.float32).clone()
            .requires_grad_(True) for n in names}


def train_grads(net: Net, params: Dict[str, torch.Tensor], x: torch.Tensor,
                y: torch.Tensor):
    """(loss, gradients) of the batch's mean loss, one sample at a time
    (the loss is a mean of per-sample terms)."""
    b = x.shape[0]
    names = list(params)
    grads = [torch.zeros_like(params[n]) for n in names]
    total = 0.0
    for i in range(b):
        loss = loss_fn(net.forward(Params(params), x[i:i + 1]), y[i:i + 1])
        gs = torch.autograd.grad(loss / b, [params[n] for n in names])
        for acc, g in zip(grads, gs):
            acc.add_(g)
        total += loss.item() / b
    return total, grads


def search_step(net: Net, weights: Dict[str, torch.Tensor],
                alphas: Dict[str, torch.Tensor], w_opt: AdamW,
                a_opt: AdamW, train_batch, val_batch):
    """One first-order bilevel step on (x, y) batches already augmented;
    returns (train loss, val loss)."""
    fixed = Params({k: v.detach() for k, v in weights.items()})
    val = loss_fn(net.forward(fixed, val_batch[0], arch_weights(alphas)),
                  val_batch[1])
    names = list(alphas)
    a_opt.step(torch.autograd.grad(val, [alphas[n] for n in names]))
    arch = {k: v.detach() for k, v in arch_weights(alphas).items()}
    loss = loss_fn(net.forward(Params(weights), train_batch[0], arch),
                   train_batch[1])
    names = list(weights)
    w_opt.step(torch.autograd.grad(loss, [weights[n] for n in names]))
    return loss.item(), val.item()


def norms(tensors: Sequence[torch.Tensor]) -> List[float]:
    """Each tensor's L2 norm, in float64."""
    return [float(t.detach().double().norm()) for t in tensors]
