"""AdamW with a learning rate that can change between steps.

Counterpart of `nas_3d_unet_tpu/train/loop.py:45-78`: `optax.adamw` under
`optax.inject_hyperparams`, with optax's defaults (b1 0.9, b2 0.999, eps
1e-8, eps_root 0, weight decay on every parameter).  One step, in optax's
order and with its roundings:

    mu  = (1 − b1)·g + b1·mu,       nu = (1 − b2)·g² + b2·nu,   t += 1
    u   = (mu / (1 − b1^t)) / (√(nu / (1 − b2^t)) + eps)
    p  += −lr·(u + wd·p)

The moments are fp32 like the parameters.  `torch.optim.AdamW` is not used:
it folds the decay and the bias corrections in other places, which moves
the last bits.  The JAX package's `optax.flatten` wrapper changes no
numbers and has no counterpart.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8          # optax.adamw's defaults


class AdamW:
    """AdamW over `params`; `lr` and `weight_decay` are plain attributes
    that may be changed between steps."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 weight_decay: float):
        self.params: List[torch.nn.Parameter] = list(params)
        self.lr, self.weight_decay = lr, weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """Apply one update from `grads` (one per parameter, in order)."""
        self.count += 1
        # 1 − b^t in fp32, as optax computes it from its int32 count
        bc1 = float(1 - np.float32(B1) ** np.float32(self.count))
        bc2 = float(1 - np.float32(B2) ** np.float32(self.count))
        g2 = torch._foreach_mul(grads, grads)
        for m, g, k in ((self.mu, grads, B1), (self.nu, g2, B2)):
            torch._foreach_mul_(m, k)
            torch._foreach_add_(m, torch._foreach_mul(g, 1 - k))
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, torch._foreach_mul(self.params,
                                                    self.weight_decay))
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(self.params, upd)


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float) -> AdamW:
    """AdamW with the LR exposed for plateau scheduling."""
    return AdamW(params, lr, weight_decay)


def get_learning_rate(opt: AdamW) -> float:
    return opt.lr


def set_learning_rate(opt: AdamW, lr: float) -> AdamW:
    opt.lr = lr
    return opt
