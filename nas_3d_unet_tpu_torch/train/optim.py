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

`step` takes the step's scalars (−lr, 1 − b1^t, 1 − b2^t) from the host as
Python floats.  `update` also takes them as fp32 0-d tensors, which is how
`train.steps_per_call` > 1 feeds a CUDA graph (`train/loop.py`
`make_train_step_n`): a replay re-reads tensors, never a float baked in at
capture.  The host computes both forms with the same numpy formula
(`bias_corrections`).  A product by a float and by a 0-d tensor give the
same bits; a quotient does not everywhere: ATen divides an fp32 tensor by
a host float as the product with the float's fp32 reciprocal on the card,
and as a true quotient on the CPU (both measured: on the H100, PyTorch
2.11, `_foreach_div(x, b)` equals `x · fp32(1/b)` bit for bit and differs
from `x / tensor(b)`).  So a tensor form holds what the device divides
with (`host_divisor`), and `update` multiplies by it on the card.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple, Union

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8          # optax.adamw's defaults

Scalar = Union[float, torch.Tensor]


def bias_corrections(count: int) -> Tuple[np.float32, np.float32]:
    """1 − b1^t and 1 − b2^t at step t = `count`, in fp32, as optax
    computes them from its int32 count."""
    t = np.float32(count)
    return 1 - np.float32(B1) ** t, 1 - np.float32(B2) ** t


def host_divisor(b: np.float32, device: torch.device) -> np.float32:
    """What ATen's division of an fp32 tensor on `device` by the host
    scalar `b` computes with: fp32(1 / b), multiplied by, on the card; `b`
    itself, divided by, on the CPU."""
    return np.float32(1) / np.float32(b) if device.type == "cuda" else b


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
        bc1, bc2 = bias_corrections(self.count)
        self.update(grads, -self.lr, float(bc1), float(bc2))

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], neg_lr: Scalar, bc1: Scalar,
               bc2: Scalar) -> None:
        """One update with its scalars given: −lr and the bias corrections
        1 − b1^t, 1 − b2^t, each a float or an fp32 0-d tensor on the
        parameters' device; a tensor correction holds `host_divisor` of
        it, which a CUDA tensor multiplies by.  `count` is the caller's to
        advance."""
        by_reciprocal = isinstance(bc2, torch.Tensor) and bc2.is_cuda
        divide = torch._foreach_mul if by_reciprocal else torch._foreach_div
        g2 = torch._foreach_mul(grads, grads)
        for m, g, k in ((self.mu, grads, B1), (self.nu, g2, B2)):
            torch._foreach_mul_(m, k)
            torch._foreach_add_(m, torch._foreach_mul(g, 1 - k))
        den = divide(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        upd = divide(self.mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, torch._foreach_mul(self.params,
                                                    self.weight_decay))
        torch._foreach_mul_(upd, neg_lr)
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
