"""The numbers that decide `correct`, each held to its limit.

Training and search: the losses of the steps the reference follows, the
first moment AdamW holds after the first call (for a one-step call
(1 − b1) times the first gradient: the gradient as the optimizer got it),
and the parameters' change over the followed steps.  Moments and changes
are compared leaf by leaf as norms: the gap between the program's norm and
the reference's, over the larger of the reference's norm of that leaf and
of the median leaf (some gradients are all but zero), the worst leaf
counting; in training the median leaf's moment gap is compared beside
it (the worst leaf swings from seed to seed, the median leaf less, and
it alone keeps the lower-precision control out: PERF.md §2).  A leaf whose reference moment is under a thousandth of the median
leaf's is left out of the change: its gradient is nought to rounding,
and AdamW moves it by round-off alone.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

ZERO_GRAD = 1e-3


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The largest relative gap of the per-step losses; inf where the
    program's is not finite."""
    return max(abs(a - b) / abs(b) if a == a and abs(a) != float("inf")
               else float("inf") for a, b in zip(prog, ref))


def leaf_gaps(prog: Sequence[float], ref: Sequence[float],
              keep: Sequence[bool] | None = None) -> List[float]:
    """Each kept leaf's gap of norms; inf where the program's norm is not
    finite."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median(ref[i] for i in idx)
    return [abs(prog[i] - ref[i]) / max(ref[i], med)
            if math.isfinite(prog[i]) else math.inf for i in idx]


def nonzero(moments: Sequence[float]) -> list:
    """Leaves whose reference moment is at least ZERO_GRAD of the median
    leaf's."""
    med = statistics.median(moments)
    return [m >= ZERO_GRAD * med for m in moments]


def verdict(numbers: Dict[str, float],
            limits: Dict[str, float]) -> Tuple[bool, Dict[str, list]]:
    """(every number within its limit, {name: [number, limit]})."""
    missing = set(limits) ^ set(numbers)
    if missing:
        raise ValueError(f"numbers and limits differ: {sorted(missing)}")
    checks = {k: [numbers[k], limits[k]] for k in sorted(limits)}
    return all(v <= lim for v, lim in checks.values()), checks
