"""The gaps ``correct`` is decided by."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def rel_gap(got: float, want: float, scale: Optional[float] = None) -> float:
    """|got - want| over |want|, or over a millionth of |scale| where that
    is larger (a term that is 0 in the reference)."""
    floor = 1e-6 * abs(scale) if scale is not None else 1e-30
    if not math.isfinite(got):
        return math.inf
    return abs(got - want) / max(abs(want), floor)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             grad_ref: Dict[str, torch.Tensor]) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger. Leaves whose reference gradient (`grad_ref`) is under a
    thousandth of the median leaf's are left out: they move by round-off."""
    g = leaf_norms(grad_ref)
    g_med = float(torch.tensor(list(g.values())).median())
    keep = [k for k in want if g[k] >= 1e-3 * g_med]
    w = leaf_norms({k: want[k] for k in keep})
    p = leaf_norms({k: got[k] for k in keep})
    med = float(torch.tensor(list(w.values())).median())
    worst = 0.0
    for k in keep:
        if not math.isfinite(p[k]):
            return math.inf
        worst = max(worst, abs(p[k] - w[k]) / max(w[k], med, 1e-30))
    return worst
