"""AdamW with float32 moments over parameters of any dtype (PyTorch).

A copy of ``repro.training.optimizer``: the same defaults (b1 0.9, b2 0.95,
eps 1e-8, weight decay 0.1 on every leaf, global-norm clip 1.0) and the same
order of operations, the global norm summed in float32 over the leaves in
``jax.tree.flatten``'s order (``training/tree.py``). Functional, as the
reference: ``adamw_update`` returns new parameters and a new state and
changes neither argument. On a device mesh a rank updates its shards and
passes ``sum_squares``, which counts every element of the global tree once
(``launch/steps.py``'s sharded train step).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.training import tree


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32
    mu: Any
    nu: Any


def adamw_init(params) -> AdamWState:
    """Zero float32 moments shaped like ``params``, on their devices."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree.leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      tree.tree_map(zeros, params), tree.tree_map(zeros, params))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr: float = 3e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0,
                 sum_squares: Optional[Callable[[List[torch.Tensor]], torch.Tensor]] = None
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step. Returns (new params, new state, {"grad_norm"}): the
    gradients are scaled by ``min(1, grad_clip / (norm + 1e-9))`` first.
    ``sum_squares(flat_grads)`` gives the squared global norm from the
    leaves given (default: their own sum of squares, in float32)."""
    flat_g, treedef = tree.flatten(grads)
    if sum_squares is None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in flat_g))
    else:
        gnorm = torch.sqrt(sum_squares(flat_g))
    scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    t = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)

    def upd(g, m, v, p):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / bc1
        vh = v / bc2
        pf = p.float()
        pn = pf - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * pf)
        return pn.to(p.dtype), m, v

    out = [upd(g, m, v, p) for g, m, v, p in
           zip(flat_g, tree.leaves(state.mu), tree.leaves(state.nu), tree.leaves(params))]
    new_p = tree.unflatten(treedef, [o[0] for o in out])
    new_m = tree.unflatten(treedef, [o[1] for o in out])
    new_v = tree.unflatten(treedef, [o[2] for o in out])
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm}
