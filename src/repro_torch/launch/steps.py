"""Step builders of the port: the train step.

A copy of ``repro.launch.steps.make_train_step`` without ``jax.jit``: the
step takes the gradient of ``Model.loss`` with autograd (through the
``flash_prefill`` and ``ssd_scan`` backward kernels on a CUDA device) and
applies AdamW. The
reference's sharded steps (``jit_step``, ``input_specs``, the prefill and
serve step builders over a device mesh) are ROADMAP.md Queue A item 8b.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model
from repro_torch.training import tree
from repro_torch.training.optimizer import AdamWState, adamw_update


def loss_and_grads(model: Model, params, batch: Dict[str, torch.Tensor], *,
                   remat: bool = False) -> Tuple[torch.Tensor, list]:
    """``Model.loss`` and its gradient by autograd, one tensor per leaf in
    ``tree.flatten`` order (zeros for a leaf the loss does not reach)."""
    flat, treedef = tree.flatten(params)
    flat = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss = model.loss(tree.unflatten(treedef, flat), batch, remat=remat)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, *, remat: bool = True, lr: float = 3e-4,
                    microbatch: int = 0):
    """Build ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``. ``remat`` recomputes each layer in the
    backward pass (``torch.utils.checkpoint``). ``microbatch=M > 1`` splits
    the batch into M sequential microbatches and accumulates their gradients
    in float32, then divides by M, as the reference does; the loss is the
    microbatches' mean."""
    model = Model(cfg)

    def train_step(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        treedef = tree.flatten(params)[1]
        if microbatch and microbatch > 1:
            m = microbatch
            parts = {key: t.reshape(m, t.shape[0] // m, *t.shape[1:])
                     for key, t in batch.items()}
            acc, losses = None, []
            for i in range(m):
                loss, grads = loss_and_grads(model, params,
                                             {key: t[i] for key, t in parts.items()},
                                             remat=remat)
                grads = [g.float() for g in grads]
                acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
                losses.append(loss)
            grads = [a / m for a in acc]
            loss = torch.stack(losses).mean()
        else:
            loss, grads = loss_and_grads(model, params, batch, remat=remat)
        new_params, new_opt, info = adamw_update(tree.unflatten(treedef, grads),
                                                 opt_state, params, lr=lr)
        return new_params, new_opt, {"loss": loss, **info}

    return train_step
