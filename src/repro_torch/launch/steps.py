"""The port's steps: the train, prefill and serve step functions, and the
input specs of each step on the meta device.

The counterpart of ``repro.launch.steps`` for one card. ``input_specs``
gives every input of a step kind as tensors on ``torch.device("meta")``:
shapes and dtypes with no storage, as ``jax.eval_shape`` gives them to the
reference, so the dry run (``launch/dryrun.py``) can trace the full
production configs without allocating a byte. The step functions are eager
closures over ``Model``; each runs on the device of the tensors it is given
(the kernels on a CUDA device, their plain versions on the CPU and on the
meta device, where nothing is computed). The train step takes its gradient
with autograd (through the ``flash_prefill`` and ``ssd_scan`` backward
kernels on a CUDA device) and applies AdamW.

Not ported: ``jit_step`` and ``launch/shardings.py``, which place a step on
a device mesh (ROADMAP.md Queue A item 8b-ii); the port runs on one card,
and ``launch/mesh.py`` raises where a mesh is asked for.

One departure: the port's page pool keeps every position of a sequence,
and a sliding window is a lower bound on what a query reads (ROADMAP.md,
Departures). So a prefill whose prompt is longer than ``cache_len_for``
(zamba2-2.7b's window of 4096 at ``prefill_32k``, internvl2-2b's 256
vision positions in front of 32768 tokens) gets a pool of the prompt's
length, where the reference keeps the last ``cache_len_for`` positions
(``prefill_cache_len``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import Model
from repro_torch.training import tree
from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update

LONG_CONTEXT_WINDOW = 4096

META = torch.device("meta")


def resolve_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Shape-dependent config adjustments: at 500k-token decode every
    attention-bearing arch runs the sliding-window variant so decode state is
    O(window)."""
    if shape.name == "long_500k" and cfg.has_attention and \
            cfg.sliding_window == 0:
        cfg = cfg.with_(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def cache_len_for(cfg: ModelConfig, shape: InputShape) -> int:
    if cfg.sliding_window > 0:
        return min(shape.seq_len, cfg.sliding_window)
    return shape.seq_len


def prefill_cache_len(cfg: ModelConfig, shape: InputShape) -> int:
    """The pool a prefill of ``shape`` writes: ``cache_len_for``, or the
    prompt's positions where they are more (a VLM's vision prefix counted;
    see the module docstring)."""
    n_vis = cfg.n_vision_tokens if cfg.arch_type == "vlm" else 0
    return max(cache_len_for(cfg, shape), shape.seq_len + n_vis)


# ------------------------------------------------------------ input specs


def _token_spec(batch: int, seq: int) -> torch.Tensor:
    return torch.empty((batch, seq), dtype=torch.int32, device=META)


def batch_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, torch.Tensor]:
    dt = getattr(torch, cfg.dtype)
    out = {"tokens": _token_spec(batch, seq)}
    if cfg.arch_type == "audio":
        out["frames"] = torch.empty((batch, cfg.enc_seq, cfg.d_model), dtype=dt,
                                    device=META)
    if cfg.arch_type == "vlm":
        out["vision"] = torch.empty((batch, cfg.n_vision_tokens, cfg.d_model),
                                    dtype=dt, device=META)
    return out


def params_specs(cfg: ModelConfig) -> Any:
    # a generator cannot live on the meta device; a CPU one draws nothing
    # for meta tensors
    return Model(cfg).init(torch.Generator(), device=META)


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Any:
    return Model(cfg).init_cache(batch, cache_len, device=META)


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Every input of the step this shape runs, as meta tensors."""
    cfg = resolve_config(cfg, shape)
    p = params_specs(cfg)
    if shape.kind == "train":
        return {"params": p, "opt_state": adamw_init(p),
                "batch": batch_specs(cfg, shape.global_batch, shape.seq_len)}
    if shape.kind == "prefill":
        return {"params": p,
                "batch": batch_specs(cfg, shape.global_batch, shape.seq_len)}
    # decode: one token against a cache of seq_len
    return {"params": p,
            "tokens": _token_spec(shape.global_batch, 1),
            "cache": cache_specs(cfg, shape.global_batch, cache_len_for(cfg, shape))}


# ------------------------------------------------------------ step fns


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


def make_prefill_step(cfg: ModelConfig, shape: Optional[InputShape] = None):
    """``prefill_step(params, batch) -> (last_logits, cache)``; with a shape,
    the cache is a page pool of ``prefill_cache_len`` positions, without one
    the model's dense cache of the prompt."""
    model = Model(cfg)
    clen = prefill_cache_len(cfg, shape) if shape else None

    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_len=clen)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """``serve_step(params, tokens, cache) -> (logits, cache)``: one decode
    step; the pools are written in place."""
    model = Model(cfg)

    def serve_step(params, tokens, cache):
        return model.decode_step(params, tokens, cache)
    return serve_step
