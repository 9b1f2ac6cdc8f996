"""Unified model API of the port.

``Model(cfg)`` exposes:
  init(gen, dtype, device)           -> params
  forward(params, batch, remat)      -> (logits, aux_loss)
  loss(params, batch, remat)         -> scalar causal-LM loss (+ aux)
  loss_terms(params, batch, remat)   -> (summed loss, positions counted, aux)
  prefill(params, batch)             -> (last_logits, cache)
  decode_step(params, tokens, cache) -> (logits, cache)
  init_cache(batch, cache_len)       -> zeroed paged cache

  write_slot(cache, slot, sub)       -> one sequence's cache into a pool row
  read_slot(cache, slot, length)     -> a pool row, copied to the host
  example_batch(batch, seq, gen)     -> random batch with the right modalities

``batch`` is a dict with ``tokens (B,S)`` integer ids, plus ``vision``
(B, n_vision_tokens, d_model) stub patch embeddings for the VLM family and
``frames`` (B, enc_seq, d_model) stub frame embeddings for the audio
family. Every family of the reference is ported: dense, moe, vlm, ssm,
hybrid and audio. ``remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does.
Entry points default to ``device="cuda"`` and raise when there is no GPU:
nothing here continues on the CPU unless the caller asks for it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, mamba_model, transformer

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]

_FAMILY = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "ssm": mamba_model,
    "hybrid": hybrid,
    "audio": encdec,
}


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names a CUDA device
    and there is none, so that no caller continues on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return device


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.arch_type not in _FAMILY:
            raise KeyError(f"unknown arch_type {cfg.arch_type!r}")
        self.cfg = cfg
        self._m = _FAMILY[cfg.arch_type]

    # ------------------------------------------------------------ params
    def init(self, gen: Optional[torch.Generator] = None, dtype=None,
             device="cuda") -> Params:
        """Random parameters on ``device`` from ``gen`` (default: a generator
        on that device seeded with 0)."""
        device = resolve_device(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(0)
        return self._m.init_params(self.cfg, gen, dtype=dtype, device=device)

    def _modalities(self, batch: Batch) -> Dict[str, torch.Tensor]:
        if self.cfg.arch_type == "vlm":
            return {"vision_embeds": batch["vision"]}
        if self.cfg.arch_type == "audio":
            return {"frames": batch["frames"]}
        return {}

    # ------------------------------------------------------------ forward
    def forward(self, params: Params, batch: Batch, *, remat: bool = False):
        return self._m.forward(self.cfg, params, batch["tokens"], remat=remat,
                               **self._modalities(batch))

    def _nll(self, params: Params, batch: Batch, remat: bool):
        """Each text position's next-token negative log-likelihood (B, S-1)
        in float32, and the auxiliary loss."""
        logits, aux = self.forward(params, batch, remat=remat)
        tokens = batch["tokens"]
        lg = logits[:, :-1].float()
        nll = torch.logsumexp(lg, dim=-1) - \
            torch.gather(lg, -1, tokens[:, 1:, None].long())[..., 0]
        return nll, aux

    def loss(self, params: Params, batch: Batch, *,
             remat: bool = False) -> torch.Tensor:
        """Mean next-token cross-entropy over the text positions (masked by
        ``batch["loss_mask"]`` where given), in float32, plus the auxiliary
        loss."""
        nll, aux = self._nll(params, batch, remat)
        mask = batch.get("loss_mask")
        if mask is not None:
            m = mask[:, 1:].float()
            return (nll * m).sum() / m.sum().clamp_min(1.0) + aux
        return nll.mean() + aux

    def loss_terms(self, params: Params, batch: Batch, *, remat: bool = False):
        """``loss``'s parts over this batch: the summed cross-entropy of the
        positions counted (by ``batch["loss_mask"]`` where given), their
        count, and the auxiliary loss. A data rank of a sharded train step
        sums the first two over the batch axes before it divides."""
        nll, aux = self._nll(params, batch, remat)
        mask = batch.get("loss_mask")
        m = torch.ones_like(nll) if mask is None else mask[:, 1:].float()
        return (nll * m).sum(), m.sum(), aux

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, cache_len: int, dtype=None, device="cuda"):
        dtype = dtype or getattr(torch, self.cfg.dtype)
        return self._m.init_cache(self.cfg, batch, cache_len, dtype,
                                  resolve_device(device))

    def prefill(self, params: Params, batch: Batch, *,
                cache_len: Optional[int] = None, dtype=None, past_cache=None):
        return self._m.prefill(self.cfg, params, batch["tokens"],
                               cache_len=cache_len, dtype=dtype,
                               past_cache=past_cache, **self._modalities(batch))

    def decode_step(self, params: Params, tokens: torch.Tensor, cache,
                    active: Optional[torch.Tensor] = None):
        return self._m.decode_step(self.cfg, params, tokens, cache, active)

    def write_slot(self, cache, slot: int, sub) -> None:
        """Write a batch-of-1 cache from ``prefill`` (or from ``read_slot``)
        into row ``slot`` of a pool from ``init_cache``."""
        self._m.write_slot(cache, slot, sub)

    def read_slot(self, cache, slot: int, length: int):
        """Row ``slot`` of a pool, holding ``length`` tokens, as a batch-of-1
        cache copied to the host."""
        return self._m.read_slot(cache, slot, length)

    # ------------------------------------------------------------ inputs
    def example_batch(self, batch: int, seq: int,
                      gen: Optional[torch.Generator] = None, dtype=None,
                      device="cuda") -> Batch:
        """Random token ids and, for the VLM family, standard-normal vision
        embeddings (for the audio family, frame embeddings) in ``dtype``,
        drawn from ``gen`` (default: a generator on ``device`` seeded with
        0)."""
        cfg = self.cfg
        device = resolve_device(device)
        dtype = dtype or getattr(torch, cfg.dtype)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(0)
        out: Batch = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                              generator=gen, device=device)}
        if cfg.arch_type == "audio":
            out["frames"] = torch.randn((batch, cfg.enc_seq, cfg.d_model),
                                        generator=gen, device=device).to(dtype)
        if cfg.arch_type == "vlm":
            out["vision"] = torch.randn((batch, cfg.n_vision_tokens, cfg.d_model),
                                        generator=gen, device=device).to(dtype)
        return out


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
