"""Sliding-window attention in the port's dense arm, against the reference
(``tests/test_sliding_window.py``'s cases): the windowed forward, prefill
and decode past the window, a token outside the window that changes
nothing, a windowed reference cache (a ring of slots) carried over into the
port's pool, and the engine token for token; float32 on the CPU. The port's
pool keeps every position and decodes with a lower bound
``max(0, pos + 1 - window)``, where the reference keeps a ring of
``window`` slots: both attend over the same positions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro.serving import request as ref_request
from repro.serving.engine import Engine as RefEngine
from repro_torch import params as port_params
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.models import layers
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import RequestState

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

WINDOW = 16
S = 48


def _pair(arch, window, seed=0):
    """(reference model, its params, port model, carried-over params)."""
    rcfg = ref_smoke_config(arch).with_(sliding_window=window)
    ref_model = RefModel(rcfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    cfg = get_smoke_config(arch).with_(sliding_window=window)
    params = port_params.from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                                        device="cpu", dtype=torch.float32)
    return ref_model, ref_params, Model(cfg), params


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ["granite-8b", "phi3-mini-3.8b"])
def test_windowed_forward_matches_reference(arch):
    ref_model, ref_params, model, params = _pair(arch, WINDOW, seed=1)
    toks = _tokens(model.cfg.vocab_size, (2, S), 1)
    want, _ = ref_model.forward(ref_params, {"tokens": jnp.asarray(toks)})
    got, _ = model.forward(params, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("arch", ["granite-8b", "llama-8b"])
def test_windowed_decode_matches_windowed_forward(arch):
    """Prefill S - 6 tokens, then decode 6 past the window: each step's
    logits are the windowed forward's at that position, and the reference
    decode's from its ring."""
    ref_model, ref_params, model, params = _pair(arch, WINDOW, seed=0)
    toks = _tokens(model.cfg.vocab_size, (2, S), 0)
    tt = torch.from_numpy(toks).long()
    full, _ = model.forward(params, {"tokens": tt})
    n_extra = 6
    last, cache = model.prefill(params, {"tokens": tt[:, :S - n_extra]}, cache_len=S,
                                dtype=torch.float32)
    _, rcache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks[:, :S - n_extra])},
                                  dtype=jnp.float32)
    assert rcache["k"].shape[2] == WINDOW        # the reference's ring
    np.testing.assert_allclose(last.numpy(), full[:, S - n_extra - 1].numpy(),
                               atol=5e-3, rtol=5e-3)
    for i in range(n_extra):
        pos = S - n_extra + i
        logits, cache = model.decode_step(params, tt[:, pos:pos + 1], cache)
        want, rcache = ref_model.decode_step(ref_params, jnp.asarray(toks[:, pos:pos + 1]),
                                             rcache)
        # the reference's own prefill-vs-decode tolerance
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), atol=5e-3, rtol=5e-3)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=5e-3, rtol=5e-3)


def test_window_restricts_attention():
    """Tokens beyond the window must not influence the output."""
    _, _, model, params = _pair("granite-8b", 8, seed=0)
    t1 = torch.from_numpy(_tokens(model.cfg.vocab_size, (1, 32), 2)).long()
    t2 = t1.clone()
    t2[0, 2] = (t1[0, 2] + 7) % model.cfg.vocab_size
    f1, _ = model.forward(params, {"tokens": t1})
    f2, _ = model.forward(params, {"tokens": t2})
    np.testing.assert_allclose(f1[:, -1].numpy(), f2[:, -1].numpy(), atol=1e-5)
    assert float((f1[:, 3] - f2[:, 3]).abs().max()) > 1e-3


def test_decode_plan_lower_bound():
    """``starts = max(0, pos + 1 - window)``; no bound without a window and
    for inactive rows a length of 0."""
    cfg = get_smoke_config("llama-8b").with_(sliding_window=8)
    bt = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    pos = torch.tensor([3, 20, 9])
    plan = layers.decode_plan(cfg, bt, pos, torch.tensor([True, True, False]), 16)
    assert plan["starts"].tolist() == [0, 13, 0]
    assert plan["starts"].dtype == torch.int32
    assert plan["lengths"].tolist() == [4, 21, 0]
    assert layers.decode_plan(cfg.with_(sliding_window=0), bt, pos, None, 16)["starts"] is None


@pytest.mark.parametrize("prompt,steps", [(10, 12), (30, 5)])
def test_windowed_reference_cache_carried_over(prompt, steps):
    """A reference cache that is a ring of ``window`` slots (prompt longer
    than the window) or a part-filled ring (shorter) is unrolled by its
    ``slot_pos`` into the port's pool, which decodes on as the reference
    does, past the window. (``cache_len=WINDOW``: without it the reference
    sizes the ring ``min(prompt, window)``, and a ring shorter than the
    window overwrites positions still inside it once decode wraps.)"""
    ref_model, ref_params, model, params = _pair("granite-8b", WINDOW, seed=3)
    toks = _tokens(model.cfg.vocab_size, (2, prompt + steps), 3)
    logits, rcache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks[:, :prompt])},
                                       cache_len=WINDOW, dtype=jnp.float32)
    assert rcache["k"].shape[2] == WINDOW
    assert int((np.asarray(rcache["slot_pos"]) >= 0).sum()) == 2 * min(prompt, WINDOW)
    cache = port_params.cache_from_reference(jax.tree.map(np.asarray, rcache), model.cfg,
                                             device="cpu", dtype=torch.float32)
    assert cache["pos"].tolist() == [prompt] * 2
    for i in range(steps):
        t = toks[:, prompt + i:prompt + i + 1]
        want, rcache = ref_model.decode_step(ref_params, jnp.asarray(t), rcache)
        got, cache = model.decode_step(params, torch.from_numpy(t.copy()).long(), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3, rtol=5e-3)


def test_chunked_prefill_refuses_a_window():
    _, _, model, params = _pair("granite-8b", WINDOW, seed=5)
    tt = torch.from_numpy(_tokens(model.cfg.vocab_size, (1, 12), 5)).long()
    _, past = model.prefill(params, {"tokens": tt[:, :6]}, dtype=torch.float32)
    with pytest.raises(ValueError, match="non-windowed"):
        model.prefill(params, {"tokens": tt[:, 6:]}, dtype=torch.float32, past_cache=past)


def test_windowed_engine_token_for_token_with_reference_engine():
    """A window of 8 under prompts of up to 30 tokens: every slot's next
    input token agrees with the reference engine's (a ring of slots) after
    every step, through a preempt-and-restore cycle."""
    arch, window = "granite-8b", 8
    rcfg = ref_smoke_config(arch).with_(sliding_window=window)
    cfg = get_smoke_config(arch).with_(sliding_window=window)
    ref = RefEngine(rcfg, key=jax.random.PRNGKey(0), max_slots=3, max_len=96,
                    dtype=jnp.float32)
    params = port_params.from_reference(jax.tree.map(np.asarray, ref.params), cfg,
                                        device="cpu", dtype=torch.float32)
    eng = Engine(cfg, params=params, max_slots=3, max_len=96, dtype=torch.float32,
                 device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,), dtype=np.int32)
               for n in (9, 23, 17, 30, 5)]

    def requests(mod):
        out = []
        for i, toks in enumerate(prompts):
            make = mod.make_batch if i < 3 else mod.make_interactive
            r = make(len(toks), 10 + 3 * i)
            r.prompt_tokens = toks
            out.append(r)
        return out

    import repro_torch.serving.request as port_request
    pairs = list(zip(requests(ref_request), requests(port_request)))
    for a, b in pairs[:3]:
        ref.submit(a)
        eng.submit(b)
    preemptions = 0
    for step in range(200):
        if not (eng.waiting or eng.n_active):
            break
        if step == 3:
            for a, b in pairs[3:]:
                ref.submit(a)
                eng.submit(b)
        sa, sb = ref.step(), eng.step()
        assert len(sa.preempted) == len(sb.preempted)
        preemptions += len(sb.preempted)
        for va, vb in zip(sa.preempted, sb.preempted):
            ref.submit(va)
            eng.submit(vb)
        got = [s.token for s in eng.slots]
        want = [None if s.token is None else int(s.token[0]) for s in ref.slots]
        assert got == want, f"step {step}"
    assert preemptions >= 1
    for a, b in pairs:
        assert b.state == RequestState.FINISHED
        assert a.tokens_generated == b.tokens_generated
