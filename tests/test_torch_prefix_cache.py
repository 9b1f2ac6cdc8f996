"""The port's prefix cache and chunked prefill (``serving/prefix_cache.py``,
``Engine(prefix_cache_entries=, prefill_chunk=)``) against the reference's:
the behaviours of ``tests/test_prefix_cache.py`` and
``tests/test_chunked_prefill.py`` on the same numpy inputs and carried-over
parameters, float32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.serving.request as port_request
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro.serving import request as ref_request
from repro.serving.engine import Engine as RefEngine
from repro.serving.prefix_cache import PrefixCache as RefPrefixCache
from repro_torch import params as port_params
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.serving.engine import Engine
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.request import RequestState

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

ARCHS = ["granite-8b", "llama-8b"]
TOL = 1e-4      # float32 logits, port against reference


def _carried(arch, seed=0):
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    ref_model = RefModel(rcfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    params = port_params.from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                                        device="cpu", dtype=torch.float32)
    return rcfg, cfg, ref_model, ref_params, params


def _engines(arch, **knobs):
    rcfg, cfg, _, ref_params, params = _carried(arch)
    ref = RefEngine(rcfg, params=ref_params, max_slots=2, max_len=96,
                    dtype=jnp.float32, **knobs)
    eng = Engine(cfg, params=params, max_slots=2, max_len=96,
                 dtype=torch.float32, device="cpu", **knobs)
    return ref, eng


# --------------------------------------------------------------- the cache


def test_prefix_cache_lookup_longest():
    for cls in (PrefixCache, RefPrefixCache):
        pc = cls(max_entries=4)
        pc.store([1, 2, 3], "c3")
        pc.store([1, 2, 3, 4, 5], "c5")
        assert pc.lookup([1, 2, 3, 4, 5, 6, 7]) == ("c5", 5)
        assert pc.lookup([1, 2, 3, 4]) == ("c3", 3)   # the longest STRICT prefix
        assert pc.lookup([9, 9]) == (None, 0)
        assert (pc.hits, pc.misses, pc.hit_tokens) == (2, 1, 8)


def test_prefix_cache_lru_eviction():
    for cls in (PrefixCache, RefPrefixCache):
        pc = cls(max_entries=2)
        pc.store([1], "a")
        pc.store([2], "b")
        pc.store([3], "c")
        assert len(pc) == 2
        assert pc.lookup([1, 0])[0] is None       # evicted
        assert pc.lookup([3, 0])[0] == "c"
        pc.store([4], "d")                        # [2] is now the oldest
        assert pc.lookup([2, 0])[0] is None and pc.lookup([3, 1])[0] == "c"


def test_slice_cache_truncates_the_dense_cache():
    k = torch.arange(2 * 1 * 6 * 2 * 4, dtype=torch.float32).reshape(2, 1, 6, 2, 4)
    cut = PrefixCache._slice_cache({"k": k, "v": -k, "pos": torch.tensor([6])}, 4)
    assert torch.equal(cut["k"], k[:, :, :4]) and torch.equal(cut["v"], -k[:, :, :4])
    assert cut["pos"].tolist() == [4] and cut["pos"].dtype == torch.int64


# ------------------------------------------------------- chunked prefill


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_matches_the_reference_oneshot(arch):
    """Three chunks of 16 through ``past_cache`` against the reference's
    one-shot prefill: logits and K within 1e-4, ``pos`` the full length."""
    rcfg, cfg, ref_model, ref_params, params = _carried(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    want, want_cache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                                         dtype=jnp.float32)
    model = Model(cfg)
    cache = None
    for lo in range(0, 48, 16):
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(toks[:, lo:lo + 16]).long()},
            dtype=torch.float32, past_cache=cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(want_cache["k"]),
                               atol=TOL, rtol=TOL)
    assert cache["pos"].tolist() == [48, 48]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_reuse_then_decode(arch):
    """A cached 24-token prefix, the 8-token suffix prefilled from it, then
    four decode steps: the same logits as the reference's from-scratch path."""
    rcfg, cfg, ref_model, ref_params, params = _carried(arch)
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab_size, (1, 24)).astype(np.int32)
    suffix = rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
    full = np.concatenate([prefix, suffix], axis=1)
    model = Model(cfg)
    _, pcache = model.prefill(params, {"tokens": torch.from_numpy(prefix).long()},
                              dtype=torch.float32)
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(suffix).long()},
                               dtype=torch.float32, past_cache=pcache, cache_len=40)
    want, rcache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(full)},
                                     dtype=jnp.float32, cache_len=40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    tok = np.array(jnp.argmax(want, -1), np.int32)
    for _ in range(4):
        want, rcache = ref_model.decode_step(ref_params, jnp.asarray(tok)[:, None],
                                             rcache)
        got, cache = model.decode_step(params, torch.from_numpy(tok).long()[:, None],
                                       cache)
        # the decode tolerance of the reference's own prefix-reuse test
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3,
                                   rtol=5e-3)
        tok = np.array(jnp.argmax(want, -1), np.int32)


# ---------------------------------------------------------------- engine


def _prompts(cfg, shared_len=16, extras=((1, 2, 3), (4, 5, 6), (7, 8, 9))):
    shared = np.arange(10, 10 + shared_len, dtype=np.int32) % cfg.vocab_size
    return [np.concatenate([shared, np.asarray(e, np.int32)]) for e in extras]


def _run_pair(ref, eng, prompts, out_len=6):
    """Serve the prompts one after another (so each earlier prompt is cached)
    on both engines; every slot's next token agrees after every step."""
    pairs = []
    for toks in prompts:
        a = ref_request.make_interactive(len(toks), out_len)
        b = port_request.make_interactive(len(toks), out_len)
        a.prompt_tokens = b.prompt_tokens = toks
        ref.submit(a)
        eng.submit(b)
        pairs.append((a, b))
        for step in range(100):
            if not (eng.waiting or eng.n_active):
                break
            ref.step()
            eng.step()
            got = [s.token for s in eng.slots]
            want = [None if s.token is None else int(s.token[0]) for s in ref.slots]
            assert got == want, f"step {step}"
    assert not (ref.waiting or ref.n_active)
    for a, b in pairs:
        assert b.state == RequestState.FINISHED
        assert a.tokens_generated == b.tokens_generated
    return pairs


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_prefix_hit_and_correctness(arch):
    ref, eng = _engines(arch, prefix_cache_entries=8)
    _run_pair(ref, eng, _prompts(eng.cfg))
    pc, rpc = eng.prefix_cache, ref.prefix_cache
    assert pc.hits >= 1
    assert (pc.hits, pc.misses, pc.hit_tokens) == (rpc.hits, rpc.misses, rpc.hit_tokens)
    assert len(pc) == len(rpc) == 3

    # the same workload without the cache gives the same tokens
    _, plain = _engines(arch)
    ref2, _ = _engines(arch)
    assert plain.prefix_cache is None
    _run_pair(ref2, plain, _prompts(plain.cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_chunked_prefill(arch):
    """29 tokens in chunks of 8 (8 + 8 + 8 + 5), then the prefix cache and
    chunks together on prompts that share 16 tokens."""
    ref, eng = _engines(arch, prefill_chunk=8)
    toks = np.random.default_rng(5).integers(0, eng.cfg.vocab_size, 29).astype(np.int32)
    _run_pair(ref, eng, [toks])
    ref, eng = _engines(arch, prefill_chunk=8, prefix_cache_entries=8)
    _run_pair(ref, eng, _prompts(eng.cfg, 21, ((1, 2, 3), (4,) * 12, (7, 8))))
    pc, rpc = eng.prefix_cache, ref.prefix_cache
    assert pc.hits == 2 and pc.hit_tokens == 42
    assert (pc.hits, pc.misses, pc.hit_tokens) == (rpc.hits, rpc.misses, rpc.hit_tokens)


@pytest.mark.parametrize("chunk,entries", [(0, 8), (5, 8), (7, 0)])
def test_engine_prefill_logits_and_cache_match_the_reference(chunk, entries):
    """``Engine._prefill`` through the knobs, request by request: last
    logits within 1e-4, the same cache length and the same hit counts."""
    ref, eng = _engines("granite-8b", prefill_chunk=chunk,
                        prefix_cache_entries=entries)
    for toks in _prompts(eng.cfg, 18, ((1, 2, 3, 4), (4, 5), (1, 2, 9))):
        a = ref_request.make_interactive(len(toks), 4)
        b = port_request.make_interactive(len(toks), 4)
        a.prompt_tokens = b.prompt_tokens = toks
        want, rcache = ref._prefill(a)
        got, cache = eng._prefill(b)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
        assert cache["k"].shape[2] == rcache["k"].shape[2] == len(toks)
        assert cache["pos"].tolist() == [len(toks)]
    if entries:
        pc, rpc = eng.prefix_cache, ref.prefix_cache
        assert (pc.hits, pc.misses, pc.hit_tokens) == (rpc.hits, rpc.misses,
                                                       rpc.hit_tokens) == (2, 1, 20 + 18)


def test_stored_cache_is_no_view_of_what_is_written_later():
    """A stored prompt cache keeps its values while its slot decodes, is
    overwritten by other requests and its prefix is reused; it shares no
    storage with the pool."""
    _, eng = _engines("granite-8b", prefix_cache_entries=8, prefill_chunk=4)
    first = _prompts(eng.cfg)[0]
    r = port_request.make_interactive(len(first), 12)
    r.prompt_tokens = first
    eng.submit(r)
    eng.step()
    stored = eng.prefix_cache._store[tuple(int(t) for t in first)]
    saved = {k: v.clone() for k, v in stored.items()}
    pool_storage = {t.untyped_storage().data_ptr() for t in eng.pool.values()}
    assert not pool_storage & {t.untyped_storage().data_ptr() for t in stored.values()}
    for toks in _prompts(eng.cfg)[1:] + _prompts(eng.cfg, 19):
        q = port_request.make_interactive(len(toks), 5)
        q.prompt_tokens = toks
        eng.submit(q)
    while eng.waiting or eng.n_active:
        eng.step()
    assert eng.prefix_cache.hits >= 4
    for k, v in saved.items():
        assert torch.equal(stored[k], v), k


def test_ssm_family_ignores_both_knobs():
    """As in the reference, only the transformer family chunks or caches."""
    for cls, kw in ((Engine, dict(device="cpu", dtype=torch.float32)),
                    (RefEngine, dict(dtype=jnp.float32))):
        cfg = (get_smoke_config if cls is Engine else ref_smoke_config)("mamba2-1.3b")
        eng = cls(cfg, max_slots=2, max_len=48, prefix_cache_entries=8,
                  prefill_chunk=4, **kw)
        assert eng.prefix_cache is None and eng.prefill_chunk == 0
