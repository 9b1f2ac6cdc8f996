"""The port's whisper-style encoder-decoder (``models/encdec.py``) against
``repro.models.encdec`` with the reference's parameters carried over by
``params.from_reference``, on the same numpy inputs, float32 on the CPU:
the cross-attention layers, ``encode``, ``forward`` and loss, prefill and
decode steps, a reference cache carried over, the slot protocol, free rows,
and the serving engine token for token with the reference engine through a
preemption."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.serving.request as port_request
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro.models import encdec as ref_encdec
from repro.models import layers as ref_layers
from repro.serving import request as ref_request
from repro.serving.engine import Engine as RefEngine
from repro_torch import params as port_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import Model, encdec, layers, transformer
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import RequestState

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

ARCH = "whisper-base"
TOL = 1e-4                # float32, other orders of sums
PROMPT_LENS = (9, 23, 17, 30, 5)


def _pair(seed=0):
    rcfg = ref_smoke_config(ARCH)
    cfg = get_smoke_config(ARCH)
    ref_model = RefModel(rcfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    params = port_params.from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                                        device="cpu", dtype=torch.float32)
    return ref_model, ref_params, Model(cfg), params


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    ref = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    port = {"tokens": torch.from_numpy(toks).long(), "frames": torch.from_numpy(frames)}
    return ref, port


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def test_full_config_widths():
    """whisper-base at full width: 6 encoder and 6 decoder layers, d 512,
    8/8 heads of 64, ff 2048, V 51865, 1500 frames, LayerNorm and GELU."""
    cfg = get_config(ARCH)
    assert Model(cfg).cfg.arch_type == "audio"
    assert (cfg.n_enc_layers, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.enc_seq) == \
        (6, 6, 512, 8, 8, 64, 2048, 51865, 1500)
    assert (cfg.norm, cfg.ffn) == ("layernorm", "gelu")
    # the cross pool holds 94 pages of 16 a slot
    c = encdec.init_cache(get_smoke_config(ARCH).with_(enc_seq=1500), 2, 64,
                          torch.float32, "cpu")
    assert c["cross_block_tables"].shape == (2, 94)


def test_init_params_layout_matches_the_reference():
    """The reference's names, stacking and shapes, leaf for leaf."""
    ref_model, ref_params, model, _ = _pair()
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, dtype=torch.float32, device="cpu")
    want = {jax.tree_util.keystr(k): v.shape
            for k, v in jax.tree_util.tree_flatten_with_path(ref_params)[0]}
    got = {}

    def walk(tree, path):
        for key, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{path}['{key}']")
            else:
                got[f"{path}['{key}']"] = tuple(v.shape)
    walk(params, "")
    assert got == want


def test_cross_attention_layers():
    """``attention_forward(kv_x=)`` (no RoPE, full over T rows, S != T) and
    ``cross_attention_decode`` over a paged cross pool against the
    reference's layers."""
    rcfg, cfg = ref_smoke_config(ARCH), get_smoke_config(ARCH)
    key = jax.random.PRNGKey(3)
    p_ref = ref_layers.init_attention(rcfg, key, jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in p_ref.items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    want = ref_layers.attention_forward(rcfg, p_ref, jnp.asarray(x),
                                        kv_x=jnp.asarray(enc), causal=False,
                                        use_rope=False)
    got, k, v = layers.attention_forward(cfg, p, torch.from_numpy(x),
                                         kv_x=torch.from_numpy(enc), causal=False,
                                         use_rope=False, return_kv=True)
    _close(got, want)
    # one token a row against the encoder K/V the prefill made, paged
    hd, Hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    ck = (enc @ np.asarray(p_ref["wk"])).reshape(2, -1, Hkv, hd)
    cv = (enc @ np.asarray(p_ref["wv"])).reshape(2, -1, Hkv, hd)
    np.testing.assert_allclose(k.numpy(), ck, atol=TOL, rtol=TOL)
    xt = x[:, :1]
    want = ref_layers.cross_attention_decode(rcfg, p_ref, jnp.asarray(xt),
                                             jnp.asarray(ck), jnp.asarray(cv))
    pool = layers.init_kv_cache(cfg, 2, cfg.enc_seq, 1, torch.float32, "cpu")
    for b in range(2):
        for key_, src in (("k", k), ("v", v)):
            rows = pool[key_][0, pool["block_tables"][b].long()].reshape(-1, Hkv, hd)
            rows[:cfg.enc_seq] = src[b]
            pool[key_][0, pool["block_tables"][b].long()] = rows.reshape(
                -1, 16, Hkv, hd)
    lengths = torch.full((2,), cfg.enc_seq, dtype=torch.int32)
    got = layers.cross_attention_decode(cfg, p, torch.from_numpy(xt), pool["k"][0],
                                        pool["v"][0], pool["block_tables"], lengths)
    _close(got, want)


def test_encode_forward_and_loss():
    ref_model, ref_params, model, params = _pair(seed=1)
    ref_batch, batch = _inputs(model.cfg, 2, 13, 1)
    want = ref_encdec.encode(ref_model.cfg, ref_params, ref_batch["frames"])
    _close(encdec.encode(model.cfg, params, batch["frames"]), want)
    want, _ = ref_model.forward(ref_params, ref_batch)
    got, aux = model.forward(params, batch)
    _close(got, want)
    assert float(aux) == 0.0
    want_loss = ref_model.loss(ref_params, ref_batch)
    assert abs(float(model.loss(params, batch)) - float(want_loss)) <= TOL


def test_prefill_and_three_decode_steps():
    """Prefill 13 tokens into pools of 20 positions, then three greedy
    decode steps; the encoder K/V the prefill cached agree too."""
    ref_model, ref_params, model, params = _pair(seed=2)
    ref_batch, batch = _inputs(model.cfg, 2, 13, 2)
    want, rcache = ref_model.prefill(ref_params, ref_batch, cache_len=20,
                                     dtype=jnp.float32)
    got, cache = model.prefill(params, batch, cache_len=20, dtype=torch.float32)
    _close(got, want)
    _, dense = model.prefill(params, batch, dtype=torch.float32)
    for key in ("cross_k", "cross_v"):
        _close(dense[key], rcache[key])
    for _ in range(3):
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)[:, None]
        want, rcache = ref_model.decode_step(ref_params, jnp.asarray(tok), rcache)
        got, cache = model.decode_step(params, torch.from_numpy(tok).long(), cache)
        _close(got, want)
        assert np.array_equal(got.argmax(-1).numpy(), np.asarray(jnp.argmax(want, -1)))
    assert cache["pos"].tolist() == [16, 16]


def test_cache_from_reference_continues_decoding():
    """A reference cache (dense self K/V, cross K/V of ``enc_seq`` rows)
    carried over into the port's pools decodes as the reference's does."""
    ref_model, ref_params, model, params = _pair(seed=3)
    ref_batch, _ = _inputs(model.cfg, 2, 11, 3)
    _, rcache = ref_model.prefill(ref_params, ref_batch, cache_len=24,
                                  dtype=jnp.float32)
    cache = port_params.cache_from_reference(jax.tree.map(np.asarray, rcache),
                                             model.cfg, device="cpu")
    assert cache["cross_k"].shape[1] == 2 * 2     # two pages of 16 a row
    tok = np.array([[3], [5]], np.int32)
    for _ in range(2):
        want, rcache = ref_model.decode_step(ref_params, jnp.asarray(tok), rcache)
        got, cache = model.decode_step(params, torch.from_numpy(tok).long(), cache)
        _close(got, want)


def test_free_rows_write_nothing_and_keep_their_position():
    """A free row of a decode step keeps ``pos``, writes no K/V into either
    pool, and leaves the active rows' logits as they are."""
    _, _, model, params = _pair(seed=4)
    _, batch = _inputs(model.cfg, 3, 9, 4)
    _, cache = model.prefill(params, batch, cache_len=16, dtype=torch.float32)
    before = {k: v.clone() for k, v in cache.items()}
    tok = torch.tensor([[1], [2], [3]])
    full, _ = model.decode_step(params, tok, {k: v.clone() for k, v in cache.items()})
    active = torch.tensor([True, False, True])
    got, cache = model.decode_step(params, tok, cache, active)
    torch.testing.assert_close(got[active], full[active], atol=TOL, rtol=TOL)
    assert cache["pos"].tolist() == [10, 9, 10]
    for key in ("k", "v", "cross_k", "cross_v"):
        rows = transformer.cache_rows(cache, key, 1, table="cross_block_tables"
                                      if key.startswith("cross") else "block_tables")
        was = transformer.cache_rows(before, key, 1, table="cross_block_tables"
                                     if key.startswith("cross") else "block_tables")
        assert torch.equal(rows, was)
    for key in ("cross_k", "cross_v"):
        assert torch.equal(cache[key], before[key])


def test_slot_read_and_write_round_trip():
    """``read_slot`` copies a row (both pools) to the host; ``write_slot``
    of that copy into another row decodes as the original row does."""
    _, _, model, params = _pair(seed=5)
    _, batch = _inputs(model.cfg, 1, 7, 5)
    pool = model.init_cache(3, 16, dtype=torch.float32, device="cpu")
    _, sub = model.prefill(params, batch, dtype=torch.float32)
    model.write_slot(pool, 0, sub)
    pool["pos"][0] = 7
    saved = model.read_slot(pool, 0, 7)
    assert saved["cross_k"].shape[2] == 32 and saved["k"].shape[2] == 7
    model.write_slot(pool, 2, saved)
    pool["pos"][2] = 7
    tok = torch.tensor([[4], [0], [4]])
    logits, _ = model.decode_step(params, tok, pool,
                                  torch.tensor([True, False, True]))
    torch.testing.assert_close(logits[0], logits[2], atol=0, rtol=0)


def test_prefill_refuses_past_cache():
    _, _, model, params = _pair()
    _, batch = _inputs(model.cfg, 1, 5, 6)
    _, sub = model.prefill(params, batch, dtype=torch.float32)
    with pytest.raises(ValueError, match="past_cache"):
        model.prefill(params, batch, past_cache=sub)


def test_example_batch_draws_frames():
    model = Model(get_smoke_config(ARCH))
    gen = torch.Generator().manual_seed(0)
    b = model.example_batch(2, 5, gen, dtype=torch.float32, device="cpu")
    assert b["frames"].shape == (2, 32, model.cfg.d_model)
    assert b["frames"].dtype == torch.float32 and b["tokens"].shape == (2, 5)
    assert 0.8 < float(b["frames"].std()) < 1.2


def test_engine_token_for_token_with_reference_engine():
    """Same parameters and prompts, float32: every slot's next input token
    agrees with the reference engine's after every step, through a
    preempt-and-restore cycle (the saved slot carries its encoder K/V)."""
    rcfg, cfg = ref_smoke_config(ARCH), get_smoke_config(ARCH)
    ref = RefEngine(rcfg, key=jax.random.PRNGKey(0), max_slots=3, max_len=96,
                    dtype=jnp.float32)
    params = port_params.from_reference(jax.tree.map(np.asarray, ref.params), cfg,
                                        device="cpu", dtype=torch.float32)
    eng = Engine(cfg, params=params, max_slots=3, max_len=96, dtype=torch.float32,
                 device="cpu")
    assert eng.prefill_chunk == 0 and eng.prefix_cache is None
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,), dtype=np.int32)
               for n in PROMPT_LENS]

    def requests(mod):
        out = []
        for i, toks in enumerate(prompts):
            r = (mod.make_batch if i < 3 else mod.make_interactive)(len(toks), 10 + 3 * i)
            r.prompt_tokens = toks
            out.append(r)
        return out

    pairs = list(zip(requests(ref_request), requests(port_request)))
    for a, b in pairs[:3]:
        ref.submit(a)
        eng.submit(b)
    preemptions = 0
    for step in range(300):
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
            assert vb.saved_kv["cross_k"].shape[2] == 32
            ref.submit(va)
            eng.submit(vb)
        assert [s.token for s in eng.slots] == \
            [None if s.token is None else int(s.token[0]) for s in ref.slots], f"step {step}"
    assert preemptions >= 1
    for a, b in pairs:
        assert b.state == RequestState.FINISHED
        assert a.tokens_generated == b.tokens_generated
