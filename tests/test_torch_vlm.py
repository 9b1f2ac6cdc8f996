"""The port's VLM arm (internvl2-2b, smoke size) against ``repro.models``
and ``repro.serving.engine`` with the reference's parameters carried over:
forward, prefill and decode with random vision embeddings (zero ones, as the
engine feeds, would leave the prefix rows zero and hide a wrong prefix
mask), the loss, and the engine token for token; float32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro.models import layers as ref_layers
from repro.serving import request as ref_request
from repro.serving.engine import Engine as RefEngine
from repro_torch import params as port_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import Model
from repro_torch.models import layers
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import RequestState, make_interactive

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

ARCH = "internvl2-2b"


def _reference(seed=0):
    model = RefModel(ref_smoke_config(ARCH))
    return model, model.init(jax.random.PRNGKey(seed), dtype=jnp.float32)


def _carried_over(ref_params):
    cfg = get_smoke_config(ARCH)
    return cfg, port_params.from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                                           device="cpu", dtype=torch.float32)


def _batch(cfg, B, S, seed):
    """Random tokens and standard-normal vision embeddings from numpy, as
    (reference batch, port batch)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    vis = rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "vision": jnp.asarray(vis)},
            {"tokens": torch.from_numpy(toks).long(), "vision": torch.from_numpy(vis)})


def test_config_is_the_vlm_arm():
    cfg = get_config(ARCH)
    assert cfg.arch_type == "vlm" and cfg.n_vision_tokens == 256
    assert (cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim) == (2, 128)
    assert get_smoke_config(ARCH).n_vision_tokens == 16


def test_forward_logits_with_random_vision_embeddings():
    ref_model, ref_params = _reference(seed=1)
    cfg, params = _carried_over(ref_params)
    rb, pb = _batch(cfg, 2, 13, seed=1)
    want, _ = ref_model.forward(ref_params, rb)
    got, aux = Model(cfg).forward(params, pb)
    assert got.shape == (2, 13, cfg.vocab_size)      # text positions only
    # float32, different order of sums
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    assert float(aux) == 0.0


def test_the_vision_prefix_is_seen_bidirectionally():
    """The prefix mask changes the vision rows' attention (a vision row sees
    the later vision rows too) and with it the text logits of the next
    layer: the port with the mask matches the reference, the causal mask
    alone does not."""
    ref_model, ref_params = _reference(seed=2)
    cfg, params = _carried_over(ref_params)
    rb, pb = _batch(cfg, 1, 9, seed=2)
    want, _ = ref_model.forward(ref_params, rb)
    got, _ = Model(cfg).forward(params, pb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    # the attention of one layer, with and without the prefix
    n = cfg.n_vision_tokens
    x = torch.cat([pb["vision"], layers.embed(params["emb"], pb["tokens"])], 1)
    lp = layers.layer_params(params["layers"], 0)["attn"]
    with_prefix = layers.attention_forward(cfg, lp, x, prefix_len=n)
    causal = layers.attention_forward(cfg, lp, x)
    ref_lp = jax.tree.map(lambda a: a[0], ref_params["layers"])["attn"]
    want_prefix = ref_layers.attention_forward(ref_smoke_config(ARCH), ref_lp,
                                               jnp.asarray(x.numpy()), prefix_len=n)
    np.testing.assert_allclose(with_prefix.numpy(), np.asarray(want_prefix),
                               atol=2e-4, rtol=2e-4)
    assert float((with_prefix[:, :n - 1] - causal[:, :n - 1]).abs().max()) > 1e-3
    # the text rows see the whole prefix either way
    np.testing.assert_allclose(with_prefix[:, n:].numpy(), causal[:, n:].numpy(),
                               atol=1e-6, rtol=1e-6)


def test_prefill_and_three_decode_steps_with_random_vision_embeddings():
    ref_model, ref_params = _reference(seed=3)
    cfg, params = _carried_over(ref_params)
    model = Model(cfg)
    B, S, cap = 2, 11, 48
    rb, pb = _batch(cfg, B, S, seed=3)
    want, rcache = ref_model.prefill(ref_params, rb, cache_len=cap, dtype=jnp.float32)
    got, cache = model.prefill(params, pb, cache_len=cap, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    n_vis = cfg.n_vision_tokens
    assert cache["pos"].tolist() == [n_vis + S] * B
    tok = np.asarray(jnp.argmax(want, -1), np.int32)
    for step in range(3):
        want, rcache = ref_model.decode_step(ref_params, jnp.asarray(tok)[:, None], rcache)
        got, cache = model.decode_step(params, torch.from_numpy(tok.copy()).long()[:, None],
                                       cache)
        # the reference's own prefill-vs-decode tolerance
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3, rtol=5e-3)
        assert cache["pos"].tolist() == [n_vis + S + step + 1] * B
        tok = np.asarray(jnp.argmax(want, -1), np.int32)
        assert got.argmax(-1).tolist() == tok.tolist()


def test_dense_prefill_cache_covers_the_vision_prefix():
    """Without ``cache_len`` the cache is the reference's: (L, B, n_vis + S)
    roped K/V, ``pos = n_vis + S``."""
    ref_model, ref_params = _reference(seed=4)
    cfg, params = _carried_over(ref_params)
    rb, pb = _batch(cfg, 1, 7, seed=4)
    _, rcache = ref_model.prefill(ref_params, rb, dtype=jnp.float32)
    _, cache = Model(cfg).prefill(params, pb, dtype=torch.float32)
    assert cache["k"].shape[2] == cfg.n_vision_tokens + 7
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(rcache["k"]),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(rcache["v"]),
                               atol=2e-4, rtol=2e-4)
    assert cache["pos"].tolist() == np.asarray(rcache["pos"]).tolist()


def test_prefill_refuses_a_vision_prefix_after_a_past_cache():
    ref_model, ref_params = _reference(seed=5)
    cfg, params = _carried_over(ref_params)
    _, pb = _batch(cfg, 1, 5, seed=5)
    model = Model(cfg)
    _, past = model.prefill(params, pb, dtype=torch.float32)
    with pytest.raises(ValueError, match="first chunk"):
        model.prefill(params, pb, dtype=torch.float32, past_cache=past)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_matches_reference(masked):
    ref_model, ref_params = _reference(seed=6)
    cfg, params = _carried_over(ref_params)
    rb, pb = _batch(cfg, 2, 12, seed=6)
    if masked:
        mask = (np.random.default_rng(6).random((2, 12)) < 0.6).astype(np.int32)
        rb["loss_mask"] = jnp.asarray(mask)
        pb["loss_mask"] = torch.from_numpy(mask)
    want = float(ref_model.loss(ref_params, rb))
    got = Model(cfg).loss(params, pb)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, atol=1e-4, rtol=1e-4)


def test_loss_matches_reference_for_a_dense_config():
    model = RefModel(ref_smoke_config("olmo-1b"))
    ref_params = model.init(jax.random.PRNGKey(7), dtype=jnp.float32)
    cfg = get_smoke_config("olmo-1b")
    params = port_params.from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                                        device="cpu", dtype=torch.float32)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 15)).astype(np.int32)
    want = float(model.loss(ref_params, {"tokens": jnp.asarray(toks)}))
    got = Model(cfg).loss(params, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(float(got), want, atol=1e-4, rtol=1e-4)


def test_example_batch_has_the_vision_modality():
    cfg = get_smoke_config(ARCH)
    model = Model(cfg)
    a = model.example_batch(3, 10, torch.Generator().manual_seed(1),
                            dtype=torch.float32, device="cpu")
    b = model.example_batch(3, 10, torch.Generator().manual_seed(1),
                            dtype=torch.float32, device="cpu")
    assert a["tokens"].shape == (3, 10) and a["tokens"].dtype == torch.long
    assert int(a["tokens"].max()) < cfg.vocab_size
    assert a["vision"].shape == (3, cfg.n_vision_tokens, cfg.d_model)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["vision"], b["vision"])
    want = RefModel(ref_smoke_config(ARCH)).example_batch(3, 10, dtype=jnp.float32)
    assert set(want) == set(a)
    assert all(tuple(want[k].shape) == tuple(a[k].shape) for k in want)
    dense = Model(get_smoke_config("olmo-1b")).example_batch(2, 4, device="cpu")
    assert set(dense) == {"tokens"}


def test_engine_counts_the_vision_prefix_against_max_len():
    cfg = get_smoke_config(ARCH)          # 16 vision tokens
    eng = Engine(cfg, max_slots=2, max_len=40, dtype=torch.float32, device="cpu")
    eng.submit(make_interactive(23, 4))   # 16 + 23 = 39 positions
    with pytest.raises(ValueError, match="does not fit"):
        eng.submit(make_interactive(24, 4))


def test_token_for_token_with_reference_engine():
    """Same parameters, same explicit prompts, float32: every slot's next
    input token agrees after every step, through a preempt-and-restore
    cycle; both engines feed zero vision embeddings."""
    rcfg, cfg = ref_smoke_config(ARCH), get_smoke_config(ARCH)
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
        if step == 3:       # interactive arrivals on a full instance
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
    assert not (ref.waiting or ref.n_active)
    for a, b in pairs:
        assert b.state == RequestState.FINISHED
        assert a.tokens_generated == b.tokens_generated
