"""The port's zamba2 hybrid (``models/hybrid.py``) against
``repro.models.hybrid`` with the reference's parameters carried over by
``params.from_reference``, on the same numpy inputs, float32 on the CPU:
forward and loss, prefill and decode steps, a reference cache carried over
(a windowed ring too, decoded past the window), the slot protocol, free
rows, and the serving engine token for token with the reference engine.
The smoke config runs at its own head_dim (32) and at zamba2's 80, the
width both attention kernels take for it on the card."""
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
from repro_torch import params as port_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import Model, hybrid
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import RequestState

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

ARCH = "zamba2-2.7b"
HEAD_DIMS = [0, 80]       # 0: the smoke config's own, d_model / n_heads = 32
LOGIT_TOL = 2e-4          # float32, other orders of sums (tests/test_torch_ssm.py)
DECODE_TOL = 5e-3         # the reference's own prefill-vs-decode tolerance


def _pair(head_dim=0, window=0, seed=0):
    rcfg = ref_smoke_config(ARCH).with_(head_dim=head_dim, sliding_window=window)
    cfg = get_smoke_config(ARCH).with_(head_dim=head_dim, sliding_window=window)
    ref_model = RefModel(rcfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    params = port_params.from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                                        device="cpu", dtype=torch.float32)
    return ref_model, ref_params, Model(cfg), params


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_full_config_widths():
    """zamba2-2.7b at full width: 54 Mamba2 layers, 9 calls of the shared
    block, head_dim 80, SSM N 64 / P 64, 2.42 B parameters."""
    cfg = get_config(ARCH)
    Model(cfg)
    assert hybrid._n_groups(cfg) == 9 and cfg.resolved_head_dim == 80
    assert (cfg.ssm.state_dim, cfg.ssm.head_dim, cfg.n_ssm_heads) == (64, 64, 80)
    assert abs(cfg.param_count() / 2.42e9 - 1) < 5e-3


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_forward_and_loss(head_dim):
    ref_model, ref_params, model, params = _pair(head_dim, seed=1)
    toks = _tokens(model.cfg.vocab_size, (2, 37), 1)
    want, _ = ref_model.forward(ref_params, {"tokens": jnp.asarray(toks)})
    batch = {"tokens": torch.from_numpy(toks).long()}
    got, aux = model.forward(params, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert float(aux) == 0.0
    want_loss = ref_model.loss(ref_params, {"tokens": jnp.asarray(toks)})
    assert abs(float(model.loss(params, batch)) - float(want_loss)) <= LOGIT_TOL


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_prefill_and_three_decode_steps(head_dim):
    """Prefill 45 tokens (two SSD chunks of 32) into pools of 60 positions,
    then three greedy decode steps; the SSM state agrees at the end."""
    ref_model, ref_params, model, params = _pair(head_dim)
    B, S, cap = 2, 45, 60
    toks = _tokens(model.cfg.vocab_size, (B, S), 0)
    want, rcache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                                     cache_len=cap, dtype=jnp.float32)
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(toks).long()},
                               cache_len=cap, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    G = hybrid._n_groups(model.cfg)
    assert cache["k"].shape[0] == G and cache["ssm"].shape[0] == model.cfg.n_layers
    tok = np.array(jnp.argmax(want, -1), np.int32)
    for step in range(3):
        want, rcache = ref_model.decode_step(ref_params, jnp.asarray(tok)[:, None], rcache)
        got, cache = model.decode_step(params, torch.from_numpy(tok).long()[:, None],
                                       cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DECODE_TOL,
                                   rtol=DECODE_TOL)
        assert got.argmax(-1).tolist() == np.asarray(jnp.argmax(want, -1)).tolist()
        assert cache["pos"].tolist() == [S + step + 1] * B
        tok = np.array(jnp.argmax(want, -1), np.int32)
    np.testing.assert_allclose(cache["ssm"].numpy(), np.asarray(rcache["ssm"]),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_cache_from_reference_continues_decoding(head_dim):
    """A reference decode cache (SSM and conv states, one K/V cache per
    shared-block call) carried over decodes on as the reference's."""
    ref_model, ref_params, model, params = _pair(head_dim, seed=2)
    toks = _tokens(model.cfg.vocab_size, (2, 9), 2)
    logits, rcache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                                       cache_len=24, dtype=jnp.float32)
    cache = port_params.cache_from_reference(jax.tree.map(np.asarray, rcache), model.cfg,
                                             device="cpu", dtype=torch.float32)
    assert cache["ssm"].dtype == torch.float32 and cache["pos"].tolist() == [9, 9]
    tok = np.array(jnp.argmax(logits, -1), np.int32)
    for _ in range(2):
        want, rcache = ref_model.decode_step(ref_params, jnp.asarray(tok)[:, None], rcache)
        got, cache = model.decode_step(params, torch.from_numpy(tok).long()[:, None],
                                       cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DECODE_TOL,
                                   rtol=DECODE_TOL)
        tok = np.array(jnp.argmax(want, -1), np.int32)


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_windowed_prefill_and_decode_past_the_window(head_dim):
    """A window of 8 under a 20-token prompt: the windowed forward is the
    reference's; the reference's prefill keeps a ring of 8 slots per
    shared-block call, which ``cache_from_reference`` unrolls by its
    ``slot_pos``; eight decode steps past the window agree with the
    reference's ring, each within the prefill-vs-decode tolerance."""
    window, prompt, steps = 8, 20, 8
    ref_model, ref_params, model, params = _pair(head_dim, window, seed=3)
    toks = _tokens(model.cfg.vocab_size, (2, prompt + steps), 3)
    want, _ = ref_model.forward(ref_params, {"tokens": jnp.asarray(toks)})
    got, _ = model.forward(params, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    _, rcache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks[:, :prompt])},
                                  dtype=jnp.float32)
    assert rcache["k"].shape[2] == window
    cache = port_params.cache_from_reference(jax.tree.map(np.asarray, rcache), model.cfg,
                                             device="cpu", dtype=torch.float32)
    for i in range(steps):
        t = toks[:, prompt + i:prompt + i + 1]
        want, rcache = ref_model.decode_step(ref_params, jnp.asarray(t), rcache)
        got, cache = model.decode_step(params, torch.from_numpy(t.copy()).long(), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DECODE_TOL,
                                   rtol=DECODE_TOL)


def test_free_rows_update_their_state_and_write_no_kv():
    """An inactive row keeps its ``pos`` and its pages, its SSM and conv
    states advance as an active row's would (as the reference engine's free
    slots do), and the active rows' logits are those of a batch without
    it."""
    _, _, model, params = _pair(80, seed=4)
    toks = torch.from_numpy(_tokens(model.cfg.vocab_size, (3, 11), 4)).long()
    _, cache = model.prefill(params, {"tokens": toks}, cache_len=32, dtype=torch.float32)
    _, every = model.prefill(params, {"tokens": toks}, cache_len=32, dtype=torch.float32)
    _, solo = model.prefill(params, {"tokens": toks[[0, 2]]}, cache_len=32,
                            dtype=torch.float32)
    kv_before = {k: cache[k].clone() for k in ("k", "v")}
    nxt = torch.tensor([[5], [6], [7]])
    got, cache = model.decode_step(params, nxt, cache, torch.tensor([True, False, True]))
    _, every = model.decode_step(params, nxt, every)
    want, _ = model.decode_step(params, nxt[[0, 2]], solo)
    assert cache["pos"].tolist() == [12, 11, 12]
    np.testing.assert_allclose(got[[0, 2]].numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    assert torch.equal(cache["ssm"], every["ssm"]) and torch.equal(cache["conv"],
                                                                   every["conv"])
    pages = cache["block_tables"][1].long()
    for key in ("k", "v"):
        assert torch.equal(cache[key][:, pages], kv_before[key][:, pages])


def test_slot_read_and_write_round_trip():
    """A slot read to the host and written into another slot decodes on as
    the original; the read is a copy."""
    _, _, model, params = _pair(seed=5)
    toks = torch.from_numpy(_tokens(model.cfg.vocab_size, (1, 13), 5)).long()
    pool = model.init_cache(3, 40, dtype=torch.float32, device="cpu")
    _, sub = model.prefill(params, {"tokens": toks}, dtype=torch.float32)
    model.write_slot(pool, 0, sub)
    pool["pos"][0] = 13
    saved = model.read_slot(pool, 0, 13)
    model.write_slot(pool, 2, saved)
    pool["pos"][2] = 13
    pool["ssm"][:, 0].mul_(1.0)            # the pool row is not the saved copy
    assert saved["ssm"].data_ptr() != pool["ssm"].data_ptr()
    nxt = torch.tensor([[3], [0], [3]])
    logits, _ = model.decode_step(params, nxt, pool, torch.tensor([True, False, True]))
    np.testing.assert_allclose(logits[0].numpy(), logits[2].numpy(), atol=1e-6, rtol=1e-6)


def test_chunked_prefill_is_refused():
    _, _, model, params = _pair()
    toks = torch.zeros((1, 6), dtype=torch.long)
    _, past = model.prefill(params, {"tokens": toks}, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="chunked"):
        model.prefill(params, {"tokens": toks}, dtype=torch.float32, past_cache=past)


def test_init_params_layout_and_dtypes():
    """The reference's names and shapes; ``A_log``, ``D`` and ``dt_bias``
    stay float32 in a bfloat16 model."""
    ref_model, ref_params, model, _ = _pair(80)
    bf = model.init(torch.Generator().manual_seed(0), dtype=torch.bfloat16, device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert shapes(bf) == jax.tree.map(lambda a: tuple(a.shape), ref_params)
    assert bf["layers"]["A_log"].dtype == torch.float32
    assert bf["shared"]["attn"]["wq"].dtype == torch.bfloat16


# the first prompt spans three SSD chunks of 32, the last is shorter than the
# conv window
PROMPT_LENS = (9, 70, 17, 30, 2)


@pytest.mark.parametrize("head_dim,window", [(0, 0), (80, 0), (0, 8)])
def test_engine_token_for_token_with_reference_engine(head_dim, window):
    """Same parameters and prompts, float32: every slot's next input token
    agrees with the reference engine's after every step, through a
    preempt-and-restore cycle; with a window of 8 the reference's prefill
    keeps a ring of 8 slots and the port every position."""
    rcfg = ref_smoke_config(ARCH).with_(head_dim=head_dim, sliding_window=window)
    cfg = get_smoke_config(ARCH).with_(head_dim=head_dim, sliding_window=window)
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
            ref.submit(va)
            eng.submit(vb)
        assert [s.token for s in eng.slots] == \
            [None if s.token is None else int(s.token[0]) for s in ref.slots], f"step {step}"
    assert preemptions >= 1
    for a, b in pairs:
        assert b.state == RequestState.FINISHED
        assert a.tokens_generated == b.tokens_generated
