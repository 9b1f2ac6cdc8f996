"""The port's MoE arm (``models/moe.py`` and the ``moe`` arm of the
transformer) against ``repro.models.moe`` / ``repro.models`` with the
reference's parameters carried over by ``params.from_reference``, on the
same numpy inputs, float32 on the CPU unless a test says otherwise:
routing and capacity drops exactly, outputs and auxiliary losses to a
stated tolerance, the model's entry points, and the serving engine token
for token with the reference engine, its knobs included."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.serving.request as port_request
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro.models import moe as ref_moe
from repro.serving import request as ref_request
from repro.serving.engine import Engine as RefEngine
from repro_torch import params as port_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import Model, moe
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import RequestState

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

ARCHS = ["qwen2-moe-a2.7b", "deepseek-moe-16b"]
# float32, the same products in another order of sums: an MoE output within
# 1e-5 of its own scale (its largest magnitude, ~100 at the smoke widths,
# where a float32 ulp is ~1e-5), the auxiliary loss within 1e-6
Y_TOL = 1e-5
AUX_TOL = 1e-6
LOGIT_TOL = 2e-4         # logits of a whole model, as tests/test_torch_model.py
DECODE_TOL = 5e-3        # the reference's own prefill-vs-decode tolerance


def _with_capacity(cfg, factor):
    return cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


def _pair(arch, seed=0, factor=None):
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    if factor is not None:
        rcfg, cfg = _with_capacity(rcfg, factor), _with_capacity(cfg, factor)
    ref_model = RefModel(rcfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    params = port_params.from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                                        device="cpu", dtype=torch.float32)
    return rcfg, cfg, ref_model, ref_params, params


def _layer0(ref_params, params):
    """Layer 0's MoE parameters, the reference's and the port's."""
    return (jax.tree.map(lambda a: a[0], ref_params["layers"]["moe"]),
            {k: (v[0] if not isinstance(v, dict) else {n: w[0] for n, w in v.items()})
             for k, v in params["layers"]["moe"].items()})


def _assert_scaled_close(got, want, tol=Y_TOL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _reference_top_k(monkeypatch):
    """Records the (gate, idx) of every ``jax.lax.top_k`` the reference
    calls while the test runs: its own routing, read off its own code."""
    seen = []
    real = jax.lax.top_k

    def top_k(x, k):
        out = real(x, k)
        seen.append(tuple(np.asarray(o) for o in out))
        return out

    monkeypatch.setattr(jax.lax, "top_k", top_k)
    return seen


def _dispatch_of(idx: np.ndarray, E: int, C: int):
    """dest and keep of the reference's rank rule (``moe.py:66-69``) in numpy:
    an assignment's rank inside its expert over the token-major order."""
    flat = idx.reshape(idx.shape[0], -1) if idx.ndim == 3 else idx.reshape(1, -1)
    dest = np.empty_like(flat)
    keep = np.empty(flat.shape, bool)
    for row in range(flat.shape[0]):
        count = np.zeros(E, np.int64)
        for j, e in enumerate(flat[row]):
            keep[row, j] = count[e] < C
            dest[row, j] = e * C + count[e] if keep[row, j] else E * C
            count[e] += 1
    return dest, keep


# ------------------------------------------------------------ the MoE layer


@pytest.mark.parametrize("factor", [8.0, 1.0])
@pytest.mark.parametrize("path", ["flat", "batched"])
def test_moe_layer_matches_reference(monkeypatch, path, factor):
    """The smoke config's no-drop capacity (8.0) and a dropping one (1.0,
    48 tokens over 4 experts, flat or 3 rows of 16): the same top-k indices as the reference's,
    the same destinations and drops, y within 1e-5 and aux within 1e-6."""
    rcfg, cfg, _, ref_params, params = _pair("qwen2-moe-a2.7b", factor=factor)
    rp, p = _layer0(ref_params, params)
    x = np.random.default_rng(0).standard_normal((48, cfg.d_model)).astype(np.float32)
    shape = (48, cfg.d_model) if path == "flat" else (3, 16, cfg.d_model)
    ref_fn = ref_moe.moe_forward if path == "flat" else ref_moe.moe_forward_batched
    fn = moe.moe_forward if path == "flat" else moe.moe_forward_batched
    seen = _reference_top_k(monkeypatch)
    want_y, want_aux = ref_fn(rcfg, rp, jnp.asarray(x.reshape(shape)))
    got_y, got_aux = fn(cfg, p, torch.from_numpy(x.reshape(shape)))

    (_, ref_idx), = seen
    xt = torch.from_numpy(x.reshape(shape))
    router = p["router"] if path == "flat" else p["router"].to(xt.dtype)
    _, _, idx = moe._route(cfg, xt.float() @ router)
    assert idx.numpy().tolist() == ref_idx.tolist()
    E, S = cfg.moe.n_experts, shape[-2]
    C = moe.expert_capacity(cfg, S)
    assert C == ref_moe.expert_capacity(rcfg, S)
    dest, keep = moe._dispatch(idx.reshape(-1 if path == "flat" else (3, -1)), E, C)
    want_dest, want_keep = _dispatch_of(ref_idx, E, C)
    assert dest.reshape(want_dest.shape).numpy().tolist() == want_dest.tolist()
    assert keep.reshape(want_keep.shape).numpy().tolist() == want_keep.tolist()
    assert bool(want_keep.all()) == (factor == 8.0)       # 1.0 drops, 8.0 does not
    _assert_scaled_close(got_y.numpy(), np.asarray(want_y))
    assert abs(float(got_aux) - float(want_aux)) <= AUX_TOL


def test_top_k_breaks_ties_as_lax_top_k():
    """Equal probabilities: the lower expert index first, as ``lax.top_k``."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1],
                      [0.0, 0.5, 0.0, 0.5],
                      [0.2, 0.2, 0.3, 0.3]], np.float32)
    probs = np.concatenate([probs, probs[::-1]], axis=0)
    for k in (1, 2, 3):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = moe._top_k(torch.from_numpy(probs), k)
        assert got_i.numpy().tolist() == np.asarray(want_i).tolist()
        assert got_v.numpy().tolist() == np.asarray(want_v).tolist()


@pytest.mark.parametrize("path", ["flat", "batched"])
def test_bf16_router_routes_as_reference(monkeypatch, path):
    """bfloat16 activations, each path's own router dtype (float32 for the
    decode step's ``moe_forward``, the activation dtype for
    ``moe_forward_batched``): the same expert indices as the reference in
    bfloat16. Inputs in {-1, 0, 1} and router entries of k/8 make every
    product and sum exact in bfloat16, so no framework's rounding decides
    the routing; equal logits are ties, broken as ``lax.top_k`` breaks
    them."""
    rcfg, cfg, _, ref_params, params = _pair("deepseek-moe-16b", factor=1.0)
    rp, p = _layer0(ref_params, params)
    rng = np.random.default_rng(1)
    router = rng.integers(-2, 3, (cfg.d_model, cfg.moe.n_experts)).astype(np.float32) / 8
    rp = {k: jax.tree.map(lambda a: a.astype(jnp.bfloat16), v)
          for k, v in rp.items() if k != "router"}
    rp["router"] = jnp.asarray(router)
    p = {k: ({n: w.to(torch.bfloat16) for n, w in v.items()} if isinstance(v, dict)
             else v.to(torch.bfloat16)) for k, v in p.items() if k != "router"}
    p["router"] = torch.from_numpy(router)
    x = rng.integers(-1, 2, (40, cfg.d_model)).astype(np.float32)
    x[:4] = x[4]                        # identical tokens: identical logits
    shape = (40, cfg.d_model) if path == "flat" else (2, 20, cfg.d_model)
    seen = _reference_top_k(monkeypatch)
    xr = jnp.asarray(x.reshape(shape), jnp.bfloat16)
    xt = torch.from_numpy(x.reshape(shape)).to(torch.bfloat16)
    if path == "flat":
        ref_moe.moe_forward(rcfg, rp, xr)
        logits = xt.float() @ p["router"]
    else:
        ref_moe.moe_forward_batched(rcfg, rp, xr)
        logits = (xt @ p["router"].to(xt.dtype)).float()
    (_, ref_idx), = seen
    _, _, idx = moe._route(cfg, logits)
    assert idx.numpy().tolist() == ref_idx.tolist()
    y, _ = (moe.moe_forward if path == "flat" else moe.moe_forward_batched)(cfg, p, xt)
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y.float()).all())


def test_init_keeps_the_router_float32_and_the_reference_layout():
    """A bf16 model keeps its router in float32; names and shapes are the
    reference's, so its parameters load one to one."""
    rcfg, cfg, _, ref_params, _ = _pair("deepseek-moe-16b")
    model = Model(cfg)
    bf = model.init(torch.Generator().manual_seed(0), dtype=torch.bfloat16, device="cpu")
    assert bf["layers"]["moe"]["router"].dtype == torch.float32
    assert bf["layers"]["moe"]["w_gate"].dtype == torch.bfloat16

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert shapes(bf) == jax.tree.map(lambda a: tuple(a.shape), ref_params)
    carried = port_params.from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                                         device="cpu", dtype=torch.bfloat16)
    assert carried["layers"]["moe"]["router"].dtype == torch.float32
    bad = jax.tree.map(np.asarray, ref_params)
    bad["layers"]["moe"]["w_gate"] = bad["layers"]["moe"]["w_gate"][:, :2]
    with pytest.raises(ValueError, match="w_gate"):
        port_params.from_reference(bad, cfg, device="cpu")


def test_full_configs_build_and_count_their_parameters():
    """Full width, as the issue's numbers: 14.32 B and 16.88 B parameters."""
    for arch, n in (("qwen2-moe-a2.7b", 14.32e9), ("deepseek-moe-16b", 16.88e9)):
        cfg = get_config(arch)
        Model(cfg)
        assert abs(cfg.param_count() / n - 1) < 1e-3
        assert cfg.resolved_head_dim == 128


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss(arch):
    rcfg, cfg, ref_model, ref_params, params = _pair(arch, seed=1)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    want, want_aux = ref_model.forward(ref_params, {"tokens": jnp.asarray(toks)})
    model = Model(cfg)
    batch = {"tokens": torch.from_numpy(toks).long()}
    got, aux = model.forward(params, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert float(aux) > 0 and abs(float(aux) - float(want_aux)) <= AUX_TOL
    ref_loss = ref_model.loss(ref_params, {"tokens": jnp.asarray(toks)})
    assert abs(float(model.loss(params, batch)) - float(ref_loss)) <= LOGIT_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_three_decode_steps(arch):
    rcfg, cfg, ref_model, ref_params, params = _pair(arch)
    model = Model(cfg)
    B, S, cap = 2, 21, 40
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    want, rcache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                                     cache_len=cap, dtype=jnp.float32)
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(toks).long()},
                               cache_len=cap, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    tok = np.array(jnp.argmax(want, -1), np.int32)
    for step in range(3):
        want, rcache = ref_model.decode_step(ref_params, jnp.asarray(tok)[:, None], rcache)
        got, cache = model.decode_step(params, torch.from_numpy(tok).long()[:, None],
                                       cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DECODE_TOL,
                                   rtol=DECODE_TOL)
        assert cache["pos"].tolist() == [S + step + 1] * B
        assert got.argmax(-1).tolist() == np.asarray(jnp.argmax(want, -1)).tolist()
        tok = np.array(jnp.argmax(want, -1), np.int32)


def test_sixteen_slot_decode_with_drops_matches_reference(monkeypatch):
    """16 rows, every one active, at capacity factor 1.0: 32 assignments over
    4 experts of capacity 8, so the decode step drops some; the logits of
    three steps within 1e-5 of the reference's (the same drops: a different
    one moves a row's logits by far more)."""
    kept = []
    dispatch = moe._dispatch

    def recorded(*args):
        dest, keep = dispatch(*args)
        kept.append(bool(keep.all()))
        return dest, keep

    monkeypatch.setattr(moe, "_dispatch", recorded)
    rcfg, cfg, ref_model, ref_params, params = _pair("qwen2-moe-a2.7b", seed=2,
                                                      factor=1.0)
    model = Model(cfg)
    B, S, cap = 16, 9, 16
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    _, rcache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                                  cache_len=cap, dtype=jnp.float32)
    cache = port_params.cache_from_reference(jax.tree.map(np.asarray, rcache), cfg,
                                             device="cpu", dtype=torch.float32)
    assert moe.expert_capacity(cfg, B) == 8
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
        want, rcache = ref_model.decode_step(ref_params, jnp.asarray(tok)[:, None], rcache)
        got, cache = model.decode_step(params, torch.from_numpy(tok).long()[:, None],
                                       cache, torch.ones(B, dtype=torch.bool))
        _assert_scaled_close(got.numpy(), np.asarray(want))
    assert len(kept) == 3 * cfg.n_layers and not all(kept)   # some layer dropped


def test_sixteen_slot_decode_drops_in_the_layer():
    """The layer itself at the decode step's shape: 16 flat tokens, capacity
    8 per expert, drops taken exactly where the reference takes them."""
    rcfg, cfg, _, ref_params, params = _pair("qwen2-moe-a2.7b", seed=5, factor=1.0)
    rp, p = _layer0(ref_params, params)
    x = np.random.default_rng(5).standard_normal((16, cfg.d_model)).astype(np.float32)
    want, _ = ref_moe.moe_forward(rcfg, rp, jnp.asarray(x))
    got, _ = moe.moe_forward(cfg, p, torch.from_numpy(x), torch.ones(16, dtype=torch.bool))
    _, _, idx = moe._route(cfg, torch.from_numpy(x) @ p["router"])
    _, keep = moe._dispatch(idx.reshape(-1), 4, 8)
    assert not bool(keep.all())
    _assert_scaled_close(got.numpy(), np.asarray(want))


def test_inactive_rows_take_no_capacity_and_do_not_move_active_rows():
    """At capacity factor 1.0 with 16 rows: whatever tokens the inactive
    rows hold, the active rows' logits stay the same, and their ``pos``
    stays put."""
    rcfg, cfg, _, _, params = _pair("qwen2-moe-a2.7b", seed=3, factor=1.0)
    model = Model(cfg)
    B = 16
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 7))).long()
    _, cache = model.prefill(params, {"tokens": toks}, cache_len=16, dtype=torch.float32)
    active = torch.tensor([i % 3 != 1 for i in range(B)])
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1))).long()
    outs = []
    for filler in (0, 1, 2):
        c = {k: v.clone() for k, v in cache.items()}
        t = torch.where(active[:, None], nxt,
                        torch.from_numpy(np.random.default_rng(filler).integers(
                            0, cfg.vocab_size, (B, 1))).long())
        logits, c = model.decode_step(params, t, c, active)
        outs.append(logits[active])
        assert c["pos"].tolist() == [8 if a else 7 for a in active.tolist()]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.parametrize("chunk", [7, 16])
def test_chunked_prefill_equals_one_shot(chunk):
    """As ``tests/test_chunked_prefill.py`` for qwen2-moe: prefill in pieces
    through ``past_cache`` (each chunk dispatched alone, with the capacity of
    its length) gives the one-shot logits and cache, and the chunked path's
    logits are the reference's chunked ones."""
    rcfg, cfg, ref_model, ref_params, params = _pair("qwen2-moe-a2.7b", seed=4)
    model = Model(cfg)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    one_logits, one = model.prefill(params, {"tokens": tt}, dtype=torch.float32)
    past = rpast = None
    for lo in range(0, 48, chunk):
        logits, past = model.prefill(params, {"tokens": tt[:, lo:lo + chunk]},
                                     dtype=torch.float32, past_cache=past)
        want, rpast = ref_model.prefill(ref_params,
                                        {"tokens": jnp.asarray(toks[:, lo:lo + chunk])},
                                        dtype=jnp.float32, past_cache=rpast)
    # the reference's own chunked-vs-one-shot tolerance
    np.testing.assert_allclose(logits.numpy(), one_logits.numpy(), atol=3e-3, rtol=3e-3)
    np.testing.assert_allclose(past["k"].numpy(), one["k"].numpy(), atol=3e-3, rtol=3e-3)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert past["pos"].tolist() == [48, 48]


# ------------------------------------------------------------ the engine


def _engines(arch, factor=None, max_slots=3, **knobs):
    rcfg, cfg, _, ref_params, params = _pair(arch, factor=factor)
    ref = RefEngine(rcfg, params=ref_params, max_slots=max_slots, max_len=96,
                    dtype=jnp.float32, **knobs)
    eng = Engine(cfg, params=params, max_slots=max_slots, max_len=96,
                 dtype=torch.float32, device="cpu", **knobs)
    return ref, eng


def _serve_pair(ref, eng, prompts, out_len=lambda i: 10 + 3 * i, arrive_at=3):
    """Serve both engines the same prompts (the first three as batch
    requests, the rest interactive arrivals at step ``arrive_at``); every
    slot's next token agrees after every step. Returns the preemptions."""
    def requests(mod):
        out = []
        for i, toks in enumerate(prompts):
            r = (mod.make_batch if i < 3 else mod.make_interactive)(len(toks), out_len(i))
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
        if step == arrive_at:
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
        assert sa.n_active == sb.n_active and sa.new_tokens == sb.new_tokens
    assert not (ref.waiting or ref.n_active)
    for a, b in pairs:
        assert b.state == RequestState.FINISHED
        assert a.tokens_generated == b.tokens_generated
    return preemptions


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_token_for_token_with_reference_engine(arch):
    """Greedy, float32, through a preempt-and-restore cycle."""
    ref, eng = _engines(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, eng.cfg.vocab_size, size=(n,), dtype=np.int32)
               for n in (9, 23, 17, 30, 5)]
    assert _serve_pair(ref, eng, prompts) >= 1


@pytest.mark.parametrize("knobs", [dict(prefill_chunk=8),
                                   dict(prefix_cache_entries=8),
                                   dict(prefill_chunk=8, prefix_cache_entries=8)])
def test_engine_knobs_token_for_token_with_reference_engine(knobs):
    """The prefix cache and chunked prefill of ``serving/engine.py`` on the
    moe family, against the reference engine with the same knobs: prompts
    sharing 20 tokens, served one after another; the same tokens and the
    same hit counts."""
    ref, eng = _engines("qwen2-moe-a2.7b", max_slots=2, **knobs)
    rng = np.random.default_rng(8)
    shared = rng.integers(0, eng.cfg.vocab_size, 20).astype(np.int32)
    for n in (5, 17, 3):
        toks = np.concatenate([shared, rng.integers(0, eng.cfg.vocab_size, n)
                               .astype(np.int32)])
        _serve_pair(ref, eng, [toks], out_len=lambda i: 6)
    if "prefix_cache_entries" in knobs:
        pc, rpc = eng.prefix_cache, ref.prefix_cache
        assert pc.hits == 2
        assert (pc.hits, pc.misses, pc.hit_tokens) == (rpc.hits, rpc.misses,
                                                       rpc.hit_tokens)
