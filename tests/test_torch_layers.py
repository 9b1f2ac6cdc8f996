"""The port's layer functions against ``repro.models.layers`` on the same
numpy inputs and parameters (float32 on the CPU; attention goes through the
kernels' plain versions)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import layers as ref_layers
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

# float32 on both sides: only the order of the sums differs
TOL = dict(atol=2e-4, rtol=2e-4)


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _attn_params(rng, cfg):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    return {n: (rng.standard_normal(s, dtype=np.float32) /
                np.sqrt(s[0])).astype(np.float32) for n, s in shapes.items()}


@pytest.mark.parametrize("with_weight", [True, False])
def test_rms_norm(with_weight):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 128), dtype=np.float32) * 3.0
    w = rng.standard_normal((128,), dtype=np.float32) if with_weight else None
    got = layers.rms_norm(torch.from_numpy(x), None if w is None else torch.from_numpy(w))
    want = ref_layers.rms_norm(jnp.asarray(x), None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparametric"])
def test_apply_norm(norm):
    rng = np.random.default_rng(1)
    cfg = get_smoke_config("llama-8b").with_(norm=norm)
    rcfg = ref_smoke_config("llama-8b").with_(norm=norm)
    x = rng.standard_normal((2, 3, cfg.d_model), dtype=np.float32)
    p = {"w": rng.standard_normal((cfg.d_model,), dtype=np.float32),
         "b": rng.standard_normal((cfg.d_model,), dtype=np.float32)}
    got = layers.apply_norm(cfg, _t(p), torch.from_numpy(x))
    want = ref_layers.apply_norm(rcfg, _j(p), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert set(layers.init_norm(cfg, torch.float32, "cpu")) == \
        set(ref_layers.init_norm(rcfg, None, jnp.float32))


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 64), dtype=np.float32)
    pos = rng.integers(0, 900, (2, 7))
    cos, sin = layers.rope_angles(torch.from_numpy(pos), 64, theta)
    rcos, rsin = ref_layers.rope_angles(jnp.asarray(pos), 64, theta)
    np.testing.assert_allclose(cos.numpy(), np.asarray(rcos), atol=1e-4)
    got = layers.apply_rope(torch.from_numpy(x), cos, sin)
    want = ref_layers.apply_rope(jnp.asarray(x), rcos, rsin)
    # angles reach ~900 rad: float32 cos/sin of the two libraries differ in
    # the last bits there
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("arch", ["llama-8b", "granite-8b"])
@pytest.mark.parametrize("S", [1, 24, 70])
def test_attention_forward(arch, S):
    rng = np.random.default_rng(3)
    cfg, rcfg = get_smoke_config(arch), ref_smoke_config(arch)
    p = _attn_params(rng, cfg)
    x = rng.standard_normal((2, S, cfg.d_model), dtype=np.float32)
    got, k, v = layers.attention_forward(cfg, _t(p), torch.from_numpy(x),
                                         return_kv=True)
    want, rk, rv = ref_layers.attention_forward(rcfg, _j(p), jnp.asarray(x),
                                                return_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(rk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), **TOL)


def test_attention_forward_past_kv():
    """A prefix that is already cached: queries at positions P.. see it."""
    rng = np.random.default_rng(4)
    cfg, rcfg = get_smoke_config("llama-8b"), ref_smoke_config("llama-8b")
    p = _attn_params(rng, cfg)
    P, S, hd = 19, 13, cfg.resolved_head_dim
    x = rng.standard_normal((2, S, cfg.d_model), dtype=np.float32)
    pk = rng.standard_normal((2, P, cfg.n_kv_heads, hd), dtype=np.float32)
    pv = rng.standard_normal((2, P, cfg.n_kv_heads, hd), dtype=np.float32)
    got, k, _ = layers.attention_forward(
        cfg, _t(p), torch.from_numpy(x), return_kv=True,
        past_kv=(torch.from_numpy(pk), torch.from_numpy(pv)))
    want, rk, _ = ref_layers.attention_forward(
        rcfg, _j(p), jnp.asarray(x), return_kv=True,
        past_kv=(jnp.asarray(pk), jnp.asarray(pv)))
    assert k.shape == (2, S, cfg.n_kv_heads, hd)      # new tokens only
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(rk), **TOL)


def test_attention_decode_paged_pool_vs_dense_cache():
    """Three decode steps: the port writes K/V into its page pool in place
    and attends through paged attention; the reference updates a dense
    cache. Same output, and the same K/V end up stored."""
    rng = np.random.default_rng(5)
    cfg, rcfg = get_smoke_config("llama-8b"), ref_smoke_config("llama-8b")
    p = _attn_params(rng, cfg)
    B, cap, hd, Hkv = 3, 48, cfg.resolved_head_dim, cfg.n_kv_heads
    pos0 = np.asarray([5, 17, 30])
    kd = np.zeros((B, cap, Hkv, hd), np.float32)
    vd = np.zeros((B, cap, Hkv, hd), np.float32)
    for b in range(B):
        kd[b, :pos0[b]] = rng.standard_normal((pos0[b], Hkv, hd))
        vd[b, :pos0[b]] = rng.standard_normal((pos0[b], Hkv, hd))
    cache = layers.init_kv_cache(cfg, B, cap, 1, torch.float32, "cpu")
    k_pool, v_pool, bt = cache["k"][0], cache["v"][0], cache["block_tables"]
    k_pool.view(B, cap, Hkv, hd)[:] = torch.from_numpy(kd)
    v_pool.view(B, cap, Hkv, hd)[:] = torch.from_numpy(vd)

    rk, rv = jnp.asarray(kd), jnp.asarray(vd)
    slot_pos = np.where(np.arange(cap)[None] < pos0[:, None],
                        np.arange(cap)[None], -1).astype(np.int32)
    for step in range(3):
        pos = pos0 + step
        x = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
        slot_pos[np.arange(B), pos] = pos
        want, rk, rv = ref_layers.attention_decode(
            rcfg, _j(p), jnp.asarray(x), rk, rv, jnp.asarray(pos, jnp.int32),
            jnp.asarray(slot_pos))
        got = layers.attention_decode(cfg, _t(p), torch.from_numpy(x), k_pool,
                                      v_pool, bt, torch.from_numpy(pos).int())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(k_pool.view(B, cap, Hkv, hd).numpy(),
                               np.asarray(rk), **TOL)
    np.testing.assert_allclose(v_pool.view(B, cap, Hkv, hd).numpy(),
                               np.asarray(rv), **TOL)


def test_attention_decode_inactive_rows_write_nothing():
    rng = np.random.default_rng(6)
    cfg = get_smoke_config("llama-8b")
    p = _t(_attn_params(rng, cfg))
    B, cap = 3, 32
    cache = layers.init_kv_cache(cfg, B, cap, 1, torch.float32, "cpu")
    k_pool, v_pool, bt = cache["k"][0], cache["v"][0], cache["block_tables"]
    k_pool.normal_(generator=torch.Generator().manual_seed(0))
    v_pool.normal_(generator=torch.Generator().manual_seed(1))
    before = k_pool.clone()
    x = torch.from_numpy(rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32))
    pos = torch.tensor([4, 10_000, 9], dtype=torch.int32)   # row 1: stale, out of range
    active = torch.tensor([True, False, True])
    out = layers.attention_decode(cfg, p, x, k_pool, v_pool, bt, pos, active)
    pages = bt.shape[1]
    assert torch.equal(k_pool[pages:2 * pages], before[pages:2 * pages])
    assert torch.count_nonzero(out[1]) == 0                 # length 0 -> zeros
    assert not torch.equal(k_pool[:pages], before[:pages])
    # the active rows do not depend on the inactive one
    k2, v2 = before.clone(), v_pool.clone()
    sel = torch.tensor([0, 2])
    alone = layers.attention_decode(
        cfg, p, x[sel], k2, v2, bt[sel], pos[sel])
    np.testing.assert_allclose(out[sel].numpy(), alone.numpy(), atol=1e-6)


@pytest.mark.parametrize("ffn", ["swiglu", "gelu"])
def test_ffn_forward(ffn):
    rng = np.random.default_rng(7)
    cfg = get_smoke_config("llama-8b").with_(ffn=ffn)
    rcfg = ref_smoke_config("llama-8b").with_(ffn=ffn)
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": rng.standard_normal((d, f), dtype=np.float32) * d ** -0.5,
         "w_down": rng.standard_normal((f, d), dtype=np.float32) * f ** -0.5}
    if ffn == "swiglu":
        p["w_gate"] = rng.standard_normal((d, f), dtype=np.float32) * d ** -0.5
    p = {n: w.astype(np.float32) for n, w in p.items()}
    x = rng.standard_normal((2, 6, d), dtype=np.float32)
    got = layers.ffn_forward(cfg, _t(p), torch.from_numpy(x))
    want = ref_layers.ffn_forward(rcfg, _j(p), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    gen = torch.Generator().manual_seed(0)
    assert set(layers.init_ffn(cfg, gen, torch.float32, "cpu")) == set(p)


def test_embed_unembed_tied_and_untied():
    rng = np.random.default_rng(8)
    tok = rng.standard_normal((50, 16), dtype=np.float32)
    head = rng.standard_normal((16, 50), dtype=np.float32)
    ids = rng.integers(0, 50, (2, 5))
    x = rng.standard_normal((2, 5, 16), dtype=np.float32)
    for p in ({"tok": tok, "head": head}, {"tok": tok}):
        np.testing.assert_array_equal(
            layers.embed(_t(p), torch.from_numpy(ids)).numpy(),
            np.asarray(ref_layers.embed(_j(p), jnp.asarray(ids))))
        np.testing.assert_allclose(
            layers.unembed(_t(p), torch.from_numpy(x)).numpy(),
            np.asarray(ref_layers.unembed(_j(p), jnp.asarray(x))), **TOL)
