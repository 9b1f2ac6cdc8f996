"""The port's ssm family against ``repro``: the ``ssd_scan`` kernel's plain
version against the Pallas kernel in interpret mode and the jnp oracles,
the Mamba2 block, and the mamba2-1.3b smoke model, float32 on the CPU on the
same numpy inputs and carried-over parameters. (The CUDA kernel itself is
held against the plain version on the card by ``chip_smoke.py``.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import Model as RefModel
from repro.models import ssm as ref_ssm
from repro_torch import params as port_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd_module
from repro_torch.models import Model, mamba_model, ssm

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

ARCH = "mamba2-1.3b"
# sums over a chunk run in another order on each side (the tolerance of the
# reference's own ssd tests, tests/test_kernels.py)
TOL = dict(atol=2e-3, rtol=2e-3)


def _ssd_inputs(seed, b, s, h, p, n, with_h0=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal((h,)) * 0.5)).astype(np.float32)
    B = rng.standard_normal((b, s, n), dtype=np.float32)
    C = rng.standard_normal((b, s, n), dtype=np.float32)
    h0 = rng.standard_normal((b, h, p, n), dtype=np.float32) if with_h0 else None
    return x, dt, A, B, C, h0


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------- ssd_scan
@pytest.mark.parametrize("b,s,h,p,n,chunk,oracle", [
    (1, 128, 2, 64, 32, 32, "interpret"),     # the Pallas body on the CPU
    (2, 256, 4, 64, 128, 64, "ref"),
    (1, 512, 8, 32, 64, 128, "ref"),
    (1, 100, 2, 32, 16, 32, "ref"),           # ragged: s is no chunk multiple
])
def test_ssd_scan_plain_against_reference(b, s, h, p, n, chunk, oracle):
    inputs = _ssd_inputs(0, b, s, h, p, n)
    y, state = ref.ssd_scan_ref(*_torch(inputs), chunk=chunk)
    assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n)
    assert state.dtype == torch.float32
    if oracle == "interpret":
        want_y, want_h = ref_ops.ssd_scan(*_jax(inputs[:5]), chunk=chunk,
                                          backend="interpret")
    else:
        want_y, want_h = ref_ref.ssd_scan_ref(*_jax(inputs[:5]), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_h), **TOL)


@pytest.mark.parametrize("s", [64, 75])
def test_ssd_scan_plain_with_initial_state(s):
    """``h0`` enters through the inter-chunk term of every chunk."""
    inputs = _ssd_inputs(1, 2, s, 2, 32, 16, with_h0=True)
    y, state = ops.ssd_scan(*_torch(inputs), chunk=32)
    want_y, want_h = ref_ref.ssd_scan_ref(*_jax(inputs), chunk=32)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_h), **TOL)
    if s == 64:   # the Pallas body takes h0 too, at a chunk multiple
        ky, kh = ref_ops.ssd_scan(*_jax(inputs), chunk=32, backend="interpret")
        np.testing.assert_allclose(y.numpy(), np.asarray(ky), **TOL)
        np.testing.assert_allclose(state.numpy(), np.asarray(kh), **TOL)


@pytest.mark.parametrize("s,chunk", [(192, 64), (100, 32)])
def test_ssd_chunked_vs_sequential(s, chunk):
    """The chunked 'dual' form equals the sequential recurrence, and the
    port's sequential recurrence equals the reference's."""
    x, dt, A, B, C, _ = _ssd_inputs(2, 2, s, 3, 32, 16)
    y_c, h_c = ssm.ssd_chunked(*_torch((x, dt, A, B, C)), chunk)
    y_s, h_s = ref.ssd_sequential_ref(*_torch((x, dt, A, B, C)))
    np.testing.assert_allclose(y_c.numpy(), y_s.numpy(), **TOL)
    np.testing.assert_allclose(h_c.numpy(), h_s.numpy(), **TOL)
    want_y, want_h = ref_ref.ssd_sequential_ref(*_jax((x, dt, A, B, C)))
    np.testing.assert_allclose(y_s.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(h_s.numpy(), np.asarray(want_h), **TOL)


def test_ssd_chunked_is_finite_at_the_steepest_decay():
    """A = -16 (the full config's steepest head) and dt near 1: dA_cum falls
    by ~16 a step, so exp(dA_cum_i - dA_cum_j) overflows for i < j unless the
    exponent is masked first; the result must stay finite and match the
    recurrence."""
    x, dt, A, B, C, _ = _ssd_inputs(3, 1, 96, 2, 32, 16)
    dt = np.full_like(dt, 1.0)
    A = np.asarray([-16.0, -1.0], np.float32)
    y, h = ssm.ssd_chunked(*_torch((x, dt, A, B, C)), 32)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    y_s, h_s = ref.ssd_sequential_ref(*_torch((x, dt, A, B, C)))
    np.testing.assert_allclose(y.numpy(), y_s.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), h_s.numpy(), **TOL)


def test_ssd_scan_wrapper_uses_the_plain_version_on_cpu_and_counts_no_launch():
    inputs = _torch(_ssd_inputs(4, 1, 40, 2, 32, 16))
    before = ssd_module.ssd_scan.launches
    got = ops.ssd_scan(*inputs[:5], chunk=32)
    want = ssd_module.ssd_scan_plain(*inputs[:5], 32)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ssd_module.ssd_scan.launches == before
    assert ops.ssd_scan is ssd_module.ssd_scan


def test_kernel_takes_the_strided_views_mamba_forward_passes():
    """At full width the scan's x, B and C are views into one conv output
    (no copies); the kernel's argument checks accept them in bf16, and refuse
    what the kernel does not take."""
    cfg = get_config(ARCH)
    di, N, H, P = cfg.d_inner, cfg.ssm.state_dim, cfg.n_ssm_heads, cfg.ssm.head_dim
    conv_out = torch.zeros((1, 5, di + 2 * N), dtype=torch.bfloat16)
    xs = conv_out[..., :di].reshape(1, 5, H, P)
    B, C = conv_out[..., di:di + N], conv_out[..., di + N:]
    assert xs.data_ptr() == conv_out.data_ptr()      # a view, not a copy
    dt = torch.zeros((1, 5, H))
    A = -torch.ones((H,))
    ssd_module._check(xs, dt, A, B, C, None, cfg.ssm.chunk_size)
    with pytest.raises(TypeError, match="float32"):
        ssd_module._check(xs, dt.bfloat16(), A, B, C, None, 256)
    with pytest.raises(ValueError, match="not taken"):
        ssd_module._check(xs, dt, A, B, C, None, 100)
    transposed = torch.zeros((1, N, 5), dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous last axis"):
        ssd_module._check(xs, dt, A, transposed, C, None, 256)


def _bf16_head_tail(t):
    """``t`` as the bf16 kernel hands it to the tensor cores: a bf16 head
    plus the bf16 rounding of what the head leaves out."""
    head = t.to(torch.bfloat16).float()
    return head + (t - head).to(torch.bfloat16).float()


def _ssd_scan_bf16_kernel_numerics(x, dt, A, B, C, chunk, h0=None):
    """``ssd_scan_plain``'s algorithm chunk by chunk, in float32, with the
    operands that the bf16 tensor-core kernel rounds rounded where it rounds
    them: the weights W of ``W x``, ``fin o B`` of the state update and the
    state that ``C h^T`` reads (each a bf16 head and tail); y is stored in
    bf16. x, B and C are the kernel's bf16 inputs, widened."""
    b, s, h, p = x.shape
    state = torch.zeros((b, h, p, B.shape[-1])) if h0 is None else h0.clone()
    ys = []
    for t0 in range(0, s, chunk):
        xc, dtc = x[:, t0:t0 + chunk], dt[:, t0:t0 + chunk]
        Bc, Cc = B[:, t0:t0 + chunk], C[:, t0:t0 + chunk]
        L = xc.shape[1]
        cum = torch.cumsum(dtc * A, dim=1)                       # (b, L, h)
        total = cum[:, -1]
        causal = (torch.arange(L)[:, None] >= torch.arange(L)[None, :])[None, :, :, None]
        decay = torch.exp(torch.where(causal, cum[:, :, None] - cum[:, None], -torch.inf))
        w = torch.einsum("bin,bjn->bij", Cc, Bc)[..., None] * decay * dtc[:, None]
        y = torch.einsum("bijh,bjhp->bihp", _bf16_head_tail(w), xc)
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bin,bhpn->bihp", Cc, _bf16_head_tail(state))
        fin = torch.exp(total[:, None] - cum) * dtc              # (b, L, h)
        bt = _bf16_head_tail(fin[..., None] * Bc[:, :, None])    # (b, L, h, n)
        state = torch.exp(total)[..., None, None] * state + torch.einsum(
            "bjhn,bjhp->bhpn", bt, xc)
        ys.append(y)
    return torch.cat(ys, dim=1).to(torch.bfloat16), state


@pytest.mark.parametrize("with_h0", [False, True])
def test_bf16_kernel_rounding_points_hold_over_eight_chunks(with_h0):
    """The bf16 kernel's rounding points, run on the CPU at the serving widths
    over eight chunks of carried state, stay within the bf16 tolerance of
    ``chip_smoke.py`` (5e-2) against the reference's float32 oracle on the
    same bf16-valued inputs."""
    x, dt, A, B, C, h0 = _ssd_inputs(6, 1, 2048, 4, 64, 128, with_h0=with_h0)
    x, B, C = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in (x, B, C))
    y, state = _ssd_scan_bf16_kernel_numerics(*_torch((x, dt, A, B, C)), 256,
                                              h0=None if h0 is None else torch.from_numpy(h0))
    want_y, want_h = ref_ref.ssd_scan_ref(*_jax((x, dt, A, B, C, h0)), chunk=256)
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want_y), atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_h), atol=5e-2, rtol=5e-2)


# ---------------------------------------------------------- Mamba2 block
def _ref_layer(seed=0):
    rcfg = ref_smoke_config(ARCH)
    lp = ref_ssm.init_mamba_layer(rcfg, jax.random.PRNGKey(seed), jnp.float32)
    ours = {k: torch.from_numpy(np.array(v)) for k, v in lp.items()}
    return rcfg, get_smoke_config(ARCH), lp, ours


@pytest.mark.parametrize("s,with_state", [(40, False), (70, True), (2, False)])
def test_mamba_forward_matches_reference(s, with_state):
    rcfg, cfg, rlp, lp = _ref_layer()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, s, cfg.d_model), dtype=np.float32)
    ch = cfg.d_inner + 2 * cfg.ssm.state_dim
    h0 = conv0 = None
    if with_state:
        h0 = rng.standard_normal((2, cfg.n_ssm_heads, cfg.ssm.head_dim,
                                  cfg.ssm.state_dim), dtype=np.float32)
        conv0 = rng.standard_normal((2, cfg.ssm.conv_width - 1, ch), dtype=np.float32)
    want = ref_ssm.mamba_forward(rcfg, rlp, jnp.asarray(x), *_jax((h0, conv0)))
    got = ssm.mamba_forward(cfg, lp, torch.from_numpy(x), *_torch((h0, conv0)))
    assert got[2].shape == (2, min(s, cfg.ssm.conv_width - 1), ch)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=2e-4)


def test_mamba_decode_matches_reference_and_updates_the_state_in_place():
    rcfg, cfg, rlp, lp = _ref_layer(seed=1)
    rng = np.random.default_rng(6)
    b, ch = 3, cfg.d_inner + 2 * cfg.ssm.state_dim
    x = rng.standard_normal((b, 1, cfg.d_model), dtype=np.float32)
    h = rng.standard_normal((b, cfg.n_ssm_heads, cfg.ssm.head_dim,
                             cfg.ssm.state_dim), dtype=np.float32)
    conv = rng.standard_normal((b, cfg.ssm.conv_width - 1, ch), dtype=np.float32)
    want = ref_ssm.mamba_decode(rcfg, rlp, *_jax((x, h, conv)))
    pool = torch.from_numpy(h.copy())
    got = ssm.mamba_decode(cfg, lp, torch.from_numpy(x), pool, torch.from_numpy(conv))
    assert got[1] is pool          # the state pool's slice itself, updated
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=2e-4)


# ---------------------------------------------------------- mamba2-1.3b smoke
def _reference_model(seed):
    model = RefModel(ref_smoke_config(ARCH))
    return model, model.init(jax.random.PRNGKey(seed), dtype=jnp.float32)


def _carried_over(ref_params):
    cfg = get_smoke_config(ARCH)
    return cfg, port_params.from_reference(jax.tree.map(np.asarray, ref_params),
                                           cfg, device="cpu", dtype=torch.float32)


def test_smoke_forward_logits():
    ref_model, ref_params = _reference_model(0)
    cfg, params = _carried_over(ref_params)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 45)).astype(np.int32)
    want, _ = ref_model.forward(ref_params, {"tokens": jnp.asarray(toks)})
    got, aux = Model(cfg).forward(params, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    assert float(aux) == 0.0


@pytest.mark.parametrize("S", [45, 2])
def test_smoke_prefill_and_three_decode_steps(S):
    """Logits within 2e-4 through a prefill (two chunks of 32, ragged; or a
    prompt shorter than the conv window) and three decode steps, the cache
    matching the reference's."""
    ref_model, ref_params = _reference_model(1)
    cfg, params = _carried_over(ref_params)
    model = Model(cfg)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    want, rcache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                                     dtype=jnp.float32)
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(toks).long()},
                               dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    for key in ("ssm", "conv"):
        assert cache[key].shape == rcache[key].shape
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(rcache[key]),
                                   atol=2e-4, rtol=2e-4)
    assert cache["pos"].tolist() == [S, S]
    if S < cfg.ssm.conv_width - 1:
        return      # the reference decodes only a full conv window
    tok = np.array(jnp.argmax(want, -1), np.int32)
    for step in range(3):
        want, rcache = ref_model.decode_step(ref_params, jnp.asarray(tok)[:, None],
                                             rcache)
        got, cache = model.decode_step(params, torch.from_numpy(tok).long()[:, None],
                                       cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
        assert cache["pos"].tolist() == [S + step + 1] * 2
        tok = np.array(jnp.argmax(want, -1), np.int32)
    np.testing.assert_allclose(cache["ssm"].numpy(), np.asarray(rcache["ssm"]),
                               atol=2e-4, rtol=2e-4)


def test_cache_from_reference_continues_decoding():
    ref_model, ref_params = _reference_model(2)
    cfg, params = _carried_over(ref_params)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    logits, rcache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                                       dtype=jnp.float32)
    cache = port_params.cache_from_reference(jax.tree.map(np.asarray, rcache), cfg,
                                             device="cpu", dtype=torch.float32)
    assert cache["ssm"].dtype == torch.float32 and cache["pos"].dtype == torch.int32
    tok = np.array(jnp.argmax(logits, -1), np.int32)
    want, _ = ref_model.decode_step(ref_params, jnp.asarray(tok)[:, None], rcache)
    got, _ = Model(cfg).decode_step(params, torch.from_numpy(tok).long()[:, None], cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_decode_step_inactive_rows_keep_pos_and_do_not_disturb_active_rows():
    cfg = get_smoke_config(ARCH)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32,
                        device="cpu")
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (3, 11))).long()
    _, cache = model.prefill(params, {"tokens": toks}, dtype=torch.float32)
    _, solo = model.prefill(params, {"tokens": toks[[0, 2]]}, dtype=torch.float32)
    nxt = torch.tensor([[5], [6], [7]])
    got, cache = model.decode_step(params, nxt, cache, torch.tensor([True, False, True]))
    want, _ = model.decode_step(params, nxt[[0, 2]], solo)
    assert cache["pos"].tolist() == [12, 11, 12]
    np.testing.assert_allclose(got[[0, 2]].numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_slot_write_of_a_short_prompt_fills_the_first_conv_rows():
    """A prompt shorter than ``conv_width - 1`` carries fewer conv rows; they
    go to the slot's first rows and the rest keep what was there, as in the
    reference engine. A read copies."""
    cfg = get_smoke_config(ARCH)
    pool = mamba_model.init_cache(cfg, 2, 64, torch.float32, "cpu")
    pool["conv"].fill_(7.0)
    ch = cfg.d_inner + 2 * cfg.ssm.state_dim
    sub = {"ssm": torch.ones((cfg.n_layers, 1, cfg.n_ssm_heads, cfg.ssm.head_dim,
                              cfg.ssm.state_dim)),
           "conv": torch.full((cfg.n_layers, 1, 2, ch), 3.0),
           "pos": torch.tensor([2], dtype=torch.int32)}
    Model(cfg).write_slot(pool, 1, sub)
    assert (pool["conv"][:, 1, :2] == 3.0).all() and (pool["conv"][:, 1, 2] == 7.0).all()
    assert (pool["conv"][:, 0] == 7.0).all() and (pool["ssm"][:, 1] == 1.0).all()
    saved = Model(cfg).read_slot(pool, 1, 2)
    pool["ssm"].zero_()
    assert (saved["ssm"] == 1.0).all() and saved["pos"].tolist() == [2]


def test_init_params_layout_and_dtypes():
    """Stacked over layers with the reference's names and shapes; A_log, D
    and dt_bias stay float32 in a bfloat16 model, also when carried over."""
    _, ref_params = _reference_model(3)
    cfg = get_smoke_config(ARCH)
    model = Model(cfg)
    a = model.init(torch.Generator().manual_seed(5), dtype=torch.float32, device="cpu")
    b = model.init(torch.Generator().manual_seed(5), dtype=torch.float32, device="cpu")
    ref_shapes = jax.tree.map(lambda x: tuple(x.shape), ref_params)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert shapes(a) == ref_shapes
    assert torch.equal(a["layers"]["w_in"], b["layers"]["w_in"])
    assert not torch.equal(a["layers"]["w_in"][0], a["layers"]["w_in"][1])
    np.testing.assert_allclose(a["layers"]["A_log"].numpy(),
                               np.asarray(ref_params["layers"]["A_log"]), rtol=1e-6)
    bf = model.init(torch.Generator().manual_seed(5), dtype=torch.bfloat16, device="cpu")
    carried = port_params.from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                                         device="cpu", dtype=torch.bfloat16)
    for tree in (bf, carried):
        assert tree["layers"]["w_in"].dtype == torch.bfloat16
        assert all(tree["layers"][k].dtype == torch.float32
                   for k in ("A_log", "D", "dt_bias"))
    with pytest.raises(ValueError, match="w_in"):
        port_params.from_reference(jax.tree.map(np.asarray, ref_params),
                                   cfg.with_(d_model=64), device="cpu")
