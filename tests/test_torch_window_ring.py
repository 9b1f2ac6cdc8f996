"""A sliding window's pool as a ring of pages (``models/layers.py``), against
the reference's ring of slots (``slot = pos % S``, ``fit_cache``), float32
on the CPU, on carried-over parameters and seeded numpy inputs.

The port's pool of a windowed model holds a row's ``ceil(S / 16)`` pages as
a ring: position ``q`` at ring page ``(q // 16) mod P``. A decode step
reads it through a rotated view of ``P + 1`` block-table entries
(``layers.ring_view``), oldest page first, and attends over the last
``min(window, 16 P)`` positions. Here the dense, MoE, hybrid, audio and VLM
smoke configs decode several wraps past a ring of ``S = window`` positions
(the VLM's prefill of its vision prefix and prompt already wraps it); a
ring of S that is not a multiple of 16; a ring shorter than the window; a
prefill longer than S; a reference ring carried over near position 524280
(``long_500k``); and the plan's shapes and positions across the wrap,
against a brute-force ring. Each decode step's logits are held to the
reference's within ``LOGIT_TOL`` (float32, sums in other orders;
``tests/test_torch_hybrid.py``'s); a reference decode step is jitted."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro_torch import params as port_params
from repro_torch.configs import get_smoke_config
from repro_torch.launch import shardings as sh
from repro_torch.models import Model, layers, runtime_flags

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

PAGE = 16
LOGIT_TOL = 2e-4
# llama-8b's widths cut to 2 layers, d 64, 4 / 2 heads of 16 (the window
# of 32 given apart)
REPRO = (("n_layers", 2), ("d_model", 64), ("n_heads", 4), ("n_kv_heads", 2),
         ("head_dim", 16))


@functools.lru_cache(maxsize=None)
def _pair(arch, window, overrides=(), seed=0):
    """(reference model, its params, jitted reference decode step, port
    model, carried-over params) of ``arch``'s float32 smoke config with a
    window of ``window`` and ``overrides`` in both packages."""
    rcfg = ref_smoke_config(arch).with_(dtype="float32", sliding_window=window,
                                         **dict(overrides))
    cfg = get_smoke_config(arch).with_(dtype="float32", sliding_window=window,
                                       **dict(overrides))
    ref_model = RefModel(rcfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    params = port_params.from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                                        device="cpu", dtype=torch.float32)
    return ref_model, ref_params, jax.jit(ref_model.decode_step), Model(cfg), params


def _batch(cfg, B, n, seed):
    """A prompt of ``n`` tokens a row, and the VLM's vision embeddings or
    the audio model's frames, as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)}
    if cfg.arch_type == "vlm":
        out["vision"] = rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_model),
                                            dtype=np.float32)
    if cfg.arch_type == "audio":
        out["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model),
                                            dtype=np.float32)
    return out


def _port(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _decode_both(arch, window, cache_len, prompt, steps, overrides=(), B=2, seed=0):
    """Prefill ``prompt`` tokens into a cache of ``cache_len`` in both
    packages, then ``steps`` decode steps fed the same seeded tokens; each
    step's logits held to the reference's. Returns the port's cache after
    the prefill's shapes and the last ``pos``."""
    ref_model, ref_params, ref_step, model, params = _pair(arch, window, overrides)
    batch = _batch(model.cfg, B, prompt, seed)
    want, rcache = ref_model.prefill(ref_params, jax.tree.map(jnp.asarray, batch),
                                     cache_len=cache_len, dtype=jnp.float32)
    got, cache = model.prefill(params, _port(batch), cache_len=cache_len,
                               dtype=torch.float32)
    assert rcache["k"].shape[2] == cache_len
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    shapes = {k: tuple(v.shape) for k, v in cache.items()}
    feed = np.random.default_rng(seed + 1).integers(0, model.cfg.vocab_size,
                                                    (steps, B, 1)).astype(np.int32)
    for i, tok in enumerate(feed):
        want, rcache = ref_step(ref_params, jnp.asarray(tok), rcache)
        got, cache = model.decode_step(params, torch.from_numpy(tok).long(), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL, err_msg=f"decode step {i}")
    assert {k: tuple(v.shape) for k, v in cache.items()} == shapes
    return shapes, cache["pos"].tolist()


def test_the_reproduction_decodes_forty_steps_past_a_ring_of_32():
    """Prefill 30 tokens with ``cache_len=32``, then 40 decode steps to
    position 70, past the ring's capacity twice: each step's logits are the
    reference's, and the pool holds the ring's 2 pages a row."""
    shapes, pos = _decode_both("llama-8b", 32, 32, 30, 40, REPRO)
    assert pos == [70, 70]
    assert shapes["k"] == (2, 2 * 2, PAGE, 2, 16) and shapes["block_tables"] == (2, 2)


@pytest.mark.parametrize("arch", ["llama-8b", "qwen2-moe-a2.7b", "zamba2-2.7b",
                                  "whisper-base", "internvl2-2b"])
def test_each_family_decodes_several_wraps_past_a_ring_of_the_window(arch):
    """A ring of ``S = window = 32`` positions (2 pages): 20 prompt tokens
    (the VLM's 16 vision positions in front: 36, so its prefill wraps the
    ring), then 52 decode steps, over the wraps at 32 and 64 (and 96)."""
    _, pos = _decode_both(arch, 32, 32, 20, 52)
    n_vis = 16 if arch == "internvl2-2b" else 0
    assert pos == [72 + n_vis] * 2


def test_a_ring_that_is_not_a_whole_number_of_pages():
    """``S = window = 24``: the port's ring holds 2 pages (32 positions) and
    attends over the last 24, the reference's ring of 24 slots."""
    shapes, pos = _decode_both("llama-8b", 24, 24, 10, 40)
    assert shapes["block_tables"] == (2, 2) and pos == [50, 50]


def test_a_ring_shorter_than_the_window():
    """A ring of 32 under a window of 48: both attend over the 32 positions
    the ring holds (the reference's ``slot_pos`` of its 32 slots)."""
    shapes, pos = _decode_both("llama-8b", 48, 32, 20, 40)
    assert shapes["block_tables"] == (2, 2) and pos == [60, 60]


@pytest.mark.parametrize("arch", ["llama-8b", "zamba2-2.7b", "whisper-base"])
def test_a_windowed_prefill_longer_than_the_ring(arch):
    """45 prompt tokens into a ring of 32 under a window of 32: the prefill
    keeps the last 32 positions at their ring pages (the reference's
    ``fit_cache`` rolls its last 32 into its ring), and 12 decode steps go
    on from them."""
    _decode_both(arch, 32, 32, 45, 12)


def test_without_a_window_a_short_pool_still_raises():
    _, _, _, model, params = _pair("llama-8b", 0)
    batch = _port(_batch(model.cfg, 1, 40, 0))
    with pytest.raises(ValueError, match="shorter than the prompt"):
        model.prefill(params, batch, cache_len=32)


@pytest.mark.parametrize("arch", ["llama-8b", "zamba2-2.7b"])
def test_a_reference_ring_carried_over_near_position_524280(arch):
    """A reference ring of ``S = window = 32`` slots built at ``long_500k``'s
    positions: slot ``q % 32`` holds position ``q`` of 524248 .. 524279
    (random K/V from a seed; a hybrid's SSM and conv states too), ``pos``
    524280. ``cache_from_reference`` puts it on a ring of ``ceil(32 / 16)``
    = 2 pages a row, not a pool of the latest position plus S; 20 decode
    steps across the page boundary at 524288 agree with the reference's."""
    ref_model, ref_params, ref_step, model, params = _pair(arch, 32)
    cfg, B, S, start = model.cfg, 2, 32, 524248
    rng = np.random.default_rng(7)
    rcache = jax.tree.map(np.asarray, ref_model.init_cache(B, S, dtype=jnp.float32))
    for key in ("k", "v"):
        rcache[key] = rng.standard_normal(rcache[key].shape).astype(np.float32)
    for key in ("ssm", "conv"):
        if key in rcache:
            rcache[key] = (0.1 * rng.standard_normal(rcache[key].shape)).astype(np.float32)
    q = np.arange(start, start + S)
    slot_pos = np.zeros((B, S), np.int32)
    slot_pos[:, q % S] = q
    rcache["slot_pos"] = slot_pos
    rcache["pos"] = np.full((B,), start + S, np.int32)
    cache = port_params.cache_from_reference(rcache, cfg, device="cpu", dtype=torch.float32)
    pools = 1 if arch == "zamba2-2.7b" else cfg.n_layers
    assert tuple(cache["block_tables"].shape) == (B, -(-S // PAGE))
    assert tuple(cache["k"].shape) == (pools, B * 2, PAGE, cfg.n_kv_heads,
                                       cfg.resolved_head_dim)
    assert cache["pos"].tolist() == [524280] * B
    rcache = jax.tree.map(jnp.asarray, rcache)
    feed = rng.integers(0, cfg.vocab_size, (20, B, 1)).astype(np.int32)
    for i, tok in enumerate(feed):
        want, rcache = ref_step(ref_params, jnp.asarray(tok), rcache)
        got, cache = model.decode_step(params, torch.from_numpy(tok).long(), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL, err_msg=f"decode step {i}")
    assert cache["pos"].tolist() == [524300] * B


def test_a_short_ring_of_part_pages_is_refused():
    """A reference ring of 24 slots under a window of 32: the port's ring of
    2 whole pages would attend over 8 positions the reference's does not
    hold, so ``cache_from_reference`` refuses it."""
    ref_model, _, _, model, _ = _pair("llama-8b", 32)
    rcache = jax.tree.map(np.asarray, ref_model.init_cache(1, 24, dtype=jnp.float32))
    with pytest.raises(ValueError, match="whole number of pages"):
        port_params.cache_from_reference(rcache, model.cfg, device="cpu")


# ------------------------------------------------------------ the plan


@pytest.mark.parametrize("m,ring_pages,window", [(1, 2, 32), (1, 3, 40), (1, 2, 48),
                                                  (1, 1, 8), (2, 2, 64), (4, 1, 16),
                                                  (4, 2, 100), (16, 1, 256)])
def test_the_plan_reads_exactly_the_window_the_ring_holds(m, ring_pages, window):
    """``decode_plan`` at every position up to four wraps, on one card (m 1)
    and on each rank of m, against a brute-force ring: the new token's place
    is ``seq_place``'s; the view's positions ``[starts, lengths)`` are
    exactly the rank's positions in ``(pos - min(window, m * P * 16), pos]``,
    each read from the slot that holds it; the view's shape and the plan's
    are the same before and after the wrap; before it the view starts with
    the block table itself and ``starts`` / ``lengths`` are the old lower
    bound and length."""
    cfg = get_smoke_config("llama-8b").with_(sliding_window=window)
    if m > 1:
        cfg = dataclass_rank(cfg, m)
    bt = torch.arange(3 * ring_pages, dtype=torch.int32).reshape(3, ring_pages).flip(1)
    span = min(window, m * ring_pages * PAGE)
    shapes = None
    # which position each slot of each rank's local pages holds, written in
    # order by seq_place (-1: none)
    held = np.full((m, ring_pages * PAGE), -1)
    for pos in range(0, 4 * m * ring_pages * PAGE + 20):
        owner, local, offset = sh.seq_place(pos, m, PAGE, ring_pages)
        held[owner, local * PAGE + offset] = pos
        for r in range(m):
            with _rank(r, m):
                plan = layers.decode_plan(cfg, bt, torch.tensor([pos, 0, pos]),
                                          torch.tensor([True, False, True]), PAGE)
            now = {k: tuple(v.shape) for k, v in plan.items() if torch.is_tensor(v)}
            assert shapes in (None, now)
            shapes = now
            assert plan["table"].shape == (3, ring_pages + 1)
            assert plan["page_ids"][0] == bt[0, local] and plan["offsets"][0] == offset
            assert bool(plan["keep"][0]) == (owner == r)
            assert plan["lengths"][1] == 0 and plan["starts"][1] == 0
            lo, hi = int(plan["starts"][0]), int(plan["lengths"][0])
            assert 0 <= lo <= hi <= (ring_pages + 1) * PAGE
            mine = [q for q in range(max(0, pos + 1 - span), pos + 1)
                    if sh.seq_place(q, m, PAGE)[0] == r]
            read = []
            for t in range(lo, hi):
                slot = int(plan["table"][0, t // PAGE]) - int(bt[0, -1])
                read.append(held[r, (ring_pages - 1 - slot) * PAGE + t % PAGE])
            assert read == mine, (pos, r)
            if pos < m * ring_pages * PAGE:      # before the wrap: today's plan
                assert torch.equal(plan["table"][:, :ring_pages], bt)
                assert hi == sh.seq_local_length(pos + 1, r, m, PAGE)
                assert lo == sh.seq_local_length(max(0, pos + 1 - window), r, m, PAGE)


def dataclass_rank(cfg, m):
    """``cfg`` as a rank's config of split heads on a model axis of ``m``."""
    from repro_torch.configs.base import RankConfig
    import dataclasses
    return RankConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
                      q_cols=cfg.n_heads * cfg.resolved_head_dim // m,
                      kv_cols=cfg.n_kv_heads * cfg.resolved_head_dim // m, kv_shards=m)


class _rank:
    """Rank ``r`` of a model axis of ``m`` as the ambient axis (no group:
    ``decode_plan`` reads only the coordinate and the size)."""

    def __init__(self, r, m):
        self.axis = None if m == 1 else runtime_flags.ModelAxis(None, r, m, False)

    def __enter__(self):
        self.before = runtime_flags.get_mesh()
        runtime_flags.set_mesh(self.axis)

    def __exit__(self, *exc):
        runtime_flags.set_mesh(self.before)
