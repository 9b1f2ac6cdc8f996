"""The engine's decode step through ``serving/decode_graph.py`` on the CPU:
the step function over its static buffers and the in-place ``pos`` is
token-for-token with the reference engine's jitted decode step; buffers keep
their addresses; a CPU engine touches no CUDA API; the ticket counters of
``paged_attention`` never move; and replays count their launches."""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.serving.request as port_request
from repro.configs import get_smoke_config as ref_smoke_config
from repro.serving import request as ref_request
from repro.serving.engine import Engine as RefEngine
from repro_torch import params as port_params
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import paged_attention as paged_module
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.serving import decode_graph
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import RequestState, make_interactive

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

# one prompt spans three smoke chunks of 32 (ssm, hybrid), one is two tokens
# long (shorter than the conv window: its conv rows keep the slot's old ones)
PROMPT_LENS = {"llama-8b": (9, 23, 17, 30, 2, 12),
               "granite-8b": (9, 23, 17, 30, 2, 12),
               "qwen2-moe-a2.7b": (9, 23, 17, 30, 2, 12),
               "mamba2-1.3b": (9, 70, 17, 30, 2, 12),
               "zamba2-2.7b": (9, 70, 17, 30, 2, 12)}
# the max batch size Algorithm 1 would set, by step
BATCH_SIZES = {6: 2, 20: 1, 30: 3}


def _pair(arch):
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    ref = RefEngine(rcfg, key=jax.random.PRNGKey(0), max_slots=3, max_len=96,
                    dtype=jnp.float32)
    params = port_params.from_reference(jax.tree.map(np.asarray, ref.params), cfg,
                                        device="cpu", dtype=torch.float32)
    eng = Engine(cfg, params=params, max_slots=3, max_len=96,
                 dtype=torch.float32, device="cpu")
    return ref, eng


def _addresses(eng):
    g = eng.decode_graph
    return {"pos": eng.pool["pos"].data_ptr(), "tokens": g.tokens.data_ptr(),
            "active": g.active.data_ptr(), "logits": g.logits.data_ptr(),
            "next_token": g.next_token.data_ptr(),
            **{key: t.data_ptr() for key, t in eng.pool.items()}}


@pytest.mark.parametrize("arch", ["llama-8b", "granite-8b", "qwen2-moe-a2.7b",
                                  "mamba2-1.3b", "zamba2-2.7b"])
def test_step_function_is_token_for_token_with_the_jitted_reference(arch):
    """Same parameters and prompts, float32: every slot's next input token
    agrees after every step, through a preempt-and-restore cycle, a 2-token
    prompt and max batch size changes mid-run; the pool's ``pos`` and the
    step's static buffers never change address."""
    ref, eng = _pair(arch)
    addresses = _addresses(eng)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, eng.cfg.vocab_size, size=(n,), dtype=np.int32)
               for n in PROMPT_LENS[arch]]

    def requests(mod):
        out = []
        for i, toks in enumerate(prompts):
            make = mod.make_batch if i < 3 else mod.make_interactive
            r = make(len(toks), 8 + 3 * i)
            r.prompt_tokens = toks
            out.append(r)
        return out

    pairs = list(zip(requests(ref_request), requests(port_request)))
    for a, b in pairs[:3]:
        ref.submit(a)
        eng.submit(b)
    preemptions = 0
    limited = set()      # slots running while requests waited
    for step in range(300):
        if not (eng.waiting or eng.n_active):
            break
        if step in BATCH_SIZES:
            ref.set_max_batch_size(BATCH_SIZES[step])
            eng.set_max_batch_size(BATCH_SIZES[step])
        if step == 3:       # interactive arrivals on a full instance
            for a, b in pairs[3:]:
                ref.submit(a)
                eng.submit(b)
        sa, sb = ref.step(), eng.step()
        if eng.waiting:
            limited.add(sb.n_active)
        assert len(sa.preempted) == len(sb.preempted)
        preemptions += len(sb.preempted)
        for va, vb in zip(sa.preempted, sb.preempted):
            ref.submit(va)
            eng.submit(vb)
        got = [s.token for s in eng.slots]
        want = [None if s.token is None else int(s.token[0]) for s in ref.slots]
        assert got == want, f"step {step}"
        assert sa.n_active == sb.n_active and sa.new_tokens == sb.new_tokens
        assert _addresses(eng) == addresses, f"step {step}"
    assert preemptions >= 1
    assert {1, 2} <= limited      # the batch size, not the slots, held them back
    assert not (ref.waiting or ref.n_active)
    for a, b in pairs:
        assert b.state == RequestState.FINISHED
        assert a.tokens_generated == b.tokens_generated
        assert a.preemptions == b.preemptions


def test_step_function_logits_and_pos_equal_an_eager_decode_step():
    """The static logits and next tokens are those of ``model.decode_step``
    on the same pool state, and ``pos`` advances in place on active rows
    only; the host mirror agrees."""
    eng = Engine(get_smoke_config("llama-8b"), max_slots=3, max_len=64,
                 dtype=torch.float32, device="cpu")
    eng.submit(make_interactive(7, 20))
    eng.submit(make_interactive(11, 20))
    eng.step()
    snapshot = {k: v.clone() for k, v in eng.pool.items()}
    tokens = [s.token if s.active else 0 for s in eng.slots]
    active = [s.active for s in eng.slots]
    assert active == [True, True, False]
    want, cache = eng.model.decode_step(
        eng.params, torch.tensor(tokens)[:, None], snapshot, torch.tensor(active))
    pos = eng.pool["pos"]
    got = eng.decode_graph.run(tokens, active)
    assert eng.pool["pos"] is pos
    assert torch.equal(eng.decode_graph.logits, want)
    assert got.tolist() == torch.argmax(want, -1).tolist()
    assert eng.pool["pos"].tolist() == cache["pos"].tolist() == [9, 13, 0]
    for key in ("k", "v"):
        assert torch.equal(eng.pool[key], snapshot[key])


def test_cpu_engine_builds_no_graph_and_never_calls_cuda(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("torch.cuda called by a CPU engine")

    for name in ("CUDAGraph", "graph", "Stream", "stream", "current_stream",
                 "synchronize", "empty_cache", "memory_reserved", "is_available",
                 "is_current_stream_capturing", "device"):
        monkeypatch.setattr(torch.cuda, name, forbidden)
    for arch in ("llama-8b", "mamba2-1.3b"):
        eng = Engine(get_smoke_config(arch), max_slots=2, max_len=48,
                     dtype=torch.float32, device="cpu", prefix_cache_entries=4,
                     prefill_chunk=4)
        eng.submit(make_interactive(9, 4))
        while eng.waiting or eng.n_active:
            eng.step()
        g = eng.decode_graph
        assert g._graph is None and g.capture_s is None
        assert not g._host_tokens.is_pinned()
        eng.close()
        with pytest.raises(RuntimeError, match="close"):
            g.run([0, 0], [False, False])


def test_ticket_counters_never_move_or_free_a_buffer():
    dev = torch.device("cpu")
    saved = dict(paged_module._tickets)
    try:
        first = {n: paged_module._ticket_counters(dev, n) for n in (16, 8, 64)}
        ptrs = {n: t.data_ptr() for n, t in first.items()}
        refs = {n: weakref.ref(t) for n, t in first.items()}
        # a larger request does not replace the buffers already handed out
        paged_module._ticket_counters(dev, 128)
        for n in (16, 8, 64, 8, 16):
            t = paged_module._ticket_counters(dev, n)
            assert t.data_ptr() == ptrs[n] and t.numel() == n
            assert t.dtype == torch.int32 and not t.any()
        del first, t
        gc.collect()
        assert all(r() is not None for r in refs.values())
        assert paged_module._ticket_counters(dev, 64).data_ptr() == ptrs[64]
    finally:
        paged_module._tickets.clear()
        paged_module._tickets.update(saved)


def test_replays_add_the_captured_launches():
    """The counting helper: a capture's delta is taken back once and added
    once per replay, for every counter of every wrapper."""
    assert {fn for fn, _ in decode_graph.COUNTERS} == \
        {paged_attention, flash_prefill, ssd_scan}
    saved = decode_graph.read_counts()
    try:
        decode_graph.add_counts([-c for c in saved])
        assert decode_graph.read_counts() == (0,) * len(saved)
        before = decode_graph.read_counts()
        # what the wrappers' host code counts while a decode step is captured
        paged_attention.launches += 32
        captured = decode_graph.count_delta(before, decode_graph.read_counts())
        assert decode_graph.named_counts(captured)["paged_attention.launches"] == 32
        assert sum(captured) == 32
        decode_graph.add_counts(captured, -1)      # a capture launches nothing
        assert decode_graph.read_counts() == before
        for replay in range(1, 6):
            decode_graph.add_counts(captured)
            assert paged_attention.launches == 32 * replay
        flash_prefill.tensor_core_launches += 3
        delta = decode_graph.count_delta(before, decode_graph.read_counts())
        named = decode_graph.named_counts(delta)
        assert named["paged_attention.launches"] == 160
        assert named["flash_prefill.tensor_core_launches"] == 3
        assert named["ssd_scan.launches"] == 0
    finally:
        now = decode_graph.read_counts()
        decode_graph.add_counts([s - n for s, n in zip(saved, now)])
    assert decode_graph.read_counts() == saved


def test_retire_closes_the_engine():
    from repro_torch.serving.real_cluster import RealCluster
    from repro_torch.sim.cluster import InstanceType
    cluster = RealCluster(get_smoke_config("llama-8b"), max_chips=2, max_slots=2,
                          max_len=48, device="cpu")
    inst = cluster.provision("llama-8b", InstanceType.MIXED, 0.0)
    inst.activate_if_ready(0.0)
    inst.admit(make_interactive(6, 20), 0.0)
    inst.step(0.0)
    displaced = cluster.retire(inst)
    assert len(displaced) == 1 and displaced[0].saved_kv is not None
    with pytest.raises(RuntimeError, match="close"):
        inst.engine.decode_graph.run([0, 0], [False, False])
