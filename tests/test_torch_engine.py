"""The port's continuous-batching engine on the CPU: the behaviours of
``tests/test_engine.py``, and token-for-token agreement with the reference
engine on the same parameters and prompts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.serving import request as ref_request
from repro.serving.engine import Engine as RefEngine
from repro_torch import params as port_params
from repro_torch.configs import get_smoke_config
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import (RequestState, make_batch,
                                         make_interactive)

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def engine_cfg():
    return get_smoke_config("granite-8b")


def _engine(cfg, **kw):
    return Engine(cfg, dtype=torch.float32, device="cpu", **kw)


def _drain(eng, max_steps=300):
    steps = 0
    while (eng.waiting or eng.n_active) and steps < max_steps:
        eng.step()
        steps += 1
    return steps


def test_serves_all_requests(engine_cfg):
    eng = _engine(engine_cfg, max_slots=4, max_len=96)
    reqs = [make_interactive(8 + i, 6 + i) for i in range(6)]
    for r in reqs:
        eng.submit(r)
    _drain(eng)
    for r in reqs:
        assert r.state == RequestState.FINISHED
        assert r.tokens_generated >= r.output_len
        assert r.first_token_time is not None
        assert r.finish_time >= r.first_token_time


def test_max_batch_size_respected(engine_cfg):
    eng = _engine(engine_cfg, max_slots=4, max_len=64, max_batch_size=2)
    for i in range(4):
        eng.submit(make_interactive(8, 30))
    eng.step()
    assert eng.n_active <= 2


def test_interactive_preempts_batch(engine_cfg):
    eng = _engine(engine_cfg, max_slots=2, max_len=96)
    b1 = make_batch(8, 60)
    b2 = make_batch(8, 60)
    eng.submit(b1)
    eng.submit(b2)
    eng.step()
    assert eng.n_active == 2
    inter = make_interactive(8, 4)
    eng.submit(inter)
    stats = eng.step()
    assert len(stats.preempted) == 1
    victim = stats.preempted[0]
    assert victim.state == RequestState.PREEMPTED
    assert victim.saved_kv is not None
    assert all(t.device.type == "cpu" for t in victim.saved_kv.values())
    assert inter.state in (RequestState.RUNNING, RequestState.FINISHED)
    # resubmit the victim: must resume from saved KV (no re-prefill -> its
    # first_token_time is preserved and generation continues)
    tokens_before = victim.tokens_generated
    eng.submit(victim)
    _drain(eng)
    assert victim.state == RequestState.FINISHED
    assert victim.tokens_generated >= victim.output_len
    assert victim.tokens_generated >= tokens_before
    assert victim.saved_kv is None


def test_throughput_metric_positive(engine_cfg):
    eng = _engine(engine_cfg, max_slots=4, max_len=64)
    for i in range(3):
        eng.submit(make_interactive(8, 20))
    for _ in range(10):
        eng.step()
    assert eng.throughput() > 0
    assert 0 < eng.utilization() <= 1
    assert len(eng.running_types()) == eng.n_active


def test_saved_kv_is_a_copy_not_a_view_of_the_slot(engine_cfg):
    """The victim's KV must survive its slot being given to someone else."""
    eng = _engine(engine_cfg, max_slots=1, max_len=64)
    b = make_batch(8, 40)
    eng.submit(b)
    eng.step()
    eng.step()
    victim = eng.preempt_one_batch(0.0)
    saved = {k: v.clone() for k, v in victim.saved_kv.items()}
    eng.submit(make_interactive(12, 5))
    _drain(eng)
    for k in ("k", "v"):
        assert torch.equal(victim.saved_kv[k], saved[k])


def test_finishes_at_max_len(engine_cfg):
    eng = _engine(engine_cfg, max_slots=2, max_len=24)
    r = make_interactive(10, 500)
    eng.submit(r)
    _drain(eng)
    assert r.state == RequestState.FINISHED
    assert r.tokens_generated == 24 - 10      # pos reaches max_len - 1
    with pytest.raises(ValueError, match="does not fit"):
        eng.submit(make_interactive(24, 4))


def test_freed_slots_stay_in_range_over_a_long_run(engine_cfg):
    """A freed slot's position must not advance: a short request's slot idles
    through many more decode iterations than its pages could hold."""
    eng = _engine(engine_cfg, max_slots=2, max_len=48)
    eng.submit(make_interactive(6, 3))
    long = [make_interactive(6, 40) for _ in range(3)]
    for r in long:
        eng.submit(r)
    assert _drain(eng) > 48
    assert all(r.state == RequestState.FINISHED for r in long)
    assert int(eng.pool["pos"].max()) < 48


# prompt lengths of the five requests; for the ssm family one prompt spans
# three smoke chunks of 32 (the state is carried across chunks) and one is
# shorter than the conv window (its conv rows fill the slot's first rows)
PROMPT_LENS = {"llama-8b": (9, 23, 17, 30, 5), "granite-8b": (9, 23, 17, 30, 5),
               "mamba2-1.3b": (9, 70, 17, 30, 2)}


@pytest.mark.parametrize("arch", ["llama-8b", "granite-8b", "mamba2-1.3b"])
def test_token_for_token_with_reference_engine(arch):
    """Same parameters, same explicit prompts, float32: the next input token
    of every slot agrees after every step, through a preempt-and-restore
    cycle (a restored request resumes on token 0 in both)."""
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    ref = RefEngine(rcfg, key=jax.random.PRNGKey(0), max_slots=3, max_len=96,
                    dtype=jnp.float32)
    params = port_params.from_reference(jax.tree.map(np.asarray, ref.params), cfg,
                                        device="cpu", dtype=torch.float32)
    eng = Engine(cfg, params=params, max_slots=3, max_len=96,
                 dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,), dtype=np.int32)
               for n in PROMPT_LENS[arch]]

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
        assert sa.n_active == sb.n_active and sa.new_tokens == sb.new_tokens
    assert preemptions >= 1
    assert not (ref.waiting or ref.n_active)
    for a, b in pairs:
        assert b.state == RequestState.FINISHED
        assert a.tokens_generated == b.tokens_generated
        assert a.preemptions == b.preemptions
