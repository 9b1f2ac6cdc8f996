"""The port's dense transformer against ``repro.models`` with the
reference's parameters carried over by ``params.from_reference``: forward,
prefill, decode steps and chunked prefill, float32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro_torch import params as port_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import Model
from repro_torch.models import transformer

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

# the dense configs; yi-34b's smoke config has group 7 and head_dim 32,
# olmo-1b's a nonparametric LayerNorm, llama-70b lands at its smoke size
ARCHS = ["llama-8b", "granite-8b", "olmo-1b", "phi3-mini-3.8b", "yi-34b",
         "llama-70b"]


def _reference(arch, seed=0):
    rcfg = ref_smoke_config(arch)
    model = RefModel(rcfg)
    params = model.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    return model, params


def _carried_over(arch, ref_params):
    cfg = get_smoke_config(arch)
    as_numpy = jax.tree.map(np.asarray, ref_params)
    return cfg, port_params.from_reference(as_numpy, cfg, device="cpu",
                                           dtype=torch.float32)


@pytest.mark.parametrize("arch", ARCHS + ["mamba2-1.3b", "internvl2-2b", "qwen2-moe-a2.7b",
                                  "deepseek-moe-16b", "zamba2-2.7b"])
def test_configs_match_reference(arch):
    """Every field agrees, the nested moe and ssm configs field by field
    (they are each package's own dataclass), and so do the derived widths."""
    import dataclasses
    from repro.configs import get_config as ref_get_config
    for ours, theirs in ((get_config(arch), ref_get_config(arch)),
                         (get_smoke_config(arch), ref_smoke_config(arch))):
        assert {k: v for k, v in ours.__dict__.items() if k not in ("moe", "ssm")} == \
            {k: v for k, v in theirs.__dict__.items() if k not in ("moe", "ssm")}
        for sub in ("moe", "ssm"):
            assert dataclasses.asdict(getattr(ours, sub)) == \
                dataclasses.asdict(getattr(theirs, sub))
        assert (ours.d_inner, ours.n_ssm_heads) == (theirs.d_inner, theirs.n_ssm_heads)
        assert ours.param_count() == theirs.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_three_decode_steps(arch):
    ref_model, ref_params = _reference(arch)
    cfg, params = _carried_over(arch, ref_params)
    model = Model(cfg)
    rng = np.random.default_rng(0)
    B, S, cap = 2, 21, 40
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)

    want, rcache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                                     cache_len=cap, dtype=jnp.float32)
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(toks).long()},
                               cache_len=cap, dtype=torch.float32)
    # prefill logits within 2e-4: float32, different order of sums
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    assert cache["pos"].tolist() == [S] * B

    tok = np.asarray(jnp.argmax(want, -1), np.int32)
    for step in range(3):
        want, rcache = ref_model.decode_step(ref_params, jnp.asarray(tok)[:, None],
                                             rcache)
        got, cache = model.decode_step(params,
                                       torch.from_numpy(tok).long()[:, None], cache)
        # decode logits within 5e-3 (the tolerance of the reference's own
        # prefill-vs-decode smoke test)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3, rtol=5e-3)
        assert cache["pos"].tolist() == [S + step + 1] * B
        assert got.argmax(-1).tolist() == np.asarray(jnp.argmax(want, -1)).tolist()
        tok = np.asarray(jnp.argmax(want, -1), np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits(arch):
    ref_model, ref_params = _reference(arch, seed=1)
    cfg, params = _carried_over(arch, ref_params)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    want, _ = ref_model.forward(ref_params, {"tokens": jnp.asarray(toks)})
    got, aux = Model(cfg).forward(params, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    assert float(aux) == 0.0


@pytest.mark.parametrize("chunk", [1, 7, 16])
def test_chunked_prefill_equals_one_shot(chunk):
    """Prefill in pieces through ``past_cache`` gives the one-shot logits and
    cache, and both give the reference's."""
    ref_model, ref_params = _reference("llama-8b", seed=2)
    cfg, params = _carried_over("llama-8b", ref_params)
    model = Model(cfg)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (1, 33)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    one_logits, one = model.prefill(params, {"tokens": tt}, dtype=torch.float32)
    past, logits = None, None
    for lo in range(0, tt.shape[1], chunk):
        logits, past = model.prefill(params, {"tokens": tt[:, lo:lo + chunk]},
                                     dtype=torch.float32, past_cache=past)
    np.testing.assert_allclose(logits.numpy(), one_logits.numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(past["k"].numpy(), one["k"].numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(past["v"].numpy(), one["v"].numpy(), atol=2e-4, rtol=2e-4)
    assert past["pos"].tolist() == [33]
    want, rcache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                                     dtype=jnp.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(one["k"].numpy(), np.asarray(rcache["k"]),
                               atol=2e-4, rtol=2e-4)


def test_cache_from_reference_continues_decoding():
    """A reference decode cache carried over into page pools decodes on."""
    ref_model, ref_params = _reference("granite-8b", seed=3)
    cfg, params = _carried_over("granite-8b", ref_params)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    logits, rcache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                                       cache_len=24, dtype=jnp.float32)
    cache = port_params.cache_from_reference(jax.tree.map(np.asarray, rcache),
                                             cfg, device="cpu", dtype=torch.float32)
    tok = np.asarray(jnp.argmax(logits, -1), np.int32)
    want, _ = ref_model.decode_step(ref_params, jnp.asarray(tok)[:, None], rcache)
    got, _ = Model(cfg).decode_step(params, torch.from_numpy(tok).long()[:, None],
                                    cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3, rtol=5e-3)


def test_decode_step_inactive_rows_keep_pos_and_do_not_disturb_active_rows():
    cfg = get_smoke_config("llama-8b")
    model = Model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 11))).long()
    _, cache = model.prefill(params, {"tokens": toks}, cache_len=32,
                             dtype=torch.float32)
    _, solo = model.prefill(params, {"tokens": toks[[0, 2]]}, cache_len=32,
                            dtype=torch.float32)
    nxt = torch.tensor([[5], [6], [7]])
    active = torch.tensor([True, False, True])
    got, cache = model.decode_step(params, nxt, cache, active)
    want, _ = model.decode_step(params, nxt[[0, 2]], solo)
    assert cache["pos"].tolist() == [12, 11, 12]
    np.testing.assert_allclose(got[[0, 2]].numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_init_params_layout_and_determinism():
    """Stacked over layers with the reference's names and shapes; the same
    generator seed gives the same parameters."""
    _, ref_params = _reference("llama-8b")
    cfg = get_smoke_config("llama-8b")
    model = Model(cfg)
    a = model.init(torch.Generator().manual_seed(5), dtype=torch.float32, device="cpu")
    b = model.init(torch.Generator().manual_seed(5), dtype=torch.float32, device="cpu")
    ref_shapes = jax.tree.map(lambda x: tuple(x.shape), ref_params)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert shapes(a) == ref_shapes
    flat_a = transformer.layer_params(a["layers"], 1)["ffn"]["w_gate"]
    flat_b = transformer.layer_params(b["layers"], 1)["ffn"]["w_gate"]
    assert torch.equal(flat_a, flat_b)
    assert not torch.equal(a["layers"]["ffn"]["w_gate"][0], a["layers"]["ffn"]["w_gate"][1])
    bf = model.init(torch.Generator().manual_seed(5), dtype=torch.bfloat16, device="cpu")
    assert bf["layers"]["attn"]["wq"].dtype == torch.bfloat16


def test_prefill_rejects_a_cache_shorter_than_the_prompt():
    cfg = get_smoke_config("llama-8b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32,
                        device="cpu")
    with pytest.raises(ValueError, match="shorter"):
        model.prefill(params, {"tokens": torch.zeros((1, 20), dtype=torch.long)},
                      cache_len=8)
