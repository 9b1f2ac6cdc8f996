"""The port's launch layer against ``repro.launch``: ``resolve_config``,
``cache_len_for``, ``model_flops_for`` and every leaf of ``input_specs``
(against ``jax.eval_shape``) for every arch x input shape; the prefill and
serve steps in float32 on carried-over parameters; the FLOP count of a
step against a hand count; the byte formulas; the roofline terms; the
dry run, on one card and on a mesh; and the mesh's entry points. The specs
and the dry run's steps live on the meta device: nothing is allocated."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import InputShape as RefInputShape
from repro.launch import roofline as ref_roofline
from repro.launch import steps as ref_steps
from repro.models import Model as RefModel
from repro_torch import params as port_params
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, mesh, roofline, steps
from repro_torch.launch import shardings as sh
from repro_torch.launch.roofline import RooflineTerms
from repro_torch.models import Model

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
PAIRS = [(a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES]
TOL = 2e-4           # tests/test_torch_model.py's prefill tolerance


def _fields(cfg):
    out = {k: v for k, v in cfg.__dict__.items() if k not in ("moe", "ssm")}
    for sub in ("moe", "ssm"):
        out[sub] = dataclasses.asdict(getattr(cfg, sub))
    return out


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_resolve_config_matches_the_reference(arch, shape):
    ours = steps.resolve_config(get_config(arch), INPUT_SHAPES[shape])
    theirs = ref_steps.resolve_config(ref_get_config(arch), REF_SHAPES[shape])
    assert _fields(ours) == _fields(theirs)
    assert dataclasses.asdict(INPUT_SHAPES[shape]) == dataclasses.asdict(REF_SHAPES[shape])


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_cache_len_and_model_flops_match_the_reference(arch, shape):
    cfg = steps.resolve_config(get_config(arch), INPUT_SHAPES[shape])
    rcfg = ref_steps.resolve_config(ref_get_config(arch), REF_SHAPES[shape])
    assert steps.cache_len_for(cfg, INPUT_SHAPES[shape]) == \
        ref_steps.cache_len_for(rcfg, REF_SHAPES[shape])
    assert roofline.model_flops_for(cfg, INPUT_SHAPES[shape]) == \
        ref_roofline.model_flops_for(rcfg, REF_SHAPES[shape])


def _port_leaves(node, path=()):
    """{path: tensor} of a port tree: dict keys, NamedTuple fields."""
    if isinstance(node, dict):
        out = {}
        for k in node:
            out.update(_port_leaves(node[k], path + (k,)))
        return out
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        out = {}
        for f in node._fields:
            out.update(_port_leaves(getattr(node, f), path + (f,)))
        return out
    return {path: node}


def _ref_leaves(tree):
    """{path: ShapeDtypeStruct} of a reference pytree, in the same terms."""
    out = {}
    for keys, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = tuple(getattr(k, "key", getattr(k, "name", getattr(k, "idx", None)))
                     for k in keys)
        out[path] = leaf
    return out


def _dtype(t):
    return str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs_match_eval_shape_and_allocate_nothing(arch, shape):
    """Every leaf of the parameters, the optimizer state, the batch and the
    tokens has the reference's path, shape and dtype. The cache changes
    format (ROADMAP.md, Departures): the reference's (L, B, S, Hkv, D) slots
    become the port's (L, B * pages, page, Hkv, D) pools with a block
    table, which hold the same positions a sequence rounded up to a page;
    ``slot_pos`` has no counterpart; the SSM and conv states and ``pos`` are
    the reference's."""
    got = _port_leaves(steps.input_specs(get_config(arch), INPUT_SHAPES[shape]))
    want = _ref_leaves(ref_steps.input_specs(
        ref_steps.resolve_config(ref_get_config(arch), REF_SHAPES[shape]),
        REF_SHAPES[shape]))
    assert all(t.device.type == "meta" for t in got.values())
    for path, w in want.items():
        if path[0] == "cache" and path[1] in ("k", "v", "cross_k", "cross_v"):
            g = got[path]
            L, B, S, Hkv, D = w.shape
            pages = -(-S // g.shape[2])
            assert g.shape == (L, B * pages, g.shape[2], Hkv, D), path
            assert _dtype(g) == str(w.dtype), path
            continue
        if path == ("cache", "slot_pos"):
            assert path not in got
            continue
        assert tuple(got[path].shape) == tuple(w.shape), path
        assert _dtype(got[path]) == str(w.dtype), path
    extra = {p for p in got if p not in want}
    assert extra <= {("cache", "block_tables"), ("cache", "cross_block_tables")}


def _pair(arch, seed):
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    ref_model = RefModel(rcfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    params = port_params.from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                                        device="cpu", dtype=torch.float32)
    return rcfg.with_(dtype="float32"), ref_params, cfg.with_(dtype="float32"), params


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-1.3b", "zamba2-2.7b"])
def test_prefill_and_serve_steps_match_the_reference(arch):
    """``make_prefill_step`` on a prompt, then two ``make_serve_step`` steps
    from the cache it returns, against the reference's step functions, in
    float32 on the same parameters."""
    rcfg, ref_params, cfg, params = _pair(arch, seed=2)
    # a 21-token prompt into a cache of 24 positions: room for the decode
    rshape, shape = RefInputShape("t", 24, 2, "prefill"), InputShape("t", 24, 2, "prefill")
    assert steps.prefill_cache_len(cfg, shape) == ref_steps.cache_len_for(rcfg, rshape)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    want, rcache = ref_steps.make_prefill_step(rcfg, rshape)(
        ref_params, {"tokens": jnp.asarray(toks)})
    got, cache = steps.make_prefill_step(cfg, shape)(
        params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    tok = np.array(jnp.argmax(want, -1), np.int32)[:, None]
    ref_serve, serve = ref_steps.make_serve_step(rcfg), steps.make_serve_step(cfg)
    for _ in range(2):
        want, rcache = ref_serve(ref_params, jnp.asarray(tok), rcache)
        got, cache = serve(params, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
        tok = np.array(jnp.argmax(want, -1), np.int32)[:, None]


def test_flop_count_of_a_prefill_equals_a_hand_count():
    """granite-8b (smoke), a prefill of 2 x 16 on meta tensors: the products
    of every layer's projections, its plain attention (full S x S scores and
    P V over every query head) and SwiGLU, and the last position's logits."""
    cfg = get_smoke_config("granite-8b")
    shape = InputShape("t", 16, 2, "prefill")
    specs = steps.input_specs(cfg, shape)
    flops, _ = roofline.count_flops(steps.make_prefill_step(cfg, shape),
                                    specs["params"], specs["batch"])
    B, S, d, H, Hkv = 2, 16, cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, f, V = cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size
    proj = 2 * B * S * d * (2 * H * hd + 2 * Hkv * hd)
    attn = 2 * (2 * B * H * S * S * hd)
    ffn = 3 * 2 * B * S * d * f
    assert flops == cfg.n_layers * (proj + attn + ffn) + 2 * B * d * V


def test_train_steps_trace_on_meta_through_the_kernels_autograd_and_remat():
    """A train step with remat on meta tensors runs autograd through
    ``FlashPrefill`` and ``SSDScan`` and ``torch.utils.checkpoint``; its
    outputs stay on meta, and remat adds the layers' forward FLOPs again."""
    for arch in ("olmo-1b", "mamba2-1.3b", "zamba2-2.7b"):
        cfg = get_smoke_config(arch)
        shape = InputShape("t", 32, 2, "train")
        specs = steps.input_specs(cfg, shape)
        counts = []
        for remat in (False, True):
            flops, out = roofline.count_flops(
                steps.make_train_step(cfg, remat=remat), specs["params"],
                specs["opt_state"], specs["batch"])
            assert all(t.device.type == "meta"
                       for t in _port_leaves({"p": out[0], "o": out[1]}).values())
            counts.append(flops)
        fwd, _ = roofline.count_flops(
            lambda p, b: Model(cfg).loss(p, b), specs["params"], specs["batch"])
        # remat runs the layers' forward again, not the logits' product, and
        # non-reentrant checkpointing stops once the backward's tensors are
        # back (each layer's last product is not run again)
        assert counts[0] < counts[1] < counts[0] + fwd - 2 * 2 * 32 * cfg.d_model * \
            cfg.vocab_size, arch


def test_decode_bytes_follow_the_formula():
    """granite-8b (smoke), 3 sequences at a context of 40 in a pool of 64:
    every parameter, the tokens, the block table, ``pos`` read and written,
    K and V of 41 positions a sequence (40 read, one written) and the
    logits."""
    cfg = get_smoke_config("granite-8b")
    shape = InputShape("t", 64, 3, "decode")
    terms, mem = roofline.plan(cfg, shape, context=40)
    specs = steps.input_specs(cfg, shape)
    hd = cfg.resolved_head_dim
    kv = 2 * cfg.n_layers * 3 * 41 * cfg.n_kv_heads * hd * 2
    want = (roofline.nbytes(specs["params"]) + 3 * 4 + specs["cache"]["block_tables"].numel() * 4
            + 2 * 3 * 4 + kv + 3 * cfg.vocab_size * 2)
    assert terms.hbm_bytes == want
    assert mem["arg_bytes"] == roofline.nbytes(specs)
    assert terms.coll_bytes == 0 and terms.collective_s == 0


def test_train_bytes_follow_the_formula():
    cfg = get_smoke_config("olmo-1b").with_(dtype="float32")
    shape = InputShape("t", 32, 2, "train")
    P = roofline.nbytes(steps.params_specs(cfg))
    opt = 2 * P + 4
    for remat, passes in ((True, 3), (False, 2)):
        terms, _ = roofline.plan(cfg, shape, remat=remat)
        assert terms.hbm_bytes == P * passes + 2 * 32 * 4 + P + 2 * opt + P
        assert terms.dtype == "float32" and terms.peak_flops == roofline.FP32_FLOPS


def test_roofline_terms_take_the_peak_of_their_dtype():
    t = RooflineTerms(flops=989e12, hbm_bytes=3.35e12 * 2, coll_bytes=450e9,
                      model_flops=100e12)
    assert t.compute_s == 1.0 and t.memory_s == 2.0 and t.collective_s == 1.0
    assert t.bottleneck == "memory" and t.step_time_s == 2.0
    assert abs(t.useful_flops_ratio - 100 / 989) < 1e-12
    t32 = dataclasses.replace(t, dtype="float32")
    assert t32.compute_s == 989e12 / 67e12 and t32.bottleneck == "compute"
    ref = ref_roofline.RooflineTerms(flops=1.0, hbm_bytes=1.0, coll_bytes=0.0)
    assert set(ref.as_dict()) <= set(t.as_dict())
    assert RooflineTerms(0.0, 0.0, 0.0).useful_flops_ratio == 0.0


def _local_mesh_of_one_rank(tmp_path):
    """``make_local_mesh`` over a gloo group of one process."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        return mesh.mesh_axis_sizes(mesh.make_local_mesh(1, backend="cpu"))
    finally:
        dist.destroy_process_group()


def _dryrun_mesh(tmp_path, *flags):
    """One pair through the dry run's CLI with mesh ``flags``: its record."""
    out = tmp_path / "rec.jsonl"
    assert dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k",
                        "--out", str(out), *flags]) == 0
    return json.loads(out.read_text().splitlines()[-1])


@pytest.mark.parametrize("fn,want", [
    (lambda _: mesh.mesh_axis_sizes(mesh.make_production_mesh()), {"data": 16, "model": 16}),
    (lambda _: mesh.mesh_axis_sizes(mesh.make_production_mesh(multi_pod=True)),
     {"pod": 2, "data": 16, "model": 16}),
    (_local_mesh_of_one_rank, {"data": 1, "model": 1}),
    (lambda _: mesh.mesh_axis_sizes(mesh.mesh_shape((32, 8))), {"data": 32, "model": 8}),
    (lambda t: _dryrun_mesh(t, "--multi-pod")["mesh"], "2x16x16"),
    (lambda t: _dryrun_mesh(t, "--mesh-shape", "32x8")["mesh"], "32x8"),
    (lambda t: _dryrun_mesh(t, "--zero-opt")["mesh"], "16x16")],
    ids=["production", "multi_pod", "local", "axis_sizes", "dryrun_multi_pod",
         "dryrun_mesh_shape", "dryrun_zero_opt"])
def test_the_mesh_entry_points_answer(tmp_path, fn, want):
    assert fn(tmp_path) == want


def test_a_local_mesh_needs_a_process_group_and_a_named_backend():
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh.make_local_mesh(1, backend="cpu")
    with pytest.raises(ValueError, match="backend"):
        mesh.make_local_mesh(1, backend="gloo")


def test_dryrun_record():
    rec, line = dryrun.run_one("mamba2-1.3b", "long_500k")
    assert rec["status"] == "ok" and rec["fits"] is True and rec["temp_bytes"] is None
    for key in ("arch", "shape", "mesh", "multi_pod", "total_s", "arg_bytes",
                "out_bytes", "flops", "hbm_bytes", "coll_bytes", "compute_s",
                "memory_s", "collective_s", "bottleneck", "useful_flops_ratio",
                "coll_breakdown"):
        assert key in rec, key
    assert rec["bottleneck"] == "memory" and "OK" in line


def test_dryrun_cli_smoke():
    """One dry-run pair through the CLI: olmo-1b's decode_32k, whose pool of
    128 x 32768 positions (552 GB) does not fit the card."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "olmo-1b", "--shape", "decode_32k"], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "1/1 pairs traced on the meta device" in out.stdout
    assert "fits=False" in out.stdout and "bottleneck=memory" in out.stdout


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_mesh_coll_bytes_count_the_plans_all_reduces(kind):
    """llama-70b on 1 x 4: per layer the attention's and the FFN's outputs,
    plus the embeddings and the full-vocabulary logits (its vocabulary
    divides 4), each in float32 at a ring's 2 (m - 1) / m over NVLink; none
    on one card."""
    cfg = get_config("llama-70b")
    shape = InputShape("s", 64, 8, kind)
    tokens = 8 * (1 if kind == "decode" else 64)
    buffers = 2 * cfg.n_layers * tokens * cfg.d_model + tokens * cfg.d_model + \
        8 * cfg.vocab_size
    got = roofline.mesh_coll_bytes(cfg, shape, mesh.mesh_shape((1, 4)))
    assert got == {"all-reduce model": buffers * 4 * 1.5}
    one = roofline.mesh_coll_bytes(cfg, shape, mesh.mesh_shape((1, 1)))
    assert one == {"all-reduce model": 0.0}
    terms, _ = roofline.plan(cfg.with_(n_layers=2), shape, mesh=mesh.mesh_shape((1, 4)))
    assert terms.coll_bytes > 0 and terms.coll_breakdown
    assert terms.link_bw == roofline.LINK_BW
    assert terms.collective_s == terms.coll_bytes / roofline.LINK_BW
    terms, _ = roofline.plan(cfg.with_(n_layers=2), shape)
    assert terms.coll_bytes == 0.0 and terms.coll_breakdown == {}


@pytest.mark.parametrize("arch,shape,mesh_shape", [
    ("mamba2-1.3b", InputShape("s", 64, 8, "train"), (1, 128)),
    ("zamba2-2.7b", InputShape("s", 64, 8, "decode"), (1, 16)),
    ("mamba2-1.3b", InputShape("s", 64, 8, "decode"), (1, 128)),
    ("qwen2-moe-a2.7b", InputShape("s", 64, 8, "prefill"), (1, 16))],
    ids=["train", "kv_heads_8_on_16", "ssm", "moe"])
def test_mesh_coll_bytes_are_none_where_the_sharded_step_does_not_run(
        arch, shape, mesh_shape):
    """No plan, no count: a train step that sharded_step refuses, a model
    axis that splits the 8 KV heads of a hybrid model (zamba2-2.7b's cut to
    8 KV heads: only the dense, VLM and audio families run on split heads,
    with a window or without), one that does not divide the
    SSM heads (mamba2-1.3b's 64 on 128), and an MoE model whose experts'
    d_ff the axis does not divide (the expert-parallel fallback; its
    experts here at 1400, where 16 divides the rest); the dry run's terms
    then leave the collective out of the bottleneck and the step time.
    (Every family's train step runs on a mesh that divides its heads:
    tests/test_torch_shardings.py counts its bytes.)"""
    cfg = get_config(arch)
    if cfg.is_moe:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, d_ff=1400))
    if arch == "zamba2-2.7b":
        cfg = cfg.with_(n_kv_heads=8)
        assert steps.splits_heads(cfg, 16)
    assert roofline.mesh_coll_bytes(cfg, shape, mesh.mesh_shape(mesh_shape)) is None
    t = RooflineTerms(flops=989e12, hbm_bytes=3.35e12 * 2, coll_bytes=None)
    assert t.collective_s is None and t.bottleneck == "memory" and t.step_time_s == 2.0


def test_mesh_collectives_cross_nodes_past_an_nvlink_domain():
    """A model axis that tiles an eight-card node rings over NVLink; one of
    16 (the production mesh's) crosses nodes at the inter-node rate."""
    assert [roofline.link_bw(m) for m in (1, 2, 4, 8)] == [roofline.LINK_BW] * 4
    assert roofline.link_bw(16) == roofline.INTER_NODE_BW < roofline.LINK_BW
    cfg = get_smoke_config("llama-70b").with_(n_heads=16, n_kv_heads=16, d_ff=512)
    terms, _ = roofline.plan(cfg, InputShape("s", 16, 16, "decode"),
                             mesh=mesh.mesh_shape((1, 16)))
    assert terms.link_bw == roofline.INTER_NODE_BW
    assert terms.collective_s == terms.coll_bytes / roofline.INTER_NODE_BW


@pytest.mark.parametrize("batch,split", [(2, 4), (1, 2)])
def test_mesh_flops_split_over_the_ranks_that_split_the_work(batch, split):
    """On 2 x 2 a batch of 2 splits over both axes; a batch of 1 does not
    divide the data axis, so each data rank computes the whole batch and the
    FLOPs split over the model axis alone. The logits a rank returns are its
    rows over the whole vocabulary, as sharded_step returns them."""
    cfg = get_smoke_config("llama-70b").with_(n_heads=8, n_kv_heads=4)
    shape = InputShape("s", 16, batch, "prefill")
    whole, one = roofline.plan(cfg, shape)
    terms, mem = roofline.plan(cfg, shape, mesh=mesh.mesh_shape((2, 2)))
    assert terms.flops == whole.flops / split
    assert terms.model_flops == whole.model_flops / split
    specs = steps.input_specs(cfg, shape)
    _, out = roofline.count_flops(steps.make_prefill_step(cfg, shape), specs["params"],
                                  specs["batch"])
    sizes = {"data": 2, "model": 2}
    cache = roofline.local_meta(out[1], sh.cache_shardings(mesh.mesh_shape((2, 2)), out[1],
                                                           batch), sizes)
    rows = batch * 2 // split
    logits = rows * cfg.vocab_size * out[0].element_size()
    assert mem["out_bytes"] == logits + roofline.nbytes(cache)
    assert one["out_bytes"] == roofline.nbytes(out)
