"""The sharded prefill and decode steps where the model axis splits the
attention heads (``launch.steps.splits_heads``): the reference's placement,
``wq``/``wk``/``wv`` cut on their columns mid-head and ``wo`` on its rows,
with the KV pool sharded over the sequence in round-robin pages
(``launch.shardings.seq_place``), in gloo processes on the CPU against the
reference's unsharded ``Model.prefill`` / ``decode_step`` and the port's
unsharded steps on the same parameters, float32.

The prompts are ragged and each is prefilled alone and written into its
slot of the decode pool (``Model.write_slot``), as an engine admits them,
so a rank's pages of a row are copied from one pool into another; one
prompt is shorter than a page, so that every rank but the first holds none
of it and gives the merge an empty partial. llama-70b's smoke config (4
heads over 2 KV heads of 32) on 1 x 4 splits the KV heads and keeps the
query heads whole; yi-34b's (7 heads over 1 KV head) on 1 x 2, 1 x 4 and
2 x 2 cuts the query heads mid-head (3.5 and 1.75 a rank); internvl2-2b's
on 1 x 4 carries its 16 vision positions, a bidirectional prefix, in
front of each prompt; 9 heads over 3 KV heads on 1 x 2 give rank 0 4.5
heads that straddle two KV heads' groups. Without processes: the round-robin map against a
brute-force count, the kernel's plain partial with its log-sum-exp over a
rank's pages merged over the ranks against the whole pool's attention, the
query heads a rank's ``wo`` rows overlap, and the refusals. Each rank is a
``python -c`` process meeting the others at a ``file://`` store under
``tmp_path``; every wait has a timeout."""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro_torch import params as port_params
from repro_torch.configs import INPUT_SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels.paged_attention import (paged_attention_plain,
                                                 paged_attention_split_plain)
from repro_torch.launch import shardings as sh
from repro_torch.launch import dryrun, roofline, steps
from repro_torch.launch.mesh import MeshShape, mesh_shape
from repro_torch.models import Model, layers
from repro_torch.models.transformer import cache_rows
from test_torch_mesh import RankZero

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
# each prompt's tokens; the second is shorter than one page of 16
LENGTHS = (24, 5, 40, 17)
DECODE_STEPS = 4
# against the reference: tests/test_torch_model.py's float32 tolerance;
# against the port's unsharded steps, tighter: the same plain versions, the
# partial sums and the softmax's pieces added in another order
REF_TOL = 2e-4
PORT_TOL = 2e-5
RANK_TIMEOUT_S = 180

# one rank: the carried-over parameters cut to its shards, each of its rows'
# prompts prefilled alone and written into its slot, then DECODE_STEPS
# decode steps over the global batch fed the reference's greedy tokens;
# writes its rows' logits
RANK = r"""
import datetime, json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import params as P
from repro_torch.configs.base import InputShape, ModelConfig, SSMConfig
from repro_torch.launch import steps
from repro_torch.launch.mesh import (close_mesh, make_local_mesh, mesh_axis_sizes,
                                     mesh_coords)
from repro_torch.models import Model
from repro_torch.models.transformer import cache_rows

rank, world, model_axis, work = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{work}/store", world_size=world,
                        rank=rank, timeout=datetime.timedelta(seconds=120))
spec = json.load(open(f"{work}/spec.json"))
spec["cfg"]["ssm"] = SSMConfig(**spec["cfg"]["ssm"])
cfg = ModelConfig(**spec["cfg"])
data = np.load(f"{work}/inputs.npz")
tree = {}
for key in data.files:
    if key.startswith("param/"):
        node = tree
        *path, leaf = key.split("/")[1:]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = data[key]
mesh = make_local_mesh(model_axis, backend="cpu")
params = P.shard_params(P.from_reference(tree, cfg, device="cpu"), mesh, mesh_coords(mesh))
lengths, cap, n_vis = spec["lengths"], spec["cap"], spec["n_vis"]
B = len(lengths)
rows = steps.batch_rows(mesh, B)
lcfg = steps.local_config(cfg, mesh_axis_sizes(mesh))
pool = Model(lcfg).init_cache(rows.stop - rows.start, cap, dtype=torch.float32, device="cpu")
out = {}
logits = []
for i in range(rows.start, rows.stop):
    n = lengths[i]
    prefill, _ = steps.sharded_step(cfg, InputShape(f"p{i}", n, 1, "prefill"), mesh)
    batch = {"tokens": torch.from_numpy(data[f"tokens{i}"]).long()}
    for key in ("vision", "frames"):
        if f"{key}{i}" in data.files:
            batch[key] = torch.from_numpy(data[f"{key}{i}"])
    lg, one = prefill(params, batch)
    sub = {k: cache_rows(one, k, 0)[:, None, :n + n_vis] for k in ("k", "v")}
    for k in ("cross_k", "cross_v"):   # the rank's pages of the encoder's rows, whole
        if k in one:
            sub[k] = cache_rows(one, k, 0, table="cross_block_tables")[:, None]
    Model(lcfg).write_slot(pool, i - rows.start, sub)
    pool["pos"][i - rows.start] = n + n_vis
    logits.append(lg)
out["prefill"] = torch.cat(logits).numpy()
decode, _ = steps.sharded_step(cfg, InputShape("d", cap, B, "decode"), mesh)
for j, tok in enumerate(data["feed"]):
    lg, pool = decode(params, torch.from_numpy(tok).long()[:, None], pool)
    out[f"decode{j}"] = lg.numpy()
np.savez(f"{work}/rank{rank}.npz", rows=np.array([rows.start, rows.stop]), **out)
close_mesh()
"""


def _flat(tree, prefix="param"):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def _prompts(cfg):
    rng = np.random.default_rng(0)
    out = []
    for n in LENGTHS:
        p = {"tokens": rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)}
        if cfg.arch_type == "vlm":
            p["vision"] = rng.standard_normal((1, cfg.n_vision_tokens, cfg.d_model),
                                              dtype=np.float32)
        if cfg.arch_type == "audio":
            p["frames"] = rng.standard_normal((1, cfg.enc_seq, cfg.d_model),
                                              dtype=np.float32)
        out.append(p)
    return out


def _cap(cfg) -> int:
    return max(LENGTHS) + cfg.n_vision_tokens + DECODE_STEPS + 8


@functools.lru_cache(maxsize=None)
def _unsharded(arch, overrides=()):
    """The reference, each prompt alone and greedy (its tokens are what
    every run is fed), and the port unsharded through the same slots as the
    ranks: ``(ref_params as numpy, prompts, feed, ref logits, port logits)``,
    each logits a list of (B, V) by step."""
    rcfg = ref_smoke_config(arch).with_(dtype="float32", **dict(overrides))
    cfg = get_smoke_config(arch).with_(dtype="float32", **dict(overrides))
    ref_model = RefModel(rcfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    as_numpy = jax.tree.map(np.asarray, ref_params)
    prompts, cap = _prompts(cfg), _cap(cfg)
    ref_rows, feed_rows = [], []
    for p in prompts:
        want, rcache = ref_model.prefill(ref_params, jax.tree.map(jnp.asarray, p),
                                         cache_len=cap, dtype=jnp.float32)
        steps_, toks = [np.asarray(want)[0]], []
        for _ in range(DECODE_STEPS):
            tok = np.array(jnp.argmax(want, -1), np.int32)
            toks.append(tok[0])
            want, rcache = ref_model.decode_step(ref_params, jnp.asarray(tok)[:, None], rcache)
            steps_.append(np.asarray(want)[0])
        ref_rows.append(steps_)
        feed_rows.append(toks)
    ref_logits = [np.stack([r[i] for r in ref_rows]) for i in range(DECODE_STEPS + 1)]
    feed = np.array(feed_rows, np.int32).T          # (steps, B)

    params = port_params.from_reference(as_numpy, cfg, device="cpu")
    model = Model(cfg)
    pool = model.init_cache(len(LENGTHS), cap, dtype=torch.float32, device="cpu")
    n_vis = cfg.n_vision_tokens
    logits = []
    for i, (n, p) in enumerate(zip(LENGTHS, prompts)):
        batch = {k: torch.from_numpy(v) for k, v in p.items()}
        batch["tokens"] = batch["tokens"].long()
        lg, one = model.prefill(params, batch, cache_len=n + n_vis, dtype=torch.float32)
        sub = {k: cache_rows(one, k, 0)[:, None, :n + n_vis] for k in ("k", "v")}
        for k in ("cross_k", "cross_v"):
            if k in one:
                sub[k] = cache_rows(one, k, 0, table="cross_block_tables")[:, None]
        model.write_slot(pool, i, sub)
        pool["pos"][i] = n + n_vis
        logits.append(lg)
    port_logits = [torch.cat(logits).numpy()]
    for tok in feed:
        lg, pool = model.decode_step(params, torch.from_numpy(tok).long()[:, None], pool)
        port_logits.append(lg.numpy())
    return as_numpy, prompts, feed, ref_logits, port_logits


def _run_ranks(work, world, model_axis):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), str(world),
                               str(model_axis), str(work)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            results.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, err in results:
        assert rc == 0, err[-3000:]
    return [np.load(work / f"rank{r}.npz") for r in range(world)]


# 9 heads over 3 KV heads (group 3) of 32 on 1 x 2: rank 0's 4.5 heads of
# columns straddle KV heads 0 and 1, which the prefill reads one a head
STRADDLE = (("n_heads", 9), ("n_kv_heads", 3), ("d_model", 288))


@pytest.mark.parametrize("arch,data_axis,model_axis,overrides",
                         [("llama-70b", 1, 4, ()), ("yi-34b", 1, 2, ()), ("yi-34b", 1, 4, ()),
                          ("yi-34b", 2, 2, ()), ("internvl2-2b", 1, 4, ()),
                          ("llama-70b", 1, 2, STRADDLE)],
                         ids=["llama-70b-1x4", "yi-34b-1x2", "yi-34b-1x4", "yi-34b-2x2",
                              "internvl2-2b-1x4", "straddle-1x2"])
def test_split_heads_prefill_and_decode_match_the_reference(tmp_path, arch, data_axis,
                                                            model_axis, overrides):
    check_split_heads_serving(tmp_path, arch, data_axis, model_axis, overrides)


def check_split_heads_serving(tmp_path, arch, data_axis, model_axis, overrides=()):
    """``arch``'s smoke config, changed by ``overrides`` (pairs of a field
    and its value, in both packages) so that a model axis of
    ``model_axis`` splits its heads, on ``data_axis`` x ``model_axis`` gloo
    ranks against the reference and the port unsharded: each prompt of
    ``LENGTHS`` prefilled alone and written into its slot, then
    ``DECODE_STEPS`` decode steps (also
    ``tests/test_torch_mesh_audio_split_heads.py``'s)."""
    cfg = get_smoke_config(arch).with_(dtype="float32", **dict(overrides))
    assert steps.splits_heads(cfg, model_axis)
    as_numpy, prompts, feed, ref_logits, port_logits = _unsharded(arch, overrides)
    inputs = {"feed": feed, **dict(_flat(as_numpy))}
    for i, p in enumerate(prompts):
        inputs.update({f"{k}{i}": v for k, v in p.items()})
    np.savez(tmp_path / "inputs.npz", **inputs)
    config = {k: v for k, v in cfg.__dict__.items() if k not in ("moe", "ssm")}
    config["ssm"] = cfg.ssm.__dict__
    (tmp_path / "spec.json").write_text(json.dumps(
        {"cfg": config, "lengths": list(LENGTHS), "cap": _cap(cfg),
         "n_vis": cfg.n_vision_tokens}))
    ranks = _run_ranks(tmp_path, data_axis * model_axis, model_axis)

    covered = set()
    for out in ranks:
        lo, hi = out["rows"]
        covered.update(range(lo, hi))
        for i, key in enumerate(["prefill"] + [f"decode{j}" for j in range(DECODE_STEPS)]):
            np.testing.assert_allclose(out[key], ref_logits[i][lo:hi], atol=REF_TOL,
                                       rtol=REF_TOL, err_msg=f"{key} vs the reference")
            np.testing.assert_allclose(out[key], port_logits[i][lo:hi], atol=PORT_TOL,
                                       rtol=PORT_TOL, err_msg=f"{key} vs the port")
    assert covered == set(range(len(LENGTHS)))


# ------------------------------------------------------------ no processes


@pytest.mark.parametrize("m", [1, 2, 3, 4, 16])
def test_the_round_robin_map_counts_each_ranks_positions(m):
    """``seq_local_length`` against a count of the positions below the
    length among ``seq_positions``; they form a prefix of the rank's pages,
    ``seq_place`` puts each position where ``seq_positions`` lists it, and
    each position lies on exactly one rank."""
    page = 16
    for length in range(0, 16 * 3 * m + 20):
        pages = sh.seq_pages(max(-(-length // page), 1), m)
        owners = []
        for r in range(m):
            pos = sh.seq_positions(r, m, pages, page)
            held = (pos < length).tolist()
            n = sum(held)
            assert sh.seq_local_length(length, r, m, page) == n
            assert all(held[:n]) and not any(held[n:])
            owners += pos[:n].tolist()
            for j, p in enumerate(pos[:n].tolist()):
                owner, local_page, offset = sh.seq_place(p, m, page)
                assert (owner, local_page * page + offset) == (r, j)
        assert sorted(owners) == list(range(length))
    lengths = torch.arange(0, 200)
    for r in range(m):
        assert torch.equal(sh.seq_local_length(lengths, r, m, page),
                           torch.tensor([sh.seq_local_length(n, r, m, page)
                                         for n in range(200)]))


@pytest.mark.parametrize("m", [2, 4, 5])
@pytest.mark.parametrize("plain", [paged_attention_plain, paged_attention_split_plain],
                         ids=["plain", "split_plain"])
def test_partials_over_the_ranks_pages_merge_to_the_whole_pools_attention(m, plain):
    """A pool of 4 rows (one of them empty, one shorter than a page), cut
    into each rank's round-robin pages; each rank's float32 partial and
    log-sum-exp over its pages (``return_lse``) merged over the ranks
    (``layers.merge_partials``, what ``merge_model_axis`` runs on the
    gathered partials) give
    ``paged_attention_plain`` over the whole pool, within 1e-6. The rows
    reach 3 pages, so on 4 and 5 ranks a rank holds no position of any row:
    its log-sum-exp is -inf and its output 0, and the merge takes it
    without NaN. The log-sum-exp of the
    whole pool is held to a direct computation."""
    gen = torch.Generator().manual_seed(3)
    B, n_kv, group, D, page, pps = 4, 2, 4, 32, 16, 5
    lengths = torch.tensor([40, 0, 5, 33], dtype=torch.int32)
    q = torch.randn((B, n_kv, group, D), generator=gen)
    k = torch.randn((B * pps, page, n_kv, D), generator=gen)
    v = torch.randn((B * pps, page, n_kv, D), generator=gen)
    bt = torch.arange(B * pps, dtype=torch.int32).reshape(B, pps)
    want = paged_attention_plain(q, k, v, bt, lengths)
    o_all, lse_all = plain(q, k, v, bt, lengths, return_lse=True)
    assert o_all.dtype == lse_all.dtype == torch.float32
    torch.testing.assert_close(o_all, want, atol=1e-6, rtol=1e-6)
    kf = k[bt.long()].reshape(B, pps * page, n_kv, D)
    s = torch.einsum("bkgd,bskd->bkgs", q, kf) / D ** 0.5
    s = s.masked_fill(torch.arange(pps * page)[None, None, None] >=
                      lengths[:, None, None, None], float("-inf"))
    torch.testing.assert_close(lse_all, torch.logsumexp(s, -1), atol=1e-6, rtol=1e-6)
    assert torch.isneginf(lse_all[1]).all() and (o_all[1] == 0).all()

    local = sh.seq_pages(pps, m)
    parts, empty = [], 0
    for r in range(m):
        pos = sh.seq_positions(r, m, local, page)
        held = (pos < pps * page)
        rk, rv = torch.zeros((B * local * page, n_kv, D)), torch.zeros((B * local * page, n_kv, D))
        for b in range(B):
            rows = k.reshape(B, pps * page, n_kv, D)[b]
            rk[b * local * page:(b + 1) * local * page][held] = rows[pos[held]]
            rows = v.reshape(B, pps * page, n_kv, D)[b]
            rv[b * local * page:(b + 1) * local * page][held] = rows[pos[held]]
        mine = sh.seq_local_length(lengths.long(), r, m, page).to(torch.int32)
        empty += int((mine == 0).all())
        rbt = torch.arange(B * local, dtype=torch.int32).reshape(B, local)
        parts.append(plain(q, rk.reshape(B * local, page, n_kv, D),
                           rv.reshape(B * local, page, n_kv, D), rbt, mine,
                           return_lse=True))
    got = layers.merge_partials(torch.stack([p[0] for p in parts]),
                                torch.stack([p[1] for p in parts]))
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    assert empty == max(0, m - 3)    # the rows reach 3 pages


MERGE_RANK = r"""
import datetime, sys
import torch, torch.distributed as dist
from repro_torch.launch.mesh import close_mesh, make_local_mesh
from repro_torch.launch.steps import on_model_axis
from repro_torch.models import layers, runtime_flags

rank, work = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{work}/store", world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
mesh = make_local_mesh(2, backend="cpu")
# rank r's partial of two query rows (D 1); rank 1 holds nothing of the second
o = torch.tensor([[[1 + 2 ** -8 - 2 ** -15], [1.0]], [[1 + 2 ** -8 + 2 ** -14], [0.0]]])[rank]
lse = torch.tensor([[0.0, 0.0], [0.0, float("-inf")]])[rank]
with on_model_axis(runtime_flags.ModelAxis.of(mesh, 2)):
    got = layers.merge_model_axis(o, lse)
print(repr([float(x) for x in got.to(torch.bfloat16).float().reshape(-1)]))
close_mesh()
"""


def test_a_bf16_merge_over_the_ranks_rounds_once(tmp_path):
    """Two ranks' partials of one query row, of equal weight: rank 0's 1 +
    2^-8 - 2^-15 lies under half a bf16 unit above 1, rank 1's 1 + 2^-8 +
    2^-14 over it. Their float32 mean 1 + 2^-8 + 2^-15 rounds once to 1 +
    2^-7, as the unsharded attention rounds its float32 output once; the
    partials rounded to bf16 first (1 and 1 + 2^-7) would give a mean of 1 +
    2^-8, which rounds to 1. ``merge_model_axis`` keeps them in float32. A
    second row that only rank 0 holds (rank 1's log-sum-exp -inf, its
    output 0) takes rank 0's value whole."""
    a, b = 1 + 2 ** -8 - 2 ** -15, 1 + 2 ** -8 + 2 ** -14
    exact = torch.tensor([(a + b) / 2]).to(torch.bfloat16)
    rounded = (torch.tensor([a]).to(torch.bfloat16).float() +
               torch.tensor([b]).to(torch.bfloat16).float()) / 2
    assert float(exact) == 1 + 2 ** -7 and float(rounded.to(torch.bfloat16)) == 1.0
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", MERGE_RANK, str(r), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=RANK_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
        assert out.strip().splitlines()[-1] == repr([1 + 2 ** -7, 1.0])


@pytest.mark.parametrize("arch,m,want", [
    ("llama-70b", 16, [(4 * r, 4 * r + 4, 0) for r in range(16)]),
    ("yi-34b", 16, [(7 * r // 2, -(-(7 * r + 7) // 2), 64 * (r % 2)) for r in range(16)]),
    ("yi-34b", 32, None)])
def test_the_heads_a_ranks_rows_of_wo_overlap(arch, m, want):
    """``split_head_block`` on the full configs: llama-70b's 4 heads a rank on
    16 (one KV head of group 8, taken as group 4), yi-34b's 3.5 (4 heads
    that cover them, from the middle of a head on odd ranks) and on 32 its
    1.75; each block's columns are the rank's ``q_cols`` within its heads,
    and every head's KV head is the one ``kv_heads_of`` gives it, a slice
    where the block keeps a grouping, each head's own where it straddles a
    group's edge."""
    cfg = get_config(arch)
    lcfg = steps.local_config(cfg, {"data": 1, "model": m})
    D, group = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
    blocks = [layers.split_head_block(lcfg, r) for r in range(m)]
    if want is not None:
        assert blocks == want
    for r, (h0, h1, off) in enumerate(blocks):
        assert h0 * D + off == r * lcfg.q_cols
        assert off + lcfg.q_cols <= (h1 - h0) * D
        kv = layers.kv_heads_of(lcfg, h0, h1)
        heads = list(range(cfg.n_kv_heads))
        taken = heads[kv] if isinstance(kv, slice) else kv
        n = h1 - h0
        per = n // len(taken) if isinstance(kv, slice) else 1
        assert [taken[j // per] for j in range(n)] == [h // group for h in range(h0, h1)]


def test_a_block_that_straddles_a_group_takes_each_heads_kv_head():
    """9 heads over 3 KV heads (group 3) on a model axis of 2: rank 0's 4.5
    heads of columns lie in heads 0-4, three on KV head 0 and two on KV head
    1, which no grouping of the kernels' takes, so each head reads its own
    KV head (group 1); rank 1's start in the middle of head 4."""
    cfg = get_smoke_config("llama-70b").with_(n_heads=9, n_kv_heads=3, d_model=288)
    lcfg = steps.local_config(cfg, {"data": 1, "model": 2})
    h0, h1, off = layers.split_head_block(lcfg, 0)
    assert (h0, h1, off) == (0, 5, 0)
    assert layers.kv_heads_of(lcfg, h0, h1) == [0, 0, 0, 1, 1]
    h0, h1, off = layers.split_head_block(lcfg, 1)
    assert (h0, h1, off) == (4, 9, 16)
    assert layers.kv_heads_of(lcfg, h0, h1) == [1, 1, 2, 2, 2]


# ------------------------------------------------------------ what runs, what is refused

ACCEPTED = ["llama-8b", "granite-8b", "llama-70b", "yi-34b", "internvl2-2b"]


@pytest.mark.parametrize("arch", ACCEPTED)
def test_the_production_model_axis_serves_the_dense_and_vlm_configs(arch):
    """On the reference's 16 x 16 mesh the prefill and decode steps of the
    five configs whose 8 KV heads 16 does not divide have a plan; a rank
    keeps the heads whole and holds ``n_heads * head_dim / 16`` columns of
    ``wq`` and ``n_kv_heads * head_dim / 16`` of ``wk`` and ``wv``, the
    shapes ``params`` cuts by the reference's specs."""
    cfg, sizes = get_config(arch), {"data": 16, "model": 16}
    for shape in ("prefill_32k", "decode_32k"):
        assert roofline.mesh_coll_bytes(cfg, INPUT_SHAPES[shape], mesh_shape((16, 16)))
    lcfg = steps.local_config(cfg, sizes)
    D = cfg.resolved_head_dim
    assert (lcfg.n_heads, lcfg.n_kv_heads, lcfg.kv_shards) == (cfg.n_heads, cfg.n_kv_heads, 16)
    assert (lcfg.q_cols, lcfg.kv_cols) == (cfg.n_heads * D // 16, cfg.n_kv_heads * D // 16)
    assert lcfg.d_ff == cfg.d_ff // 16
    attn = layers.init_attention(lcfg, torch.Generator(), torch.float32, "meta")
    leaves = port_params.rank_leaves(cfg.with_(n_layers=1),
                                     MeshShape((16, 16), ("data", "model")))[0]
    shapes = {rl.shape[1:] for rl in leaves if len(rl.shape) == 3}
    for name, t in attn.items():
        assert tuple(t.shape) in shapes, name


@pytest.mark.parametrize("arch", ACCEPTED)
def test_their_train_step_on_split_heads_runs(arch):
    """The five configs' train step on 16 x 16 has a plan, and
    ``sharded_step`` builds their smoke configs' train step on 1 x 4
    (which splits their heads) with the rank's blocks as its meta specs:
    ``q_cols`` columns of ``wq`` and ``wo``'s rows, ``kv_cols`` of ``wk``
    and ``wv``, and AdamW moments of the same shapes
    (tests/test_torch_mesh_train_split_heads.py runs such steps)."""
    assert roofline.mesh_coll_bytes(get_config(arch), INPUT_SHAPES["train_4k"],
                                    mesh_shape((16, 16)))
    cfg = get_smoke_config(arch)
    mesh = RankZero((1, 4), ("data", "model"))
    assert steps.splits_heads(cfg, 4)
    fn, (params, opt, batch) = steps.sharded_step(cfg, InputShape("t", 32, 4, "train"), mesh)
    assert callable(fn) and batch["tokens"].shape == (4, 32)
    D = cfg.resolved_head_dim
    q_cols, kv_cols = cfg.n_heads * D // 4, cfg.n_kv_heads * D // 4
    attn = params["layers"]["attn"]
    want = {"wq": (cfg.d_model, q_cols), "wk": (cfg.d_model, kv_cols),
            "wv": (cfg.d_model, kv_cols), "wo": (q_cols, cfg.d_model)}
    for name, shape in want.items():
        assert tuple(attn[name].shape) == (cfg.n_layers, *shape), name
        assert attn[name].device.type == "meta"
        for moments in (opt.mu, opt.nu):
            assert tuple(moments["layers"]["attn"][name].shape) == (cfg.n_layers, *shape)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_the_audio_family_on_split_heads_is_planned(kind):
    """whisper-base's 8 heads on 16, half a head a rank: its step of
    ``kind`` has a plan on 16 x 16 (``tests/test_torch_shardings.py``
    counts it) and the dry run plans it, and ``sharded_step`` builds it on rank 0 of 1 x 16 with the
    rank's column blocks of ``wq``/``wk``/``wv`` (32 of 512) and rows of
    ``wo`` in every encoder and decoder attention, its share of ``d_ff``,
    the vocabulary of 51865 whole (16 does not divide it), and, for a
    decode, both pools on round-robin pages: the cross pool's 94 pages of
    1500 encoder positions a row at 6 a rank (``shardings.seq_pages``)."""
    cfg = get_config("whisper-base")
    shape = {"prefill": "prefill_32k", "decode": "decode_32k", "train": "train_4k"}[kind]
    assert roofline.mesh_coll_bytes(cfg, INPUT_SHAPES[shape], mesh_shape((16, 16)))
    rec, line = dryrun.run_one("whisper-base", shape, mesh=(16, 16))
    assert rec["status"] == "ok" and rec["coll_bytes"] > 0, line
    fn, args = steps.sharded_step(cfg, InputShape("s", 64, 4, kind),
                                  RankZero((1, 16), ("data", "model")))
    params = args[0]
    assert callable(fn)
    for stack in (params["enc_layers"]["attn"], params["dec_layers"]["self_attn"],
                  params["dec_layers"]["cross_attn"]):
        for name in ("wq", "wk", "wv"):
            assert tuple(stack[name].shape)[1:] == (512, 32), name
        assert tuple(stack["wo"].shape)[1:] == (32, 512)
    assert tuple(params["dec_layers"]["ffn"]["w_up"].shape) == (6, 512, 2048 // 16)
    assert tuple(params["emb"]["tok"].shape) == (51865, 512)
    if kind == "decode":
        cache = args[2]
        assert tuple(cache["cross_k"].shape) == (6, 4 * 6, 16, 8, 64)
        assert tuple(cache["cross_block_tables"].shape) == (4, 6)
        assert tuple(cache["k"].shape) == (6, 4 * 1, 16, 8, 64)
    if kind == "train":
        assert tuple(args[1].mu["enc_layers"]["attn"]["wq"].shape) == (6, 512, 32)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_a_window_on_split_heads_raises(kind):
    """A window on split heads runs for the dense, VLM and audio families
    (``tests/test_torch_mesh_window_split_heads.py``,
    ``tests/test_torch_mesh_train_window_split_heads.py``): llama-8b's
    window of 4096 on 16 x 16 builds each step. It still raises for the
    hybrid, whose family does not run on split heads: zamba2-2.7b's own
    window of 4096 with its KV heads cut to 8."""
    llama = get_config("llama-8b").with_(sliding_window=4096)
    fn, _ = steps.sharded_step(llama, InputShape("w", 4096, 16, kind),
                               RankZero((16, 16), ("data", "model")))
    assert callable(fn)
    cfg = get_config("zamba2-2.7b").with_(n_kv_heads=8)
    assert cfg.sliding_window == 4096 and steps.splits_heads(cfg, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        steps.sharded_step(cfg, InputShape("w", 4096, 16, kind),
                           MeshShape((16, 16), ("data", "model")))


def test_an_axis_that_divides_the_kv_heads_but_not_the_heads_raises():
    cfg = get_smoke_config("llama-70b").with_(n_heads=6, n_kv_heads=4, d_model=192)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        steps.check_mesh_runs(cfg, {"data": 1, "model": 4})


def test_an_axis_that_does_not_divide_the_projections_raises():
    """yi-34b's smoke config (7 heads of 32 over one KV head) on a model axis
    of 64: neither ``wq``'s 224 columns nor ``wk``'s 32 divide, where the
    reference replicates the projection."""
    cfg = get_smoke_config("yi-34b")
    with pytest.raises(NotImplementedError, match="replicates"):
        steps.check_mesh_runs(cfg, {"data": 1, "model": 64})
