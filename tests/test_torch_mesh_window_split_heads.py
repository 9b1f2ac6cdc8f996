"""A sliding window where the model axis splits the attention heads
(``launch.steps.splits_heads``), in gloo processes on the CPU, float32:
the windowed prefill and the decode across the ring's wraps of the dense,
VLM and audio smoke configs against the reference's unsharded ``Model``
(``REF_TOL``) and the port's unsharded steps (``PORT_TOL``), on the same
carried-over parameters and seeded tokens.

A windowed pool is a ring of pages (``models/layers.py``); on ``m`` ranks
each rank holds its round-robin pages of it by ring page, ``L = ceil(P /
m)`` local pages a row that form a ring of their own (``shardings.seq_place``
with ``ring=L``). The prefill runs ``flash_prefill`` with the window over
the rank's heads and writes its ring pages of the prompt's last positions;
each decode step attends over the rank's positions within the window, its
``starts`` and ``lengths`` in its own rotated view, and the ranks merge
their partials by log-sum-exp. Every prompt here is longer than the window
(the VLM's with its 16 vision positions in front), so the prefill's ring
wraps, and the decode steps cross the ranks' ring's wrap at ``m * L * 16``
positions too. llama-70b's smoke config on 1 x 4 splits the KV heads, once
with a window of two pages and once with one page: a ring of 1 page, 4
pages over 4 ranks, where at every step two or three ranks hold no position
of the window and give the merge a partial with a log-sum-exp of -inf;
yi-34b's cuts its heads mid-head on 1 x 2 and 2 x 2; internvl2-2b's on 1 x
4 carries its vision prefix; whisper-base's at 3 heads on 1 x 2 its frames
(the cross pool is no ring). A last case carries a reference ring of 64
slots at ``long_500k``'s positions (524216 .. 524279, random K/V from a
seed) to llama-70b's ranks on 1 x 4 by ring page, through
``cache_from_reference`` at world 1 (rank ``r``'s local page ``j`` is ring
page ``4 j + r``), and decodes across the page boundary at 524288. Each
rank is a ``python -c`` process meeting
the others at a ``file://`` store under the test's temporary directory;
every rank ends with ``close_mesh``."""
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
from repro_torch.configs import get_smoke_config
from repro_torch.launch import shardings as sh
from repro_torch.launch import steps
from repro_torch.models import Model

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
# tests/test_torch_mesh_split_heads.py's tolerances
REF_TOL = 2e-4
PORT_TOL = 2e-5
RANK_TIMEOUT_S = 180
B = 2

THREE_HEADS = (("n_heads", 3), ("n_kv_heads", 3), ("d_model", 96), ("enc_seq", 40))
CASES = {  # id: (arch, overrides, data, model, window, prompt tokens, decode steps)
    "llama-70b-1x4": ("llama-70b", (), 1, 4, 32, 40, 28),
    "llama-70b-1x4-one-page": ("llama-70b", (), 1, 4, 16, 24, 44),
    "yi-34b-1x2": ("yi-34b", (), 1, 2, 32, 40, 28),
    "yi-34b-2x2": ("yi-34b", (), 2, 2, 32, 40, 28),
    "internvl2-2b-1x4": ("internvl2-2b", (), 1, 4, 32, 24, 28),
    "whisper-3-heads-1x2": ("whisper-base", THREE_HEADS, 1, 2, 32, 40, 28),
    # prompt 0: a reference ring carried over at CARRY_POS instead of a prefill
    "llama-70b-1x4-carried": ("llama-70b", (), 1, 4, 64, 0, 20),
}
# the carried ring's next position: its 64 slots hold 524216 .. 524279
CARRY_POS = 524280

# one rank, for each case of its mesh in turn: the carried-over parameters
# cut to its shards, the sharded prefill of the global batch (its pool a
# ring of the window's positions), then the decode steps fed the same
# tokens; writes its rows' logits and its pool's shape
RANK = r"""
import datetime, json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import params as P
from repro_torch.configs.base import InputShape, ModelConfig, SSMConfig
from repro_torch.launch import steps
from repro_torch.launch.mesh import close_mesh, make_local_mesh, mesh_coords
from repro_torch.models import Model

rank, world, model_axis, work = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{work}/store", world_size=world,
                        rank=rank, timeout=datetime.timedelta(seconds=120))
mesh = make_local_mesh(model_axis, backend="cpu")
for case, spec in json.load(open(f"{work}/spec.json")).items():
    spec["cfg"]["ssm"] = SSMConfig(**spec["cfg"]["ssm"])
    cfg = ModelConfig(**spec["cfg"])
    data = np.load(f"{work}/{case}.npz")
    tree = {}
    for key in data.files:
        if key.startswith("param/"):
            node = tree
            *path, leaf = key.split("/")[1:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    params = P.shard_params(P.from_reference(tree, cfg, device="cpu"), mesh, mesh_coords(mesh))
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "vision", "frames")
             if k in data.files}
    batch["tokens"] = batch["tokens"].long()
    n, B = batch["tokens"].shape[1], batch["tokens"].shape[0]
    out = {}
    if "ring_k" in data.files:   # world 1's ring by ring page: local page j of a
        # row is its ring page j m + r (the mesh has one data rank)
        lcfg = steps.local_config(cfg, {"data": 1, "model": model_axis})
        cache = Model(lcfg).init_cache(B, cfg.sliding_window, dtype=torch.float32,
                                       device="cpu")
        r, L = mesh_coords(mesh)["model"], cache["block_tables"].shape[1]
        for key in ("k", "v"):
            ring = torch.from_numpy(data[f"ring_{key}"])
            P = ring.shape[1] // B
            for b in range(B):
                cache[key][:, b * L:(b + 1) * L] = ring[:, b * P + r:(b + 1) * P:model_axis]
        cache["pos"].copy_(torch.from_numpy(data["ring_pos"]))
    else:
        prefill, _ = steps.sharded_step(cfg, InputShape("p", n, B, "prefill"), mesh)
        lg, cache = prefill(params, batch)
        out["prefill"] = lg.numpy()
    out["pool"] = np.array(cache["k"].shape)
    decode, _ = steps.sharded_step(cfg, InputShape("d", cfg.sliding_window, B, "decode"), mesh)
    for j, tok in enumerate(data["feed"]):
        lg, cache = decode(params, torch.from_numpy(tok).long(), cache)
        out[f"decode{j}"] = lg.numpy()
    rows = steps.batch_rows(mesh, B)
    np.savez(f"{work}/{case}_rank{rank}.npz", rows=np.array([rows.start, rows.stop]),
             pos=cache["pos"].numpy(), **out)
close_mesh()
"""


def _flat(tree, prefix="param"):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def _configs(case):
    arch, overrides, _, _, window, _, _ = CASES[case]
    kw = dict(overrides, dtype="float32", sliding_window=window)
    return ref_smoke_config(arch).with_(**kw), get_smoke_config(arch).with_(**kw)


def _reference_ring(ref_model, cfg, window, rng):
    """A reference cache of B rows whose ring of ``window`` slots holds the
    positions ``CARRY_POS - window .. CARRY_POS - 1`` at slot ``q % window``
    (random K/V from ``rng``), as numpy."""
    rcache = jax.tree.map(np.asarray, ref_model.init_cache(B, window, dtype=jnp.float32))
    for key in ("k", "v"):
        rcache[key] = rng.standard_normal(rcache[key].shape).astype(np.float32)
    q = np.arange(CARRY_POS - window, CARRY_POS)
    rcache["slot_pos"] = np.zeros((B, window), np.int32)
    rcache["slot_pos"][:, q % window] = q
    rcache["pos"] = np.full((B,), CARRY_POS, np.int32)
    return rcache


@functools.lru_cache(maxsize=None)
def _unsharded(case):
    """The reference and the port unsharded, each prefilling the batch into
    a ring of the window's positions (or, for a carried case, starting from
    ``_reference_ring``, carried over by ``cache_from_reference``) and
    decoding the fed tokens: ``(ref params as numpy, batch, feed, ref
    logits, port logits, the port's carried ring or None)``, the logits a
    list of (B, V) by step, the prefill's first where there is one."""
    rcfg, cfg = _configs(case)
    _, _, _, _, window, prompt, n_steps = CASES[case]
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, max(prompt, 1))).astype(np.int32)}
    if cfg.arch_type == "vlm":
        batch["vision"] = rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_model),
                                              dtype=np.float32)
    if cfg.arch_type == "audio":
        batch["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    feed = rng.integers(0, cfg.vocab_size, (n_steps, B, 1)).astype(np.int32)
    ref_model = RefModel(rcfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    ref_step = jax.jit(ref_model.decode_step)
    as_numpy = jax.tree.map(np.asarray, ref_params)
    model = Model(cfg)
    params = port_params.from_reference(as_numpy, cfg, device="cpu")
    if not prompt:
        rcache = _reference_ring(ref_model, cfg, window, rng)
        cache = port_params.cache_from_reference(rcache, cfg, device="cpu")
        ring = {"ring_k": cache["k"].numpy().copy(), "ring_v": cache["v"].numpy().copy(),
                "ring_pos": cache["pos"].numpy().copy()}
        rcache, ref_logits, port_logits = jax.tree.map(jnp.asarray, rcache), [], []
    else:
        want, rcache = ref_model.prefill(ref_params, jax.tree.map(jnp.asarray, batch),
                                         cache_len=window, dtype=jnp.float32)
        ref_logits, ring = [np.asarray(want)], None
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        tb["tokens"] = tb["tokens"].long()
        got, cache = model.prefill(params, tb, cache_len=window, dtype=torch.float32)
        port_logits = [got.numpy()]
    for tok in feed:
        want, rcache = ref_step(ref_params, jnp.asarray(tok), rcache)
        ref_logits.append(np.asarray(want))
    for tok in feed:
        got, cache = model.decode_step(params, torch.from_numpy(tok).long(), cache)
        port_logits.append(got.numpy())
    return as_numpy, batch, feed, ref_logits, port_logits, ring


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


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    """``run(case)``: the ranks' records of ``case``; the first case of a
    mesh shape runs every case of that shape in one set of rank
    processes."""
    done = {}

    def run(case):
        shape = CASES[case][2:4]
        if shape not in done:
            work = tmp_path_factory.mktemp("x".join(map(str, shape)))
            specs = {}
            for name, (_, _, data, model, _, _, _) in CASES.items():
                if (data, model) != shape:
                    continue
                as_numpy, batch, feed, _, _, ring = _unsharded(name)
                np.savez(work / f"{name}.npz", feed=feed, **batch, **dict(_flat(as_numpy)),
                         **(ring or {}))
                cfg = _configs(name)[1]
                config = {k: v for k, v in cfg.__dict__.items() if k not in ("moe", "ssm")}
                config["ssm"] = cfg.ssm.__dict__
                specs[name] = {"cfg": config}
            (work / "spec.json").write_text(json.dumps(specs))
            _run_ranks(work, shape[0] * shape[1], shape[1])
            done[shape] = work
        return [np.load(done[shape] / f"{case}_rank{r}.npz")
                for r in range(shape[0] * shape[1])]
    return run


@pytest.mark.parametrize("case", list(CASES))
def test_a_window_on_split_heads_matches_the_reference(mesh_ranks, case):
    """Each rank's rows' prefill and decode logits against the reference's
    and the port's unsharded ones; each rank's pool holds ``ceil(P / m)``
    pages a row of the window's ring of ``P`` pages; every row is some
    rank's, and each row's ``pos`` went past the ring's wrap (a carried
    ring's, past the page boundary at 524288)."""
    _, cfg = _configs(case)
    _, _, data, model, window, prompt, n_steps = CASES[case]
    assert steps.splits_heads(cfg, model)
    _, _, _, ref_logits, port_logits, _ = _unsharded(case)
    covered = set()
    for out in mesh_ranks(case):
        lo, hi = out["rows"]
        covered.update(range(lo, hi))
        pages = sh.seq_pages(-(-window // 16), model)
        assert tuple(out["pool"][1:3]) == ((hi - lo) * pages, 16)
        if prompt:
            n = prompt + (cfg.n_vision_tokens if cfg.arch_type == "vlm" else 0)
            assert n > window and n + n_steps > model * pages * 16
        else:
            n = CARRY_POS
            assert n // 16 < 524288 // 16 <= (n + n_steps - 1) // 16
        assert (out["pos"] == n + n_steps).all()
        keys = ["prefill"] * bool(prompt) + [f"decode{j}" for j in range(n_steps)]
        for i, key in enumerate(keys):
            np.testing.assert_allclose(out[key], ref_logits[i][lo:hi], atol=REF_TOL,
                                       rtol=REF_TOL, err_msg=f"{key} vs the reference")
            np.testing.assert_allclose(out[key], port_logits[i][lo:hi], atol=PORT_TOL,
                                       rtol=PORT_TOL, err_msg=f"{key} vs the port")
    assert covered == set(range(B))


def test_in_the_one_page_window_some_ranks_hold_none():
    """The one-page case's decode positions (24 .. 67 on 1 x 4): at each, the
    window's 16 positions lie on one or two of the four ranks' pages, so two
    or three ranks give an empty partial, and at the steps where the window
    is one whole page three do."""
    _, _, _, m, window, prompt, n_steps = CASES["llama-70b-1x4-one-page"]
    empty = []
    for pos in range(prompt, prompt + n_steps):
        held = [sh.seq_local_length(pos + 1, r, m, 16) -
                sh.seq_local_length(pos + 1 - window, r, m, 16) for r in range(m)]
        assert sum(held) == window
        empty.append(held.count(0))
    assert set(empty) == {2, 3} and empty.count(3) >= 2
