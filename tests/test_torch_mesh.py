"""The sharded prefill and decode steps (``launch.steps.sharded_step``) in
gloo processes on the CPU, against the reference's unsharded
``Model.prefill`` / ``decode_step`` and the port's unsharded steps on the
same parameters (the reference's, carried over by ``params.from_reference``
and cut by ``params.shard_params``), float32.

Each rank is a process of its own (``python -c``), as the reference's own
sharding test runs its mesh in a subprocess: the ranks meet at a ``file://``
store under the test's ``tmp_path`` (no port to clash between the test
workers), and every wait has a timeout. llama-70b's smoke config runs on
1 x 2 and 2 x 2; on 1 x 4 with 8 heads and 4 KV heads, so that the model
axis divides them; internvl2-2b's (16 vision embeddings in front of the
prompt) on 2 x 2. A model axis that splits the heads is
``tests/test_torch_mesh_split_heads.py``'s. The MoE family's runs are
``tests/test_torch_mesh_moe.py``'s, the ssm, hybrid and audio families'
``tests/test_torch_mesh_ssm.py``'s."""
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

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro_torch import params as port_params
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import steps
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import Model

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
B, S, DECODE_STEPS = 4, 24, 4
# the sharded steps against the reference: tests/test_torch_model.py's
# float32 tolerance; against the port's unsharded steps, tighter: the same
# kernels' plain versions, the partial sums added in another order
REF_TOL = 2e-4
PORT_TOL = 2e-5
RANK_TIMEOUT_S = 180

# one rank: the carried-over parameters cut to its shards, the sharded
# prefill, then DECODE_STEPS decode steps fed the tokens the parent gives
# (the reference's greedy ones); writes its rows' logits
RANK = r"""
import datetime, json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import params as P
from repro_torch.configs.base import InputShape, ModelConfig, MoEConfig, SSMConfig
from repro_torch.launch import steps
from repro_torch.launch.mesh import close_mesh, make_local_mesh, mesh_coords

rank, world, model_axis, work = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{work}/store", world_size=world,
                        rank=rank, timeout=datetime.timedelta(seconds=120))
spec = json.load(open(f"{work}/spec.json"))
if spec["cfg"].get("moe"):
    spec["cfg"]["moe"] = MoEConfig(**spec["cfg"]["moe"])
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
coords = mesh_coords(mesh)
params = P.shard_params(P.from_reference(tree, cfg, device="cpu"), mesh, coords)
B, S, cap = spec["B"], spec["S"], spec["cap"]
prefill, _ = steps.sharded_step(cfg, InputShape("p", cap, B, "prefill"), mesh)
decode, _ = steps.sharded_step(cfg, InputShape("d", cap, B, "decode"), mesh)
batch = {"tokens": torch.from_numpy(data["tokens"]).long()}
for key in ("vision", "frames"):
    if key in data.files:
        batch[key] = torch.from_numpy(data[key])
logits, cache = prefill(params, batch)
out = {"prefill": logits.numpy()}
for i, tok in enumerate(data["feed"]):
    logits, cache = decode(params, torch.from_numpy(tok).long()[:, None], cache)
    out[f"decode{i}"] = logits.numpy()
rows = steps.batch_rows(mesh, B)
np.savez(f"{work}/rank{rank}.npz", rows=np.array([rows.start, rows.stop]), **out)
print(json.dumps({"rank": rank, "coords": coords}))
close_mesh()
"""


class RankZero(MeshShape):
    """Rank 0 of a live mesh of ``shape`` as far as ``sharded_step`` reads it
    while it builds a step: the axes' sizes and this rank's coordinates; no
    process group (building the step runs no collective)."""

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def get_group(self, name: str):
        return None

    def get_local_rank(self, name: str) -> int:
        return 0


def _flat(tree, prefix="param"):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


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
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, out, err in results:
        assert rc == 0, err[-3000:]
    return [np.load(work / f"rank{r}.npz") for r in range(world)]


@pytest.mark.parametrize("arch,data_axis,model_axis",
                         [("llama-70b", 1, 2), ("llama-70b", 2, 2), ("llama-70b", 1, 4),
                          ("internvl2-2b", 2, 2)],
                         ids=["1x2", "2x2", "1x4", "vlm-2x2"])
def test_sharded_prefill_and_decode_match_the_reference(tmp_path, arch, data_axis,
                                                        model_axis):
    check_sharded_serving(tmp_path, arch, data_axis, model_axis)


def check_sharded_serving(tmp_path, arch, data_axis, model_axis, *, batch=B,
                          configure=None):
    """``arch``'s smoke config on a ``data_axis`` x ``model_axis`` mesh of
    gloo ranks against the reference and the port unsharded, over ``batch``
    sequences (also ``tests/test_torch_mesh_moe.py``'s and
    ``tests/test_torch_mesh_ssm.py``'s). ``configure(cfg)`` changes both
    packages' configs alike; a dense model on a model axis of 4 gets 8 heads
    over 4 KV heads."""
    heads = {"n_heads": 8, "n_kv_heads": 4} \
        if model_axis == 4 and arch in ("llama-70b", "internvl2-2b") else {}
    configure = configure or (lambda c: c)
    rcfg = configure(ref_smoke_config(arch).with_(dtype="float32", **heads))
    cfg = configure(get_smoke_config(arch).with_(dtype="float32", **heads))
    B = batch
    ref_model = RefModel(rcfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    as_numpy = jax.tree.map(np.asarray, ref_params)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    inputs = {"tokens": toks}
    if cfg.arch_type == "vlm":
        inputs["vision"] = rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_model),
                                               dtype=np.float32)
    if cfg.arch_type == "audio":
        inputs["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model),
                                               dtype=np.float32)
    cap = S + cfg.n_vision_tokens + 16

    # the reference, greedy; its tokens are what every run is fed
    want, rcache = ref_model.prefill(ref_params, jax.tree.map(jnp.asarray, inputs),
                                     cache_len=cap, dtype=jnp.float32)
    ref_logits, feed = [np.asarray(want)], []
    for _ in range(DECODE_STEPS):
        tok = np.array(jnp.argmax(want, -1), np.int32)
        feed.append(tok)
        want, rcache = ref_model.decode_step(ref_params, jnp.asarray(tok)[:, None], rcache)
        ref_logits.append(np.asarray(want))

    # the port unsharded, fed the same tokens
    params = port_params.from_reference(as_numpy, cfg, device="cpu")
    model = Model(cfg)
    batch = {k: torch.from_numpy(v) for k, v in inputs.items()}
    batch["tokens"] = batch["tokens"].long()
    got, cache = model.prefill(params, batch, cache_len=cap, dtype=torch.float32)
    port_logits = [got.numpy()]
    for tok in feed:
        got, cache = model.decode_step(params, torch.from_numpy(tok).long()[:, None], cache)
        port_logits.append(got.numpy())

    np.savez(tmp_path / "inputs.npz", feed=np.stack(feed), **inputs,
             **dict(_flat(as_numpy)))
    config = {k: v for k, v in cfg.__dict__.items() if k not in ("moe", "ssm")}
    if cfg.is_moe:
        config["moe"] = cfg.moe.__dict__
    config["ssm"] = cfg.ssm.__dict__
    (tmp_path / "spec.json").write_text(json.dumps(
        {"cfg": config, "B": B, "S": S, "cap": cap}))
    world = data_axis * model_axis
    ranks = _run_ranks(tmp_path, world, model_axis)

    covered = set()
    for out in ranks:
        lo, hi = out["rows"]
        covered.update(range(lo, hi))
        assert hi - lo == B // data_axis
        for i, key in enumerate(["prefill"] + [f"decode{j}" for j in range(DECODE_STEPS)]):
            np.testing.assert_allclose(out[key], ref_logits[i][lo:hi], atol=REF_TOL,
                                       rtol=REF_TOL, err_msg=f"{key} vs the reference")
            np.testing.assert_allclose(out[key], port_logits[i][lo:hi], atol=PORT_TOL,
                                       rtol=PORT_TOL, err_msg=f"{key} vs the port")
    assert covered == set(range(B))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_a_model_axis_that_does_not_divide_the_kv_heads_runs(kind):
    """llama-70b's smoke config has 2 KV heads: a model axis of 4 splits
    them, the reference's sequence-sharded placement, which the sharded
    prefill and decode steps now run (tests/test_torch_mesh_split_heads.py
    holds them to the reference): ``sharded_step`` builds the step of
    ``kind`` on rank 0 of 1 x 4, whose parameters keep the heads whole, 32
    columns of ``wq`` (one head of 32) and 16 of ``wk`` / ``wv`` (half a KV
    head), and whose decode pool holds every KV head at a quarter of each
    row's pages."""
    cfg = get_smoke_config("llama-70b")
    sizes = {"data": 1, "model": 4}
    steps.check_mesh_runs(cfg, sizes)
    lcfg = steps.local_config(cfg, sizes)
    assert (lcfg.n_heads, lcfg.n_kv_heads) == (4, 2)
    assert (lcfg.q_cols, lcfg.kv_cols, lcfg.kv_shards) == (32, 16, 4)
    fn, args = steps.sharded_step(cfg, InputShape("s", 32 * 16, 4, kind),
                                  RankZero((1, 4), ("data", "model")))
    attn = args[0]["layers"]["attn"]
    assert callable(fn) and tuple(attn["wq"].shape) == (2, cfg.d_model, 32)
    assert tuple(attn["wk"].shape) == tuple(attn["wv"].shape) == (2, cfg.d_model, 16)
    if kind == "decode":
        assert tuple(args[2]["k"].shape) == (2, 4 * 8, 16, 2, 32)


def test_the_sharded_train_step_raises():
    """The train step runs every family on a mesh whose model axis divides
    its heads (tests/test_torch_mesh_train.py, tests/test_torch_mesh_train_ssm.py);
    mamba2-1.3b's smoke config has 8 SSM heads, which a model axis of 16
    would split."""
    cfg = get_smoke_config("mamba2-1.3b")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        steps.sharded_step(cfg, InputShape("t", 32, 4, "train"),
                           MeshShape((1, 16), ("data", "model")))


def _moe_with_expert_d_ff(arch, d_ff):
    cfg = get_smoke_config(arch)
    return cfg.with_(moe=dataclasses.replace(cfg.moe, d_ff=d_ff))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "qwen2-moe-a2.7b", "zamba2-2.7b",
                                  "whisper-base"])
def test_families_without_a_mesh_plan_raise(arch):
    """The ssm and hybrid families run on a mesh whose model axis divides
    their SSM heads and attention heads, and raise on one of 16, which
    splits their smoke configs' 8 SSM or 4 attention heads; the audio
    family runs on split heads too, and raises on a model axis of 3, which
    divides neither its smoke config's 4 heads nor their 128 columns (the
    reference replicates the projections there); an MoE model runs on a
    mesh whose model axis divides its experts' d_ff, and raises where it
    does not (the reference's expert-parallel fallback)."""
    cfg, sizes = get_smoke_config(arch), {"data": 1, "model": 16}
    if cfg.is_moe:
        cfg, sizes = _moe_with_expert_d_ff(arch, 66), {"data": 1, "model": 4}
    if cfg.arch_type == "audio":
        sizes = {"data": 1, "model": 3}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        steps.local_config(cfg, sizes)


def test_an_moe_local_config_cuts_the_experts_d_ff():
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    local = steps.local_config(cfg, {"data": 2, "model": 2})
    assert local.moe.d_ff == cfg.moe.d_ff // 2
    assert local.moe.n_experts == cfg.moe.n_experts
    assert (local.n_heads, local.n_kv_heads) == (cfg.n_heads // 2, cfg.n_kv_heads // 2)
