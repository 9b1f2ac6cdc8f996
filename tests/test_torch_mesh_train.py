"""The sharded train step (``launch.steps.sharded_step`` for a train shape)
in gloo processes on the CPU, against the reference's jitted unsharded
``make_train_step`` and the port's unsharded one, on the same parameters
(the reference's, carried over by ``params.from_reference`` and cut by
``params.shard_params``) and the same batches, float32, three steps.

After each step the loss and the gradient norm, and the parameters and the
AdamW moments gathered back to the global trees (``params.gather_params``,
``gather_opt_state``), are held against the reference within
``tests/test_torch_training.py``'s ``TOL``, and against the port's
unsharded step within ``PORT_TOL``; the leaves that a rank holds whole (the
norms, an unsharded embedding) must be the same bits on every rank of a
data block. Each rank is a ``python -c`` process meeting the others at a
``file://`` store under ``tmp_path``, as ``tests/test_torch_mesh.py`` runs
them; every wait has a timeout.

One property of the comparison, not of the step: Adam divides the
gradient by its running magnitude, so an element whose clipped gradient is
near ``eps`` (1e-8) turns float32 noise of the order in which its sums are
taken into a parameter change of up to ``lr``. The tied head's rows of
tokens no batch targets get such gradients; the cases below stay inside
``TOL`` (microbatches and a loss mask together moved one element 3.1e-4 on
2 x 2, CHANGES.md)."""
import dataclasses
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
from repro.launch import steps as ref_steps
from repro.models import Model as RefModel
from repro.training import optimizer as ref_opt
from repro_torch import params as port_params
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import steps
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import Model
from repro_torch.training import tree
from repro_torch.training.optimizer import adamw_init

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
B, S, STEPS = 4, 16, 3
# against the reference: tests/test_torch_training.py's TOL; against the
# port's unsharded step: the loss and the norm to a few float32 roundings
# of their sums in another order, the trees to TOL's fifth (Adam's eps
# amplification, the module docstring)
TOL = 1e-4
PORT_TOL = 2e-5
# the parameters of a case against the port's unsharded step where PORT_TOL
# is beyond float32: with three experts on two ranks the whole router's
# gradient takes another order of sums, and two embedding elements whose
# gradients are float32 noise (-3.6e-8 unsharded, -2.2e-8 sharded; Adam's
# eps is 1e-8) move 0.09 lr apart, 2.8e-5 after step 0, 6.8e-5 after step 2
# (the module docstring). Loss, norm and moments stay at PORT_TOL
PARAM_PORT_TOL = {"qwen2-moe-3-experts-1x2": TOL}
# AdamW's defaults (training/optimizer.py), for the float64 step of
# ``check_train_case``'s witness
LR, B1, B2, ADAM_EPS, WEIGHT_DECAY = 3e-4, 0.9, 0.95, 1e-8, 0.1
RANK_TIMEOUT_S = 120

# one rank, for each case of its mesh in turn: the carried-over parameters
# cut to its shards, its blocks of a zero AdamW state, STEPS sharded train
# steps on the global batches; after each, the gathered trees (rank 0 writes
# them) and the metrics; its replicated leaves after the last
RANK = r"""
import datetime, json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import params as P
from repro_torch.configs.base import InputShape, ModelConfig, MoEConfig, SSMConfig
from repro_torch.launch import steps
from repro_torch.launch.mesh import close_mesh, make_local_mesh, mesh_coords
from repro_torch.training import tree

rank, world, model_axis, work = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{work}/store", world_size=world,
                        rank=rank, timeout=datetime.timedelta(seconds=100))
mesh = make_local_mesh(model_axis, backend="cpu")
coords = mesh_coords(mesh)
for case, spec in json.load(open(f"{work}/spec.json")).items():
    cfg = spec["cfg"]
    if cfg.get("moe"):
        cfg["moe"] = MoEConfig(**cfg["moe"])
    cfg["ssm"] = SSMConfig(**cfg["ssm"])
    cfg = ModelConfig(**cfg)
    data = np.load(f"{work}/{case}.npz")
    params = {}
    for key in data.files:
        if key.startswith("param/"):
            node = params
            *path, leaf = key.split("/")[1:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    params = P.shard_params(P.from_reference(params, cfg, device="cpu"), mesh, coords)
    zero = spec["zero"]
    opt = P.init_opt_shard(cfg, mesh, zero=zero, device="cpu")
    fn, _ = steps.sharded_step(cfg, InputShape("t", spec["S"], spec["B"], "train"), mesh,
                               remat=spec["remat"], zero_opt=zero,
                               microbatch=spec["microbatch"])
    out = {}
    for i in range(spec["steps"]):
        batch = {k.split("/")[1]: torch.from_numpy(data[k]) for k in data.files
                 if k.startswith(f"batch{i}/")}
        batch["tokens"] = batch["tokens"].long()
        params, opt, info = fn(params, opt, batch)
        out[f"loss{i}"], out[f"grad_norm{i}"] = float(info["loss"]), float(info["grad_norm"])
        gathered = P.gather_params(params, cfg, mesh)
        state = P.gather_opt_state(opt, cfg, mesh, zero=zero)
        for name, t in (("p", gathered), ("mu", state.mu), ("nu", state.nu)):
            for j, leaf in enumerate(tree.leaves(t)):
                if rank == 0:
                    out[f"{name}{i}/{j}"] = leaf.numpy()
    for j, (leaf, rl) in enumerate(zip(tree.leaves(params), P.rank_leaves(cfg, mesh)[0])):
        if not rl.on_model:
            out[f"replicated/{j}"] = leaf.numpy()
    np.savez(f"{work}/{case}_rank{rank}.npz",
             coords=np.array([coords["data"], coords["model"]]), **out)
print(json.dumps({"rank": rank, "coords": coords}))
close_mesh()
"""


def _flat(node, prefix):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def _config_json(cfg):
    out = {k: v for k, v in cfg.__dict__.items() if k not in ("moe", "ssm")}
    if cfg.is_moe:
        out["moe"] = cfg.moe.__dict__
    out["ssm"] = cfg.ssm.__dict__
    return out


def _batches(cfg, masked):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(STEPS):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
        if cfg.arch_type == "vlm":
            b["vision"] = rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_model),
                                              dtype=np.float32)
        if cfg.arch_type == "audio":
            b["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model),
                                              dtype=np.float32)
        if masked:
            b["loss_mask"] = (rng.random((B, S)) < 0.6).astype(np.float32)
        out.append(b)
    return out


def _configs(arch):
    """The reference's and the port's float32 smoke configs of ``arch``;
    ``"<arch>/E<n>"`` gives its MoE ``n`` routed experts, ``/L<n>`` ``n``
    layers, ``/V<n>`` a vocabulary of ``n``, ``/H<n>`` ``n`` heads, ``/K<n>``
    ``n`` KV heads, ``/D<n>`` a ``d_model`` of ``n``, ``/T<n>`` ``n`` encoder
    positions, ``/W<n>`` a sliding window of ``n``."""
    arch, *mods = arch.split("/")
    rcfg = ref_smoke_config(arch).with_(dtype="float32")
    cfg = get_smoke_config(arch).with_(dtype="float32")
    for mod in mods:
        n = int(mod[1:])
        if mod[0] == "E":
            rcfg = rcfg.with_(moe=dataclasses.replace(rcfg.moe, n_experts=n))
            cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, n_experts=n))
        else:
            key = {"L": "n_layers", "V": "vocab_size", "H": "n_heads", "K": "n_kv_heads",
                   "D": "d_model", "T": "enc_seq", "W": "sliding_window"}[mod[0]]
            rcfg, cfg = rcfg.with_(**{key: n}), cfg.with_(**{key: n})
    return rcfg, cfg


@functools.lru_cache(maxsize=None)
def _runs(arch, remat, microbatch, masked):
    """The reference's jitted step and the port's unsharded one over STEPS
    batches from the same parameters: each step's loss, norm and trees."""
    rcfg, cfg = _configs(arch)
    ref_params = RefModel(rcfg).init(jax.random.PRNGKey(0), dtype=jnp.float32)
    as_numpy = jax.tree.map(np.asarray, ref_params)
    batches = _batches(cfg, masked)
    ref_step = jax.jit(ref_steps.make_train_step(rcfg, remat=remat, microbatch=microbatch))
    port_step = steps.make_train_step(cfg, remat=remat, microbatch=microbatch)
    rp, ro = ref_params, ref_opt.adamw_init(ref_params)
    pp = port_params.from_reference(as_numpy, cfg, device="cpu")
    po = adamw_init(pp)
    ref, port = [], []
    for b in batches:
        rp, ro, rinfo = ref_step(rp, ro, {k: jnp.asarray(v) for k, v in b.items()})
        ref.append({"loss": float(rinfo["loss"]), "grad_norm": float(rinfo["grad_norm"]),
                    "trees": [np.asarray(x) for t in (rp, ro.mu, ro.nu)
                              for x in jax.tree.leaves(t)]})
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        tb["tokens"] = tb["tokens"].long()
        pp, po, info = port_step(pp, po, tb)
        port.append({"loss": float(info["loss"]), "grad_norm": float(info["grad_norm"]),
                     "trees": [x.numpy() for t in (pp, po.mu, po.nu) for x in tree.leaves(t)]})
    return cfg, as_numpy, batches, ref, port


@functools.lru_cache(maxsize=None)
def _float64_run(arch, remat, microbatch, masked):
    """The port's unsharded model in float64 from the same parameters and
    batches, stepped by AdamW's defaults in float64: after each step, the
    gradients as the optimizer took them (clipped to a global norm of 1)
    and the parameters."""
    _, cfg = _configs(arch)
    cfg = cfg.with_(dtype="float64")
    model = Model(cfg)
    _, as_numpy, batches, _, _ = _runs(arch, remat, microbatch, masked)
    flat, treedef = tree.flatten(port_params.from_reference(as_numpy, cfg, device="cpu",
                                                            dtype=torch.float64))
    mu = [torch.zeros_like(p) for p in flat]
    nu = [torch.zeros_like(p) for p in flat]
    out = []
    for t, b in enumerate(batches, 1):
        parts = max(microbatch, 1)
        tb = {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v).double()
              for k, v in b.items()}
        grads = None
        for i in range(parts):
            sub = {k: v.reshape(parts, -1, *v.shape[1:])[i] for k, v in tb.items()}
            _, g = steps.loss_and_grads(model, tree.unflatten(treedef, flat), sub, remat=remat)
            grads = g if grads is None else [a + c for a, c in zip(grads, g)]
        grads = [g / parts for g in grads]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        grads = [g * min(1.0, 1.0 / (float(norm) + 1e-9)) for g in grads]
        mu = [B1 * m + (1 - B1) * g for m, g in zip(mu, grads)]
        nu = [B2 * v + (1 - B2) * g * g for v, g in zip(nu, grads)]
        flat = [p - LR * ((m / (1 - B1 ** t)) / (torch.sqrt(v / (1 - B2 ** t)) + ADAM_EPS)
                          + WEIGHT_DECAY * p) for p, m, v in zip(flat, mu, nu)]
        out.append({"grads": [g.numpy() for g in grads], "params": [p.numpy() for p in flat]})
    return out


def _witness(case, arch_spec, i, j, got, port, eps_factor=1.0):
    """The elements of parameter leaf ``j`` after step ``i`` where the
    sharded run (``got``) stands beyond ``PORT_TOL`` of the port's unsharded
    one (``port``): each must have had a clipped gradient under
    ``eps_factor`` times Adam's eps at this step or an earlier one in the
    float64 run, and lie at least as near the float64 run's parameter as the
    unsharded float32 run does. Returns the mask of those elements."""
    arch, _, _, _, remat, microbatch, masked = arch_spec
    beyond = np.abs(got - port) > PORT_TOL + PORT_TOL * np.abs(port)
    if not beyond.any():
        return beyond
    exact = _float64_run(arch, remat, microbatch, masked)
    smallest = np.min([np.abs(exact[k]["grads"][j][beyond]) for k in range(i + 1)], axis=0)
    where = f"{case}: step {i} leaf {j} at {np.argwhere(beyond).tolist()}"
    assert (smallest < eps_factor * ADAM_EPS).all(), \
        f"{where}: clipped float64 gradients {smallest} are not under {eps_factor} x Adam's eps"
    want = exact[i]["params"][j][beyond]
    assert (np.abs(got[beyond] - want) <= np.abs(port[beyond] - want)).all(), \
        (f"{where}: sharded {got[beyond]} lies farther from the float64 step {want} than "
         f"the unsharded {port[beyond]}")
    return beyond


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


CASES = {  # id: (arch, data, model, zero_opt, remat, microbatch, loss_mask)
    "1x2": ("llama-8b", 1, 2, False, True, 0, False),
    "2x1": ("llama-8b", 2, 1, False, True, 0, False),
    "2x2": ("llama-8b", 2, 2, False, True, 0, False),
    "2x2-zero": ("llama-8b", 2, 2, True, True, 0, False),
    "2x2-no-remat": ("llama-8b", 2, 2, False, False, 0, False),
    "2x2-microbatch": ("llama-8b", 2, 2, True, True, 2, False),
    "2x2-loss-mask": ("llama-8b", 2, 2, False, True, 0, True),
    "vlm-2x2": ("internvl2-2b", 2, 2, False, True, 0, False),
    "qwen2-moe-2x2": ("qwen2-moe-a2.7b", 2, 2, True, True, 0, False),
    "deepseek-moe-2x2": ("deepseek-moe-16b", 2, 2, False, True, 0, False),
    # three experts on a model axis of 2: the router stays whole on each rank
    "qwen2-moe-3-experts-1x2": ("qwen2-moe-a2.7b/E3", 1, 2, False, True, 0, False),
}


def mesh_ranks_of(cases, tmp_path_factory):
    """``run(case)``: the ranks' records of ``case`` of ``cases`` (a dict as
    ``CASES``). The first case of a mesh shape runs every case of that
    shape in one set of rank processes."""
    done = {}

    def run(case):
        shape = cases[case][1:3]
        if shape not in done:
            work = tmp_path_factory.mktemp("x".join(map(str, shape)))
            specs = {}
            for name, (arch, data, model, zero, remat, microbatch, masked) in cases.items():
                if (data, model) != shape:
                    continue
                cfg, as_numpy, batches, _, _ = _runs(arch, remat, microbatch, masked)
                np.savez(work / f"{name}.npz", **dict(_flat(as_numpy, "param")),
                         **{f"batch{i}/{k}": v for i, b in enumerate(batches)
                            for k, v in b.items()})
                specs[name] = {"cfg": _config_json(cfg), "B": B, "S": S, "steps": STEPS,
                               "zero": zero, "remat": remat, "microbatch": microbatch}
            (work / "spec.json").write_text(json.dumps(specs))
            _run_ranks(work, shape[0] * shape[1], shape[1])
            done[shape] = work
        return [np.load(done[shape] / f"{case}_rank{r}.npz")
                for r in range(shape[0] * shape[1])]
    return run


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    return mesh_ranks_of(CASES, tmp_path_factory)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_train_steps_match_the_reference(mesh_ranks, case):
    check_train_case(CASES, mesh_ranks, case)


def check_train_case(cases, mesh_ranks, case, witnessed=(), eps_factor=1.0):
    """``case`` of ``cases`` (a dict as ``CASES``) against the reference and
    the port unsharded (also ``tests/test_torch_mesh_train_ssm.py``'s).
    Where ``case`` is in ``witnessed``, a parameter element beyond
    ``PORT_TOL`` of the port's unsharded step passes only on the float64
    witness of ``_witness`` (Adam's eps amplification, the module
    docstring; ``eps_factor`` its bound on the float64 gradient, in Adam's
    eps); every element stays within ``TOL`` of the reference."""
    arch, _, _, _, remat, microbatch, masked = cases[case]
    _, as_numpy, _, ref, port = _runs(arch, remat, microbatch, masked)
    ranks = mesh_ranks(case)

    first = ranks[0]
    for i in range(STEPS):
        for rank in ranks:   # the metrics are the global batch's on every rank
            assert rank[f"loss{i}"] == first[f"loss{i}"]
            assert rank[f"grad_norm{i}"] == first[f"grad_norm{i}"]
        for key in ("loss", "grad_norm"):
            got = float(first[f"{key}{i}"])
            np.testing.assert_allclose(got, ref[i][key], atol=TOL, rtol=TOL,
                                       err_msg=f"step {i} {key} vs the reference")
            np.testing.assert_allclose(got, port[i][key], atol=PORT_TOL, rtol=PORT_TOL,
                                       err_msg=f"step {i} {key} vs the port")
        got = [first[f"{name}{i}/{j}"] for name in ("p", "mu", "nu")
               for j in range(len(tree.leaves(as_numpy)))]
        assert len(got) == len(ref[i]["trees"])
        n_params = len(tree.leaves(as_numpy))
        for j, (g, r, p) in enumerate(zip(got, ref[i]["trees"], port[i]["trees"])):
            np.testing.assert_allclose(g, r, atol=TOL, rtol=TOL,
                                       err_msg=f"step {i} leaf {j} vs the reference")
            tol = PARAM_PORT_TOL.get(case, PORT_TOL) if j < n_params else PORT_TOL
            if j < n_params and case in witnessed:
                keep = ~_witness(case, cases[case], i, j, g, p, eps_factor)
                g, p = g[keep], p[keep]
            np.testing.assert_allclose(g, p, atol=tol, rtol=tol,
                                       err_msg=f"step {i} leaf {j} vs the port")

    # the leaves a rank holds whole: the same bits across each data block
    by_block = {}
    for rank in ranks:
        by_block.setdefault(int(rank["coords"][0]), []).append(rank)
    for block in by_block.values():
        keys = [k for k in block[0].files if k.startswith("replicated/")]
        assert keys
        for other in block[1:]:
            for k in keys:
                np.testing.assert_array_equal(other[k], block[0][k], err_msg=k)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b", "whisper-base"])
def test_the_sharded_train_step_refuses_the_other_families(arch):
    """The ssm and hybrid families train on a mesh whose model axis divides
    their heads (tests/test_torch_mesh_train_ssm.py); their smoke configs'
    8 SSM heads on a model axis of 16 would split a head, which the step
    refuses. The audio family trains on split heads too
    (tests/test_torch_mesh_audio_split_heads.py), and is refused on a model
    axis of 3, which divides neither its smoke config's 4 heads nor their
    128 columns."""
    model = 3 if arch == "whisper-base" else 16
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        steps.sharded_step(get_smoke_config(arch), InputShape("t", 32, 4, "train"),
                           MeshShape((2, model), ("data", "model")))


def test_a_model_axis_that_does_not_divide_the_experts_d_ff_raises():
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, d_ff=66))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        steps.local_config(cfg, {"data": 1, "model": 4})
