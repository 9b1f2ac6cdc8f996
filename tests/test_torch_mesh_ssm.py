"""The ssm family on a device mesh, in gloo processes on the CPU:
mamba2-1.3b's smoke config (8 SSM heads) through ``launch.steps.sharded_step``'s
prefill and decode on 1 x 2, 2 x 2 and 1 x 4 against the reference's
unsharded ``Model.prefill`` / ``decode_step`` (``REF_TOL``) and the port's
unsharded steps (``PORT_TOL``), as ``tests/test_torch_mesh.py`` runs the
dense family; the rank layout of the Mamba2 leaves (``params.ssm_layout``:
a rank's z, x and dt columns of ``w_in``, B and C whole) through
``shard_params`` and back through ``gather_params`` for the ssm, hybrid and
audio families on 2 x 2 ranks; and ``check_mesh_runs`` refusing a model axis
that splits an SSM head. The hybrid and audio families' serving runs are
``tests/test_torch_mesh_hybrid.py``'s and ``tests/test_torch_mesh_audio.py``'s."""
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import steps
from repro_torch.launch.mesh import MeshShape
from test_torch_mesh import check_sharded_serving

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
RANK_TIMEOUT_S = 120


@pytest.mark.parametrize("data_axis,model_axis", [(1, 2), (2, 2), (1, 4)],
                         ids=["1x2", "2x2", "1x4"])
def test_sharded_ssm_prefill_and_decode_match_the_reference(tmp_path, data_axis, model_axis):
    check_sharded_serving(tmp_path, "mamba2-1.3b", data_axis, model_axis)


# each rank: every family's smoke tree (zamba2 with two groups, whisper with
# an odd vocabulary) cut by shard_params, its pieces' shapes those of
# rank_leaves and of init_opt_shard's moments, the same pieces drawn by
# init_shard, and gather_params giving back the whole tree bit for bit
ROUND_TRIP = r"""
import datetime, sys
import torch, torch.distributed as dist
from repro_torch import params as P
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import close_mesh, make_local_mesh, mesh_coords
from repro_torch.models import Model
from repro_torch.training import tree

rank, work = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{work}/store", world_size=4, rank=rank,
                        timeout=datetime.timedelta(seconds=100))
mesh = make_local_mesh(2, backend="cpu")
coords = mesh_coords(mesh)
for arch, kw in (("mamba2-1.3b", {}), ("zamba2-2.7b", {"n_layers": 4}),
                 ("whisper-base", {"vocab_size": 513})):
    cfg = get_smoke_config(arch).with_(dtype="float32", **kw)
    whole = Model(cfg).init(torch.Generator().manual_seed(5), device="cpu")
    mine = P.shard_params(whole, mesh, coords)
    drawn = P.init_shard(cfg, torch.Generator().manual_seed(5), mesh, coords, device="cpu")
    leaves, _ = P.rank_leaves(cfg, mesh, zero=True)
    moments = tree.leaves(P.init_opt_shard(cfg, mesh, zero=True, device="cpu").mu)
    for j, (a, b, rl, mu) in enumerate(zip(tree.leaves(mine), tree.leaves(drawn), leaves,
                                           moments)):
        assert torch.equal(a, b), (arch, j)
        assert tuple(a.shape) == rl.shape, (arch, j, a.shape, rl.shape)
        want = tuple(n // 2 if i == rl.zero_dim else n for i, n in enumerate(rl.shape))
        assert tuple(mu.shape) == want, (arch, j, mu.shape, want)
    back = P.gather_params(mine, cfg, mesh)
    for j, (a, b) in enumerate(zip(tree.leaves(back), tree.leaves(whole))):
        assert torch.equal(a, b), (arch, j)
    lay = mine.get("layers", {})
    if "w_in" in lay:   # the rank's columns: z, x, B, C, dt
        di, N, H = cfg.d_inner, cfg.ssm.state_dim, cfg.n_ssm_heads
        r, w = coords["model"], whole["layers"]["w_in"]
        cols = torch.cat([torch.arange(r * di // 2, (r + 1) * di // 2),
                          di + torch.arange(r * di // 2, (r + 1) * di // 2),
                          torch.arange(2 * di, 2 * di + 2 * N),
                          2 * di + 2 * N + torch.arange(r * H // 2, (r + 1) * H // 2)])
        assert torch.equal(lay["w_in"], w[..., cols]), arch
print("ok", rank)
close_mesh()
"""


def test_the_rank_layout_round_trips_for_the_ssm_hybrid_and_audio_families(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", ROUND_TRIP, str(r), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    results = []
    try:
        for p in procs:
            results.append((p.returncode, *p.communicate(timeout=RANK_TIMEOUT_S)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, out, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
        assert out.startswith("ok"), out


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_a_model_axis_that_does_not_divide_the_ssm_heads_raises(kind):
    """mamba2-1.3b's smoke config at d_model 96 has 6 SSM heads of 32
    channels: a model axis of 2 holds 3 a rank, one of 4 would split one."""
    cfg = get_smoke_config("mamba2-1.3b").with_(d_model=96)
    assert cfg.n_ssm_heads == 6
    assert steps.local_config(cfg, {"data": 1, "model": 2}).n_ssm_heads == 3
    with pytest.raises(NotImplementedError, match="n_ssm_heads"):
        steps.sharded_step(cfg, InputShape("s", 32, 4, kind),
                           MeshShape((1, 4), ("data", "model")))
