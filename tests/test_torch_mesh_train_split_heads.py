"""The sharded train step where the model axis splits the attention heads
(``launch.steps.splits_heads``), in gloo processes on the CPU, as
``tests/test_torch_mesh_train.py`` runs it on whole heads: three float32
steps against the reference's jitted unsharded ``make_train_step``
(``TOL``) and the port's unsharded one (``PORT_TOL``), the loss, the
gradient norm, and the parameters and AdamW moments gathered back to the
global trees after each step.

A rank holds the reference's column blocks of ``wq``/``wk``/``wv`` and rows
of ``wo``, gathers q, k and v whole (``layers.gather_columns``) and runs the
attention over the heads its ``wo`` rows overlap; the gather's backward sums
the gathered gradients over the model axis and keeps the rank's columns.
llama-8b's smoke config (4 heads over 2 KV heads) on 1 x 4 gives each rank
one head and half a KV head, read by two ranks; yi-34b's (7 heads over one
KV head) on 1 x 2 cuts a head in the middle (3.5 a rank), on 2 x 2 also
with ZeRO-1, two microbatches and a loss mask; internvl2-2b's on 1 x 4
carries its 16 vision positions in front; 9 heads over 3 KV heads on 1 x 2
give rank 0 4.5 heads that straddle two KV heads' groups, which the
attention reads one a head (an advanced index, whose backward adds into the
shared KV head). Remat runs the gather again inside the backward on every
rank. Also: ``gather_columns``' gradient on two ranks against the
unsharded ``x @ W``'s, float64."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_mesh_train import check_train_case, mesh_ranks_of

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
RANK_TIMEOUT_S = 90

# 9 heads over 3 KV heads (group 3) of 32 on 1 x 2, as
# tests/test_torch_mesh_split_heads.py's STRADDLE
STRADDLE = "llama-70b/H9/K3/D288"

CASES = {  # id: (arch, data, model, zero_opt, remat, microbatch, loss_mask)
    "llama-8b-1x4": ("llama-8b", 1, 4, False, True, 0, False),
    "yi-34b-1x2": ("yi-34b", 1, 2, False, True, 0, False),
    "yi-34b-2x2-zero-microbatch-loss-mask": ("yi-34b", 2, 2, True, True, 2, True),
    "internvl2-2b-1x4": ("internvl2-2b", 1, 4, False, True, 0, False),
    "straddle-1x2": (STRADDLE, 1, 2, False, True, 0, False),
}


# the case whose parameters may stand beyond PORT_TOL of the port's
# unsharded step where the float64 witness holds (check_train_case): one
# element of a ``wk`` whose float64 gradient is 3.83e-8 before the clip,
# under Adam's eps after it, which the unsharded float32 sum takes as 8.37e-8
# and the sharded one nearer 3.83e-8, so the two runs move it 0.14 lr apart
WITNESSED = ("straddle-1x2",)


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    return mesh_ranks_of(CASES, tmp_path_factory)


@pytest.mark.parametrize("case", list(CASES))
def test_split_heads_train_steps_match_the_reference(mesh_ranks, case):
    check_train_case(CASES, mesh_ranks, case, witnessed=WITNESSED)


# ------------------------------------------------------------ the gather's gradient

T, D = 6, 8
WIDTHS = (6, 4, 4)   # each rank's columns of wq, wk and wv

# one rank: its column blocks of three weights, ``gather_columns`` of the
# replicated x, and a loss of its own over the gathered tensors (rank 1's
# reads no v: its gradient there is zero); writes its gradients
GATHER_RANK = r"""
import datetime, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.launch.mesh import close_mesh, make_local_mesh
from repro_torch.launch.steps import on_model_axis
from repro_torch.models import layers, runtime_flags

rank, work = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{work}/store", world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
mesh = make_local_mesh(2, backend="cpu")
data = np.load(f"{work}/gather.npz")
x = torch.from_numpy(data["x"]).requires_grad_(True)
ws = []
for name in ("wq", "wk", "wv"):
    c = data[name].shape[1] // 2
    ws.append(torch.from_numpy(data[name][:, rank * c:(rank + 1) * c]).requires_grad_(True))
with on_model_axis(runtime_flags.ModelAxis.of(mesh, 2)):
    q, k, v = layers.gather_columns(layers.copy_to_model_axis(x), *ws)
    loss = (q * torch.from_numpy(data[f"dq{rank}"])).sum() + \
        (k * torch.from_numpy(data[f"dk{rank}"])).sum()
    if rank == 0:
        loss = loss + (v * torch.from_numpy(data["dv0"])).sum()
    loss.backward()
np.savez(f"{work}/gather{rank}.npz", q=q.detach().numpy(), k=k.detach().numpy(),
         v=v.detach().numpy(), dx=x.grad.numpy(), **{f"d{n}": w.grad.numpy()
                                                     for n, w in zip(("wq", "wk", "wv"), ws)})
close_mesh()
"""


def test_the_gathered_columns_gradient_is_the_unsharded_products(tmp_path):
    """``gather_columns(x, wq_r, wk_r, wv_r)`` on two ranks: the outputs are
    the unsharded ``x @ W``, each rank's weight gradients its columns of the
    unsharded ones, and its input gradient (after ``copy_to_model_axis``'s
    sum) the whole one, for the sum of the two ranks' losses, each of which
    reads every column of the gathered tensors (as two ranks read a shared
    head) and only rank 0's reads v; float64, within 1e-12."""
    rng = np.random.default_rng(2)
    arrays = {"x": rng.standard_normal((T, D))}
    for name, c in zip(("wq", "wk", "wv"), WIDTHS):
        arrays[name] = rng.standard_normal((D, 2 * c))
    for r in range(2):
        arrays[f"dq{r}"] = rng.standard_normal((T, 2 * WIDTHS[0]))
        arrays[f"dk{r}"] = rng.standard_normal((T, 2 * WIDTHS[1]))
    arrays["dv0"] = rng.standard_normal((T, 2 * WIDTHS[2]))
    np.savez(tmp_path / "gather.npz", **arrays)
    leaves = {k: torch.from_numpy(arrays[k]).requires_grad_(True)
              for k in ("x", "wq", "wk", "wv")}
    q, k, v = (leaves["x"] @ leaves[n] for n in ("wq", "wk", "wv"))
    loss = sum((q * torch.from_numpy(arrays[f"dq{r}"])).sum() +
               (k * torch.from_numpy(arrays[f"dk{r}"])).sum() for r in range(2))
    (loss + (v * torch.from_numpy(arrays["dv0"])).sum()).backward()

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", GATHER_RANK, str(r), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=RANK_TIMEOUT_S)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, err in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    for r in range(2):
        out = np.load(tmp_path / f"gather{r}.npz")
        for name, got in (("q", q), ("k", k), ("v", v)):
            np.testing.assert_allclose(out[name], got.detach().numpy(), rtol=1e-12,
                                       atol=1e-12, err_msg=name)
        np.testing.assert_allclose(out["dx"], leaves["x"].grad.numpy(), rtol=1e-12,
                                   atol=1e-12)
        for name, c in zip(("wq", "wk", "wv"), WIDTHS):
            np.testing.assert_allclose(out[f"d{name}"],
                                       leaves[name].grad.numpy()[:, r * c:(r + 1) * c],
                                       rtol=1e-12, atol=1e-12, err_msg=name)
