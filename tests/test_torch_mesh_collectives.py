"""The model axis's pair of autograd collectives (``models/layers.py``:
``reduce_model_axis``, ``copy_to_model_axis``) on two gloo ranks on the CPU:
a column- then row-parallel SwiGLU FFN's input and weight gradients against
the unsharded FFN's ``torch.autograd``, float64, and the reduction leaving
its argument as it was; and ``sum_model_axis`` (an ``all_reduce`` both
ways), the Mamba2 block's gated norm over a width the ranks split, against
the unsharded norm's gradient, where a one-way reduction gives each rank a
wrong one; ``row_parallel`` in bfloat16, whose sum is rounded once; and
``launch.mesh.close_mesh``, with which every rank here ends. Each rank is a
``python -c`` process meeting the other at a ``file://`` store under
``tmp_path``; every wait has a timeout."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
RANK_TIMEOUT_S = 90
T, D, F = 6, 8, 12

RANK = r"""
import datetime, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.launch.mesh import close_mesh, make_local_mesh
from repro_torch.launch.steps import on_model_axis
from repro_torch.models import layers, runtime_flags

rank, work, copy = int(sys.argv[1]), sys.argv[2], sys.argv[3] == "1"
dtype = getattr(torch, sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{work}/store", world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
mesh = make_local_mesh(2, backend="cpu")
data = np.load(f"{work}/inputs.npz")
f = data["w_gate"].shape[1] // 2
cols = slice(rank * f, (rank + 1) * f)
x = torch.from_numpy(data["x"]).to(dtype).requires_grad_(True)
w_gate = torch.from_numpy(data["w_gate"][:, cols]).to(dtype).requires_grad_(True)
w_up = torch.from_numpy(data["w_up"][:, cols]).to(dtype).requires_grad_(True)
w_down = torch.from_numpy(data["w_down"][cols]).to(dtype).requires_grad_(True)
with on_model_axis(runtime_flags.ModelAxis.of(mesh, 2)):
    h = layers.copy_to_model_axis(x) if copy else x
    part = (torch.nn.functional.silu(h @ w_gate) * (h @ w_up)) @ w_down
    before = part.detach().clone()
    y = layers.reduce_model_axis(part)
    aliased = not torch.equal(part.detach(), before)
    (y * torch.from_numpy(data["dy"]).to(dtype)).sum().backward()
np.savez(f"{work}/rank{rank}.npz", y=y.detach().numpy(), dx=x.grad.numpy(),
         dw_gate=w_gate.grad.numpy(), dw_up=w_up.grad.numpy(), dw_down=w_down.grad.numpy(),
         aliased=np.array(aliased))
close_mesh()
"""


def _two_ranks(script, work, *args) -> list:
    """``script`` run as ranks 0 and 1 (``python -c script rank work
    *args``): each one's standard output, after asserting that both exited
    0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(work), *args],
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
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    return [out for out, _ in results]


def _run(work, copy: bool, dtype: str = "float64"):
    _two_ranks(RANK, work, str(int(copy)), dtype)
    return [np.load(work / f"rank{r}.npz") for r in range(2)]


def _inputs(work):
    rng = np.random.default_rng(0)
    arrays = {"x": rng.standard_normal((T, D)), "w_gate": rng.standard_normal((D, F)),
              "w_up": rng.standard_normal((D, F)), "w_down": rng.standard_normal((F, D)),
              "dy": rng.standard_normal((T, D))}
    np.savez(work / "inputs.npz", **arrays)
    leaves = {k: torch.from_numpy(v).requires_grad_(k != "dy") for k, v in arrays.items()}
    y = (torch.nn.functional.silu(leaves["x"] @ leaves["w_gate"]) *
         (leaves["x"] @ leaves["w_up"])) @ leaves["w_down"]
    (y * leaves["dy"]).sum().backward()
    return y.detach().numpy(), {k: t.grad.numpy() for k, t in leaves.items() if k != "dy"}


@pytest.mark.parametrize("copy", [True, False], ids=["with the copy", "without"])
def test_the_conjugate_pair_gives_the_unsharded_gradients(tmp_path, copy):
    """With the copy at the column-parallel products' input every rank's
    input gradient is the unsharded one; without it each rank holds only its
    partial sum (what the layers' in-place all_reduce gave before the pair:
    a replicated leaf upstream then gets a wrong gradient, another on each
    rank). The weight gradients are each rank's shard of the unsharded ones
    either way, and the output every rank's whole sum."""
    y, grads = _inputs(tmp_path)
    ranks = _run(tmp_path, copy)
    f = F // 2
    for r, out in enumerate(ranks):
        cols = slice(r * f, (r + 1) * f)
        np.testing.assert_allclose(out["y"], y, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(out["dw_gate"], grads["w_gate"][:, cols], rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(out["dw_up"], grads["w_up"][:, cols], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(out["dw_down"], grads["w_down"][cols], rtol=1e-12,
                                   atol=1e-12)
        if copy:
            np.testing.assert_allclose(out["dx"], grads["x"], rtol=1e-12, atol=1e-12)
    if not copy:
        partial = ranks[0]["dx"] + ranks[1]["dx"]
        np.testing.assert_allclose(partial, grads["x"], rtol=1e-12, atol=1e-12)
        assert not np.allclose(ranks[0]["dx"], grads["x"])


def test_reduce_model_axis_leaves_its_argument_as_it_was(tmp_path):
    """A float32 reduction that ran ``all_reduce`` on ``x.float()``, which
    is ``x`` itself for a float32 ``x``, overwrote the caller's partial sum
    with the total; the reduction works on a copy."""
    _inputs(tmp_path)
    for out in _run(tmp_path, True, "float32"):
        assert not bool(out["aliased"])


NORM_RANK = r"""
import datetime, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.launch.mesh import close_mesh, make_local_mesh
from repro_torch.launch.steps import on_model_axis
from repro_torch.models import layers, runtime_flags

rank, work, both = int(sys.argv[1]), sys.argv[2], sys.argv[3] == "1"
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{work}/store", world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
mesh = make_local_mesh(2, backend="cpu")
data = np.load(f"{work}/norm.npz")
f = data["g"].shape[1] // 2
cols = slice(rank * f, (rank + 1) * f)
g = torch.from_numpy(data["g"][:, cols]).requires_grad_(True)
w = torch.from_numpy(data["w"][cols]).requires_grad_(True)
with on_model_axis(runtime_flags.ModelAxis.of(mesh, 2)):
    part = torch.sum(g * g, dim=-1, keepdim=True)
    ss = layers.sum_model_axis(part) if both else layers.reduce_model_axis(part)
    y = g * torch.rsqrt(ss / (2 * f) + 1e-5) * w
    (y * torch.from_numpy(data["dy"][:, cols])).sum().backward()
np.savez(f"{work}/norm{rank}.npz", y=y.detach().numpy(), dg=g.grad.numpy(), dw=w.grad.numpy())
close_mesh()
"""


@pytest.mark.parametrize("both", [True, False], ids=["both ways", "forward only"])
def test_the_gated_norms_statistic_sums_both_ways(tmp_path, both):
    """An RMS norm over a width two ranks split: each rank sums its squares,
    the sum is reduced, and each rank normalises its half. Each rank's loss
    reaches the statistic through its own half only, so the statistic's
    gradient is a sum over the ranks: with ``sum_model_axis`` every rank's
    input gradient is its half of the unsharded one; with the one-way
    ``reduce_model_axis`` (identity backward) it is not. The output and the
    weight's gradient, which do not pass the statistic's backward, are the
    unsharded ones either way."""
    rng = np.random.default_rng(1)
    arrays = {"g": rng.standard_normal((T, 2 * D)), "w": rng.standard_normal(2 * D),
              "dy": rng.standard_normal((T, 2 * D))}
    np.savez(tmp_path / "norm.npz", **arrays)
    g = torch.from_numpy(arrays["g"]).requires_grad_(True)
    w = torch.from_numpy(arrays["w"]).requires_grad_(True)
    y = g * torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True) + 1e-5) * w
    (y * torch.from_numpy(arrays["dy"])).sum().backward()
    _two_ranks(NORM_RANK, tmp_path, str(int(both)))
    for r in range(2):
        out = np.load(tmp_path / f"norm{r}.npz")
        cols = slice(r * D, (r + 1) * D)
        np.testing.assert_allclose(out["y"], y.detach().numpy()[:, cols], rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(out["dw"], w.grad.numpy()[cols], rtol=1e-12, atol=1e-12)
        if both:
            np.testing.assert_allclose(out["dg"], g.grad.numpy()[:, cols], rtol=1e-12,
                                       atol=1e-12)
        else:
            assert not np.allclose(out["dg"], g.grad.numpy()[:, cols], rtol=1e-6, atol=1e-6)


ROW_RANK = r"""
import datetime, sys
import torch, torch.distributed as dist
from repro_torch.launch.mesh import close_mesh, make_local_mesh
from repro_torch.launch.steps import on_model_axis
from repro_torch.models import layers, runtime_flags

rank, work = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{work}/store", world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
mesh = make_local_mesh(2, backend="cpu")
x = torch.tensor([[1 + 2 ** -7, 2 ** -7]], dtype=torch.bfloat16)[:, rank:rank + 1]
w = torch.tensor([[1 - 2 ** -8], [2 ** -7]], dtype=torch.bfloat16)[rank:rank + 1]
with torch.no_grad(), on_model_axis(runtime_flags.ModelAxis.of(mesh, 2)):
    y = layers.row_parallel(x, w)
print(repr((str(y.dtype), float(y))))
close_mesh()
"""


def test_a_bf16_row_parallel_product_rounds_its_sum_once(tmp_path):
    """Two ranks each hold one term of a bfloat16 product's sum: rank 0's
    (1 + 2^-7)(1 - 2^-8) = 1 + 2^-8 - 2^-15 lies just under half a bf16 unit
    above 1, rank 1's 2^-14 lifts the sum over it. The unsharded product
    rounds the float32 sum once, to 1 + 2^-7; partials rounded to bfloat16
    before the reduction would give 1. ``row_parallel`` keeps them in
    float32 and gives the unsharded product's value."""
    x = torch.tensor([[1 + 2 ** -7, 2 ** -7]], dtype=torch.bfloat16)
    w = torch.tensor([[1 - 2 ** -8], [2 ** -7]], dtype=torch.bfloat16)
    want = float((x.float() @ w.float()).to(torch.bfloat16))
    assert want == 1 + 2 ** -7
    assert float(x[0, 0].float() * w[0, 0].float()) == 1 + 2 ** -8 - 2 ** -15
    rounded = (x[:, :1] @ w[:1]).float() + (x[:, 1:] @ w[1:]).float()
    assert float(rounded.to(torch.bfloat16)) == 1.0
    for out in _two_ranks(ROW_RANK, tmp_path):
        assert out.strip().splitlines()[-1] == repr(("torch.bfloat16", want))


# one rank: a mesh of 1 x 2 whose last collective is an all_gather; rank 1
# takes a second over its result before it closes its part of the group;
# each prints when it closed (rank 1 also when it was through its result)
CLOSE_RANK = r"""
import datetime, sys, time
import torch, torch.distributed as dist
from repro_torch.launch.mesh import close_mesh, make_local_mesh

rank, work = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{work}/store", world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
make_local_mesh(2, backend="cpu")
x = torch.arange(16, dtype=torch.float32) + 16 * rank
parts = [torch.empty_like(x) for _ in range(2)]
dist.all_gather(parts, x)
if rank == 1:
    time.sleep(1.0)
    assert torch.equal(torch.cat(parts), torch.arange(32, dtype=torch.float32))
    print("read", repr(time.time()))
close_mesh()
print("closed", repr(time.time()), dist.is_initialized())
"""


def test_a_rank_that_closes_first_waits_for_the_other_to_read(tmp_path):
    """``launch.mesh.close_mesh`` right after a rank's last collective,
    while the other rank still reads its result: rank 0 closes only after
    rank 1 is through (without the barrier it would close at once, and
    under load gloo can then abort the other rank: exit -6, ``terminate
    called without an active exception``), both exit 0, and neither holds
    a process group afterwards."""
    outs = [dict((line.split(" ", 1)[0], line.split(" ")[1:])
                 for line in out.strip().splitlines())
            for out in _two_ranks(CLOSE_RANK, tmp_path)]
    assert [out["closed"][1] for out in outs] == ["False", "False"]
    assert float(outs[1]["read"][0]) <= float(outs[0]["closed"][0])
