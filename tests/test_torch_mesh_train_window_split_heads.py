"""The sharded train step with a sliding window where the model axis splits
the attention heads (``launch.steps.splits_heads``), in gloo processes on
the CPU, as ``tests/test_torch_mesh_train_split_heads.py`` runs it without
one: three float32 steps against the reference's jitted unsharded
``make_train_step`` and the port's unsharded one
(``tests/test_torch_mesh_train.py``'s ``check_train_case`` and tolerances),
the loss, the gradient norm, and the parameters and AdamW moments gathered
back after each step.

A window of 8 under sequences of 16: each rank runs ``flash_prefill`` with
the window over the heads its ``wo`` rows overlap, forward and backward.
llama-70b's smoke config on 1 x 4 splits its KV heads; yi-34b's cuts its 7
heads mid-head on 1 x 2 and on 2 x 2 with ZeRO-1; internvl2-2b's on 1 x 4
carries its 16 vision positions in front, which every query reads whatever
the window; whisper-base's at 3 heads on 1 x 2 takes the window in its
decoder's self-attention only (its encoder and cross-attention take
none)."""
import pytest
import torch

from test_torch_mesh_train import check_train_case, mesh_ranks_of

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

CASES = {  # id: (arch, data, model, zero_opt, remat, microbatch, loss_mask)
    "llama-70b-window-1x4": ("llama-70b/W8", 1, 4, False, True, 0, False),
    "yi-34b-window-1x2": ("yi-34b/W8", 1, 2, False, True, 0, False),
    "yi-34b-window-2x2-zero": ("yi-34b/W8", 2, 2, True, True, 0, False),
    "internvl2-2b-window-1x4": ("internvl2-2b/W8", 1, 4, False, True, 0, False),
    "whisper-3-heads-window-1x2": ("whisper-base/H3/K3/D96/T40/W8", 1, 2, False, True, 0,
                                   False),
}


# the cases whose parameters may stand beyond PORT_TOL of the port's
# unsharded step where check_train_case's float64 witness holds: an element
# whose clipped float64 gradient is float32 noise near Adam's eps, which
# float32 sums in another order move by a good part of lr
# (tests/test_torch_mesh_train.py's module docstring), and the sharded run
# stands at least as near the float64 step. EPS_FACTOR: the bound on that
# gradient, in Adam's eps. yi-34b's embedding element [168, 152] (a token
# no batch targets) has a clipped float64 gradient of 3.12e-8, 3.1 eps, at
# step 0, where Adam's first step lr g / (|g| + eps) moves the parameter by
# lr eps / (|g| + eps)^2 = 5.9e6 lr a unit of gradient: the unsharded
# float32 run stands 3.3e-5 off the float64 parameter (its gradient about
# 1.9e-8 off), the sharded run on 1 x 2 7.1e-6
WITNESSED = ("yi-34b-window-1x2", "yi-34b-window-2x2-zero", "internvl2-2b-window-1x4")
EPS_FACTOR = 4.0


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    return mesh_ranks_of(CASES, tmp_path_factory)


@pytest.mark.parametrize("case", list(CASES))
def test_windowed_split_heads_train_steps_match_the_reference(mesh_ranks, case):
    check_train_case(CASES, mesh_ranks, case, witnessed=WITNESSED, eps_factor=EPS_FACTOR)
