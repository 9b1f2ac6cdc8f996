"""The sharded train step of the ssm and hybrid families in gloo
processes on the CPU, as ``tests/test_torch_mesh_train.py`` runs the dense,
VLM and MoE families: three float32 steps against the reference's jitted
unsharded ``make_train_step`` (``TOL``) and the port's unsharded one
(``PORT_TOL``), the loss, the gradient norm, and the parameters and AdamW
moments gathered back to the global trees after each step.

The gradient norm against world 1's shows that each element is counted
once: the B and C columns of ``w_in``, ``conv_w`` and ``conv_b``, which
every rank holds whole inside a leaf cut over the model axis
(``params.ssm_layout``). zamba2-2.7b runs with two groups, so its shared
block's gradient is a sum over two calls on each rank. ZeRO-1 on 2 x 2 cuts
each rank's piece of a Mamba2 leaf. The audio family's runs are
``tests/test_torch_mesh_train_audio.py``'s."""
import pytest
import torch

from test_torch_mesh_train import check_train_case, mesh_ranks_of

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

CASES = {  # id: (arch, data, model, zero_opt, remat, microbatch, loss_mask)
    "mamba2-1x2": ("mamba2-1.3b", 1, 2, False, True, 0, False),
    "mamba2-2x2-zero": ("mamba2-1.3b", 2, 2, True, True, 0, False),
    "zamba2-two-groups-1x2": ("zamba2-2.7b/L4", 1, 2, False, True, 0, False),
    "zamba2-two-groups-2x2-zero": ("zamba2-2.7b/L4", 2, 2, True, True, 0, False),
}


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    return mesh_ranks_of(CASES, tmp_path_factory)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_ssm_and_hybrid_train_steps_match_the_reference(mesh_ranks, case):
    check_train_case(CASES, mesh_ranks, case)
