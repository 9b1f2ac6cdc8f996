"""The sharded train step of the audio family in gloo processes on the CPU,
as ``tests/test_torch_mesh_train.py`` runs the dense family: whisper-base's
smoke config with frames and an odd vocabulary of 513, which no model axis
divides, so the embedding and the head stay whole on every rank; their
gradients must be neither summed over the model axis nor lost, and the
gradient norm must count them once (against world 1's). Three float32
steps against the reference's jitted unsharded ``make_train_step``
(``TOL``) and the port's unsharded one (``PORT_TOL``), on 1 x 2 and on 2 x 2
with ZeRO-1."""
import pytest
import torch

from test_torch_mesh_train import check_train_case, mesh_ranks_of

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

CASES = {  # id: (arch, data, model, zero_opt, remat, microbatch, loss_mask)
    "whisper-odd-vocab-1x2": ("whisper-base/V513", 1, 2, False, True, 0, False),
    "whisper-odd-vocab-2x2-zero": ("whisper-base/V513", 2, 2, True, True, 0, False),
}


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    return mesh_ranks_of(CASES, tmp_path_factory)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_audio_train_steps_match_the_reference(mesh_ranks, case):
    check_train_case(CASES, mesh_ranks, case)
