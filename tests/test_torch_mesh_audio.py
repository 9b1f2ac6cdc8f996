"""The audio family on a device mesh, in gloo processes on the CPU, against
the reference's unsharded ``Model.prefill`` / ``decode_step`` (``REF_TOL``)
and the port's unsharded steps (``PORT_TOL``), as ``tests/test_torch_mesh.py``
runs the dense family: whisper-base's smoke config with an odd vocabulary of
513, which no model axis divides, so the embedding and the head stay whole
on every rank (``ModelAxis.shard_vocab`` False); its encoder at a rank's
heads, its cross K/V projected from the whole encoder output into a rank's
cross pool, and the frames cut by ``batch_rows`` like the tokens, on 1 x 2
and 2 x 2."""
import pytest
import torch

from test_torch_mesh import check_sharded_serving

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)


@pytest.mark.parametrize("data_axis,model_axis", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_sharded_audio_prefill_and_decode_match_the_reference(tmp_path, data_axis,
                                                              model_axis):
    check_sharded_serving(tmp_path, "whisper-base", data_axis, model_axis,
                          configure=lambda c: c.with_(vocab_size=513))
