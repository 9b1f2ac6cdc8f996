"""The hybrid family on a device mesh, in gloo processes on the CPU, against
the reference's unsharded ``Model.prefill`` / ``decode_step`` (``REF_TOL``)
and the port's unsharded steps (``PORT_TOL``), as ``tests/test_torch_mesh.py``
runs the dense family: zamba2-2.7b's smoke config with two groups (the
shared attention block called twice, each call with its own pool at a
rank's KV heads; the Mamba2 layers by their rank layout) on 1 x 2 and
2 x 2."""
import pytest
import torch

from test_torch_mesh import check_sharded_serving

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)


@pytest.mark.parametrize("data_axis,model_axis", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_sharded_hybrid_prefill_and_decode_match_the_reference(tmp_path, data_axis,
                                                               model_axis):
    check_sharded_serving(tmp_path, "zamba2-2.7b", data_axis, model_axis,
                          configure=lambda c: c.with_(n_layers=4))
