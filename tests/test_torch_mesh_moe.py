"""The MoE family's sharded prefill and decode steps in gloo processes on the
CPU: qwen2-moe-a2.7b's and deepseek-moe-16b's smoke configs (the router's
columns of each rank's experts, gathered whole before the top-k; the
routed experts f-sharded, combined, then summed over the model axis; the
shared experts column- then row-parallel) on 1 x 2 and 2 x 2, against the
reference's unsharded ``Model.prefill`` / ``decode_step`` (``REF_TOL``) and
the port's unsharded steps (``PORT_TOL``), as ``tests/test_torch_mesh.py``
runs the dense and VLM families."""
import pytest
import torch

from test_torch_mesh import check_sharded_serving

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-moe-16b"])
@pytest.mark.parametrize("data_axis,model_axis", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_sharded_moe_prefill_and_decode_match_the_reference(tmp_path, arch, data_axis,
                                                            model_axis):
    check_sharded_serving(tmp_path, arch, data_axis, model_axis)
