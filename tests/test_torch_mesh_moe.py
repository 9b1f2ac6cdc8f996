"""The MoE family's sharded prefill and decode steps in gloo processes on the
CPU: qwen2-moe-a2.7b's and deepseek-moe-16b's smoke configs (the router's
columns of each rank's experts, gathered whole before the top-k; the
routed experts f-sharded, combined, then summed over the model axis; the
shared experts column- then row-parallel) on 1 x 2 and 2 x 2, against the
reference's unsharded ``Model.prefill`` / ``decode_step`` (``REF_TOL``) and
the port's unsharded steps (``PORT_TOL``), as ``tests/test_torch_mesh.py``
runs the dense and VLM families; and a decode step whose tokens are dropped
for capacity, on data ranks that must dispatch them as one global batch."""
import dataclasses

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


def _drops(cfg):
    # capacity factor 0.25: a decode step of 32 tokens, top-2 of 4 experts,
    # sends 64 assignments to 4 x 8 capacity rows, so at least half drop
    return cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=0.25))


@pytest.mark.parametrize("data_axis,model_axis", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_data_ranks_dispatch_the_global_batch_when_tokens_drop(tmp_path, data_axis,
                                                               model_axis):
    """The reference's decode step sizes the capacity from the whole batch and
    ranks every token in one token-major cumulative sum; each data rank
    takes that capacity and starts each expert's count at what the lower
    ranks gave it (``moe._dispatch``'s ``over_batch``). Every slot is
    active. A rank that dispatched its own rows alone kept other tokens."""
    check_sharded_serving(tmp_path, "qwen2-moe-a2.7b", data_axis, model_axis, batch=32,
                          configure=_drops)
