"""The audio family where the model axis splits its attention heads
(``launch.steps.splits_heads``: whisper-base's 8 heads on the reference's
model axis of 16), in gloo processes on the CPU, float32.

A rank holds the reference's column blocks of ``wq``/``wk``/``wv`` and rows
of ``wo`` in every encoder and decoder attention; a cross-attention gathers
q from the decoder's rows and k and v from the encoder's. Both KV pools
hold their rows in round-robin pages (``launch.shardings.seq_place``), the
cross pool those of the encoder's ``enc_seq`` positions, where the
reference cuts the cross K/V's ``head_dim`` (ROADMAP.md, Departures); a
decode step's self- and cross-attention each merge the ranks' partials by
their log-sum-exp. whisper-base's smoke config, changed in both packages so
that the axis splits the heads: 3 heads of 32 on 1 x 2 (1.5 heads a rank,
cut mid-head) and on 2 x 2, 2 heads on 1 x 4 (half a head a rank), with
40 encoder positions: a ragged last page, and on 1 x 4 one rank that
holds none of them and gives the merge an empty partial.

Serving (``tests/test_torch_mesh_split_heads.py``'s ``check_split_heads_serving``):
ragged prompts, each with its frames, prefilled alone and written into its
slot, then 4 decode steps, against the reference's unsharded ``Model``
(``REF_TOL``) and the port's unsharded steps (``PORT_TOL``), fed the
reference's greedy tokens. Training (``tests/test_torch_mesh_train.py``'s
``check_train_case``): 3 steps against the reference's jitted step and the
port's unsharded one, at that file's tolerances. Without processes: each
rank's partial over its cross pages, as the prefill writes them and the
decode step counts them, merged over the ranks against the whole pool's
attention."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.launch import shardings as sh
from repro_torch.launch import steps
from repro_torch.models import encdec, layers, runtime_flags
from test_torch_mesh_split_heads import check_split_heads_serving
from test_torch_mesh_train import check_train_case, mesh_ranks_of

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

# whisper-base's smoke config (4 heads of 32, d_model 128, 32 encoder
# positions) changed in both packages: 3 heads or 2 of 32, 40 encoder
# positions (two pages and a half)
THREE_HEADS = (("n_heads", 3), ("n_kv_heads", 3), ("d_model", 96), ("enc_seq", 40))
TWO_HEADS = (("n_heads", 2), ("n_kv_heads", 2), ("d_model", 64), ("enc_seq", 40))


@pytest.mark.parametrize("data_axis,model_axis,overrides",
                         [(1, 2, THREE_HEADS), (1, 4, TWO_HEADS), (2, 2, THREE_HEADS)],
                         ids=["3-heads-1x2", "2-heads-1x4", "3-heads-2x2"])
def test_split_heads_audio_prefill_and_decode_match_the_reference(tmp_path, data_axis,
                                                                  model_axis, overrides):
    cfg = get_smoke_config("whisper-base").with_(**dict(overrides))
    assert steps.splits_heads(cfg, model_axis)
    check_split_heads_serving(tmp_path, "whisper-base", data_axis, model_axis, overrides)


CASES = {  # id: (arch, data, model, zero_opt, remat, microbatch, loss_mask)
    "whisper-3-heads-1x2": ("whisper-base/H3/K3/D96/T40", 1, 2, False, True, 0, False),
    "whisper-2-heads-1x4": ("whisper-base/H2/K2/D64/T40", 1, 4, False, True, 0, False),
    "whisper-3-heads-2x2-zero": ("whisper-base/H3/K3/D96/T40", 2, 2, True, True, 0, False),
}


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    return mesh_ranks_of(CASES, tmp_path_factory)


@pytest.mark.parametrize("case", list(CASES))
def test_split_heads_audio_train_steps_match_the_reference(mesh_ranks, case):
    check_train_case(CASES, mesh_ranks, case)


# ------------------------------------------------------------ no processes


def _rank_axis(r: int, m: int):
    """Rank ``r`` of a model axis of ``m`` as the layers read it (no process
    group: nothing here runs a collective)."""
    return steps.on_model_axis(runtime_flags.ModelAxis(None, r, m, False))


@pytest.mark.parametrize("cfg,m", [
    (get_smoke_config("whisper-base").with_(**dict(THREE_HEADS)), 2),
    (get_smoke_config("whisper-base").with_(**dict(TWO_HEADS)), 4),
    (get_config("whisper-base"), 16)], ids=["40-on-2", "40-on-4", "1500-on-16"])
def test_the_ranks_cross_partials_merge_to_the_whole_cross_pools_attention(cfg, m):
    """Four rows of encoder K/V, one of them free: each rank's cross pool
    holds the positions ``layers.held_positions`` gives it (what
    ``encdec.prefill`` writes), each row's length is
    ``encdec.cross_lengths``' (what ``decode_step`` attends over; 0 for the
    free row), each rank's partial with its log-sum-exp comes from
    ``ops.paged_attention(return_lse=True)`` (the plain version on the CPU),
    and ``layers.merge_partials`` over the ranks gives the whole pool's
    attention within 1e-6. 40 positions on 4 ranks leave rank 3 none (its
    log-sum-exp -inf); whisper-base's 1500 on 16 give ranks 0-12 96
    positions, rank 13 92 and ranks 14-15 80."""
    gen = torch.Generator().manual_seed(4)
    B, T, page = 4, cfg.enc_seq, ops.DEFAULT_PAGE_SIZE
    Hkv, D = cfg.n_kv_heads, cfg.resolved_head_dim
    group = cfg.n_heads // Hkv
    pages = -(-T // page)
    k = torch.randn((B, T, Hkv, D), generator=gen)
    v = torch.randn((B, T, Hkv, D), generator=gen)
    q = torch.randn((B, Hkv, group, D), generator=gen)
    active = torch.tensor([True, True, False, True])
    pos = torch.tensor([7, 1, 0, 30], dtype=torch.int32)
    whole_k = torch.zeros((B * pages, page, Hkv, D))
    whole_v = torch.zeros_like(whole_k)
    whole_k.view(B, pages * page, Hkv, D)[:, :T] = k
    whole_v.view(B, pages * page, Hkv, D)[:, :T] = v
    bt = torch.arange(B * pages, dtype=torch.int32).reshape(B, pages)
    want = paged_attention_plain(q, whole_k, whole_v, bt,
                                 encdec.cross_lengths(cfg, pos, active, page).to(torch.int32))

    lcfg = steps.local_config(cfg, {"data": 1, "model": m})
    local = sh.seq_pages(pages, m)
    parts, held = [], []
    for r in range(m):
        with _rank_axis(r, m):
            where, slots = layers.held_positions(lcfg, local, T, page)
            assert slots == slice(0, len(where))
            lengths = encdec.cross_lengths(lcfg, pos, active, page).to(torch.int32)
        held.append(len(where))
        assert lengths.tolist() == [len(where), len(where), 0, len(where)]
        rk = torch.zeros((B, local * page, Hkv, D))
        rv = torch.zeros_like(rk)
        rk[:, :len(where)] = k[:, where]
        rv[:, :len(where)] = v[:, where]
        rbt = torch.arange(B * local, dtype=torch.int32).reshape(B, local)
        o, lse = ops.paged_attention(q, rk.reshape(B * local, page, Hkv, D),
                                     rv.reshape(B * local, page, Hkv, D), rbt, lengths,
                                     return_lse=True)
        if not len(where):
            assert torch.isneginf(lse).all() and (o == 0).all()
        parts.append((o, lse))
    assert sum(held) == T
    got = layers.merge_partials(torch.stack([o for o, _ in parts]),
                                torch.stack([lse for _, lse in parts]))
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    assert (got[2] == 0).all()
    if T == 1500:
        assert held == [96] * 13 + [92] + [80] * 2
    if m == 4:
        assert held[-1] == 0
    np.testing.assert_array_equal(
        held, [int(sh.seq_local_length(T, r, m, page)) for r in range(m)])
