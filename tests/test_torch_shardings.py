"""The port's sharding rules (``launch/shardings.py``) against the
reference's (``repro.launch.shardings``), leaf by leaf: the parameters on
the reference's ``jax.eval_shape`` tree and the port's meta tree, the cache
by meaning (the port's page pool against the reference's dense slots), the
batch, ZeRO's moments and the logits, for every assigned arch plus
llama-8b and llama-70b, on model axes of 1, 4, 8 and 16 and the production
meshes 16 x 16 and 2 x 16 x 16; the reference's own cases; and the dry
run's per-device bytes on a 16 x 16 mesh against the local shards of the
reference's specs.

The reference's rules read a mesh's ``axis_names`` and ``devices.shape``
only, and wrap each spec in a ``NamedSharding``: a stand-in mesh with no
devices and a ``NamedSharding`` that keeps the spec let them run on a host
with one device. Nothing of ``repro`` is edited."""
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import shardings as ref_sh
from repro.launch import steps as ref_steps
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import shardings as sh
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh, mesh_shape
from repro_torch.training.optimizer import adamw_init

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

ARCHS = ASSIGNED_ARCHS + ["llama-8b", "llama-70b"]
MODEL_SIZES = [1, 4, 8, 16]
# a model axis of each size, and the two production meshes
MESHES = [(16, 1), (4, 4), (2, 8), (16, 16), (2, 16, 16)]


class _Spec:
    """What the patched ``NamedSharding`` gives: the spec, as a pytree leaf."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


@pytest.fixture(autouse=True)
def _named_sharding_keeps_the_spec(monkeypatch):
    monkeypatch.setattr(ref_sh, "NamedSharding", _Spec)


def _ref_mesh(shape):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _ref_leaves(ref_tree):
    """{path: leaf} of a reference pytree, under the reference's key names."""
    flat = jax.tree_util.tree_flatten_with_path(
        ref_tree, is_leaf=lambda x: isinstance(x, _Spec))[0]
    return {ref_sh._key_names(path): leaf for path, leaf in flat}


def _port_leaves(port_tree):
    out = {}
    sh.map_with_path(lambda path, leaf: out.setdefault(path, leaf), port_tree)
    return out


@functools.lru_cache(maxsize=None)
def _ref_inputs(arch, shape):
    rcfg = ref_steps.resolve_config(ref_get_config(arch), REF_SHAPES[shape])
    return ref_steps.input_specs(rcfg, REF_SHAPES[shape])


@functools.lru_cache(maxsize=None)
def _port_inputs(arch, shape):
    cfg = steps.resolve_config(get_config(arch), INPUT_SHAPES[shape])
    return steps.input_specs(cfg, INPUT_SHAPES[shape])


def _ref_specs(leaves):
    return {k: v.spec for k, v in leaves.items()}


# ------------------------------------------------------------ the reference's own


def test_param_spec_divisibility_fallback():
    # vocab 50280 (mamba2) is not divisible by 16 -> replicated
    spec = sh.param_spec(("emb", "tok"), (50280, 2048), 16)
    assert all(s is None for s in spec)
    spec = sh.param_spec(("emb", "tok"), (50304, 2048), 16)
    assert spec[0] == "model"


def test_param_spec_moe_f_sharded():
    spec = sh.param_spec(("layers", "moe", "w_gate"), (24, 60, 2048, 1408), 16)
    assert spec[1] is None and spec[3] == "model"
    spec = sh.param_spec(("layers", "moe", "w_down"), (28, 64, 1408, 2048), 16)
    assert spec[2] == "model"
    # f not divisible -> expert parallel fallback
    spec = sh.param_spec(("layers", "moe", "w_gate"), (24, 64, 2048, 1000), 16)
    assert spec[1] == "model"


# ------------------------------------------------------------ leaf by leaf


@pytest.mark.parametrize("msize", MODEL_SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, msize):
    ref = _ref_leaves(_ref_inputs(arch, "prefill_32k")["params"])
    ours = _port_leaves(_port_inputs(arch, "prefill_32k")["params"])
    assert set(ours) == set(ref)
    for path, leaf in ours.items():
        assert tuple(leaf.shape) == tuple(ref[path].shape), path
        want = tuple(ref_sh.param_spec(path, tuple(ref[path].shape), msize))
        assert sh.param_spec(path, tuple(leaf.shape), msize) == want, path


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_on_a_mesh_match_the_reference(arch, mesh):
    ref = _ref_specs(_ref_leaves(ref_sh.param_shardings(
        _ref_mesh(mesh), _ref_inputs(arch, "prefill_32k")["params"])))
    ours = _port_leaves(sh.param_shardings(mesh_shape(mesh),
                                           _port_inputs(arch, "prefill_32k")["params"]))
    assert ours == ref


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_reference_by_meaning(arch, shape, mesh):
    """Every leaf the two caches share (K/V, cross K/V, SSM and conv states,
    pos) has the reference's spec: the pool's pages stand where the batch
    stands, and the pool's sequence positions where the slots' do. The
    reference's ``slot_pos`` has no counterpart; the port's block tables are
    sharded with their rows as the batch is."""
    batch = INPUT_SHAPES[shape].global_batch
    ref_cache = _ref_inputs(arch, shape)["cache"]
    cache = _port_inputs(arch, shape)["cache"]
    ref = _ref_specs(_ref_leaves(ref_sh.cache_shardings(_ref_mesh(mesh), ref_cache, batch)))
    enc = get_config(arch).enc_seq
    ours = _port_leaves(sh.cache_shardings(mesh_shape(mesh), cache, batch,
                                           {"cross_k": enc, "cross_v": enc}))
    shared = set(ours) & set(ref)
    assert shared >= {("pos",)}
    assert set(ours) - shared <= {("block_tables",), ("cross_block_tables",)}
    assert set(ref) - shared <= {("slot_pos",)}
    for path in shared:
        assert ours[path] == ref[path], path
        ref_shape = tuple(_ref_leaves(ref_cache)[path].shape)
        if path[-1] in ("k", "v", "cross_k", "cross_v"):
            # the same positions: a slot axis of S, or the pages that hold S
            L, pages, page, hkv, hd = cache[path[-1]].shape
            assert (L, hkv, hd) == (ref_shape[0], ref_shape[3], ref_shape[4])
            assert pages == ref_shape[1] * -(-ref_shape[2] // page)
    baxis = sh._batch_spec_axis(mesh_shape(mesh), batch)
    for table in set(ours) - shared:
        assert ours[table] == (baxis, None)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_batch_and_logits_specs_match_the_reference(shape, mesh):
    for arch in ARCHS:
        specs = _port_inputs(arch, shape)
        ref_specs = _ref_inputs(arch, shape)
        key = "tokens" if INPUT_SHAPES[shape].kind == "decode" else "batch"
        ours = _port_leaves(sh.batch_shardings(mesh_shape(mesh), {key: specs[key]}))
        ref = _ref_specs(_ref_leaves(ref_sh.batch_shardings(_ref_mesh(mesh),
                                                            {key: ref_specs[key]})))
        assert ours == ref, arch
        batch, vocab = INPUT_SHAPES[shape].global_batch, get_config(arch).vocab_size
        assert sh.logits_sharding(mesh_shape(mesh), batch, vocab) == \
            ref_sh.logits_sharding(_ref_mesh(mesh), batch, vocab).spec


@pytest.mark.parametrize("zero", [False, True], ids=["moments", "zero1"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_optimizer_specs_match_the_reference(mesh, zero):
    for arch in ARCHS:
        params = _port_inputs(arch, "prefill_32k")["params"]
        ref_params = _ref_inputs(arch, "prefill_32k")["params"]
        ours = sh.opt_shardings(mesh_shape(mesh), adamw_init(params),
                                sh.param_shardings(mesh_shape(mesh), params), zero=zero)
        ref_opt = jax.eval_shape(lambda p: ref_steps.adamw_init(p), ref_params)
        theirs = ref_sh.opt_shardings(_ref_mesh(mesh), ref_opt,
                                      ref_sh.param_shardings(_ref_mesh(mesh), ref_params),
                                      zero=zero)
        assert ours.step == theirs.step.spec == ()
        assert _port_leaves(ours.mu) == _ref_specs(_ref_leaves(theirs.mu)), arch
        assert _port_leaves(ours.nu) == _ref_specs(_ref_leaves(theirs.nu)), arch


# ------------------------------------------------------------ shards


def test_local_shape_and_shard_slices():
    sizes = {"pod": 2, "data": 4, "model": 8}
    spec = (("pod", "data"), None, "model")
    assert sh.local_shape(spec, (16, 3, 64), sizes) == (2, 3, 8)
    assert sh.local_shape((), (5, 7), sizes) == (5, 7)
    # row-major over (pod, data): pod 1, data 2 holds block 6 of 8
    assert sh.shard_slices(spec, (16, 3, 64), sizes, {"pod": 1, "data": 2, "model": 5}) == \
        (slice(12, 14), slice(0, 3), slice(40, 48))
    with pytest.raises(ValueError):
        sh.local_shape(("model",), (12,), sizes)


def test_production_meshes():
    assert make_production_mesh().shape == (16, 16)
    assert make_production_mesh().mesh_dim_names == ("data", "model")
    assert make_production_mesh(multi_pod=True).shape == (2, 16, 16)
    assert make_production_mesh(multi_pod=True).mesh_dim_names == ("pod", "data", "model")


def _ref_local_bytes(ref_tree, ref_specs, sizes):
    total = 0
    specs = _ref_leaves(ref_specs)
    for path, leaf in _ref_leaves(ref_tree).items():
        n = int(np.prod(sh.local_shape(specs[path].spec, tuple(leaf.shape), sizes)))
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_dryrun_on_a_mesh_reports_the_local_bytes_of_the_references_specs(arch, shape):
    """``dryrun --mesh-shape 16x16``'s ``arg_bytes`` = the bytes of one
    device's shards of the reference's inputs under the reference's specs;
    for a decode, with the reference's ``slot_pos`` exchanged for the port's
    block tables (each sharded on its rows)."""
    rec, line = dryrun.run_one(arch, shape, mesh=(16, 16))
    assert rec["status"] == "ok", line
    assert rec["mesh"] == "16x16" and rec["multi_pod"] is False
    mesh, sizes = _ref_mesh((16, 16)), {"data": 16, "model": 16}
    ref = _ref_inputs(arch, shape)
    B = REF_SHAPES[shape].global_batch
    want = _ref_local_bytes(ref["params"], ref_sh.param_shardings(mesh, ref["params"]), sizes)
    if REF_SHAPES[shape].kind == "prefill":
        want += _ref_local_bytes(ref["batch"], ref_sh.batch_shardings(mesh, ref["batch"]),
                                 sizes)
    else:
        want += _ref_local_bytes({"tokens": ref["tokens"]},
                                 ref_sh.batch_shardings(mesh, {"tokens": ref["tokens"]}),
                                 sizes)
        # the port's cache leaves under the reference's specs of the same
        # keys (by meaning); the block tables under their own
        ref_specs = _ref_leaves(ref_sh.cache_shardings(mesh, ref["cache"], B))
        cache = _port_inputs(arch, shape)["cache"]
        ours = sh.cache_shardings(mesh_shape((16, 16)), cache, B)
        specs = {k: ref_specs[(k,)].spec if (k,) in ref_specs else ours[k] for k in cache}
        want += roofline.nbytes(roofline.local_meta(cache, specs, sizes))
    assert rec["arg_bytes"] == want
    assert rec["fits"] == (want <= roofline.CARD_BYTES)


def _train_coll_want(arch, shape, mesh_dims, *, remat, zero):
    """The collective bytes of the sharded train step's plan, one device,
    from the config and the reference's specs (launch/roofline.py's
    ``mesh_coll_bytes`` states the plan): on ``model`` the forward's
    all_reduces of every layer's two row-parallel outputs, the embeddings
    and the logits of every position (the vocabulary divides the axis
    here), the layers' again under remat, and the backward's at the
    attention's, the FFN's and the head's inputs; on ``data`` the rank's
    gradient; under ZeRO-1 the all-gather of the blocks of the leaves whose
    moments ``data`` cuts. float32 buffers; rings."""
    cfg = get_config(arch)
    data, m = mesh_dims
    shp = REF_SHAPES[shape]
    assert cfg.vocab_size % m == 0 and not cfg.is_moe and cfg.arch_type == "dense"
    tokens = shp.global_batch // data * shp.seq_len
    layer = 2 * tokens * cfg.d_model
    model = cfg.n_layers * layer + tokens * cfg.d_model + tokens * cfg.vocab_size
    model += cfg.n_layers * layer if remat else 0
    model += cfg.n_layers * layer + tokens * cfg.d_model
    return {"all-reduce model": model * 4 * 2 * (m - 1) / m,
            **_data_coll_want(arch, shape, mesh_dims, zero=zero)}


def _data_coll_want(arch, shape, mesh_dims, *, zero):
    """A train step's collective bytes on ``data``, one device: the average
    of its gradient (every leaf's shard under the reference's specs, in
    float32) and, under ZeRO-1, the all-gather of the blocks of the leaves
    whose moments ``data`` cuts, in their dtype; rings. Empty for one data
    rank."""
    data, m = mesh_dims
    mesh, sizes = _ref_mesh(mesh_dims), {"data": data, "model": m}
    ref = _ref_inputs(arch, shape)
    p_sh = ref_sh.param_shardings(mesh, ref["params"])
    want = {}
    if data > 1:
        p_specs = _ref_leaves(p_sh)
        local = {path: int(np.prod(sh.local_shape(p_specs[path].spec, tuple(leaf.shape),
                                                  sizes)))
                 for path, leaf in _ref_leaves(ref["params"]).items()}
        # the gradient reduced in float32, the parameters gathered in their dtype
        want["all-reduce data"] = sum(local.values()) * 4 * 2 * (data - 1) / data
        if zero:
            o_sh = _ref_leaves(ref_sh.opt_shardings(mesh, ref["opt_state"], p_sh,
                                                    zero=True).mu)
            cut = sum(local[path] * np.dtype(leaf.dtype).itemsize
                      for path, leaf in _ref_leaves(ref["params"]).items()
                      if "data" in o_sh[path].spec)
            want["all-gather data"] = cut * (data - 1) / data
    return want


def test_the_dry_runs_train_bytes_on_a_mesh_with_zero():
    """A train pair on 16 x 16: parameters, the batch and AdamW's state, with
    ZeRO-1's moments sharded over ``data`` as well; and its collective
    bytes, the sharded train step's plan (``_train_coll_want``)."""
    arch, shape = "olmo-1b", "train_4k"
    mesh, sizes = _ref_mesh((16, 16)), {"data": 16, "model": 16}
    ref = _ref_inputs(arch, shape)
    p_sh = ref_sh.param_shardings(mesh, ref["params"])
    base = _ref_local_bytes(ref["params"], p_sh, sizes) + \
        _ref_local_bytes(ref["batch"], ref_sh.batch_shardings(mesh, ref["batch"]), sizes)
    for zero in (False, True):
        rec, line = dryrun.run_one(arch, shape, mesh=(16, 16), zero_opt=zero)
        assert rec["status"] == "ok", line
        o_sh = ref_sh.opt_shardings(mesh, ref["opt_state"], p_sh, zero=zero)
        want = base + _ref_local_bytes(ref["opt_state"], o_sh, sizes)
        assert rec["arg_bytes"] == want, zero
        coll = _train_coll_want(arch, shape, (16, 16), remat=True, zero=zero)
        assert rec["mesh"] == "16x16" and set(rec["coll_breakdown"]) == set(coll)
        for key, value in coll.items():
            assert rec["coll_breakdown"][key] == pytest.approx(value, rel=1e-12), key
        assert rec["coll_bytes"] == pytest.approx(sum(coll.values()), rel=1e-12)
        # 16 x 16 spans nodes: both axes' rings at the inter-node rate
        assert rec["collective_s"] == pytest.approx(sum(coll.values()) /
                                                    roofline.INTER_NODE_BW, rel=1e-12)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("zero", [False, True], ids=["", "zero"])
@pytest.mark.parametrize("mesh_dims", [(2, 2), (1, 4), (4, 1)], ids=lambda m: "x".join(map(str, m)))
def test_mesh_coll_bytes_of_a_train_step(mesh_dims, zero, remat):
    """``mesh_coll_bytes`` for a train step counts the forward's all_reduces,
    the backward's (remat's recomputed forward and the copies'), the
    gradient's average over ``data`` and ZeRO-1's all-gather; one node's
    mesh runs every ring over NVLink."""
    arch, shape = "olmo-1b", "train_4k"
    cfg, mesh = get_config(arch), mesh_shape(mesh_dims)
    got = roofline.mesh_coll_bytes(cfg, INPUT_SHAPES[shape], mesh, remat=remat,
                                   zero_opt=zero)
    want = _train_coll_want(arch, shape, mesh_dims, remat=remat, zero=zero)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-12), key
    terms, _ = roofline.plan(cfg, INPUT_SHAPES[shape], remat=remat, mesh=mesh,
                             zero_opt=zero)
    assert terms.collective_s == pytest.approx(sum(want.values()) / roofline.LINK_BW,
                                               rel=1e-12)
    # the forward's model-axis bytes are a prefill's of every position, plus
    # the backward's, which remat makes larger
    if mesh_dims[1] > 1:
        fwd_only = roofline.mesh_coll_bytes(cfg, INPUT_SHAPES[shape], mesh, remat=False)
        assert got["all-reduce model"] >= fwd_only["all-reduce model"]


# ------------------------------------------------------------ a rank's shards


def _meshes_and_coords():
    for shape in ((1, 2), (2, 2), (1, 4)):
        for d in range(shape[0]):
            for m in range(shape[1]):
                yield shape, {"data": d, "model": m}


@pytest.mark.parametrize("shape,coords", list(_meshes_and_coords()),
                         ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple)
                         else f"d{x['data']}m{x['model']}")
def test_init_shard_draws_shard_params_of_the_whole_tree(shape, coords):
    """``params.init_shard`` keeps, layer by layer, exactly the shards
    ``shard_params`` cuts from ``Model.init``'s whole tree, from the same
    generator; each shard has ``local_shape``'s shape."""
    from repro_torch import params as P
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    cfg = get_smoke_config("llama-70b").with_(n_heads=8, n_kv_heads=4)
    mesh = mesh_shape(shape)
    whole = Model(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    want = P.shard_params(whole, mesh, coords)
    got = P.init_shard(cfg, torch.Generator().manual_seed(3), mesh, coords, device="cpu")
    specs = sh.param_shardings(mesh, whole)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for path, leaf in _port_leaves(got).items():
        assert torch.equal(leaf, _port_leaves(want)[path]), path
        assert tuple(leaf.shape) == sh.local_shape(_port_leaves(specs)[path],
                                                   tuple(_port_leaves(whole)[path].shape),
                                                   sizes), path


# ------------------------------------------------------------ the ssm, hybrid and audio families


def _rank_width(cfg, name, m):
    """A rank's width of a Mamba2 leaf's cut dimension (its z, x and dt
    columns and B and C whole; its heads; its slice of d_inner), or None
    for a leaf the reference's specs place."""
    di, N, H = cfg.d_inner, cfg.ssm.state_dim, cfg.n_ssm_heads
    return {"w_in": 2 * di // m + 2 * N + H // m, "conv_w": di // m + 2 * N,
            "conv_b": di // m + 2 * N, "A_log": H // m, "D": H // m, "dt_bias": H // m,
            "norm_w": di // m, "w_out": di // m}.get(name)


def _rank_elements(arch, shape, mesh_dims):
    """{path: (elements of a rank's piece, of its shard under the reference's
    spec, item size)} of the reference's parameter tree."""
    cfg = get_config(arch)
    m = mesh_dims[-1]
    mesh, sizes = _ref_mesh(mesh_dims), dict(zip(_ref_mesh(mesh_dims).axis_names, mesh_dims))
    ref = _ref_inputs(arch, shape)
    specs = _ref_leaves(ref_sh.param_shardings(mesh, ref["params"]))
    out = {}
    for path, leaf in _ref_leaves(ref["params"]).items():
        spec_n = int(np.prod(sh.local_shape(specs[path].spec, tuple(leaf.shape), sizes)))
        width = _rank_width(cfg, path[-1], m) if path[0] == "layers" and \
            cfg.arch_type in ("ssm", "hybrid") else None
        if width is None:
            n = spec_n
        else:
            dim = -2 if path[-1] == "w_out" else -1
            n = int(np.prod(leaf.shape)) // leaf.shape[dim] * width
        out[path] = (n, spec_n, np.dtype(leaf.dtype).itemsize)
    return out


def _family_coll_want(arch, shape, mesh_dims, *, remat=True):
    """The collective bytes of the ssm, hybrid or audio family's sharded step
    on one device, from the config (launch/roofline.py's ``mesh_coll_bytes``
    states the plan): on ``model`` a Mamba2 layer's ``w_out`` and gated-norm
    statistic (one a token), the shared block's or a decoder layer's
    row-parallel outputs (the audio decoder's three, its encoder's two over
    the frames), the embeddings and logits where the vocabulary divides the
    axis; a train step adds the forward again under remat (the decoder's
    only), and at the copies the z/x/dt input, B and C (2 N a token), the
    statistic, the attention's, FFN's and cross K/V's inputs and the head's;
    on ``data`` the rank's pieces (``_rank_elements``)."""
    cfg = get_config(arch)
    data, m = mesh_dims
    shp = REF_SHAPES[shape]
    d, L, N = cfg.d_model, cfg.n_layers, cfg.ssm.state_dim
    rows = shp.global_batch // data if shp.global_batch % data == 0 else shp.global_batch
    seq = 1 if shp.kind == "decode" else shp.seq_len
    tokens = rows * seq
    vocab = cfg.vocab_size % m == 0
    edges = (tokens * d + (tokens if shp.kind == "train" else rows) * cfg.vocab_size) \
        if vocab else 0
    if cfg.arch_type == "audio":
        enc = 0 if shp.kind == "decode" else cfg.n_enc_layers * 2 * rows * cfg.enc_seq * d
        fwd, again = enc + L * 3 * tokens * d, L * 3 * tokens * d
        back = enc + L * (3 * tokens + rows * cfg.enc_seq) * d
    else:
        calls = L // cfg.attn_every if cfg.arch_type == "hybrid" else 0
        fwd = again = L * tokens * (d + 1) + calls * 2 * tokens * d
        back = L * tokens * (d + 2 * N + 1) + calls * 2 * tokens * d
    model = fwd + edges
    if shp.kind == "train":
        model += (again if remat else 0) + back + (tokens * d if vocab else 0)
    want = {"all-reduce model": model * 4 * 2 * (m - 1) / m}
    if shp.kind == "train" and data > 1:
        pieces = _rank_elements(arch, shape, mesh_dims)
        want["all-reduce data"] = sum(n for n, _, _ in pieces.values()) * 4 * 2 * \
            (data - 1) / data
    return want


def _audio_split_heads_coll_want(shape, mesh_dims):
    """whisper-base's ``mesh_coll_bytes`` where the model axis splits its 8
    heads: ``_family_coll_want``'s all_reduces, with a train step's
    backward all_reduce of the gathered q, k and v's gradients (the
    forward's gathered elements, the decoder's once); and the all-gathers,
    (m - 1) / m of what each gathers: q, k and v in each encoder layer over
    the frames, and in each decoder layer the self-attention's q, k and v
    and the cross q over the tokens and the cross k and v over the frames
    (a decode step: the new token's self q, k, v and cross q, and two
    merges a layer, every rank's partial and log-sum-exp, ``H (D + 1)`` a
    sequence from each of m), the decoder's again under remat."""
    cfg, shp = get_config("whisper-base"), INPUT_SHAPES[shape]
    data, m = mesh_dims
    H, D, L = cfg.n_heads, cfg.resolved_head_dim, cfg.n_layers
    assert cfg.n_kv_heads == H
    rows = shp.global_batch // data if shp.global_batch % data == 0 else shp.global_batch
    decode, train = shp.kind == "decode", shp.kind == "train"
    tokens = rows * (1 if decode else shp.seq_len)
    frames = 0 if decode else rows * cfg.enc_seq
    encoder = cfg.n_enc_layers * frames * 3 * H * D
    decoder = L * (tokens * 4 * H * D + frames * 2 * H * D)
    merges = 2 * L * m * rows * H * (D + 1) if decode else 0
    want = _family_coll_want("whisper-base", shape, mesh_dims)
    if train:
        want["all-reduce model"] += (encoder + decoder) * 4 * 2 * (m - 1) / m
    want["all-gather model"] = (encoder + decoder + merges + (decoder if train else 0)) * \
        4 * (m - 1) / m
    return want


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
@pytest.mark.parametrize("mesh_dims", [(1, 2), (2, 2), (16, 16)],
                         ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b", "whisper-base"])
def test_mesh_coll_bytes_of_the_ssm_hybrid_and_audio_families(arch, mesh_dims, shape):
    """``mesh_coll_bytes`` of each family's prefill, decode and train steps
    on 1 x 2 and 2 x 2 (one node: NVLink), and on 16 x 16: mamba2-1.3b's and
    zamba2-2.7b's heads 16 divides; whisper-base's 8 heads it splits, so
    there its step gathers q, k and v and merges its decode attention
    (``_audio_split_heads_coll_want``)."""
    cfg, mesh = get_config(arch), mesh_shape(mesh_dims)
    got = roofline.mesh_coll_bytes(cfg, INPUT_SHAPES[shape], mesh)
    want = _family_coll_want(arch, shape, mesh_dims)
    if steps.splits_heads(cfg, mesh_dims[-1]):
        assert arch == "whisper-base" and mesh_dims == (16, 16)
        want = _audio_split_heads_coll_want(shape, mesh_dims)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-12), key


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_the_dry_run_states_the_rank_layouts_extra_bytes(arch):
    """``dryrun --mesh-shape 16x16``'s ``layout_extra_bytes`` for a decode:
    each Mamba2 leaf's rank piece (B and C whole) less its shard under the
    reference's spec, and the ``conv`` cache's B/C channels, which its
    spec's contiguous block of channels does not hold; ``arg_bytes`` stays
    the reference's specs' (tested above)."""
    shape = "decode_32k"
    rec, line = dryrun.run_one(arch, shape, mesh=(16, 16))
    assert rec["status"] == "ok", line
    cfg = get_config(arch)
    want = sum((n - spec_n) * size for n, spec_n, size in
               _rank_elements(arch, shape, (16, 16)).values())
    conv = _port_inputs(arch, shape)["cache"]["conv"]      # (L, B, w - 1, ch)
    L, B, w, ch = conv.shape
    di, N = cfg.d_inner, cfg.ssm.state_dim
    want += L * (B // 16) * w * (di // 16 + 2 * N - ch // 16) * conv.element_size()
    assert want > 0
    assert rec["layout_extra_bytes"] == want
    assert rec["fits"] == (rec["arg_bytes"] + want <= roofline.CARD_BYTES)


def test_the_dry_run_counts_whisper_bases_cross_pool_on_round_robin_pages():
    """whisper-base's ``decode_32k`` on 16 x 16 (8 rows a device): a rank
    holds its round-robin pages of each row's cross pool, ceil(94 / 16) = 6
    pages of 16 positions (1500 encoder positions fill 94 pages), where the
    reference's spec cuts the pool's ``head_dim``, a sixteenth of 94 pages:
    ``layout_extra_bytes`` is the difference, for ``cross_k`` and
    ``cross_v`` in every layer, bf16; the self pool's 2048 pages a row
    divide over the ranks and add nothing. Its collective bytes are the
    split-heads plan's."""
    rec, line = dryrun.run_one("whisper-base", "decode_32k", mesh=(16, 16))
    assert rec["status"] == "ok", line
    cfg, m = get_config("whisper-base"), 16
    rows = INPUT_SHAPES["decode_32k"].global_batch // 16
    pages = -(-cfg.enc_seq // 16)
    held = -(-pages // m) * 16                # positions a rank holds of a row
    assert (pages, held) == (94, 96)
    position = cfg.n_kv_heads * cfg.resolved_head_dim * 2          # bf16
    want = 2 * cfg.n_layers * rows * (held * position - pages * 16 * position // m)
    assert rec["layout_extra_bytes"] == want > 0
    assert rec["fits"] == (rec["arg_bytes"] + want <= roofline.CARD_BYTES)
    assert rec["coll_breakdown"] == pytest.approx(
        _audio_split_heads_coll_want("decode_32k", (16, 16)), rel=1e-12)


# every config of the registry
REGISTRY = sorted(set(ASSIGNED_ARCHS) | {"llama-8b", "llama-70b"})


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k", "long_500k"])
@pytest.mark.parametrize("arch", REGISTRY)
def test_every_registry_config_runs_on_the_production_mesh(arch, shape):
    """On the reference's 16 x 16 mesh ``check_mesh_runs`` refuses no config
    of the registry at the prefill, decode, train or ``long_500k`` shape
    (where ``resolve_config`` gives every attention model a window of 4096,
    on split heads for six of them), and each step has a plan."""
    from repro_torch import configs
    assert set(REGISTRY) == set(configs._ARCH_MODULES)
    cfg = steps.resolve_config(get_config(arch), INPUT_SHAPES[shape])
    steps.check_mesh_runs(cfg, {"data": 16, "model": 16})
    assert roofline.mesh_coll_bytes(cfg, INPUT_SHAPES[shape], mesh_shape((16, 16)))


@pytest.mark.parametrize("arch", REGISTRY)
def test_the_dry_run_plans_every_registry_config_at_long_500k(arch):
    """The dry run on 16 x 16 plans every config of the registry at
    ``long_500k``, as the reference's compiles it: a decode of one sequence
    whose attention layers hold a ring of 4096 positions (256 pages, 16 a
    rank where the axis splits the heads), so that the round-robin ring
    adds nothing to the reference's bytes: ``layout_extra_bytes`` is 0 on
    split heads but for whisper-base's cross pool of 1500 encoder positions
    (94 pages, 6 a rank: 96 positions where the specs give 94;
    ``test_the_dry_run_counts_whisper_bases_cross_pool_on_round_robin_pages``)."""
    rec, line = dryrun.run_one(arch, "long_500k", mesh=(16, 16))
    assert rec["status"] == "ok" and rec["coll_bytes"] is not None, line
    cfg = steps.resolve_config(get_config(arch), INPUT_SHAPES["long_500k"])
    if steps.splits_heads(cfg, 16):
        assert cfg.sliding_window == 4096, line
        position = cfg.n_kv_heads * cfg.resolved_head_dim * 2          # bf16
        cross = 2 * cfg.n_layers * (96 - 94) * position if arch == "whisper-base" else 0
        assert rec["layout_extra_bytes"] == cross, line


SPLIT_HEADS = ["llama-8b", "granite-8b", "llama-70b", "yi-34b", "internvl2-2b"]


def _split_heads_coll_want(arch, shape, mesh_dims, *, remat=True, zero=False):
    """``mesh_coll_bytes`` by formula where the model axis splits the heads:
    the row-parallel ``wo`` and ``w_down`` all_reduces and the
    vocabulary-sharded edges as on whole heads, in float32 at a ring's 2 (m -
    1) / m; and the all-gathers, (m - 1) / m of what each gathers: q, k and v
    in every layer, and a decode step's merge, every rank's partial output
    and log-sum-exp (``H (D + 1)`` a sequence a layer from each of m). A
    train step adds the layers' forward again under ``remat`` (its
    all_reduces and its gathers), the backward's all_reduces at the
    attention's, the FFN's and the head's inputs and of the gathered q, k
    and v's gradients, and the gradient's average over ``data``
    (``_data_coll_want``)."""
    cfg, shp = get_config(arch), INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    data, m = mesh_dims
    d, L, H, Hkv = cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads
    D = cfg.resolved_head_dim
    train = shp.kind == "train"
    rows = shp.global_batch // data if shp.global_batch % data == 0 else shp.global_batch
    seq = 1 if shp.kind == "decode" else shp.seq_len
    n_vis = cfg.n_vision_tokens if shp.kind != "decode" else 0
    tokens = rows * (seq + n_vis)
    vocab = cfg.vocab_size % m == 0
    logits = rows * seq if train else rows
    edges = rows * seq * d + logits * cfg.vocab_size if vocab else 0
    layers = L * 2 * tokens * d
    model = layers + edges
    qkv = L * tokens * (H + 2 * Hkv) * D
    gathered = qkv
    if shp.kind == "decode":
        gathered += L * m * rows * H * (D + 1)
    want = {}
    if train:
        model += (layers if remat else 0) + layers + (rows * seq * d if vocab else 0) + qkv
        gathered += qkv if remat else 0
        want = _data_coll_want(arch, shape, mesh_dims, zero=zero)
    return {"all-reduce model": model * 4 * 2 * (m - 1) / m,
            "all-gather model": gathered * 4 * (m - 1) / m, **want}


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", SPLIT_HEADS)
def test_mesh_coll_bytes_where_the_model_axis_splits_the_heads(arch, shape):
    """The five configs whose 8 KV heads the production model axis of 16
    splits (yi-34b's 56 heads too): their prefill and decode steps on 16 x
    16 have a plan, counted by formula, and so has ``long_500k``'s decode of
    one sequence on a ring of 4096 positions (the window ``resolve_config``
    gives them there); ``arg_bytes`` stays the bytes of the reference's
    specs, and at these lengths each row's pages divide over the 16 ranks,
    so the round-robin pool adds nothing (``layout_extra_bytes`` 0). Their
    train step has a plan too (``test_mesh_coll_bytes_of_a_split_heads_train_step``),
    and so has whisper-base's step of this shape, counted by
    ``_audio_split_heads_coll_want``."""
    cfg = steps.resolve_config(get_config(arch), INPUT_SHAPES[shape])
    mesh = mesh_shape((16, 16))
    got = roofline.mesh_coll_bytes(cfg, INPUT_SHAPES[shape], mesh)
    want = _split_heads_coll_want(arch, shape, (16, 16))
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-12), key
    assert roofline.mesh_coll_bytes(cfg, INPUT_SHAPES["train_4k"], mesh) is not None
    audio = roofline.mesh_coll_bytes(get_config("whisper-base"), INPUT_SHAPES[shape], mesh)
    assert audio == pytest.approx(_audio_split_heads_coll_want(shape, (16, 16)), rel=1e-12)
    if arch in ASSIGNED_ARCHS:
        test_dryrun_on_a_mesh_reports_the_local_bytes_of_the_references_specs(arch, shape)
    rec, line = dryrun.run_one(arch, shape, mesh=(16, 16))
    assert rec["status"] == "ok" and rec["layout_extra_bytes"] == 0, line


@pytest.mark.parametrize("zero", [False, True], ids=["", "zero"])
@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", SPLIT_HEADS)
def test_mesh_coll_bytes_of_a_split_heads_train_step(arch, remat, zero):
    """The five configs' ``train_4k`` on 16 x 16, which the model axis's
    split heads once left unplanned: counted by formula, with and without
    remat (which gathers q, k and v a second time) and ZeRO-1."""
    cfg, mesh = get_config(arch), mesh_shape((16, 16))
    got = roofline.mesh_coll_bytes(cfg, INPUT_SHAPES["train_4k"], mesh, remat=remat,
                                   zero_opt=zero)
    want = _split_heads_coll_want(arch, "train_4k", (16, 16), remat=remat, zero=zero)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-12), key


def test_the_dry_runs_split_heads_train_bytes():
    """llama-8b's ``train_4k`` on 16 x 16 through the dry run: ``arg_bytes``
    the local bytes of the reference's specs of its parameters, batch and
    AdamW state (a rank's column blocks of ``wq``/``wk``/``wv`` and rows of
    ``wo`` among them), with and without ZeRO-1, as
    ``test_the_dry_runs_train_bytes_on_a_mesh_with_zero`` holds olmo-1b's;
    its collective bytes the split-heads train step's plan."""
    arch, shape = "llama-8b", "train_4k"
    mesh, sizes = _ref_mesh((16, 16)), {"data": 16, "model": 16}
    ref = _ref_inputs(arch, shape)
    p_sh = ref_sh.param_shardings(mesh, ref["params"])
    base = _ref_local_bytes(ref["params"], p_sh, sizes) + \
        _ref_local_bytes(ref["batch"], ref_sh.batch_shardings(mesh, ref["batch"]), sizes)
    for zero in (False, True):
        rec, line = dryrun.run_one(arch, shape, mesh=(16, 16), zero_opt=zero)
        assert rec["status"] == "ok" and rec["layout_extra_bytes"] == 0, line
        o_sh = ref_sh.opt_shardings(mesh, ref["opt_state"], p_sh, zero=zero)
        assert rec["arg_bytes"] == base + _ref_local_bytes(ref["opt_state"], o_sh, sizes), zero
        coll = _split_heads_coll_want(arch, shape, (16, 16), zero=zero)
        assert set(rec["coll_breakdown"]) == set(coll)
        for key, value in coll.items():
            assert rec["coll_breakdown"][key] == pytest.approx(value, rel=1e-12), key


def test_the_planned_split_heads_decode_on_one_node():
    """llama-70b's decode of 8 sequences on 1 x 16 (the pair the launch
    tests once held unplanned): counted by the same formula. Its rows of 4
    pages round up to one page on each of the 16 ranks: a rank holds 16
    positions a row where the reference's specs give it 4, in the dry run's
    ``layout_extra_bytes``."""
    cfg, mesh = get_config("llama-70b"), mesh_shape((1, 16))
    shape = InputShape("s", 64, 8, "decode")
    got = roofline.mesh_coll_bytes(cfg, shape, mesh)
    want = _split_heads_coll_want("llama-70b", shape, (1, 16))
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-12), key
    _, mem = roofline.plan(cfg.with_(n_layers=2), shape, mesh=mesh)
    position = cfg.n_kv_heads * cfg.resolved_head_dim * 2          # bf16
    assert mem["layout_extra_bytes"] == 2 * 2 * 8 * (16 - 4) * position   # k, v; 2 layers
