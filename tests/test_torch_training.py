"""The port's training substrate against the reference's, float32 on the
CPU: the counterparts of ``tests/test_training.py`` (AdamW, the clip, a
falling loss, remat against no remat, the checkpoint round trip), one and
two ``make_train_step`` steps against the reference's jitted step on the
same parameters and batches (loss, gradient norm and parameters), the
synthetic batches draw for draw, checkpoints read across the packages, and
the launcher. Attention's gradient runs through ``FlashPrefill`` and the
SSD scan's through ``SSDScan``, each with its plain backward here (the
backward kernels on the card)."""
import gc
import os
import tempfile
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import steps as ref_steps
from repro.launch import train as ref_train
from repro.models import Model as RefModel
from repro.training import checkpoint as ref_ckpt
from repro.training import optimizer as ref_opt
from repro_torch import params as port_params
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as port_train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.training import tree
from repro_torch.training.checkpoint import (checkpoint_meta, load_checkpoint,
                                             save_checkpoint)
from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

TOL = 1e-4


def _pair(arch, seed=0):
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    ref_model = RefModel(rcfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    params = port_params.from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                                        device="cpu", dtype=torch.float32)
    return ref_model, ref_params, Model(cfg), params


def _ref_batch(batch):
    return {k: jnp.asarray(v.numpy().astype(np.int32) if k == "tokens" else v.numpy())
            for k, v in batch.items()}


def _assert_trees_close(got, want, tol=TOL):
    got_leaves, want_leaves = tree.leaves(got), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=tol, rtol=tol)


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    for _ in range(300):
        w = params["w"].clone().requires_grad_(True)
        g, = torch.autograd.grad(torch.sum(torch.square(w - 1.0)), [w])
        params, opt, _ = adamw_update({"w": g}, opt, params, lr=0.05, weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), [1.0, 1.0], atol=0.05)


def test_grad_clip():
    params = {"w": torch.tensor([0.0])}
    opt = adamw_init(params)
    p2, opt2, info = adamw_update({"w": torch.tensor([1e9])}, opt, params, lr=0.1,
                                  grad_clip=1.0)
    assert float(info["grad_norm"]) == 1e9
    assert abs(float(p2["w"][0])) < 1.0   # clipped update
    assert int(opt2.step) == 1 and params["w"].item() == 0.0   # inputs unchanged


def test_adamw_update_matches_the_reference():
    """Two updates of a nested tree with a mixed-shape gradient, leaf for
    leaf in ``jax.tree.flatten``'s order."""
    rng = np.random.default_rng(0)
    shapes = {"b": {"z": (3,), "a": (2, 2)}, "a": (4,)}
    p = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                     is_leaf=lambda x: isinstance(x, tuple))
    gs = [jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                       is_leaf=lambda x: isinstance(x, tuple)) for _ in range(2)]
    rp, rs = jax.tree.map(jnp.asarray, p), ref_opt.adamw_init(jax.tree.map(jnp.asarray, p))
    tp = tree.tree_map(torch.from_numpy, p)
    ts = adamw_init(tp)
    for g in gs:
        rp, rs, rinfo = ref_opt.adamw_update(jax.tree.map(jnp.asarray, g), rs, rp,
                                             lr=0.1, grad_clip=2.0)
        tp, ts, info = adamw_update(tree.tree_map(torch.from_numpy, g), ts, tp, lr=0.1,
                                    grad_clip=2.0)
        assert abs(float(info["grad_norm"]) - float(rinfo["grad_norm"])) <= 1e-6
        _assert_trees_close(tp, rp, 1e-6)
        _assert_trees_close(ts.mu, rs.mu, 1e-6)
        _assert_trees_close(ts.nu, rs.nu, 1e-6)


def test_lm_training_loss_decreases():
    res = port_train.train(get_smoke_config("olmo-1b"), steps=30, batch=4, seq=32,
                           lr=3e-3, device="cpu")
    losses = res["losses"]
    assert losses[-1] < losses[0] * 0.9, losses[:3] + losses[-3:]


def test_remat_matches_no_remat():
    model = Model(get_smoke_config("granite-8b"))
    params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32,
                        device="cpu")
    batch = model.example_batch(2, 32, torch.Generator().manual_seed(1),
                                dtype=torch.float32, device="cpu")
    flat, treedef = tree.flatten(params)
    results = []
    for remat in (False, True):
        leaves = [p.clone().requires_grad_(True) for p in flat]
        loss = model.loss(tree.unflatten(treedef, leaves), batch, remat=remat)
        results.append((float(loss.detach()), torch.autograd.grad(loss, leaves)))
    (l1, g1), (l2, g2) = results
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)


def test_tree_helpers_free_the_leaves_at_once():
    """Flattening and rebuilding a tree leaves no reference cycle behind: once
    the caller drops them, the leaves are freed without the cyclic collector
    (a train step's old parameters and gradients go when the step returns)."""
    params = {"b": {"w": torch.ones(3)}, "a": torch.zeros(2)}
    state = adamw_init(params)
    refs = [weakref.ref(t) for t in tree.leaves(params) + tree.leaves(state)]
    gc.collect()
    gc.disable()
    try:
        flat, treedef = tree.flatten(params)
        rebuilt = tree.unflatten(treedef, flat)
        mapped = tree.tree_map(torch.neg, state)
        assert [t.tolist() for t in tree.leaves(rebuilt)] == [[0.0, 0.0], [1.0, 1.0, 1.0]]
        del params, state, flat, rebuilt, mapped
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_checkpoint_roundtrip():
    model = Model(get_smoke_config("olmo-1b"))
    params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32,
                        device="cpu")
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, params, meta={"arch": model.cfg.name})
        restored = load_checkpoint(d, tree.tree_map(torch.zeros_like, params))
        assert checkpoint_meta(d) == {"arch": model.cfg.name}
    for a, b in zip(tree.leaves(params), tree.leaves(restored)):
        assert torch.equal(a, b)


def test_synthetic_batches_match_the_reference_draw_for_draw():
    for arch in ("olmo-1b", "whisper-base", "internvl2-2b"):
        ref_model, model = RefModel(ref_smoke_config(arch)), Model(get_smoke_config(arch))
        ra, pa = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(3):
            want = ref_train.synthetic_lm_batch(ra, ref_model, 3, 17)
            got = port_train.synthetic_lm_batch(pa, model, 3, 17, device="cpu")
            assert sorted(got) == sorted(want)
            for key in got:
                np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-8b"])
@pytest.mark.parametrize("microbatch", [0, 2])
def test_train_steps_match_the_reference(arch, microbatch):
    """Two steps from the same parameters on the same batches: the loss and
    the gradient norm of each step, and the parameters and moments after
    each, against the reference's jitted ``make_train_step``."""
    ref_model, ref_params, model, params = _pair(arch, seed=1)
    ref_step = jax.jit(ref_steps.make_train_step(ref_model.cfg, remat=False, lr=3e-3,
                                                 microbatch=microbatch))
    step = make_train_step(model.cfg, remat=False, lr=3e-3, microbatch=microbatch)
    ropt, opt = ref_opt.adamw_init(ref_params), adamw_init(params)
    rng = np.random.default_rng(2)
    for _ in range(2):
        batch = port_train.synthetic_lm_batch(rng, model, 4, 24, device="cpu")
        ref_params, ropt, rm = ref_step(ref_params, ropt, _ref_batch(batch))
        params, opt, m = step(params, opt, batch)
        assert abs(float(m["loss"]) - float(rm["loss"])) <= TOL
        assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) <= \
            TOL * max(1.0, float(rm["grad_norm"]))
        _assert_trees_close(params, ref_params)
        _assert_trees_close(opt.mu, ropt.mu)
    assert int(opt.step) == int(ropt.step) == 2


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_ssm_and_hybrid_train_steps_match_the_reference(arch):
    """Six steps of mamba2-1.3b and zamba2-2.7b (smoke) at lr 3e-4 on
    ``synthetic_lm_batch``: each step's loss and gradient norm, and the
    parameters and moments after it, against the reference's jitted
    ``make_train_step``. Both packages' losses stay near their first value
    over these steps (6.807 -> 6.663 for mamba2-1.3b), so a loss that barely
    falls at this rate is the reference's behaviour too."""
    ref_model, ref_params, model, params = _pair(arch, seed=1)
    ref_step = jax.jit(ref_steps.make_train_step(ref_model.cfg, remat=False, lr=3e-4))
    step = make_train_step(model.cfg, remat=False, lr=3e-4)
    ropt, opt = ref_opt.adamw_init(ref_params), adamw_init(params)
    rng = np.random.default_rng(2)
    for i in range(6):
        batch = port_train.synthetic_lm_batch(rng, model, 4, 40, device="cpu")
        ref_params, ropt, rm = ref_step(ref_params, ropt, _ref_batch(batch))
        params, opt, m = step(params, opt, batch)
        print(f"{arch} step {i}: loss {float(rm['loss']):.6f} (reference) "
              f"{float(m['loss']):.6f} (port)")
        assert abs(float(m["loss"]) - float(rm["loss"])) <= TOL
        assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) <= \
            TOL * max(1.0, float(rm["grad_norm"]))
        _assert_trees_close(params, ref_params)
        _assert_trees_close(opt.mu, ropt.mu)
    assert int(opt.step) == int(ropt.step) == 6


@pytest.mark.parametrize("remat", [False, True])
def test_audio_gradients_match_the_reference(remat):
    """whisper-base (smoke): the loss and every parameter's gradient against
    ``jax.grad`` of the reference's loss, through the encoder's full and the
    decoder's causal and cross attention, with random frame embeddings.
    (Parameters after an AdamW step are not compared: an update divides each
    gradient by its own magnitude, so the leaves whose gradients are ~1e-9
    move by a share of ``lr`` that depends on the order of the sums.)"""
    ref_model, ref_params, model, params = _pair("whisper-base", seed=5)
    batch = model.example_batch(2, 20, torch.Generator().manual_seed(5),
                                dtype=torch.float32, device="cpu")
    rloss, rgrads = jax.value_and_grad(
        lambda p: ref_model.loss(p, _ref_batch(batch), remat=remat))(ref_params)
    flat, treedef = tree.flatten(params)
    leaves = [p.clone().requires_grad_(True) for p in flat]
    loss = model.loss(tree.unflatten(treedef, leaves), batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(rloss)) <= TOL
    _assert_trees_close(tree.unflatten(treedef, list(grads)), rgrads)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_ssm_and_hybrid_gradients_match_the_reference(arch, remat):
    """mamba2-1.3b and zamba2-2.7b (smoke): the loss and every parameter's
    gradient against ``jax.grad`` of the reference's loss, 2 x 40 tokens in
    chunks of 32 (the last one ragged). The SSD scan's gradient runs through
    ``SSDScan`` and the plain backward (the reference's through ``jax.grad``
    of its jnp oracle), zamba2's shared attention through ``FlashPrefill``."""
    ref_model, ref_params, model, params = _pair(arch, seed=8)
    batch = port_train.synthetic_lm_batch(np.random.default_rng(8), model, 2, 40,
                                          device="cpu")
    rloss, rgrads = jax.value_and_grad(
        lambda p: ref_model.loss(p, _ref_batch(batch), remat=remat))(ref_params)
    flat, treedef = tree.flatten(params)
    leaves = [p.clone().requires_grad_(True) for p in flat]
    loss = model.loss(tree.unflatten(treedef, leaves), batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(rloss)) <= TOL
    _assert_trees_close(tree.unflatten(treedef, list(grads)), rgrads)


def test_train_step_with_remat_matches_without():
    _, _, model, params = _pair("olmo-1b", seed=3)
    batch = port_train.synthetic_lm_batch(np.random.default_rng(3), model, 2, 16,
                                          device="cpu")
    out = [make_train_step(model.cfg, remat=r, lr=1e-3)(params, adamw_init(params), batch)
           for r in (False, True)]
    assert abs(float(out[0][2]["loss"]) - float(out[1][2]["loss"])) <= 1e-6
    for a, b in zip(tree.leaves(out[0][0]), tree.leaves(out[1][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_are_read_across_the_packages(writer):
    """Parameters and an AdamW state (a NamedTuple of trees): the reference
    writes and the port reads, or the reverse, leaf for leaf."""
    ref_model, ref_params, model, params = _pair("olmo-1b", seed=4)
    ropt = ref_opt.adamw_init(ref_params)
    ropt = ref_opt.AdamWState(ropt.step + 3, jax.tree.map(lambda p: p * 0.5, ref_params),
                              jax.tree.map(lambda p: p * p, ref_params))
    opt = AdamWState(torch.tensor(3, dtype=torch.int32),
                     tree.tree_map(lambda p: p * 0.5, params),
                     tree.tree_map(lambda p: p * p, params))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt")
        if writer == "reference":
            ref_ckpt.save_checkpoint(path, {"params": ref_params, "opt": ropt},
                                     meta={"by": "reference"})
            like = {"params": tree.tree_map(torch.zeros_like, params),
                    "opt": adamw_init(params)}
            got = load_checkpoint(path, like)
            _assert_trees_close(got, {"params": ref_params, "opt": ropt}, 0)
            assert checkpoint_meta(path) == {"by": "reference"}
        else:
            save_checkpoint(path, {"params": params, "opt": opt}, meta={"by": "port"})
            like = {"params": jax.tree.map(jnp.zeros_like, ref_params),
                    "opt": ref_opt.adamw_init(ref_params)}
            got = ref_ckpt.load_checkpoint(path, like)
            _assert_trees_close({"params": params, "opt": opt}, got, 0)
            assert ref_ckpt.checkpoint_meta(path) == {"by": "port"}


def test_train_launcher_on_the_cpu(capsys):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt")
        port_train.main(["--arch", "olmo-1b", "--steps", "3", "--batch", "2",
                         "--seq", "16", "--device", "cpu", "--checkpoint", path])
        assert checkpoint_meta(path) == {"arch": "olmo-1b", "steps": 3}
    out = capsys.readouterr().out
    assert "loss" in out and "checkpoint saved" in out


def test_training_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the entry points run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.train(get_smoke_config("olmo-1b"), steps=1, batch=1, seq=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.main(["--steps", "1"])
