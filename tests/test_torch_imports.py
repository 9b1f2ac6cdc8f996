"""The port stands alone: it imports neither JAX nor the reference package,
every module of it imports on a host with no GPU and no triton, and its
entry points refuse to run on the CPU unasked."""
import ast
import importlib
import pathlib
import pkgutil

import pytest
import torch

import repro_torch
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import Model
from repro_torch.serving.engine import Engine

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
TWINS = sorted((ROOT / "examples").glob("*_torch.py")) + \
    sorted((ROOT / "scripts").glob("*_torch.py"))
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + TWINS
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_nothing_of_the_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_sources_were_found():
    names = {p.name for p in SOURCES}
    assert {"engine.py", "layers.py", "paged_attention.py", "flash_prefill.py",
            "ssd_scan.py", "ssm.py", "mamba_model.py", "_build.py", "serve.py",
            "chip_smoke.py", "global_queue.py", "real_cluster.py", "cluster_trace.py",
            "global_autoscaler.py", "request_groups.py", "waiting_time.py",
            "baselines.py", "perf_model.py", "cluster.py", "controllers.py",
            "simulator.py", "workload.py", "trace_io.py", "ledger.py", "metrics.py",
            "overload.py", "recorder.py", "shadow.py", "fleet.py", "scenarios.py",
            "checks.py", "findings.py", "export.py", "__main__.py", "steps.py",
            "roofline.py", "dryrun.py", "mesh.py", "quickstart_torch.py",
            "serve_autoscaled_torch.py", "train_tiny_torch.py",
            "cluster_experiment_torch.py", "scenario_sweep_torch.py",
            "dev_engine_torch.py", "dev_kernels_torch.py", "dev_smoke_torch.py",
            "dev_sim_torch.py", "profile_sim_torch.py", "ci_fast_torch.py"} <= names


def test_every_module_imports_without_gpu_or_triton():
    mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
    assert len(mods) >= 20
    for name in mods:
        importlib.import_module(name)


def test_kernel_sources_are_in_the_package():
    from repro_torch.kernels import _build
    assert set(_build.KERNEL_SOURCES) == {"paged_attention", "flash_prefill",
                                          "flash_prefill_bwd", "ssd_scan", "ssd_scan_bwd"}
    for name in _build.KERNEL_SOURCES:
        text = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
        assert f'extern "C" int {name}_launch' in text
        assert "torch/extension.h" not in text


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the entry points run on it")
    cfg = get_smoke_config("llama-8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, max_slots=2, max_len=32)            # device defaults to cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg).init()
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg).init_cache(1, 16)


def test_ssm_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the entry points run on it")
    cfg = get_smoke_config("mamba2-1.3b")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, max_slots=2, max_len=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg).init()
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg).init_cache(1, 16)


class _Elsewhere(torch.Tensor):
    """A tensor that claims a device which is neither the CPU, the meta
    device nor CUDA, and refuses to compute."""

    @staticmethod
    def __new__(cls, *shape):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=torch.float32,
                                                   device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"{func} ran on a tensor of another device")


def test_cuda_tensor_path_never_falls_back_to_plain():
    """The wrappers take the plain version for CPU tensors, and for meta
    tensors (which compute nothing: the dry run counts the plain versions'
    products on them), only: a tensor on any other device is launched or
    refused. On meta no kernel launch is counted."""
    from repro_torch.kernels import flash_prefill, ops, paged_attention, ssd_scan
    before = (flash_prefill.flash_prefill.launches,
              paged_attention.paged_attention.launches, ssd_scan.ssd_scan.launches)
    x = torch.zeros((1, 2, 16, 64), device="meta")
    assert ops.flash_prefill(x, x, x).shape == x.shape
    q = torch.zeros((1, 2, 1, 64), device="meta")
    pool = torch.zeros((4, 16, 2, 64), device="meta")
    table = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    lengths = torch.zeros((1,), dtype=torch.int32, device="meta")
    assert ops.paged_attention(q, pool, pool, table, lengths).device.type == "meta"
    y, state = ops.ssd_scan(x, x[..., 0], x[0, 0, :, 0], x[..., 0], x[..., 0])
    assert y.shape == x.shape and state.device.type == "meta"
    assert before == (flash_prefill.flash_prefill.launches,
                      paged_attention.paged_attention.launches,
                      ssd_scan.ssd_scan.launches)
    e = _Elsewhere(1, 2, 4, 64)
    with pytest.raises(ValueError, match="not supported"):
        ops.flash_prefill(e, e, e)
    with pytest.raises(ValueError, match="not supported"):
        ops.paged_attention(e, e, e, e, e)
    with pytest.raises(ValueError, match="not supported"):
        ops.ssd_scan(e, _Elsewhere(1, 2, 4), _Elsewhere(4), _Elsewhere(1, 2, 64),
                     _Elsewhere(1, 2, 64))


def test_unported_configs_and_families_raise():
    """Every architecture and family of the reference is ported: whisper-base
    and the audio family build, cross-attention (``kv_x``) runs, and an
    unknown architecture or family raises."""
    assert get_config("whisper-base").arch_type == "audio"
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    cfg = get_smoke_config("llama-8b")
    with pytest.raises(KeyError):
        Model(cfg.with_(arch_type="no-such-family"))
    for arch, family in (("qwen2-moe-a2.7b", "moe"), ("deepseek-moe-16b", "moe"),
                         ("zamba2-2.7b", "hybrid"), ("whisper-base", "audio")):
        for c in (get_config(arch), get_smoke_config(arch)):
            assert Model(c).cfg.arch_type == family
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(0)
    p = layers.init_attention(cfg, gen, torch.float32, "cpu")
    x, enc = torch.zeros((1, 4, cfg.d_model)), torch.ones((1, 9, cfg.d_model))
    assert layers.attention_forward(cfg, p, x, kv_x=enc, causal=False,
                                    use_rope=False).shape == x.shape
