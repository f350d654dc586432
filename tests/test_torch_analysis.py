"""The port's dry run and roofline analysis for one H100, on the CPU.

``model_flops`` and ``modeled_hbm_bytes`` (one device: ``n_chips=1``,
``model_axis=1``) equal the JAX package's for every cell; the depth
calibration extrapolates two shallow ``FlopCounterMode`` counts to the
full-depth count exactly, for a reduced config of each family and each step
kind; a meta tensor reaches no kernel launch; the memory fit adds its terms;
the dry-run and executor-block CLIs run in subprocesses.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.launch import analysis as jax_analysis  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.kv_cache import cache_bytes  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import steps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = {"dense": "qwen2-0.5b", "moe": "qwen2-moe-a2.7b", "mla": "minicpm3-4b",
            "ssm": "mamba2-2.7b", "hybrid": "zamba2-2.7b", "encdec": "whisper-small",
            "vlm": "internvl2-26b"}


def _jax_model_flops():
    """``repro.launch.dryrun.model_flops``: the module forces 512 host devices
    through XLA_FLAGS when imported, so the flag is put back at once (no JAX
    backend in this process has read it before)."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch.dryrun import model_flops
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return model_flops


@pytest.mark.parametrize("shape", list(configs.SHAPES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_flops_and_modeled_bytes_equal_the_reference(arch, shape):
    ours_cfg, ours_shape = configs.get_config(arch), configs.SHAPES[shape]
    cfg, spec = jax_configs.get_config(arch), jax_configs.SHAPES[shape]
    assert dryrun.model_flops(ours_cfg, ours_shape) == _jax_model_flops()(cfg, spec)
    assert analysis.modeled_hbm_bytes(ours_cfg, ours_shape, n_chips=1, model_axis=1) == \
        jax_analysis.modeled_hbm_bytes(cfg, spec, n_chips=1, model_axis=1)


def _reduced_flops(arch: str, kind: str, n_layers: int) -> float:
    cfg = configs.get_reduced(arch)
    cfg = cfg.with_(n_layers=n_layers)
    seq = 32 + (cfg.n_patches if cfg.family == "vlm" else 0)
    shape = configs.ShapeSpec(kind, kind, seq, 2)
    model = Model(cfg, device="meta", kernel_impl="ref")
    if kind == "train":
        model.requires_grad_(True)
        built = steps.build_train_step(model, opt.OptimizerConfig(), shape=shape)
    elif kind == "prefill":
        built = steps.build_prefill_step(model, shape=shape)
    else:
        built = steps.build_decode_step(model, shape=shape)
    return analysis.trace_costs(built)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_calibrated_flops_equal_the_full_depth_count(family, kind):
    arch = FAMILIES[family]
    cfg = configs.get_reduced(arch)
    L1, L2, units = dryrun._calibration_depths(cfg)
    full = _reduced_flops(arch, kind, cfg.n_layers)
    assert full["flops_per_device"] > 0
    assert "aten.mm" in full["flops_by_op"] or "aten.addmm" in full["flops_by_op"]
    total = analysis.extrapolate(_reduced_flops(arch, kind, L1), _reduced_flops(arch, kind, L2),
                                 units)
    assert total["flops_per_device"] == full["flops_per_device"]
    assert total["flops_per_device_per_layer"] > 0


def test_meta_tensors_take_the_plain_versions():
    """Under impl="auto" a meta tensor reaches no ctypes launch: each kernel
    wrapper computes its plain version's shapes, the SSD scan with autograd
    recording too."""
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
    q, k, v = m(2, 8, 4, 16), m(2, 8, 2, 16), m(2, 8, 2, 16)
    assert attn_ops.flash_attention(q, k, v).shape == (2, 8, 4, 16)
    assert attn_ops.decode_attention(q[:, :1], k, v, 5).shape == (2, 1, 4, 16)
    res, out = rms_ops.fused_add_rmsnorm(m(3, 32), m(3, 32), m(32), 1e-6)
    assert res.device.type == out.device.type == "meta"
    x = m(1, 16, 4, 8).requires_grad_()
    y, state = ssd_kernel.ssd(x, m(1, 16, 4), m(4), m(1, 16, 1, 8), m(1, 16, 1, 8), chunk=8,
                              return_final_state=True)
    assert y.shape == x.shape and state.shape == (1, 4, 8, 8) and y.requires_grad
    assert ssd_kernel.LAUNCHES["ssd"] == 0


def test_roofline_terms_use_the_h100_figures():
    assert analysis.HW["peak_flops_bf16"] == 989e12 and analysis.HW["hbm_bw"] == 3.35e12
    assert "H100" in analysis.HW["name"]
    r = analysis.roofline_terms(989e12, 3.35e12 / 2, model_flops_total=989e12 / 2)
    assert r["compute_s"] == 1.0 and r["memory_s"] == 0.5 and r["bottleneck"] == "compute"
    assert r["step_time_lower_bound_s"] == 1.0
    assert r["useful_flops_ratio"] == 0.5 and r["roofline_fraction"] == 0.5
    r = analysis.roofline_terms(1.0, 3.35e12)
    assert r["bottleneck"] == "memory" and r["step_time_lower_bound_s"] == 1.0


def test_memory_fit_adds_its_terms():
    cfg, shape = configs.get_config("qwen2-0.5b"), configs.SHAPES["decode_32k"]
    fit = analysis.memory_fit(cfg, shape, capacity=80e9)
    assert fit["terms"]["cache"] == cache_bytes(cfg, 128, 32768)
    assert fit["total"] == sum(fit["terms"].values()) and fit["fits"]
    weights, elems = analysis.weight_bytes(cfg)
    assert fit["terms"]["params"] == weights and elems == sum(
        p.numel() for p in Model(cfg, device="meta").parameters())
    train = analysis.memory_fit(cfg, configs.SHAPES["train_4k"], capacity=80e9)
    assert train["terms"]["optimizer"] == 12 * elems and train["terms"]["grads"] == 2 * elems
    assert not train["fits"]
    # the largest batch that fits is monotone: one more row does not fit
    prefill = configs.SHAPES["prefill_32k"]
    n = analysis.max_batch(cfg, prefill, capacity=80e9)
    assert 0 < n < prefill.global_batch
    assert analysis.memory_fit(cfg, prefill, batch=n, capacity=80e9)["fits"]
    assert not analysis.memory_fit(cfg, prefill, batch=n + 1, capacity=80e9)["fits"]


def _cli(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                           "--results", str(tmp_path / "r.json")],
                          capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)


def test_dryrun_cli_records_fits_and_skips(tmp_path):
    for arch, shape in (("qwen2-0.5b", "decode_32k"), ("deepseek-67b", "train_4k"),
                        ("qwen2-0.5b", "long_500k")):
        out = _cli(tmp_path, "--arch", arch, "--shape", shape)
        assert out.returncode == 0, out.stdout + out.stderr
    res = json.loads((tmp_path / "r.json").read_text())
    fit = res["qwen2-0.5b|decode_32k|1xH100|"]
    assert fit["status"] == "ok" and fit["analysis"]["fit"]["fits"] is True
    assert fit["analysis"]["calibrated"]["matches_full_depth"]
    assert fit["analysis"]["roofline"]["bottleneck"] == "memory"
    big = res["deepseek-67b|train_4k|1xH100|"]
    assert big["status"] == "ok" and big["analysis"]["fit"]["fits"] is False
    assert big["analysis"]["fit"]["max_batch"] == 0
    assert big["analysis"]["roofline"]["bottleneck"] == "compute"
    skip = res["qwen2-0.5b|long_500k|1xH100|"]
    assert skip["status"] == "skipped" and "sub-quadratic" in skip["reason"]
    out = _cli(tmp_path, "--arch", "qwen2-0.5b", "--shape", "decode_32k")
    assert out.returncode == 0 and "[cached]" in out.stdout


@pytest.mark.parametrize("flag", [["--mesh", "2,4"], ["--multi-pod"], ["--both-meshes"]])
def test_dryrun_cli_refuses_a_mesh_naming_the_sharding_slice(tmp_path, flag):
    """Since the mesh half of A5 a mesh cell is traced (tests/test_torch_dryrun_mesh.py);
    what the CLI refuses is ``--run`` on a mesh: it times cells on one card."""
    out = _cli(tmp_path, "--arch", "qwen2-0.5b", "--shape", "train_4k", *flag, "--run")
    assert out.returncode != 0 and "a mesh cell is traced only" in out.stderr


def test_dryrun_cli_run_needs_a_card(tmp_path):
    out = _cli(tmp_path, "--arch", "mamba2-2.7b", "--shape", "long_500k", "--run")
    assert out.returncode != 0 and "CUDA" in out.stderr


def test_executor_block_exits_when_idle():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.executor_block",
                          "--block-id", "t0", "--workers", "2", "--heartbeat-s", "0.2",
                          "--idle-exit-s", "0.5"],
                         capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[executor_block t0] up: 2 workers" in out.stdout
    assert "[executor_block t0] shut down" in out.stdout
