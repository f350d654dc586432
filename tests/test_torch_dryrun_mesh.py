"""The port's mesh dry run: collectives, per-device FLOPs and mesh cells.

``parse_collectives`` reads the reference's HLO snippet
(tests/test_dryrun_small.py) to the reference's counts and bytes.
``trace_collectives`` records the functional collectives a traced DTensor
step issues under a fake process group of 8 ranks, (data 2, model 4), with
the counts and wire bytes reckoned by hand; ``trace_device`` counts each
rank's local FLOPs: global / chips for a fully sharded product, the global
count for a replicated one. ``python -m repro_torch.launch.dryrun --mesh
2,4`` runs the reference's two mesh cells (qwen1.5-0.5b ``train_4k``,
qwen2-0.5b ``decode_32k``) and ``--multi-pod`` a two-layer cell, each in a
subprocess.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.launch.analysis import parse_collectives as jax_parse_collectives  # noqa: E402
from repro_torch.launch import analysis  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_mesh  # noqa: E402
from repro_torch.sharding import partition  # noqa: E402
from repro_torch.training.steps import BuiltStep  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

HLO = """
  %ar = f32[128,256]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag.1 = bf16[64,512]{1,0} all-gather(%y), replica_groups=[2,4]<=[8], dimensions={1}
  %rs = f32[32]{0} reduce-scatter(%z), replica_groups={{0,1}}, dimensions={0}
  %cp = collective-permute-start(%w), source_target_pairs={{0,1}}
  %single = f32[8]{0} all-reduce(%q), replica_groups={{0}}, to_apply=%add
"""


def test_parse_collectives_reads_the_reference_snippet():
    stats, want = analysis.parse_collectives(HLO), jax_parse_collectives(HLO)
    assert stats.counts == want.counts == {"all-reduce": 1, "all-gather": 1, "reduce-scatter": 1}
    assert stats.result_bytes == want.result_bytes
    assert stats.wire_bytes == pytest.approx(want.wire_bytes)
    ar, ag, rs = 128 * 256 * 4, 64 * 512 * 2, 32 * 4
    assert stats.wire_bytes["all-reduce"] == pytest.approx(2 * ar * 3 / 4)
    assert stats.wire_bytes["all-gather"] == pytest.approx(ag * 3 / 4)
    assert stats.wire_bytes["reduce-scatter"] == pytest.approx(rs * 1)
    assert stats.to_dict()["total_wire_bytes"] == int(want.total_wire_bytes)


def _meta(shape, mesh, placements):
    from torch.distributed.tensor import DTensor, Replicate

    t = DTensor.from_local(torch.empty(shape, device="meta"), mesh,
                           [Replicate()] * mesh.ndim, run_check=False)
    return t.redistribute(mesh, placements)


def _built(fn, mesh, *args):
    rep = partition.NamedSharding(mesh, partition.P())
    return BuiltStep(fn, tuple(rep for _ in args), None, (), args)


def test_trace_collectives_of_an_fsdp_tp_product():
    """x (16, 32) batch-split over data; w (32, 64) FSDP over data and TP over
    model. Gathering w's data split is one all-gather (result (32, 16) f32 =
    2048 B a device, 2 ranks: wire 1024); the product needs nothing; its
    output gathered over model is another (result (8, 64) f32 = 2048 B,
    4 ranks: wire 1536); a row sum is partial over model: replicating it is
    an all-reduce (8 f32 = 32 B: wire 2·32·3/4 = 48) and scattering it a
    reduce-scatter (result 2 f32 = 8 B: wire 8·3 = 24)."""
    from torch.distributed.tensor import Replicate, Shard

    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        x = _meta((16, 32), mesh, [Shard(0), Replicate()])
        w = _meta((32, 64), mesh, [Shard(0), Shard(1)])

        def step(x, w):
            y = x @ partition.gather_fsdp(w)
            assert tuple(y.placements) == (Shard(0), Shard(1))
            z = y.redistribute(mesh, [Shard(0), Replicate()])
            s = y.sum(dim=1)
            return z, s.redistribute(mesh, [Shard(0), Replicate()]), s.redistribute(
                mesh, [Shard(0), Shard(0)])

        stats = analysis.trace_collectives(_built(step, mesh, x, w))
    assert stats.counts == {"all-gather": 2, "all-reduce": 1, "reduce-scatter": 1}
    assert stats.result_bytes == {"all-gather": 4096, "all-reduce": 32, "reduce-scatter": 8}
    assert stats.wire_bytes == pytest.approx(
        {"all-gather": 1024 + 1536, "all-reduce": 48, "reduce-scatter": 24})
    assert stats.pod_wire_bytes == 0


def test_per_device_flops_of_sharded_and_replicated_products():
    from torch.distributed.tensor import Replicate, Shard

    global_flops = 2 * 16 * 32 * 64
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        x = _meta((16, 32), mesh, [Shard(0), Replicate()])
        w = _meta((32, 64), mesh, [Replicate(), Shard(1)])
        sharded = analysis.trace_device(_built(lambda x, w: x @ w, mesh, x, w))
        xr, wr = _meta((16, 32), mesh, [Replicate()] * 2), _meta((32, 64), mesh, [Replicate()] * 2)
        replicated = analysis.trace_device(_built(lambda x, w: x @ w, mesh, xr, wr))
        # FlopCounterMode over the DTensor product counts the global op
        from torch.utils.flop_counter import FlopCounterMode
        counter = FlopCounterMode(display=False)
        with counter:
            x @ w
    assert sharded["flops_per_device"] == global_flops / 8
    assert sharded["collectives"]["total_wire_bytes"] == 0
    assert replicated["flops_per_device"] == global_flops
    assert counter.get_total_flops() == global_flops


def test_roofline_collective_term_uses_nvlink_and_infiniband():
    r = analysis.roofline_terms(0.0, 0.0, wire_bytes=450e9)
    assert r["collective_s"] == 1.0 and r["bottleneck"] == "collective"
    r = analysis.roofline_terms(0.0, 0.0, wire_bytes=450e9 + 50e9, pod_wire_bytes=50e9)
    assert r["collective_s"] == 2.0
    r = analysis.roofline_terms(989e12, 0.0, model_flops_total=989e12 * 4, n_chips=8)
    assert r["useful_flops_ratio"] == 0.5 and r["roofline_fraction"] == 0.5


def _dryrun(tmp_path, *args):
    results = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                          "--results", str(results)],
                         capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    return json.loads(results.read_text())


@pytest.mark.parametrize("arch,shape", [("qwen1.5-0.5b", "train_4k"),
                                        ("qwen2-0.5b", "decode_32k")])
def test_dryrun_mesh_cells_of_the_reference(tmp_path, arch, shape):
    res = _dryrun(tmp_path, "--arch", arch, "--shape", shape, "--mesh", "2,4")
    (key, rec), = res.items()
    assert key == f"{arch}|{shape}|mesh=2x4|"
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == {"axes": {"data": 2, "model": 4}, "devices": 8, "platform": "cpu"}
    a = rec["analysis"]
    assert a["calibrated"]["matches_full_depth"]
    assert 0 < a["roofline"]["useful_flops_ratio"] <= 1.5
    assert a["cost"]["flops_per_device"] > 0
    assert set(a["roofline"]) >= {"compute_s", "memory_s", "collective_s", "bottleneck"}
    if shape == "train_4k":
        assert a["cost"]["wire_bytes_per_device"] > 0
        assert a["cost"]["collectives"]["counts"]
    assert rec["shardings"]["embed/tok"] == ["model", "data"]
    assert a["fit"]["total"] == pytest.approx(sum(a["fit"]["terms"].values()))


def test_dryrun_multi_pod_cell(tmp_path):
    res = _dryrun(tmp_path, "--arch", "qwen2-0.5b", "--shape", "train_4k", "--multi-pod",
                  "--override", "n_layers=1")
    (key, rec), = res.items()
    assert key == "qwen2-0.5b|train_4k|mesh=2x16x16|n_layers=1"
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"]["devices"] == 512
    # the batch splits jointly over pod and data; the weights' FSDP split too
    assert rec["shardings"]["final_norm/scale"] == [["pod", "data"]]
    cost = rec["analysis"]["cost"]
    assert 0 < cost["pod_wire_bytes_per_device"] <= cost["wire_bytes_per_device"]
    assert rec["analysis"]["roofline"]["collective_s"] > 0


def test_dryrun_by_op_breaks_one_layer_down(tmp_path):
    results = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "qwen1.5-0.5b", "--shape", "train_4k", "--mesh", "2,4", "--calibrated",
                          "--by-op", "--results", str(results)],
                         capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    (rec,) = json.loads(results.read_text()).values()
    cal = rec["analysis"]["calibrated"]
    layer = cal["flops_per_device_per_layer"]
    assert layer > 0
    assert sum(cal["flops_by_op_per_layer"].values()) == pytest.approx(layer, rel=1e-12)
    assert sum(cal["flops_by_shape_per_layer"].values()) == pytest.approx(layer, rel=1e-12)
    # the printout: the ops, then the largest product by its local operand shapes
    top_key, top = max(cal["flops_by_shape_per_layer"].items(), key=lambda kv: kv[1])
    assert f"{top:.4e}  {top_key}" in out.stdout
    assert any(line.split()[:1] == ["aten.mm"] for line in out.stdout.splitlines())
