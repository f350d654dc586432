"""A later change adds a configuration, a mix, a metric and a cell by adding
files and entries: the harness resolves them with no file of it edited."""
import hashlib
import json
import shutil
from pathlib import Path

from perfbench import bench

ROOT = Path(__file__).resolve().parents[2]


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_resolves_from_added_files_only(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    pkg = tmp_path / "perfbench"
    cfg = json.loads((pkg / "configs" / "qwen2-moe-a2.7b.json").read_text())
    cfg["name"] = cfg["model"]["name"] = "tiny-moe"
    (pkg / "configs" / "tiny-moe.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "longprompt.json").write_text(json.dumps(
        {"driver": "frontdoor", "clients": 8, "max_batch": 8, "max_len": 8192,
         "prompt": {"median": 4096, "sigma": 0.3, "min": 2048, "max": 6144},
         "output": {"median": 16, "sigma": 0.5, "min": 8, "max": 32}, "strata": 32,
         "warm_s": 4.0, "check_requests": 6}))
    (pkg / "metrics" / "admissions.serve.py").write_text(
        "def read(ctx):\n    return len(ctx['win']['records'])\n")
    (pkg / "limits" / "tiny-longprompt.json").write_text(json.dumps({"logit_gap": 0.5}))
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny-moe", "source": "https://example.org/tiny",
                         "file": "perfbench/configs/tiny-moe.json", "reduced": [], "why": "x"})
    b["workloads"].append({"name": "tiny-longprompt", "config": "tiny-moe",
                           "traffic": "longprompt", "chips": 1, "why": "x"})
    b["end_to_end"][0]["workloads"].append("tiny-longprompt")
    b["per_layer"].append({"name": "admissions.serve", "unit": "requests", "better": "higher",
                           "source": "program_counter", "layer": "engine admission",
                           "moves": "serve_tokens_per_s", "workloads": ["tiny-longprompt"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell = bench.resolve("tiny-longprompt", root=tmp_path)
    assert cell.model["name"] == "tiny-moe"
    assert cell.mix["prompt"]["max"] == 6144
    assert cell.driver().__name__ == "perfbench.drivers.frontdoor"
    assert cell.reference().__name__ == "perfbench.reference.moe"
    assert list(cell.readers) == ["admissions.serve"]
    assert cell.readers["admissions.serve"].read({"win": {"records": [1, 2]}}) == 2
    assert [m["name"] for m in cell.end_to_end] == ["serve_tokens_per_s", "setup_s"]
    assert cell.limits == {"logit_gap": 0.5}
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before     # nothing edited
    # the cells already there resolve as before
    assert bench.resolve("moe-chat", root=tmp_path).readers.keys() == \
        bench.resolve("moe-chat").readers.keys()
