"""Nothing the harness imports loads JAX or the JAX package, and the plain
reference imports nothing of the program. Top-level module names are
compared whole: ``repro_torch`` begins with ``repro``."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "perfbench"


def _loaded_after(code: str) -> set:
    """The top-level names in ``sys.modules`` after running ``code`` in a fresh
    interpreter with the checkout's ``src`` on its path."""
    script = (f"import sys\nsys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n{code}\n"
              "import json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _every_module() -> str:
    """Code that imports every module of the harness: the package's by name,
    the metric readers by file (their names hold dots)."""
    lines = ["import importlib, importlib.util"]
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT)
        if "tests" in rel.parts:
            continue
        if rel.parts[1] == "metrics" and "." in path.stem:
            lines.append(f"s = importlib.util.spec_from_file_location({path.stem!r}, "
                         f"{str(path)!r})")
            lines.append("m = importlib.util.module_from_spec(s); sys.modules[s.name] = m; "
                         "s.loader.exec_module(m)")
        else:
            name = ".".join(rel.with_suffix("").parts).removesuffix(".__init__")
            lines.append(f"importlib.import_module({name!r})")
    return "\n".join(lines)


def test_the_harness_loads_no_jax_and_no_jax_package():
    loaded = _loaded_after(_every_module() + "\nimport perfbench.run, perfbench.limits")
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}, loaded & {"jax", "jaxlib", "flax",
                                                                     "repro"}


def test_the_harness_with_the_program_loaded_still_has_no_jax():
    code = ("import perfbench.program as p\n"
            "import repro_torch.serving.engine, repro_torch.models.model, "
            "repro_torch.core\n"
            "p.model_config(__import__('perfbench.bench', fromlist=['x'])"
            ".resolve('moe-chat').model)")
    loaded = _loaded_after(code)
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_imports_nothing_of_the_program():
    names = [p.stem for p in (PKG / "reference").glob("*.py") if p.stem != "__init__"]
    code = "\n".join(f"import perfbench.reference.{n}" for n in names)
    loaded = _loaded_after(code)
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    assert "torch" in loaded


def test_the_forbidden_check_compares_whole_top_level_names():
    sys.path.insert(0, str(ROOT))
    from perfbench import run

    before = dict(sys.modules)
    try:
        sys.modules["repro_torch_like.sub"] = sys.modules["json"]
        assert run.forbidden_modules() == sorted(
            {n.split(".")[0] for n in before} & set(run.FORBIDDEN))
        sys.modules["repro.core"] = sys.modules["json"]
        assert "repro" in run.forbidden_modules()
    finally:
        for k in ("repro_torch_like.sub", "repro.core"):
            sys.modules.pop(k, None)


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, str(PKG / "run.py"), "--workload", "moe-chat",
                          "--seed", str(2**40), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
