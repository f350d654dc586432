"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke`` loads neither ``jax`` nor anything of ``repro`` (nor
``msgpack``, which the card's machine lacks: the port carries its own codec),
and no source of the port names them in an import."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)  # defines main() without running it
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "repro", "msgpack"))
import torch.distributed as dist
print(len(names), "modules;", "leaked:", leaked, "group:", dist.is_initialized())
print("names:", ",".join(names))
sys.exit(1 if leaked else 0)
"""

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|msgpack)\b|from\s+(jax|msgpack)\b"
    r"|import\s+repro(\.|\s*$|\s*,|\s+as\b)|from\s+repro(\.|\s+import\b))",
    re.M,
)


def test_importing_the_port_loads_no_jax_and_no_repro():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "leaked: []" in proc.stdout
    # the mesh modules are among those imported, and importing them starts no
    # process group (the mesh is a function of an initialized world)
    assert "group: False" in proc.stdout
    names = proc.stdout.split("names:", 1)[1].strip().split(",")
    assert {"repro_torch.sharding.partition", "repro_torch.sharding.local",
            "repro_torch.launch.mesh"} <= set(names)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_and_no_repro(path):
    hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(path.read_text())]
    assert not hits, f"{path}: {hits}"


def test_forbidden_pattern_catches_what_it_should():
    bad = ["import jax", "import jax.numpy as jnp", "from jax import lax", "import repro",
           "from repro.models import model", "from repro import configs", "import repro.core",
           "import msgpack", "from msgpack import ExtType"]
    good = ["import repro_torch", "from repro_torch.models import model", "import jaxlib_free",
            "from .ref import NEG_INF"]
    assert all(_FORBIDDEN.search(s) for s in bad)
    assert not any(_FORBIDDEN.search(s) for s in good)
