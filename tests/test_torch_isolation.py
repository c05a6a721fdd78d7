"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, and its entry points
run on the card unless the caller asks for the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch
from repro_torch.core import GraphDB, HybridGraphDB
from repro_torch.graphs import erdos_renyi

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_importing_every_port_module_imports_no_jax():
    mods = _port_modules()
    assert "repro_torch.core.vlftj" in mods and "repro_torch.convert" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path}: imports {bad}"


def test_default_device_is_the_card(monkeypatch):
    """With no CUDA device, a db built for the default device raises
    instead of landing on the CPU; device='cpu' is the explicit way."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = erdos_renyi(20, 40, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphDB(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        HybridGraphDB.build(g)
    db = GraphDB(g, device="cpu")
    assert db.dev("indices").device.type == "cpu"
    hdb = HybridGraphDB.build(g, device="cpu")
    assert hdb.dev("bitset_words").device.type == "cpu"
