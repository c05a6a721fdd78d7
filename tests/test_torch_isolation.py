"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py`` or ``tools/port_join_ab.py``) imports JAX or the JAX
package, and its entry points run on the card unless the caller asks
for the CPU."""
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
    assert {"repro_torch.core.vlftj", "repro_torch.convert",
            "repro_torch.kernels.intersect", "repro_torch.results.cursor",
            "repro_torch.results.expand", "repro_torch.results.backward",
            "repro_torch.results.factorize",
            "repro_torch.results.result_set",
            "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.segment_outer",
            "repro_torch.layers.common", "repro_torch.models.transformer",
            "repro_torch.configs.common", "repro_torch.configs.chatglm3_6b",
            "repro_torch.configs.stablelm_3b",
            "repro_torch.core.relation", "repro_torch.core.lftj_ref",
            "repro_torch.core.minesweeper_ref",
            "repro_torch.core.binary_join", "repro_torch.graphs.io",
            "repro_torch.analysis", "repro_torch.analysis.findings",
            "repro_torch.analysis.recompile",
            "repro_torch.analysis.verifier"} <= set(mods)
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
                         [ROOT / "chip_smoke.py",
                          ROOT / "tools" / "port_join_ab.py"],
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


def test_default_device_is_the_card_for_the_transformer(monkeypatch):
    """Parameters built for the default device raise without a card;
    device='cpu' is the explicit way."""
    import torch
    from repro_torch.configs import STABLELM_3B, reduced_cfg
    from repro_torch.models.transformer import init_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_cfg(STABLELM_3B)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, torch.Generator().manual_seed(0))
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["embed"].device.type == "cpu"
