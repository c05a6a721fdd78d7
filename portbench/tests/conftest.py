"""CPU tests of the benchmark (``python -m pytest portbench/tests``).

Tests marked ``card`` need an NVIDIA card; they decide inside a fixture
whether one is present and skip without it."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    return "cuda"


#: tiny graphs for each configuration, for runs on the CPU
TINY = {"soc-livejournal1": {"graph": {"n_nodes": 3000, "n_edges": 15000,
                                       "degree_cap": 300}}}


def bench_with(root, extra: dict):
    """A copy of the benchmark under ``root`` with ``extra``'s entries
    added: new files and entries only, no file the benchmark has edited."""
    import shutil
    from portbench import harness
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in extra.items():
        spec[key] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.Bench(root)
