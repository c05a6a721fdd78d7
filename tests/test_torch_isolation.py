"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py`` or the ``tools/`` scripts that drive it) imports JAX
or the JAX package, and its entry points run on the card unless the
caller asks for the CPU."""
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
            "repro_torch.layers.moe",
            "repro_torch.configs.common", "repro_torch.configs.chatglm3_6b",
            "repro_torch.configs.stablelm_3b",
            "repro_torch.configs.granite_moe_3b_a800m",
            "repro_torch.configs.moonshot_v1_16b_a3b",
            "repro_torch.core.relation", "repro_torch.core.lftj_ref",
            "repro_torch.core.minesweeper_ref",
            "repro_torch.core.binary_join", "repro_torch.graphs.io",
            "repro_torch.analysis", "repro_torch.analysis.findings",
            "repro_torch.analysis.recompile",
            "repro_torch.analysis.verifier",
            "repro_torch.analysis.__main__",
            "repro_torch.obs", "repro_torch.obs.schema",
            "repro_torch.obs.metrics", "repro_torch.obs.trace",
            "repro_torch.obs.profile", "repro_torch.obs.explain",
            "repro_torch.obs.export_trace",
            "repro_torch.serve", "repro_torch.serve.query_server",
            "repro_torch.serve.scheduler",
            "repro_torch.dist", "repro_torch.dist.pool",
            "repro_torch.dist.overlap", "repro_torch.dist.compression",
            "repro_torch.dist.sharded_join", "repro_torch.dist.rebalance",
            "repro_torch.dist.sharded_csr",
            "repro_torch.train", "repro_torch.train.stragglers",
            "repro_torch.train.optimizer", "repro_torch.train.loop",
            "repro_torch.train.checkpoint", "repro_torch.train.tree",
            "repro_torch.data", "repro_torch.data.pipeline",
            "repro_torch.dist.compressed_step",
            "repro_torch.graphs.sampling", "repro_torch.models.gnn",
            "repro_torch.models.gnn.data", "repro_torch.models.gnn.gatedgcn",
            "repro_torch.models.gnn.pna", "repro_torch.models.gnn.egnn",
            "repro_torch.models.gnn.mace", "repro_torch.configs.gatedgcn",
            "repro_torch.configs.pna", "repro_torch.configs.egnn",
            "repro_torch.configs.mace", "repro_torch.models.xdeepfm",
            "repro_torch.configs.xdeepfm",
            "repro_torch.configs.command_r_plus_104b",
            "repro_torch.configs.wcoj", "repro_torch.launch",
            "repro_torch.launch.train",
            "repro_torch.launch.serve", "repro_torch.launch.mesh",
            "repro_torch.launch.roofline",
            "repro_torch.launch.dryrun", "repro_torch.layers.sharding",
            "repro_torch.kernels.custom"} <= set(mods)
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
                          ROOT / "tools" / "port_join_ab.py",
                          ROOT / "tools" / "profile_sum_cost.py"],
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


def test_default_device_is_the_card_for_the_server(monkeypatch):
    """``QueryServer(csr)`` with no device puts its graphs on the card:
    without one it raises at construction; with one (stubbed here, the
    graphs build their tensors lazily) every warmed ``GraphDB`` is on
    ``cuda``.  ``device='cpu'`` is the explicit way to the CPU."""
    import torch
    from repro_torch.serve import QueryServer
    g = erdos_renyi(20, 40, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryServer(g)
    assert QueryServer(g, device="cpu")._gdb_for(4, 0).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    srv = QueryServer(g)
    assert srv.device == torch.device("cuda")
    assert srv._gdb_for(4, 0).device.type == "cuda"


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


def test_default_device_is_the_card_for_moe(monkeypatch):
    """The MoE parameters, alone or in an MoE config's model, are made on
    the card unless the caller asks for the CPU."""
    import torch
    from repro_torch.configs import GRANITE_MOE_3B_A800M, reduced_cfg
    from repro_torch.layers.moe import init_moe_params
    from repro_torch.models.transformer import init_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_cfg(GRANITE_MOE_3B_A800M)
    for build in (lambda: init_moe_params(None, 64, cfg.moe, 2),
                  lambda: init_moe_params(torch.Generator().manual_seed(0),
                                          64, cfg.moe, 2),
                  lambda: init_params(cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["moe"]["w_gate"].device.type == "cpu"
    assert init_moe_params(None, 64, cfg.moe, 2, device="cpu")[
        "router"].device.type == "cpu"


def test_default_device_is_the_card_for_dist(monkeypatch):
    """The SPMD steps run on the card unless the caller asks for the
    CPU: without one they raise at construction, before any collective.
    ``PartitionedJoin`` runs where its db lives, and a db built for the
    default device raises without a card."""
    import torch
    from repro_torch.core import get_query
    from repro_torch.dist import (PartitionedJoin, ShardedGraphDB,
                                  spmd_join_step, spmd_sharded_join_step,
                                  spmd_spmv_step)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = erdos_renyi(20, 40, seed=0)
    kw = dict(probe_cols=(0, 1), n_unary=0, lower_cols=(1,),
              upper_cols=(), width=8, n_iter=4, needs_degree=False)
    for build in (lambda: spmd_join_step(None, kw),
                  lambda: spmd_spmv_step(None, g.n_nodes),
                  lambda: spmd_sharded_join_step(None, kw,
                                                 ShardedGraphDB(g, 1))):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    with pytest.raises(RuntimeError, match="CUDA"):
        PartitionedJoin(get_query("3-clique"), GraphDB(g))
    pj = PartitionedJoin(get_query("3-clique"), GraphDB(g, device="cpu"))
    assert pj.executor.gdb.dev("indices").device.type == "cpu"


def test_default_device_is_the_card_for_training(monkeypatch):
    """``Trainer`` runs on the card unless the caller asks for the CPU:
    without one it raises at construction, before any step; with
    ``device='cpu'`` its parameters, optimizer state and batches are on
    the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import STABLELM_3B, reduced_cfg
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.train import OptimizerConfig, Trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_cfg(STABLELM_3B)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    lf = lambda p, b: loss_fn(p, b, cfg)
    batch = lambda step: {"tokens": np.zeros((2, 8), np.int32),
                          "labels": np.ones((2, 8), np.int32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(lf, params, OptimizerConfig(), batch)
    tr = Trainer(lf, params, OptimizerConfig(), batch, device="cpu")
    hist = tr.run(1, log_every=1)
    assert hist[0]["step"] == 1 and np.isfinite(hist[0]["loss"])
    assert tr.opt_state["m"]["wq"].device.type == "cpu"


@pytest.mark.parametrize("what", ["init_gatedgcn", "init_pna", "init_egnn",
                                  "init_mace", "GraphBatch.to",
                                  "gnn_params_from_numpy", "smoke"])
def test_default_device_is_the_card_for_gnns(monkeypatch, what):
    """With no card, each GNN entry point called without a device raises
    instead of landing on the CPU; ``device='cpu'`` is the explicit
    way."""
    import numpy as np
    import torch
    from repro_torch.configs import PNA
    from repro_torch.convert import gnn_params_from_numpy
    from repro_torch.models import gnn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inits = {"init_gatedgcn": (gnn.init_gatedgcn, gnn.GatedGCNConfig),
             "init_pna": (gnn.init_pna, gnn.PNAConfig),
             "init_egnn": (gnn.init_egnn, gnn.EGNNConfig),
             "init_mace": (gnn.init_mace, gnn.MACEConfig)}
    g = gnn.random_graph_batch(5, 4, 2)
    tree = {"enc": np.zeros((2, 2), np.float32)}
    if what in inits:
        init, cfg = inits[what]
        calls = (lambda: init(cfg()),
                 lambda: init(cfg(), torch.Generator().manual_seed(0)))
        cpu = lambda: init(cfg(), device="cpu")["enc"]
    else:
        calls = ({"GraphBatch.to": g.to,
                  "gnn_params_from_numpy": lambda: gnn_params_from_numpy(tree),
                  "smoke": PNA.smoke}[what],)
        cpu = {"GraphBatch.to": lambda: g.to("cpu").src,
               "gnn_params_from_numpy":
                   lambda: gnn_params_from_numpy(tree, device="cpu")["enc"],
               "smoke": lambda: torch.tensor(PNA.smoke("cpu")["loss"])}[what]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert cpu().device.type == "cpu"


@pytest.mark.parametrize("what", ["stablelm-3b", "granite-moe-3b-a800m",
                                  "xdeepfm", "wcoj", "init_xdeepfm",
                                  "launch.train", "launch.serve"])
def test_default_device_is_the_card_for_the_registry_and_launchers(
        monkeypatch, capsys, what):
    """With no card, ``ARCHS[...].smoke()``, ``init_xdeepfm`` and both
    launchers' ``main`` without ``--device`` raise before any work
    instead of landing on the CPU; ``device='cpu'`` (``--device cpu``)
    is the explicit way."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve, train
    from repro_torch.models.xdeepfm import XDeepFMConfig, init_xdeepfm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = XDeepFMConfig(n_sparse=3, embed_dim=2, vocab_per_field=5,
                          cin_layers=(2,), mlp_dims=(4,))
    serve_argv = ["--nodes", "60", "--requests", "2"]
    train_argv = ["--arch", "xdeepfm", "--reduced", "--steps", "1"]
    call, cpu = {
        "init_xdeepfm": (lambda: init_xdeepfm(small),
                         lambda: init_xdeepfm(small, device="cpu")[
                             "embed"].device.type == "cpu"),
        "launch.train": (lambda: train.main(train_argv),
                         lambda: train.main(train_argv + ["--device",
                                                          "cpu"]) == 0),
        "launch.serve": (lambda: serve.main(serve_argv),
                         lambda: serve.main(serve_argv + ["--device",
                                                          "cpu"]) == 0),
    }.get(what, (lambda: ARCHS[what].smoke(),
                 lambda: all(np.isfinite(v) for v in
                             ARCHS[what].smoke(device="cpu").values())))
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    assert capsys.readouterr().out == ""
    assert cpu()
