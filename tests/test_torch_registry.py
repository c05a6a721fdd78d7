"""The port's architecture registry against the JAX package's: the same
11 ids in the same order, each record's family, shapes (``opt_variants``
merged) and configuration field by field (dtypes mapped by name), the
LM records' microbatches, reduced configs and parameter counts, xDeepFM's
reduced config, the paper engine's shapes, and every record's
``smoke(device="cpu")`` finite (the mirror of
``tests/test_arch_configs.py::test_arch_smoke``).  Exact equality
throughout; a smoke value need only be finite, as in the JAX test."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_arch as j_get_arch
from repro.configs import common as jcommon
from repro.configs import wcoj as jwcoj

from repro_torch import configs as tconfigs
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import common as tcommon
from repro_torch.configs import wcoj as twcoj

torch.set_num_threads(1)

LM_IDS = [a for a, arch in J_ARCHS.items() if arch.family == "lm"]


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else jnp.dtype(dt).name


def _fields(cfg) -> dict:
    """A config's fields by name, dtypes by name and nested configs (an
    MoE config) as dicts."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            v = _dtype_name(v)
        elif dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        out[f.name] = v
    return out


def test_ids_and_order_match_jax():
    assert list(T_ARCHS) == list(J_ARCHS)
    assert len(T_ARCHS) == 11
    for arch_id in J_ARCHS:
        assert tconfigs.get_arch(arch_id) is T_ARCHS[arch_id]
        assert j_get_arch(arch_id).arch_id == arch_id


@pytest.mark.parametrize("arch_id", list(J_ARCHS))
def test_family_and_shapes_match_jax(arch_id):
    t, j = T_ARCHS[arch_id], J_ARCHS[arch_id]
    assert t.arch_id == j.arch_id == arch_id
    assert t.family == j.family
    assert t.shapes == j.shapes
    assert getattr(t, "opt_variants", {}) == getattr(j, "opt_variants", {})


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_records_match_jax(arch_id):
    """Config field by field, microbatches, full attention, the reduced
    config and both parameter counts, full and reduced."""
    t, j = T_ARCHS[arch_id], J_ARCHS[arch_id]
    assert isinstance(t, tcommon.LMArch)
    assert _fields(t.cfg) == _fields(j.cfg)
    assert (t.microbatches, t.full_attention) == (j.microbatches,
                                                  j.full_attention)
    assert _fields(t.reduced_cfg()) == _fields(j.reduced_cfg())
    assert t.reduced_cfg() == tconfigs.reduced_cfg(t.cfg)
    for tc, jc in ((t.cfg, j.cfg), (t.reduced_cfg(), j.reduced_cfg())):
        assert (tc.n_params, tc.n_active_params) == (jc.n_params,
                                                     jc.n_active_params)


def test_command_r_plus_104b():
    """The one LM that had no port config before the registry: 103.8 B
    parameters, heads of 128 in GQA groups of 12, 8 microbatches and the
    JAX package's three §Perf variants, merged into its shapes."""
    cfg = tconfigs.COMMAND_R_PLUS_104B
    arch = T_ARCHS["command-r-plus-104b"]
    assert arch.cfg is cfg and cfg.n_params == 103_810_609_152
    assert (cfg.head_dim, cfg.n_heads // cfg.n_kv_heads) == (128, 12)
    assert arch.microbatches == 8
    assert {k: v["base"] for k, v in arch.shapes.items() if "base" in v} \
        == dict.fromkeys(("train_4k_b1", "train_4k_b2", "train_4k_b3"),
                         "train_4k")


def test_recsys_record_matches_jax():
    t, j = T_ARCHS["xdeepfm"], J_ARCHS["xdeepfm"]
    assert isinstance(t, tcommon.RecsysArch)
    assert _fields(t.cfg) == _fields(j.cfg)
    assert _fields(t.reduced_cfg()) == _fields(j.reduced_cfg())
    assert t.cfg.total_vocab == j.cfg.total_vocab == 39_000_000
    assert tcommon.RECSYS_SHAPES == jcommon.RECSYS_SHAPES


def test_shape_tables_match_jax():
    assert tcommon.LM_SHAPES == jcommon.LM_SHAPES
    assert tcommon.GNN_SHAPES == jcommon.GNN_SHAPES
    assert twcoj.WCOJ_SHAPES == jwcoj.WCOJ_SHAPES
    assert T_ARCHS["wcoj"].shapes == jwcoj.WCOJ_SHAPES


@pytest.mark.parametrize("arch_id", list(J_ARCHS))
def test_arch_smoke_on_the_cpu(arch_id):
    out = T_ARCHS[arch_id].smoke(device="cpu")
    assert set(out) == ({"triangles"} if arch_id == "wcoj" else {"loss"})
    for v in out.values():
        assert np.isfinite(v)


def test_wcoj_smoke_counts_what_the_jax_smoke_counts():
    """The same graph and query: the same triangle count."""
    assert T_ARCHS["wcoj"].smoke(device="cpu") == J_ARCHS["wcoj"].smoke()
