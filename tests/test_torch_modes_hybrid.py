"""The VLFTJ check modes on the Zipf hybrid db (renumbered, hub bitsets)
vs the JAX package: ``tests/test_torch_modes.py``'s settings and shapes,
in a file of their own so that they run beside the plain-db half under
``pytest -n``."""
import pytest
from test_torch_engine import SHAPES, _hybrid_pair
from test_torch_modes import MODES, check_mode_parity, mode_id


@pytest.fixture(scope="module")
def hybrid():
    return _hybrid_pair()


@pytest.mark.parametrize("kw", MODES, ids=mode_id)
@pytest.mark.parametrize("shape", SHAPES)
def test_mode_counts_and_stats_match_hybrid(shape, kw, hybrid):
    check_mode_parity(shape, kw, *hybrid)
