"""Enumeration on the Zipf hybrid db (renumbered, hub bitsets) vs the
JAX package: ``tests/test_torch_results.py``'s flat and factorized
parity cases, in a file of their own so that they run beside the
plain-db half under ``pytest -n``."""
import pytest
from test_torch_engine import SHAPES, _hybrid_pair
from test_torch_results import (ENGINES, check_enumerate_parity,
                                check_factorized_parity)


@pytest.fixture(scope="module")
def hybrid():
    return _hybrid_pair()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", SHAPES)
def test_enumerate_rows_match_hybrid(shape, engine, hybrid):
    check_enumerate_parity(shape, engine, *hybrid)


@pytest.mark.parametrize("shape", SHAPES)
def test_factorized_matches_hybrid(shape, hybrid):
    check_factorized_parity(shape, *hybrid)
