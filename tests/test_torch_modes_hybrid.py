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


@pytest.mark.parametrize("shape", ["3-clique", "4-clique", "4-cycle"])
def test_bitset_rows_pass_lane_len_and_match_hybrid(shape, hybrid,
                                                    monkeypatch):
    """The hub rows' bitset check gets ``lane_len`` (the probe degrees, as
    an int32 row vector) at every launch, and counts and stats still
    equal the reference's on the Zipf hybrid db."""
    import torch
    from repro_torch.core import vlftj as t_vlftj
    from repro_torch.kernels import ref
    seen = []

    def spy(words, row, cand, lane_len=None):
        seen.append(lane_len)
        return ref.bitset_member_mask_ref(words, row, cand, lane_len)

    monkeypatch.setattr(t_vlftj.kops, "bitset_member_mask", spy)
    check_mode_parity(shape, {}, *hybrid)
    assert seen
    for lane_len in seen:
        assert lane_len is not None and lane_len.dtype == torch.int32
        assert lane_len.dim() == 1 and int(lane_len.min()) >= 0
