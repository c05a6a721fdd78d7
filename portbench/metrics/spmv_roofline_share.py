"""``spmv_roofline_share``: the tree messages' share of their bound.

A message (``core/yannakakis.py`` ``_spmv``) is one gather of the count
vector over every CSR entry and one ``index_add_`` back.  The least it
must move is its int32 ``indices`` and ``src_ids`` (8 bytes an entry)
and the int64 vector in and out (16 bytes a node); at the card's HBM
rate that is its bound.  Messages are counted as the ``index_add_``
kernels' launches, and their time is the device time of those kernels
and of the gathers (``torch.profiler``), from the window's opening to
the last reply due in it."""
from portbench.measure import is_spmv_gather, is_spmv_scatter
from portbench.peaks import HBM_BYTES_S


def read(run):
    if run.timeline is None:
        return None
    _, messages = run.timeline.device_s(is_spmv_scatter)
    seconds, _ = run.timeline.device_s(
        lambda k: is_spmv_scatter(k) or is_spmv_gather(k))
    if not messages or seconds <= 0:
        return None
    nbytes = 8 * run.graph["n_entries"] + 16 * run.graph["n_nodes"]
    return 100.0 * messages * nbytes / HBM_BYTES_S / seconds
