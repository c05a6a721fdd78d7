"""``warm_graph_build_s``: host seconds the query server spends on each
sample first seen in the window: its four node samples
(``server.sample``), its statistics (``server.stats``) and its device
tensors (``graph.build``, the copies inside them too), as the union of
those program spans from the window's opening to the last reply due in
it, over the fresh samples."""
from portbench import program_spans
from portbench.measure import fresh_samples

NAMES = ("server.sample", "server.stats", "graph.build")

program_spans.open_log()


def read(run):
    recs = [r for r in program_spans.take(run) if r.name in NAMES]
    fresh = fresh_samples(run)
    if not recs or not fresh:
        return None
    return program_spans.union_s(recs, run.t_open * 1e9,
                                 program_spans.window_end_ns(run)) / len(fresh)
