"""``warm_graph_mb``: megabytes of card memory that each sample first
seen in the window leaves held once the window has drained: the query
server's warm graph for it (``torch.cuda.memory_allocated``, after
over before, over the fresh samples)."""
from portbench.measure import fresh_samples


def read(run):
    fresh = fresh_samples(run)
    if not fresh or run.memory.get("open") is None:
        return None
    return (run.memory["end"] - run.memory["open"]) / len(fresh) / 1e6
