"""``setup_s``: seconds from the process's start to the window's
opening: imports, the card's start, the graph, the server and its warm
graphs, and the warm-up of every shape (host clock)."""


def read(run):
    return run.setup_s
