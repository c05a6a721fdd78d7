"""The benchmark of the PyTorch and CUDA port: graph-pattern queries
served by ``repro_torch`` (see ``run.py``)."""
