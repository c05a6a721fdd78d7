"""repro_torch: the PyTorch and CUDA port of ``repro`` for NVIDIA Hopper.

Counts graph patterns over a CSR graph with the same planner and the same
three device engines as the JAX package (``vlftj``, ``yannakakis``,
``hybrid``), held against it on the same inputs: counts match exactly.

* ``graphs/`` and the planning half of ``core/`` (query, hypergraph, gao,
  agm, plan, planner) are copies of the JAX package's numpy/scipy
  modules: the port imports nothing of ``repro`` (any ``import repro``
  imports JAX).
* ``core/device_graph.py`` puts the graph on ``device`` (``"cuda"`` by
  default; ``"cpu"`` runs the plain PyTorch path), and the engines run
  where the graph lives.
* ``kernels/`` holds the hand-written CUDA kernels (sources in
  ``csrc/``), their plain PyTorch versions, and the router that picks
  between them by the tensors' device.
* ``convert.py`` builds the port's graph databases and plans from the
  JAX package's plain arrays and fields.

Counts are int64, written out explicitly (the JAX package gets int64
from its global x64 switch).
"""
__version__ = "0.1.0"
