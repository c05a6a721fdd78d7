"""repro_torch: the PyTorch and CUDA port of ``repro`` for NVIDIA Hopper.

Counts and enumerates graph patterns over a CSR graph with the same
planner and the same three device engines as the JAX package (``vlftj``,
``yannakakis``, ``hybrid``), held against it on the same inputs: counts
and rows match exactly.  Serves the dense LM transformer, whose logits
match the JAX package's within its own tolerances.

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
* ``results/`` holds the enumeration side: flat and factorized result
  sets, the bounded-memory page cursor and backward expansion for the
  message-passing engines (``core.engine.enumerate`` / ``stream``).
* ``layers/``, ``models/transformer.py`` and ``configs/`` serve the
  dense decoder-only LM (prefill, KV-cache decode, forward) with the
  flash-attention kernel in every layer.
* ``convert.py`` builds the port's graph databases and plans from the
  JAX package's plain arrays and fields, and the transformer's
  parameters from the JAX package's.
* ``configs/`` is also the architecture registry (``ARCHS``: the five
  LMs, the four GNNs, xDeepFM of ``models/xdeepfm.py`` and the join
  engine), which ``launch/train.py`` and ``launch/serve.py``, the
  launchers, resolve.

Counts are int64, written out explicitly (the JAX package gets int64
from its global x64 switch).
"""
__version__ = "0.1.0"
