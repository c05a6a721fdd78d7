"""The port's models.  ``transformer``: the dense decoder-only LM
(forward, prefill, KV-cache decode), held against
``repro.models.transformer`` on the same parameters.  ``gnn``: GatedGCN,
PNA, EGNN and MACE over a COO graph batch, held against
``repro.models.gnn``."""
