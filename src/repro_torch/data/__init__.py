"""Deterministic data pipelines (the port of ``repro.data``)."""
from .pipeline import (LMTokenPipeline, RecSysPipeline, lm_synthetic_batch,
                       recsys_synthetic_batch)

__all__ = ["LMTokenPipeline", "RecSysPipeline", "lm_synthetic_batch",
           "recsys_synthetic_batch"]
