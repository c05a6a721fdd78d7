"""Result enumeration of the port: flat and factorized result sets,
streaming cursors, and backward expansion for the counting engines.

Entry points: ``repro_torch.core.engine.enumerate`` (one contract for
every device engine) and ``repro_torch.core.engine.stream`` (page
cursor).
"""
from .backward import hybrid_rows, yannakakis_rows
from .cursor import ResultCursor
from .expand import segment_expand
from .factorize import factorize_vlftj
from .result_set import FactorizedResult, FLevel, ResultSet, lex_sorted

__all__ = [
    "FactorizedResult", "FLevel", "ResultSet", "ResultCursor",
    "factorize_vlftj", "hybrid_rows", "yannakakis_rows", "lex_sorted",
    "segment_expand",
]
