"""Query serving of the port: the batched query server and the
preemptive quantum scheduler (the port of ``repro.serve``)."""
from .query_server import QueryRequest, QueryResult, QueryServer
from .scheduler import (AdmissionError, PlanSnapshot, Preempted,
                        QuantumBudget, QuantumScheduler, TenantQuota)

__all__ = [
    "QueryRequest", "QueryResult", "QueryServer",
    "AdmissionError", "PlanSnapshot", "Preempted", "QuantumBudget",
    "QuantumScheduler", "TenantQuota",
]
