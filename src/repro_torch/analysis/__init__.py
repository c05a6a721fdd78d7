"""``repro_torch.analysis`` — static analyses gating execution.

The port's counterpart of ``repro.analysis``.  Two passes, one reporting
currency (:class:`Finding`):

* :mod:`~repro_torch.analysis.verifier` — static plan verification
  (rules ``V101``–``V110``), enforced before any device dispatch via
  :func:`verify_for_execution` (``verify=True``, the default of
  ``core.count`` / ``core.engine.enumerate`` / ``core.engine.stream``);
* :mod:`~repro_torch.analysis.recompile` — the specialization census
  (``V107``), with the JAX package's arithmetic, cross-checkable against
  a :class:`~repro_torch.obs.DeviceProfile` (:func:`check_runtime`).

``python -m repro_torch.analysis --tier1`` runs the verifier and the
census over the planner's output for every tier-1 query shape;
``--self-test`` proves the gate fires.

Both read the plan and host-side graph statistics only: verifying a plan
launches no kernel and copies nothing from the card.
"""
from .findings import (SEVERITIES, Finding, FindingReport,
                       PlanVerificationError, filter_suppressed)
from .recompile import (DEFAULT_RECOMPILE_BUDGET, RecompileAudit,
                        audit_recompilation, check_runtime)
from .verifier import (filters_quotient_automorphism, verify_for_execution,
                       verify_plan, verify_snapshot)

__all__ = [
    "Finding", "FindingReport", "PlanVerificationError", "SEVERITIES",
    "filter_suppressed",
    "RecompileAudit", "audit_recompilation", "check_runtime",
    "DEFAULT_RECOMPILE_BUDGET",
    "verify_plan", "verify_for_execution", "verify_snapshot",
    "filters_quotient_automorphism",
]
