"""Multi-tenant serving front door for the swarm.

The reference system (and every entry point here before this package) is a
single-caller loop: one client drives one generation at a time. Production
serving in the Orca/continuous-batching lineage needs three things in front
of the engine: admission control (refuse work you cannot serve, cheaply and
early), weighted fairness across tenants (a flood from one tenant must not
starve the others), and SLO-aware shedding (a typed "come back in N
seconds", not a downstream timeout).

  * ``admission`` — per-tenant token buckets + concurrency caps + global
    queue watermarks; refusals raise the typed, non-retryable
    :class:`~.admission.Overloaded` with a ``retry_after_s`` hint.
  * ``fair_queue`` — weighted deficit-round-robin across tenants,
    earliest-deadline-first within a tenant.
  * ``gateway`` — the framed-TCP ``submit`` server that owns the
    PipelineClients and interleaves many sessions one decode step at a
    time (``PipelineClient.generate_stepwise``), streaming tokens back as
    they land.
"""

from .admission import (AdmissionController, Overloaded, TenantConfig,
                        TokenBucket, parse_tenants_config)
from .fair_queue import DeficitRoundRobin, FairQueue
from .gateway import GatewayServer, GatewaySubmitClient

__all__ = [
    "AdmissionController",
    "Overloaded",
    "TenantConfig",
    "TokenBucket",
    "parse_tenants_config",
    "DeficitRoundRobin",
    "FairQueue",
    "GatewayServer",
    "GatewaySubmitClient",
]
