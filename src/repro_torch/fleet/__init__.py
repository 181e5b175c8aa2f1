"""Fleet serving: traffic generation, routing, simulation, autoscaling.

The system-level layer over ``DeploymentSpec`` replicas — seeded
workload generators (`traffic`), a prefix-affinity SLO router
(`router`), a calibrated discrete-event fleet simulator (`simulator`),
and traffic-envelope SKU/replica planning (`autoscaler`).

A copy of the reference's ``repro/fleet`` (numpy only), its imports
redirected to the port's ``core``, ``runtime/deployment.py`` and
``runtime/kv_cache.py``; ``simulator.calibrate`` / ``cross_check`` drive a
port ``ContinuousServeEngine``.
"""
from repro_torch.fleet.router import SLO, PrefixAffinityRouter, RoundRobinRouter
from repro_torch.fleet.simulator import (
    DisaggFleetSimulator, FleetSimulator, FleetStats, LatencyTable,
    ReplicaSpec, calibrate, cross_check, disagg_replica_specs,
)
from repro_torch.fleet.autoscaler import (
    DisaggFleetPlan, FleetPlan, ReactiveAutoscaler, TrafficEnvelope,
    default_candidates, plan_disagg_fleet, plan_fleet,
)
from repro_torch.fleet.traffic import (
    FleetRequest, LengthMix, TenantMix, Trace, make_trace,
)

__all__ = [
    "SLO", "PrefixAffinityRouter", "RoundRobinRouter",
    "DisaggFleetSimulator", "FleetSimulator", "FleetStats", "LatencyTable",
    "ReplicaSpec", "calibrate", "cross_check", "disagg_replica_specs",
    "DisaggFleetPlan", "FleetPlan", "ReactiveAutoscaler", "TrafficEnvelope",
    "default_candidates", "plan_disagg_fleet", "plan_fleet",
    "FleetRequest", "LengthMix", "TenantMix", "Trace", "make_trace",
]
