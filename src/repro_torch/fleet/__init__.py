"""Fleet-level serving control plane.

One high-rate request stream, N serving replicas: a deterministic router
splits the stream (``router``), each replica serves its sub-stream with
its own searched hardware+mapping (``replica`` — planned or measured),
the per-replica timings merge back into one request-indexed view
(``fleet``), and a scale-out policy search compares add-a-replica vs
re-search-the-mapping vs swap-the-scheduler at a target offered load
(``policy``). Keystone invariant: a 1-replica fleet is bit-identical to
serving the unsplit stream.
"""
from .fleet import Fleet, FleetResult
from .policy import ScaleOutDecision, ScaleOutOption, plan_scale_out
from .replica import (
    MeasuredReplica,
    PlannedReplica,
    Replica,
    ReplicaResult,
    compass_pricer,
    unit_pricer,
)
from .router import (
    POLICIES,
    RouteAssignment,
    assign,
    default_classify,
    route_stream,
)

__all__ = [
    "Fleet", "FleetResult",
    "ScaleOutDecision", "ScaleOutOption", "plan_scale_out",
    "Replica", "ReplicaResult", "PlannedReplica", "MeasuredReplica",
    "unit_pricer", "compass_pricer",
    "POLICIES", "RouteAssignment", "assign", "route_stream",
    "default_classify",
]
