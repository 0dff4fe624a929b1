"""APEX core in the port: automated parallel execution planning for LLM
serving via dynamism-aware simulation (the port's ``repro/core``).

The simulator (IR, clusters, planner, mapper, event engine, simulator,
plan search, fluid surrogate, multi-fidelity search, dynamic re-planning)
is plain Python, copied from the reference and giving its results bit for
bit; it imports nothing of ``repro`` and computes nothing on a device.
``profiles`` adds the one device-facing piece: ``MeasuredBackend``, the op
profiler that times on the card the ops the simulator's tables price, and
``TorchMeasuredBackend``, its samples as a ``ProfileBackend``.
"""

from .batching import BatchingModule, BatchingPolicy, BatchingResult
from .dynamic import (DynamicPlanSimulator, DynamicSpec, EpochSchedule,
                      ReconfigReport, SwitchCost, build_schedules,
                      fault_schedule, reactive_schedule)
from .engine import (ContinuousScheduler, Engine, PreemptionPolicy,
                     SacrificePolicy, SchedulerPolicy, SharedCostStore,
                     SharedLink, StaticScheduler, StepCostCache,
                     SwapPolicy, make_preemption)
from .faults import (FaultSchedule, LinkDegradation, ReplicaFault,
                     Straggler, fault_ensemble, normalize_faults)
from .metrics import (ClassReport, ResilienceReport, WindowReport, p50,
                      p95, p99, percentile, windowed_metrics)
from .cluster import (CLUSTER_PRESETS, Cluster, DeviceSpec, NetworkLevel,
                      cpu_local, cross_pool_link, get_cluster,
                      h100_multinode, h100_node, h200_node, host_link,
                      tpu_v5e_multipod, tpu_v5e_pod)
from .ir import (AttentionCell, Block, Cell, CrossAttentionCell, MLACell,
                 MLPCell, ModelIR, MoECell, OpCall, SSMCell, Workload,
                 ir_from_hf_config)
from .mapper import ExecutionPlan, assign_physical_ids, map_scheme
from .planner import (ParallelScheme, divisors, generate_schemes,
                      heuristic_scheme, prefilter_schemes)
from .profiles import AnalyticBackend, CollectiveModel, MeasuredBackend, \
    ProfileBackend, ProfileStore, TorchMeasuredBackend
from .fluid import FluidDisaggSimulator, FluidSimulator, TraceSummary
from .multifid import MultiFidelityResult, MultiFidelitySearch, RungStat
from .quant import FORMATS, QuantFormat, get_format, register_format
from .search import (ApexSearch, PlanEvaluationError, SearchResult,
                     compare_three_plans, fork_map)
from .simulator import PlanSimulator, SimulationReport, cost_fingerprint
from .templates import CellScheme, CollectiveCall, reshard_collectives, \
    schemes_for_cell
from .trace import (DEFAULT_SLO, ArrivalProcess, BurstProcess,
                    ClassTraffic, ConstantRate, DiurnalRate,
                    PiecewiseRate, Request, SLOClass,
                    TRACE_SPECS, as_arrival_process, get_trace,
                    mixed_trace, prefix_trace, retag_slo,
                    synthesize_mixed_trace, synthesize_trace,
                    trace_stats)

__all__ = [
    "ApexSearch", "AnalyticBackend", "ArrivalProcess", "AttentionCell",
    "BatchingModule", "BurstProcess", "ConstantRate", "DiurnalRate",
    "DynamicPlanSimulator", "DynamicSpec", "EpochSchedule",
    "PiecewiseRate", "ReconfigReport", "SwitchCost", "WindowReport",
    "as_arrival_process", "build_schedules", "fault_schedule",
    "reactive_schedule", "windowed_metrics",
    "BatchingPolicy", "BatchingResult", "Block", "Cell", "CellScheme",
    "CLUSTER_PRESETS", "ClassReport", "ClassTraffic", "Cluster",
    "CollectiveCall", "CollectiveModel",
    "ContinuousScheduler", "CrossAttentionCell", "DEFAULT_SLO",
    "DeviceSpec", "Engine",
    "ExecutionPlan", "FORMATS", "FluidDisaggSimulator", "FluidSimulator",
    "FaultSchedule", "LinkDegradation",
    "MLACell", "MLPCell", "MeasuredBackend", "ModelIR", "MoECell",
    "MultiFidelityResult", "MultiFidelitySearch", "RungStat",
    "NetworkLevel", "OpCall", "PlanEvaluationError", "PreemptionPolicy",
    "ReplicaFault", "ResilienceReport", "SLOClass", "Straggler",
    "TraceSummary", "cost_fingerprint", "cpu_local", "fault_ensemble",
    "fork_map", "normalize_faults",
    "ParallelScheme", "PlanSimulator", "ProfileBackend", "ProfileStore",
    "QuantFormat", "Request", "SSMCell", "SacrificePolicy",
    "SchedulerPolicy", "SearchResult",
    "SharedCostStore", "SharedLink", "SimulationReport", "StaticScheduler",
    "StepCostCache", "SwapPolicy", "TorchMeasuredBackend",
    "TRACE_SPECS", "Workload", "assign_physical_ids", "compare_three_plans",
    "cross_pool_link", "divisors", "generate_schemes", "get_cluster",
    "get_format", "get_trace", "host_link", "make_preemption",
    "mixed_trace", "p50", "p95", "p99", "percentile", "prefix_trace",
    "h100_multinode", "h100_node", "h200_node", "heuristic_scheme",
    "ir_from_hf_config", "map_scheme", "prefilter_schemes",
    "register_format", "retag_slo",
    "reshard_collectives", "schemes_for_cell", "synthesize_mixed_trace",
    "synthesize_trace",
    "tpu_v5e_multipod", "tpu_v5e_pod", "trace_stats",
]
