"""APEX plan -> ``DeviceMesh`` and placements
(``repro/parallel/plan_sharding.py``).

A ``ParallelScheme`` chosen by the simulator's search is materialised as
a mesh plus a spec per parameter:

  * model-level DP  -> the "data" axis; batches shard over it, parameters
    replicate.
  * TP / EP         -> the "model" axis; parameter specs follow
    ``sharding.param_pspecs`` (head-, column- and expert-sharding).
  * PP              -> a "stage" axis, which ``pipeline.pipeline_forward``
    consumes (``needs_pipeline``).

``scheme`` is any object with ``model_dp``, ``pp_stages``,
``stage_devices`` and ``total_devices``, as the simulator's
``ParallelScheme`` has; the port imports nothing of the simulator.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.config import ModelConfig
from .sharding import (batch_pspec, make_mesh, param_pspecs, to_shardings,
                       world_size)


@dataclasses.dataclass
class MaterializedPlan:
    scheme: object
    mesh: object                 # DeviceMesh
    param_specs: dict
    batch_spec: tuple
    needs_pipeline: bool
    pp_stages: int

    def param_shardings(self, mesh: Optional[object] = None) -> dict:
        """Each parameter's placements on ``mesh`` (default the plan's)."""
        return to_shardings(self.param_specs, mesh or self.mesh)


def plan_to_shardings(scheme, cfg: ModelConfig, params,
                      device=None) -> MaterializedPlan:
    """The mesh and specs realising ``scheme``: ("data", "model") of
    (dp, tp), or ("data", "stage", "model") of (dp, pp, tp) when
    ``pp_stages > 1``, over the first ``total_devices`` ranks."""
    n = scheme.total_devices
    have = world_size()
    if have < n:
        raise ValueError(
            f"plan needs {n} devices, have {have} — run under a process "
            "group of that many ranks for large plans")
    dp, pp, tp = scheme.model_dp, scheme.pp_stages, scheme.stage_devices
    needs_pipeline = pp > 1
    if needs_pipeline:
        mesh = make_mesh((dp, pp, tp), ("data", "stage", "model"), device)
    else:
        mesh = make_mesh((dp, tp), ("data", "model"), device)
    specs = param_pspecs(params, cfg, mesh, fsdp=False)
    return MaterializedPlan(scheme=scheme, mesh=mesh, param_specs=specs,
                            batch_spec=batch_pspec(mesh),
                            needs_pipeline=needs_pipeline, pp_stages=pp)
