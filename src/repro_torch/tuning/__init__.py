"""Simulator-guided autotuning: partition cuts, per-group tile shapes,
and a persistent plan cache.

``resolve_tuned_plan`` is the one entry point the executors and the
serving engine use; everything else is the search machinery and the
cache it writes through.
"""

from repro_torch.tuning.autotune import (
    AUTOTUNE_MODES,
    autotune_plan,
    collect_layer_coords,
    representative_input,
    resolve_tuned_plan,
    resolve_tuned_tile,
    tile_candidates,
)
from repro_torch.tuning.plan_cache import (
    PlanCache,
    TunedGroup,
    TunedPlan,
    default_plan_cache,
    net_digest,
    plan_cache_hits,
    plan_cache_misses,
    plan_key,
)

__all__ = [
    "AUTOTUNE_MODES",
    "PlanCache",
    "TunedGroup",
    "TunedPlan",
    "autotune_plan",
    "collect_layer_coords",
    "default_plan_cache",
    "net_digest",
    "plan_cache_hits",
    "plan_cache_misses",
    "plan_key",
    "representative_input",
    "resolve_tuned_plan",
    "resolve_tuned_tile",
    "tile_candidates",
]
