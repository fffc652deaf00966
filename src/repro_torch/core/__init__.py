# The HSFL training engine and its aggregation schedule.  The analytic
# solve path (latency, convergence, MA/MS solvers, BCD) is ported with
# ROADMAP A8.
from .tiers import (
    TierPlan,
    class_tier_members,
    combine_tiers,
    default_plan,
    ragged_synchronize,
    synchronize,
    tier_subtrees,
)
from .engine import (
    TrainState,
    build_train_step_a,
    init_state_a,
    replicate_for_clients,
    unreplicate,
)
