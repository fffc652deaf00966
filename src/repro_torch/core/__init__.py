# The paper's primary contribution: the HSFL framework (Engine A), its
# convergence theory (Theorem 1 / Corollary 1), and the MA+MS system
# optimizer (Proposition 1, Dinkelbach, Algorithm 2 BCD), with per-class
# cuts, the bound-constant estimator, the fault guard and bounded-staleness
# async aggregation (``async_agg``), Engine B, the split-placement
# engine that proves Engine A exact, and Engine A sharded over the ranks of
# ``torch.distributed`` (``sharded``) — port of ``repro.core``.
from .convergence import (
    HyperSpec,
    ParticipationSpec,
    class_weighted_G2_sums,
    corollary1_rounds,
    synthetic_hyperspec,
    theorem1_bound,
)
from .latency import LayerProfile, SystemSpec, build_profile, total_latency
from .problem import HsflProblem
from .batched import BatchedEvaluator, cut_lattice
from .ma_solver import MaSolution, solve_ma, solve_ma_bruteforce
from .ms_solver import MsSolution, solve_ms, solve_ms_bruteforce
from .bcd import BcdResult, solve_bcd
from .classes import (
    ClassBatchedEvaluator,
    ClassBcdResult,
    ClassMsSolution,
    CutClassSpec,
    banded_assignment,
    solve_bcd_classes,
    solve_ma_classes,
    solve_ms_classes,
)
from .tiers import (
    GuardSpec,
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
    build_train_step_b,
    init_state_a,
    init_state_b,
    replicate_for_clients,
    unreplicate,
)
from .estimator import HyperEstimator, estimate_from_probe
from .sharded import (
    build_sharded_train_step_a,
    init_sharded_state_a,
    num_client_shards,
    sharded_guard_health,
    sharded_synchronize,
)
