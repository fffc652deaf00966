# The paper's primary contribution: the HSFL framework (Engine A), its
# convergence theory (Theorem 1 / Corollary 1), and the MA+MS system
# optimizer (Proposition 1, Dinkelbach, Algorithm 2 BCD), with per-class
# cuts, and the bound-constant estimator — port of ``repro.core``.  Engine B
# (ROADMAP A12) is not ported yet.
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
from .estimator import HyperEstimator, estimate_from_probe
