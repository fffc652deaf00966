# Fleet simulator: heterogeneity-aware discrete-event simulation of
# multi-tier HSFL systems — port of ``repro.sim``. events.py is the
# deterministic oracle, fleet.py the vectorized fast path (NumPy, or float64
# tensors on the card), scenarios.py the regime library,
# robust.py plugs trace quantiles into the MA+MS solvers, and
# participation.py turns traces + deadlines into client masks, q_m rates,
# and expected-round-time pricing (DESIGN.md §12).
from .scenarios import (
    RoundState,
    SCENARIOS,
    SystemTrace,
    diurnal_churn,
    flaky_wan,
    homogeneous_paper,
    lognormal_heterogeneous,
    make_trace,
    scenario_params,
    straggler_tail,
)
from .events import EventSimResult, RoundResult, simulate, simulate_round
from .fleet import (
    FleetResult,
    FleetRound,
    round_latency,
    simulate_lattice_rounds,
    simulate_rounds,
)
from .robust import TraceLatency, robust_problem
from .participation import (
    DeadlineLatency,
    ParticipationResult,
    deadline_for_rate,
    estimate_participation,
    participation_masks,
    participation_problem,
)
