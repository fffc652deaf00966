# repro_torch.api — the declarative driver layer (DESIGN.md §10), port of
# repro.api.
#
# One serializable ExperimentSpec (the JAX package's JSON, field for field)
# describes model / system / scenario / compression / solver / run; build()
# composes the underlying repro_torch.core objects in the one valid order;
# run() dispatches to the BCD/MA/MS solvers, the fleet simulator, or Engine
# A training on the card and returns a uniform ExperimentResult whose
# provenance is the resolved spec.
from .spec import (
    ClassesCfg,
    CompressionCfg,
    ControlCfg,
    EnergyCfg,
    ExperimentSpec,
    FaultsCfg,
    HyperCfg,
    ModelCfg,
    ParticipationCfg,
    PrivacyCfg,
    RunCfg,
    ScenarioCfg,
    SolverCfg,
    SystemCfg,
)
from .registry import (
    CODECS,
    MODEL_IDS,
    SYSTEMS,
    register_codec,
    register_system,
    resolve_model,
    resolve_system,
    scenario_names,
)
from .build import BuiltExperiment, build, resolve_compression
from .result import ExperimentResult, jsonify
from .run import evaluate_schedule, run
from .presets import (
    EXPERIMENTS,
    compressed_spec,
    fault_storm_spec,
    get_experiment,
    hetcuts_spec,
    paper_spec,
    participation_spec,
    privacy_energy_spec,
    quickstart_spec,
    register_experiment,
    robust_spec,
    tpu_pod_spec,
    two_tier_spec,
)
