"""Windowed system estimate: the online analogue of ``TraceLatency`` —
port of ``repro.control.window`` (verbatim NumPy float64).

``WindowedLatency`` keeps a ring buffer of the last W observed rounds.
Each ``push`` prices that single round's ``RoundState`` against the whole
cut lattice through ``sim.fleet.price_lattice_round`` — the *same*
per-round pricing kernel ``simulate_lattice_rounds`` runs — and stores
the resulting split/agg columns.  The batched latency tables are then a
quantile (or deadline-mean) over the buffered columns, incrementally:
one observed round costs one [K, N] pass, and a full lattice re-price at
control time is a pure reduction over the buffer.

Fed the same ``RoundState`` sequence, the windowed tables are
bit-identical to a ``TraceLatency``/``DeadlineLatency`` built over a
trace of exactly those rounds (pinned in ``tests/test_torch_control.py``) —
the controller re-solves against the same arithmetic the offline robust
pricing uses, just restricted to the recent window.

``version`` increments on every push: ``HsflProblem.evaluator`` watches
it to rebuild its memoized ``BatchedEvaluator`` instead of serving stale
split/agg tables.
"""
from __future__ import annotations

from collections import deque
from typing import Optional, Sequence

import numpy as np

from ..core.batched import model_bits_lattice, split_work_tensor, stage_meta
from ..core.latency import LayerProfile, SystemSpec
from ..sim.fleet import price_lattice_round
from ..sim.participation import _tier_entity_rates
from ..sim.scenarios import RoundState


class WindowedLatency:
    """Sliding-window lattice pricing over observed rounds.

    ``quantile`` is the pricing level when no deadline policy is active
    (the windowed analogue of ``TraceLatency``); with ``deadline`` set,
    rounds are priced deadline-capped and aggregated by mean (the
    windowed analogue of ``DeadlineLatency``).
    """

    def __init__(
        self,
        profile: LayerProfile,
        system: SystemSpec,
        lattice: np.ndarray,
        window: int,
        quantile: float = 0.5,
        deadline: Optional[float] = None,
        compression=None,
    ):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if not 0.0 < quantile <= 1.0:
            raise ValueError(f"quantile must lie in (0, 1]: {quantile}")
        self.profile = profile
        self.system = system
        self.lattice = np.asarray(lattice)
        self.window = int(window)
        self.quantile = float(quantile)
        self.deadline = None if deadline is None else float(deadline)
        self.compression = compression
        self.version = 0
        self._works = split_work_tensor(profile, self.lattice, compression)
        self._lam = model_bits_lattice(profile, self.lattice, compression)
        self._meta = stage_meta(system.M)
        self._key = self.lattice.tobytes()
        self._row = {
            tuple(int(x) for x in row): k
            for k, row in enumerate(self.lattice.tolist())
        }
        self._split_cols: deque = deque(maxlen=self.window)  # [K]
        self._agg_cols: deque = deque(maxlen=self.window)    # [K, M-1]
        self._masks: deque = deque(maxlen=self.window)       # [N] bool
        self._states: deque = deque(maxlen=self.window)      # RoundState

    # ------------------------------------------------------------------ #
    @property
    def n_obs(self) -> int:
        return len(self._split_cols)

    def push(self, state: RoundState, mask: Optional[np.ndarray] = None) -> None:
        """Fold one observed round into the window (prices the whole
        lattice against it once); ``mask`` overrides availability as the
        round's participation set (deadline policies)."""
        split_col, agg_col = price_lattice_round(
            self.system, self._works, self._lam, self._meta, state,
            deadline=self.deadline, backend="numpy",
        )
        self._split_cols.append(split_col)
        self._agg_cols.append(agg_col)
        self._masks.append(
            state.available.copy() if mask is None
            else np.asarray(mask, dtype=bool).copy()
        )
        self._states.append(state)
        self.version += 1

    def states(self) -> tuple:
        """The buffered ``RoundState``s, oldest first — e.g. to rebuild an
        offline ``TraceLatency`` over exactly this window (the cold
        comparator of a warm re-solve)."""
        return tuple(self._states)

    def _require_obs(self) -> None:
        if not self._split_cols:
            raise ValueError(
                "WindowedLatency has no observed rounds yet — push() at "
                "least one before pricing"
            )

    def _check_lattice(self, lattice: np.ndarray) -> None:
        if np.asarray(lattice).tobytes() != self._key:
            raise ValueError(
                "lattice mismatch: WindowedLatency prices the lattice it "
                "was constructed with"
            )

    # ------------------------------------------------------------------ #
    # LatencyModel protocol (same surface as TraceLatency/DeadlineLatency)
    # ------------------------------------------------------------------ #
    def _tables(self):
        """Whole-lattice scalar tables, memoized per version: one vectorized
        reduction serves every scalar ``split_T``/``agg_T`` call until the
        next push (the solvers' scalar path hits these hundreds of times
        per control step)."""
        cached = getattr(self, "_table_cache", None)
        if cached is not None and cached[0] == self.version:
            return cached[1], cached[2]
        split = self.split_T_batch(self.lattice)
        agg = self.agg_T_batch(self.lattice)
        self._table_cache = (self.version, split, agg)
        return split, agg

    def split_T(self, cuts: Sequence[int]) -> float:
        self._require_obs()
        k = self._row.get(tuple(int(c) for c in cuts))
        if k is None:
            raise KeyError(f"cuts {tuple(cuts)} not on the priced lattice")
        split, _ = self._tables()
        return float(split[k])

    def agg_T(self, cuts: Sequence[int], m: int) -> float:
        self._require_obs()
        k = self._row.get(tuple(int(c) for c in cuts))
        if k is None:
            raise KeyError(f"cuts {tuple(cuts)} not on the priced lattice")
        _, agg = self._tables()
        return float(agg[k, m])

    # ------------------------------------------------------------------ #
    # batched lattice protocol (consumed by core.batched.BatchedEvaluator)
    # ------------------------------------------------------------------ #
    def split_T_batch(self, lattice: np.ndarray) -> np.ndarray:
        self._require_obs()
        self._check_lattice(lattice)
        cols = np.stack(tuple(self._split_cols), axis=1)  # [K, W]
        if self.deadline is None:
            return np.quantile(cols, self.quantile, axis=1)
        return np.mean(cols, axis=1)

    def agg_T_batch(self, lattice: np.ndarray) -> np.ndarray:
        self._require_obs()
        self._check_lattice(lattice)
        cols = np.stack(tuple(self._agg_cols), axis=2)  # [K, M-1, W]
        if self.deadline is None:
            return np.quantile(cols, self.quantile, axis=2)
        return np.mean(cols, axis=2)

    # ------------------------------------------------------------------ #
    def q_tiers(self) -> np.ndarray:
        """[M] windowed per-tier participation rates — the mean over the
        buffered rounds of ``sim.participation._tier_entity_rates`` on
        each round's mask (the online ``ParticipationSpec`` estimate)."""
        self._require_obs()
        rates = np.stack(
            [_tier_entity_rates(m, self.system.entities) for m in self._masks]
        )
        return rates.mean(axis=0)
