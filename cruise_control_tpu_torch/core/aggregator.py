"""Windowed metric-sample aggregation with extrapolation (port of
cruise_control_tpu/core/aggregator.py).

Cruise Control's core aggregation stack (MetricSampleAggregator.java,
RawMetricValues.java, Extrapolation.java, AggregationOptions.java,
MetricSampleCompleteness.java) keeps one small cyclic buffer per entity;
here the whole aggregator is three dense numpy arrays

    acc    f32[E, W, M]   accumulated value per entity/window/metric
    counts i32[E, W]      samples per entity/window
    latest f64[E, W]      timestamp of the last sample (LATEST ordering)

over which window validity, the four extrapolation kinds and the
completeness ratios are vectorized masks.  It is host code, as in the
JAX package, and every result equals that package's bit for bit: the
float32 accumulation adds one sample at a time in arrival order (under
numpy 2 a Python float is rounded to float32 before the float32 add),
and the window reductions are the same numpy calls.

Window model: windows are fixed-width time buckets; the aggregator keeps
``num_windows`` stable windows plus one *current* (active) window, which
is excluded from validity and completeness until it rolls over.

Extrapolation per entity-window (RawMetricValues.aggregate):
  count >= min_samples                         -> NONE
  half_min <= count < min_samples              -> AVG_AVAILABLE
  count < half_min, both neighbours sufficient -> AVG_ADJACENT
  0 < count (no valid neighbours)              -> FORCED_INSUFFICIENT
  count == 0                                   -> NO_VALID_EXTRAPOLATION
An entity is valid if every stable window is valid (not NO_VALID) and at
most ``max_allowed_extrapolations`` stable windows are extrapolated.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
from typing import (Dict, Hashable, List, Mapping, Optional, Sequence, Set,
                    Tuple)

import numpy as np

from cruise_control_tpu_torch.core.metricdef import (AggregationFunction,
                                                    MetricDef)


class Extrapolation(enum.Enum):
    """reference .../aggregator/Extrapolation.java:32-34"""

    NONE = 0
    AVG_AVAILABLE = 1
    AVG_ADJACENT = 2
    FORCED_INSUFFICIENT = 3
    NO_VALID_EXTRAPOLATION = 4


class NotEnoughValidWindowsError(Exception):
    """reference cruise-control-core/.../NotEnoughValidWindowsException."""


@dataclasses.dataclass(frozen=True)
class MetricSample:
    """One sample of all metrics for one entity at one instant
    (reference CORE/monitor/sampling/MetricSample.java)."""

    entity: Hashable
    sample_time_ms: float
    values: Mapping[int, float]  # metric id -> value

    def group(self) -> Hashable:
        return getattr(self.entity, "group", None)


class Granularity(enum.Enum):
    """reference AggregationOptions.Granularity"""

    ENTITY = "entity"
    ENTITY_GROUP = "entity_group"


@dataclasses.dataclass(frozen=True)
class AggregationOptions:
    """reference .../aggregator/AggregationOptions.java:18-70"""

    min_valid_entity_ratio: float = 0.0
    min_valid_entity_group_ratio: float = 0.0
    min_valid_windows: int = 1
    max_allowed_extrapolations_per_entity: int = 5
    interested_entities: Optional[Set[Hashable]] = None
    granularity: Granularity = Granularity.ENTITY
    include_invalid_entities: bool = False


@dataclasses.dataclass
class ValuesAndExtrapolations:
    """Per-entity aggregation output (reference ValuesAndExtrapolations.java):
    ``values[w, m]`` over the valid windows in chronological order plus the
    extrapolation kind used at each window."""

    values: np.ndarray                     # f32[W, M]
    extrapolations: Dict[int, Extrapolation]  # window position -> kind
    window_times_ms: List[int] = dataclasses.field(default_factory=list)

    def metric_values(self, metric_id: int) -> np.ndarray:
        return self.values[:, metric_id]

    def is_extrapolated(self) -> bool:
        return any(e != Extrapolation.NONE
                   for e in self.extrapolations.values())


@dataclasses.dataclass
class MetricSampleCompleteness:
    """reference .../aggregator/MetricSampleCompleteness.java"""

    generation: int
    valid_entity_ratio: float
    valid_entity_group_ratio: float
    valid_window_indices: List[int]
    valid_entities: Set[Hashable]
    valid_entity_groups: Set[Hashable]
    # per valid-window entity coverage ratio, aligned with valid_window_indices
    valid_entity_ratio_by_window: Dict[int, float] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class MetricSampleAggregationResult:
    """reference .../aggregator/MetricSampleAggregationResult.java"""

    generation: int
    completeness: MetricSampleCompleteness
    entity_values: Dict[Hashable, ValuesAndExtrapolations] = dataclasses.field(
        default_factory=dict)
    invalid_entities: Set[Hashable] = dataclasses.field(default_factory=set)


class MetricSampleAggregator:
    """Thread-safe dense windowed aggregator
    (reference MetricSampleAggregator.java:84-430).

    E (entity rows) grows geometrically as entities appear; W is the ring of
    ``num_windows + 1`` window slots (stable windows + the current one);
    M is ``metric_def.size()``.
    """

    def __init__(self, num_windows: int, window_ms: int,
                 min_samples_per_window: int, metric_def: MetricDef,
                 completeness_cache_size: int = 5) -> None:
        if num_windows < 1:
            raise ValueError("need at least one stable window")
        if window_ms <= 0:
            raise ValueError("window_ms must be positive")
        self._num_windows = num_windows
        self._window_ms = int(window_ms)
        self._num_slots = num_windows + 1
        self._min_samples = max(1, int(min_samples_per_window))
        self._half_min = max(1, self._min_samples // 2)
        self._metric_def = metric_def
        self._num_metrics = metric_def.size()
        self._agg_fn_by_id = [m.aggregation_function
                              for m in metric_def.all_metric_infos()]

        self._lock = threading.RLock()
        self._entity_index: Dict[Hashable, int] = {}
        self._entities: List[Hashable] = []
        cap = 16
        self._acc = np.zeros((cap, self._num_slots, self._num_metrics),
                             dtype=np.float32)
        self._counts = np.zeros((cap, self._num_slots), dtype=np.int32)
        self._latest = np.full((cap, self._num_slots), -np.inf,
                               dtype=np.float64)

        self._current_window_index: Optional[int] = None  # absolute index
        self._oldest_window_index: Optional[int] = None
        self._generation = 0
        self._completeness_cache: Dict[Tuple, MetricSampleCompleteness] = {}
        self._completeness_cache_size = completeness_cache_size
        self._tensor_cache: Dict[Tuple, Tuple] = {}
        self._num_abandoned_samples = 0

    # ------------------------------------------------------------------
    # basic window arithmetic (reference WindowIndexedArrays.java)
    # ------------------------------------------------------------------
    def _window_index(self, time_ms: float) -> int:
        # window w covers (w*window_ms - window_ms, w*window_ms]; window
        # index is time/windowMs + 1 in the reference
        return int(time_ms // self._window_ms) + 1

    def _slot(self, window_index: int) -> int:
        return window_index % self._num_slots

    def window_end_time_ms(self, window_index: int) -> int:
        return window_index * self._window_ms

    @property
    def window_ms(self) -> int:
        return self._window_ms

    @property
    def num_windows(self) -> int:
        return self._num_windows

    @property
    def generation(self) -> int:
        return self._generation

    @property
    def metric_def(self) -> MetricDef:
        return self._metric_def

    @property
    def num_abandoned_samples(self) -> int:
        return self._num_abandoned_samples

    # ------------------------------------------------------------------
    # sample ingestion
    # ------------------------------------------------------------------
    def add_sample(self, sample: MetricSample) -> bool:
        """Add one sample; returns False if the sample was too old to record
        (reference MetricSampleAggregator.addSample :141-175).

        Samples must carry a value for every defined metric (the reference's
        MetricSample.close() guarantees this): the per-window sample count is
        shared across metrics, so a partial sample would silently skew AVG
        (sum over fewer addends / full count) and MAX (0-baseline)."""
        if (len(sample.values) != self._num_metrics
                or not all(0 <= int(m) < self._num_metrics
                           for m in sample.values)):
            expected = set(range(self._num_metrics))
            missing = expected - set(sample.values)
            unknown = set(sample.values) - expected
            raise ValueError(
                f"sample for {sample.entity} must provide exactly metric ids "
                f"0..{self._num_metrics - 1}; missing {sorted(missing)}, "
                f"unknown {sorted(unknown)}")
        with self._lock:
            window_index = self._window_index(sample.sample_time_ms)
            if self._current_window_index is None:
                # history starts at the first sample's window: inventing
                # empty windows before it would leave permanently-invalid
                # leading windows until a full retention period has passed
                self._current_window_index = window_index
                self._oldest_window_index = window_index
            if window_index < self._oldest_window_index:
                return False
            rolled = self._maybe_roll_out_new_window(window_index)
            row = self._entity_row(sample.entity)
            slot = self._slot(window_index)
            self._record(row, slot, sample)
            self._tensor_cache.clear()
            if rolled or window_index != self._current_window_index:
                self._bump_generation(window_index)
            return True

    def add_samples(self, samples: Sequence[MetricSample]) -> int:
        return sum(1 for s in samples if self.add_sample(s))

    def _record(self, row: int, slot: int, sample: MetricSample) -> None:
        is_latest = sample.sample_time_ms >= self._latest[row, slot]
        for metric_id, value in sample.values.items():
            fn = self._agg_fn_by_id[metric_id]
            if fn is AggregationFunction.AVG:
                self._acc[row, slot, metric_id] += value
            elif fn is AggregationFunction.MAX:
                if self._counts[row, slot] == 0:
                    self._acc[row, slot, metric_id] = value
                else:
                    self._acc[row, slot, metric_id] = max(
                        self._acc[row, slot, metric_id], value)
            else:  # LATEST
                if self._counts[row, slot] == 0 or is_latest:
                    self._acc[row, slot, metric_id] = value
        self._counts[row, slot] += 1
        if is_latest:
            self._latest[row, slot] = sample.sample_time_ms

    def _entity_row(self, entity: Hashable) -> int:
        row = self._entity_index.get(entity)
        if row is not None:
            return row
        row = len(self._entities)
        if row == self._acc.shape[0]:
            grow = max(16, row)
            self._acc = np.concatenate(
                [self._acc, np.zeros((grow,) + self._acc.shape[1:],
                                     dtype=self._acc.dtype)])
            self._counts = np.concatenate(
                [self._counts, np.zeros((grow, self._num_slots),
                                        dtype=self._counts.dtype)])
            self._latest = np.concatenate(
                [self._latest, np.full((grow, self._num_slots), -np.inf)])
        self._entity_index[entity] = row
        self._entities.append(entity)
        return row

    def _maybe_roll_out_new_window(self, window_index: int) -> bool:
        if window_index <= self._current_window_index:
            return False
        new_oldest = max(self._oldest_window_index,
                         window_index - self._num_windows)
        num_reset = min(new_oldest - self._oldest_window_index,
                        self._num_slots)
        e = len(self._entities)
        for idx in range(self._oldest_window_index,
                         self._oldest_window_index + num_reset):
            slot = self._slot(idx)
            self._num_abandoned_samples += int(self._counts[:e, slot].sum())
            self._counts[:, slot] = 0
            self._acc[:, slot, :] = 0.0
            self._latest[:, slot] = -np.inf
        self._oldest_window_index = new_oldest
        self._current_window_index = window_index
        return True

    def _bump_generation(self, window_index: int) -> None:
        self._generation += 1
        self._completeness_cache.clear()

    # ------------------------------------------------------------------
    # window queries (reference MetricSampleAggregator.java:302-357)
    # ------------------------------------------------------------------
    def all_windows(self) -> List[int]:
        """End times (ms) of all stable windows, oldest first."""
        with self._lock:
            return [self.window_end_time_ms(w)
                    for w in self._stable_window_indices()]

    def available_windows(self) -> List[int]:
        return self.all_windows()

    def num_available_windows(self, from_ms: float = -np.inf,
                              to_ms: float = np.inf) -> int:
        with self._lock:
            return sum(1 for w in self._stable_window_indices()
                       if from_ms <= self.window_end_time_ms(w) <= to_ms)

    def earliest_window(self) -> Optional[int]:
        windows = self.all_windows()
        return windows[0] if windows else None

    def num_samples(self) -> int:
        with self._lock:
            e = len(self._entities)
            return int(self._counts[:e].sum())

    def _stable_window_indices(self) -> List[int]:
        if self._current_window_index is None:
            return []
        return list(range(self._oldest_window_index,
                          self._current_window_index))

    # ------------------------------------------------------------------
    # entity retention (reference :368-424)
    # ------------------------------------------------------------------
    def retain_entities(self, entities: Set[Hashable]) -> None:
        with self._lock:
            self._filter_entities(lambda ent: ent in entities)

    def remove_entities(self, entities: Set[Hashable]) -> None:
        with self._lock:
            self._filter_entities(lambda ent: ent not in entities)

    def retain_entity_group(self, groups: Set[Hashable]) -> None:
        with self._lock:
            self._filter_entities(
                lambda ent: getattr(ent, "group", None) in groups)

    def remove_entity_group(self, groups: Set[Hashable]) -> None:
        with self._lock:
            self._filter_entities(
                lambda ent: getattr(ent, "group", None) not in groups)

    def _filter_entities(self, keep) -> None:
        kept = [i for i, ent in enumerate(self._entities) if keep(ent)]
        self._entities = [self._entities[i] for i in kept]
        self._entity_index = {ent: i for i, ent in enumerate(self._entities)}
        n = len(kept)
        self._acc[:n] = self._acc[kept]
        self._counts[:n] = self._counts[kept]
        self._latest[:n] = self._latest[kept]
        self._acc[n:] = 0.0
        self._counts[n:] = 0
        self._latest[n:] = -np.inf
        self._generation += 1
        self._completeness_cache.clear()

    def clear(self) -> None:
        with self._lock:
            self._entities.clear()
            self._entity_index.clear()
            self._acc[:] = 0.0
            self._counts[:] = 0
            self._latest[:] = -np.inf
            self._generation += 1
            self._completeness_cache.clear()

    # ------------------------------------------------------------------
    # vectorized aggregation core
    # ------------------------------------------------------------------
    def _window_tensor(self, window_indices: List[int]):
        """Vectorized per-entity-per-window value + extrapolation computation
        over the given absolute window indices (RawMetricValues.aggregate
        re-shaped: entity loop -> tensor ops).

        Memoized per (windows, entity count, generation): aggregate() needs
        the same tensor _completeness_locked just computed, so the second
        O(E*W*M) pass becomes a cache hit."""
        key = (tuple(window_indices), len(self._entities), self._generation)
        cached = self._tensor_cache.get(key)
        if cached is not None:
            return cached
        result = self._window_tensor_uncached(window_indices)
        if len(self._tensor_cache) >= 4:
            self._tensor_cache.pop(next(iter(self._tensor_cache)))
        self._tensor_cache[key] = result
        return result

    def _window_tensor_uncached(self, window_indices: List[int]):
        e = len(self._entities)
        slots = np.array([self._slot(w) for w in window_indices],
                         dtype=np.int64)
        counts = self._counts[:e][:, slots]                      # [E, W]
        acc = self._acc[:e][:, slots, :]                         # [E, W, M]

        # neighbour views in *absolute window* terms; windows outside the
        # retained range have zero counts by construction
        prev_idx = [w - 1 for w in window_indices]
        next_idx = [w + 1 for w in window_indices]
        lo, hi = self._oldest_window_index, self._current_window_index

        def fetch(idxs):
            c = np.zeros((e, len(idxs)), dtype=np.int32)
            a = np.zeros((e, len(idxs), self._num_metrics), dtype=np.float32)
            for j, w in enumerate(idxs):
                if lo <= w <= hi:
                    s = self._slot(w)
                    c[:, j] = self._counts[:e, s]
                    a[:, j] = self._acc[:e, s]
            return c, a

        pc, pa = fetch(prev_idx)
        nc, na = fetch(next_idx)
        # edge windows have no usable neighbour pair: the reference excludes
        # the first and last array index from AVG_ADJACENT (the current
        # window hi and the newest stable window hi-1 share that edge)
        is_edge = np.array([(w == lo) or (w == hi) or (w == hi - 1)
                            for w in window_indices])

        sufficient = counts >= self._min_samples
        avg_avail = (counts >= self._half_min) & ~sufficient
        adjacent_ok = ((counts < self._half_min) & ~is_edge[None, :]
                       & (pc >= self._min_samples) & (nc >= self._min_samples))
        forced = (~sufficient & ~avg_avail & ~adjacent_ok) & (counts > 0)

        # own-window value per aggregation function
        fns = np.array([m.aggregation_function is AggregationFunction.AVG
                        for m in self._metric_def.all_metric_infos()])
        own = np.where(fns[None, None, :],
                       acc / np.maximum(counts[:, :, None], 1),
                       acc)

        # AVG_ADJACENT value
        total = pa + na + np.where(counts[:, :, None] > 0, acc, 0.0)
        avg_cnt = np.maximum(pc + nc + counts, 1)[:, :, None]
        maxlatest_cnt = np.where(counts > 0, 3, 2)[:, :, None]
        adj = np.where(fns[None, None, :], total / avg_cnt,
                       total / maxlatest_cnt)

        use_own = sufficient | avg_avail | forced
        values = np.where(use_own[:, :, None], own,
                          np.where(adjacent_ok[:, :, None], adj, 0.0))

        extrap = np.full(counts.shape,
                         Extrapolation.NO_VALID_EXTRAPOLATION.value,
                         dtype=np.int8)
        extrap[forced] = Extrapolation.FORCED_INSUFFICIENT.value
        extrap[adjacent_ok] = Extrapolation.AVG_ADJACENT.value
        extrap[avg_avail] = Extrapolation.AVG_AVAILABLE.value
        extrap[sufficient] = Extrapolation.NONE.value
        return values.astype(np.float32), extrap

    def _entity_validity(self, extrap: np.ndarray,
                         max_allowed_extrapolations: int):
        """bool[E] entity validity + bool[E, W] per-window validity
        (RawMetricValues.isValid / isValidAtWindowIndex)."""
        window_valid = extrap != Extrapolation.NO_VALID_EXTRAPOLATION.value
        extrapolated = window_valid & (extrap != Extrapolation.NONE.value)
        entity_valid = (window_valid.all(axis=1)
                        & (extrapolated.sum(axis=1)
                           <= max_allowed_extrapolations))
        return entity_valid, window_valid

    # ------------------------------------------------------------------
    # public aggregation API
    # ------------------------------------------------------------------
    def aggregate(self, from_ms: float, to_ms: float,
                  options: Optional[AggregationOptions] = None
                  ) -> MetricSampleAggregationResult:
        """reference MetricSampleAggregator.aggregate :193-246."""
        options = options or AggregationOptions()
        with self._lock:
            completeness, win_indices = self._completeness_locked(
                from_ms, to_ms, options)
            self._validate_completeness(completeness, options, from_ms, to_ms)

            valid_windows = set(completeness.valid_window_indices)
            abs_windows = [w for w in win_indices
                           if self.window_end_time_ms(w) in valid_windows]
            values, extrap = self._window_tensor(abs_windows)
            result = MetricSampleAggregationResult(
                generation=self._generation, completeness=completeness)
            interested = (options.interested_entities
                          if options.interested_entities is not None
                          else set(self._entities))
            window_times = [self.window_end_time_ms(w) for w in abs_windows]
            for entity in interested:
                row = self._entity_index.get(entity)
                if row is None:
                    if not options.include_invalid_entities:
                        continue
                    vae = ValuesAndExtrapolations(
                        values=np.zeros((len(abs_windows), self._num_metrics),
                                        dtype=np.float32),
                        extrapolations={
                            i: Extrapolation.NO_VALID_EXTRAPOLATION
                            for i in range(len(abs_windows))},
                        window_times_ms=window_times)
                    result.entity_values[entity] = vae
                    result.invalid_entities.add(entity)
                    continue
                is_valid = entity in completeness.valid_entities
                if not is_valid and not options.include_invalid_entities:
                    result.invalid_entities.add(entity)
                    continue
                ex = {i: Extrapolation(int(extrap[row, i]))
                      for i in range(len(abs_windows))
                      if extrap[row, i] != Extrapolation.NONE.value}
                result.entity_values[entity] = ValuesAndExtrapolations(
                    values=values[row].copy(), extrapolations=ex,
                    window_times_ms=window_times)
                if not is_valid:
                    result.invalid_entities.add(entity)
            return result

    def peek_current_window(self) -> Dict[Hashable, ValuesAndExtrapolations]:
        """reference MetricSampleAggregator.peekCurrentWindow :249-268."""
        with self._lock:
            if self._current_window_index is None:
                return {}
            values, extrap = self._window_tensor([self._current_window_index])
            t = [self.window_end_time_ms(self._current_window_index)]
            out = {}
            for entity, row in self._entity_index.items():
                ex = {0: Extrapolation(int(extrap[row, 0]))} \
                    if extrap[row, 0] != Extrapolation.NONE.value else {}
                out[entity] = ValuesAndExtrapolations(
                    values=values[row].copy(), extrapolations=ex,
                    window_times_ms=t)
            return out

    def completeness(self, from_ms: float, to_ms: float,
                     options: Optional[AggregationOptions] = None
                     ) -> MetricSampleCompleteness:
        """reference MetricSampleAggregator.completeness :275-300."""
        options = options or AggregationOptions()
        with self._lock:
            comp, _ = self._completeness_locked(from_ms, to_ms, options)
            return comp

    def _completeness_locked(self, from_ms: float, to_ms: float,
                             options: AggregationOptions):
        if self._current_window_index is None:
            raise NotEnoughValidWindowsError("no samples added yet")
        # ±inf means "everything retained" (callers pass -inf/inf for the
        # full history; int(inf) would raise)
        from_w = (self._oldest_window_index if from_ms == -np.inf
                  else max(self._window_index(from_ms),
                           self._oldest_window_index))
        to_w = (self._current_window_index - 1 if to_ms == np.inf
                else min(self._window_index(to_ms),
                         self._current_window_index - 1))
        if to_w < from_w:
            raise NotEnoughValidWindowsError(
                f"no stable window in [{from_ms}, {to_ms}]")
        win_indices = list(range(from_w, to_w + 1))

        cache_key = (from_w, to_w, options.min_valid_entity_ratio,
                     options.min_valid_entity_group_ratio,
                     options.max_allowed_extrapolations_per_entity,
                     options.granularity,
                     None if options.interested_entities is None
                     else frozenset(options.interested_entities),
                     self._generation)
        cached = self._completeness_cache.get(cache_key)
        if cached is not None:
            return cached, win_indices

        _, extrap = self._window_tensor(win_indices)
        _, window_valid = self._entity_validity(
            extrap, options.max_allowed_extrapolations_per_entity)

        interested = (options.interested_entities
                      if options.interested_entities is not None
                      else set(self._entities))
        interested_rows = np.array(
            [self._entity_index[ent] for ent in self._entities
             if ent in interested], dtype=np.int64)
        num_interested = max(len(interested), 1)

        # Two-step, as in the reference (MetricSampleAggregatorState
        # .completeness → WindowState.maybeInclude): first windows that meet
        # the per-window coverage ratio are included, then entity validity is
        # the intersection over *included* windows only — a sparse window
        # that fails the ratio is skipped without invalidating its entities.
        # denominator is ALL interested entities (never-sampled ones count
        # as invalid), matching valid_entity_ratio's denominator
        if len(interested_rows):
            per_window_ratio = (window_valid[interested_rows].sum(axis=0)
                                / num_interested)
        else:
            per_window_ratio = np.zeros(len(win_indices))
        included = per_window_ratio >= options.min_valid_entity_ratio
        valid_window_indices = []
        ratio_by_window = {}
        for j, w in enumerate(win_indices):
            if included[j]:
                t = self.window_end_time_ms(w)
                valid_window_indices.append(t)
                ratio_by_window[t] = float(per_window_ratio[j])

        extrapolated = window_valid & (extrap != Extrapolation.NONE.value)
        if included.any():
            entity_valid = (
                window_valid[:, included].all(axis=1)
                & (extrapolated[:, included].sum(axis=1)
                   <= options.max_allowed_extrapolations_per_entity))
        else:
            # no included windows → no valid entities (reference
            # MetricSampleAggregatorState.computeCompleteness:230-233)
            entity_valid = np.zeros(window_valid.shape[0], dtype=bool)

        # group validity: a group is valid iff all its interested entities are
        groups: Dict[Hashable, List[int]] = {}
        for ent in interested:
            row = self._entity_index.get(ent)
            g = getattr(ent, "group", None)
            groups.setdefault(g, []).append(-1 if row is None else row)
        group_valid = {
            g: all(r >= 0 and entity_valid[r] for r in rows)
            for g, rows in groups.items()}

        if options.granularity is Granularity.ENTITY_GROUP:
            effective_valid = np.zeros_like(entity_valid)
            for g, rows in groups.items():
                if group_valid[g]:
                    for r in rows:
                        effective_valid[r] = True
        else:
            effective_valid = entity_valid

        valid_entities = {ent for ent in interested
                          if (r := self._entity_index.get(ent)) is not None
                          and effective_valid[r]}
        valid_groups = {g for g, ok in group_valid.items() if ok}
        valid_entity_ratio = len(valid_entities) / num_interested
        valid_group_ratio = len(valid_groups) / max(len(groups), 1)

        comp = MetricSampleCompleteness(
            generation=self._generation,
            valid_entity_ratio=valid_entity_ratio,
            valid_entity_group_ratio=valid_group_ratio,
            valid_window_indices=valid_window_indices,
            valid_entities=valid_entities,
            valid_entity_groups=valid_groups,
            valid_entity_ratio_by_window=ratio_by_window)
        if len(self._completeness_cache) >= self._completeness_cache_size:
            self._completeness_cache.pop(next(iter(self._completeness_cache)))
        self._completeness_cache[cache_key] = comp
        return comp, win_indices

    def _validate_completeness(self, comp: MetricSampleCompleteness,
                               options: AggregationOptions,
                               from_ms: float, to_ms: float) -> None:
        if len(comp.valid_window_indices) < options.min_valid_windows:
            raise NotEnoughValidWindowsError(
                f"only {len(comp.valid_window_indices)} valid windows in "
                f"[{from_ms}, {to_ms}], need {options.min_valid_windows}")
        if comp.valid_entity_ratio < options.min_valid_entity_ratio:
            raise NotEnoughValidWindowsError(
                f"valid entity ratio {comp.valid_entity_ratio:.3f} < "
                f"required {options.min_valid_entity_ratio:.3f}")
        if (comp.valid_entity_group_ratio
                < options.min_valid_entity_group_ratio):
            raise NotEnoughValidWindowsError(
                f"valid entity-group ratio {comp.valid_entity_group_ratio:.3f}"
                f" < required {options.min_valid_entity_group_ratio:.3f}")
