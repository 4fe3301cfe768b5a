"""The PyTorch port's windowed aggregator (cruise_control_tpu_torch/core/
aggregator.py, core/metricdef.py) against the JAX reference's, on the CPU.

Each scenario of tests/test_aggregator.py (avg / max / latest, the four
extrapolations, window rolling, too-old and partial samples, a sparse
window, the completeness cache, entity and group granularity, the
window and ratio errors, the current-window peek, entity retention, the
generation) is replayed on both packages' aggregators with the same
samples, and so is a seeded stream of many samples a window over 40
entities in 4 groups (so float32 accumulation rounds).  Everything
observable is recorded and must be equal exactly: every `aggregate()`
result (values as float32 bit views, extrapolations, window times,
valid windows, valid entities and groups, the ratios, invalid
entities), each completeness, `peek_current_window`, the windows, the
sample and abandoned counts, the generation, and each error raised (its
class name and message).
"""
import dataclasses

import numpy as np
import pytest

from cruise_control_tpu.core import aggregator as JA
from cruise_control_tpu.core import metricdef as JM
from cruise_control_tpu_torch.core import aggregator as PA
from cruise_control_tpu_torch.core import metricdef as PM

WINDOW_MS = 1000
MIN_SAMPLES = 4


@dataclasses.dataclass(frozen=True)
class IntegerEntity:
    """An entity with a named group (the reference's IntegerEntity)."""
    group: str
    idx: int


class Pkg:
    """One package's aggregator API and a log of what it observed."""

    def __init__(self, agg_mod, md_mod):
        self.A, self.M = agg_mod, md_mod
        self.log = []

    def metric_def(self):
        md = self.M.MetricDef()
        md.define("m_avg", self.M.AggregationFunction.AVG)
        md.define("m_max", self.M.AggregationFunction.MAX)
        md.define("m_latest", self.M.AggregationFunction.LATEST)
        return md.freeze()

    def aggregator(self, num_windows=8):
        return self.A.MetricSampleAggregator(
            num_windows=num_windows, window_ms=WINDOW_MS,
            min_samples_per_window=MIN_SAMPLES,
            metric_def=self.metric_def())

    def sample(self, entity, t, values):
        return self.A.MetricSample(entity, t, values)

    def options(self, **kw):
        if "granularity" in kw:
            kw["granularity"] = self.A.Granularity(kw["granularity"])
        return self.A.AggregationOptions(**kw)

    def fill_window(self, agg, entity, window, num_samples=MIN_SAMPLES,
                    value=10.0):
        for i in range(num_samples):
            t = ((window - 1) * WINDOW_MS
                 + (i + 1) * WINDOW_MS // (num_samples + 1))
            self.log.append(("add", agg.add_sample(self.sample(
                entity, t, {0: value, 1: value * 2, 2: value * 3}))))

    def call(self, fn, *args, **kw):
        """fn(...) recorded: its canonical result, or its error."""
        try:
            out = fn(*args, **kw)
        except Exception as exc:  # noqa: BLE001 - errors are compared
            self.log.append(("error", type(exc).__name__, str(exc)))
            return None
        self.log.append(("ok", canon(out)))
        return out

    def state(self, agg):
        self.log.append(("state", agg.generation, agg.all_windows(),
                         agg.num_samples(), agg.num_abandoned_samples,
                         agg.earliest_window(),
                         agg.num_available_windows()))


def _bits(values) -> tuple:
    arr = np.ascontiguousarray(values, dtype=np.float32)
    return (arr.shape, arr.view(np.uint32).tobytes())


def _extrap(ex) -> tuple:
    return tuple(sorted((int(k), v.name) for k, v in ex.items()))


def _vae(v) -> tuple:
    return (_bits(v.values), _extrap(v.extrapolations),
            tuple(v.window_times_ms), v.is_extrapolated())


def _key(entity):
    return repr(entity)


def canon(out):
    """A comparable form of an aggregator answer (no package classes)."""
    if out is None or isinstance(out, (bool, int, float, str)):
        return out
    if isinstance(out, dict):
        return tuple(sorted((_key(k), canon(v)) for k, v in out.items()))
    if isinstance(out, (list, tuple)):
        return tuple(canon(x) for x in out)
    name = type(out).__name__
    if name == "ValuesAndExtrapolations":
        return _vae(out)
    if name == "MetricSampleCompleteness":
        return ("completeness", out.generation, out.valid_entity_ratio,
                out.valid_entity_group_ratio,
                tuple(out.valid_window_indices),
                tuple(sorted(map(_key, out.valid_entities))),
                tuple(sorted(map(repr, out.valid_entity_groups))),
                tuple(sorted(out.valid_entity_ratio_by_window.items())))
    if name == "MetricSampleAggregationResult":
        return ("result", out.generation, canon(out.completeness),
                canon(out.entity_values),
                tuple(sorted(map(_key, out.invalid_entities))))
    raise TypeError(f"no canonical form for {name}")


# ---------------------------------------------------------------------------
# the reference's scenarios (tests/test_aggregator.py), package-neutral
# ---------------------------------------------------------------------------
def s_avg_max_latest(k):
    agg, e = k.aggregator(), IntegerEntity("g", 0)
    for i, v in enumerate([1.0, 2.0, 3.0, 4.0]):
        k.log.append(agg.add_sample(k.sample(e, 100 + i * 100,
                                             {0: v, 1: v * 2, 2: v * 3})))
    k.fill_window(agg, e, 2)
    k.call(agg.aggregate, 0, 10_000, k.options())
    k.state(agg)


def s_avg_available(k):
    agg, e = k.aggregator(), IntegerEntity("g", 0)
    for i, v in enumerate([2.0, 4.0]):
        agg.add_sample(k.sample(e, 100 + i * 100, {0: v, 1: v, 2: v}))
    k.fill_window(agg, e, 2)
    k.call(agg.aggregate, 0, 10_000)


def s_avg_adjacent(k):
    agg, e = k.aggregator(), IntegerEntity("g", 0)
    k.fill_window(agg, e, 1, value=10.0)
    k.fill_window(agg, e, 3, value=20.0)
    k.fill_window(agg, e, 4)
    k.fill_window(agg, e, 5)
    k.call(agg.aggregate, 0, 100_000)
    k.state(agg)


def s_forced_insufficient(k):
    agg, e = k.aggregator(), IntegerEntity("g", 0)
    agg.add_sample(k.sample(e, 500, {0: 7.0, 1: 7.0, 2: 7.0}))
    k.fill_window(agg, e, 2)
    k.call(agg.aggregate, 0, 10_000)


def s_window_rolling(k):
    agg, e = k.aggregator(num_windows=4), IntegerEntity("g", 0)
    for w in range(1, 10):
        k.fill_window(agg, e, w)
    k.state(agg)
    k.call(agg.aggregate, 0, 100_000)


def s_too_old_rejected(k):
    agg, e = k.aggregator(num_windows=2), IntegerEntity("g", 0)
    for w in range(5, 9):
        k.fill_window(agg, e, w)
    k.log.append(agg.add_sample(k.sample(e, 100, {0: 1.0, 1: 1.0, 2: 1.0})))
    k.state(agg)


def s_partial_rejected(k):
    agg, e = k.aggregator(), IntegerEntity("g", 0)
    k.call(agg.add_sample, k.sample(e, 100, {0: 1.0}))
    k.call(agg.add_sample, k.sample(e, 100, {0: 1.0, 1: 1.0, 2: 1.0,
                                             7: 1.0}))
    k.state(agg)


def s_sparse_window(k):
    agg = k.aggregator()
    entities = [IntegerEntity("g", i) for i in range(10)]
    for w in [1, 5, 6]:
        for e in entities:
            k.fill_window(agg, e, w)
    for e in entities[:2]:
        for w in [2, 3, 4]:
            k.fill_window(agg, e, w)
    opts = k.options(min_valid_entity_ratio=0.5,
                     interested_entities=set(entities))
    k.call(agg.aggregate, 0, 100_000, opts)
    k.call(agg.completeness, 0, 100_000, opts)


def s_completeness_cache(k):
    agg, e = k.aggregator(), IntegerEntity("g", 0)
    for w in range(1, 5):
        k.fill_window(agg, e, w)
    opts = k.options()
    c1 = k.call(agg.completeness, 0, 100_000, opts)
    c2 = k.call(agg.completeness, 0, 100_000, opts)
    k.log.append(("cached", c2 is c1))
    k.fill_window(agg, e, 5)
    c3 = k.call(agg.completeness, 0, 100_000, opts)
    k.log.append(("invalidated", c3 is not c1))


def s_granularity(k):
    agg = k.aggregator()
    complete = IntegerEntity("topicA", 0)
    partial = IntegerEntity("topicA", 1)
    other = IntegerEntity("topicB", 2)
    for w in range(1, 6):
        k.fill_window(agg, complete, w)
        k.fill_window(agg, other, w)
        if w >= 3:
            k.fill_window(agg, partial, w)
    ents = {complete, partial, other}
    k.call(agg.completeness, 0, 100_000,
           k.options(interested_entities=ents))
    k.call(agg.completeness, 0, 100_000,
           k.options(interested_entities=ents, granularity="entity_group"))
    k.call(agg.aggregate, 0, 100_000,
           k.options(interested_entities=ents, granularity="entity_group",
                     include_invalid_entities=True))


def s_not_enough_windows(k):
    agg, e = k.aggregator(), IntegerEntity("g", 0)
    k.call(agg.aggregate, 0, 10_000)   # no sample yet
    k.fill_window(agg, e, 1)
    k.call(agg.aggregate, 0, 10_000, k.options(min_valid_windows=1))
    k.fill_window(agg, e, 2)
    k.call(agg.aggregate, 0, 10_000, k.options(min_valid_windows=3))


def s_min_valid_entity_ratio(k):
    agg = k.aggregator()
    good, bad = IntegerEntity("g", 0), IntegerEntity("g", 1)
    for w in range(1, 4):
        k.fill_window(agg, good, w)
    k.call(agg.aggregate, 0, 100_000,
           k.options(min_valid_entity_ratio=0.9,
                     interested_entities={good, bad}))
    k.call(agg.aggregate, 0, 100_000,
           k.options(min_valid_entity_group_ratio=0.5,
                     interested_entities={good, IntegerEntity("h", 2)}))


def s_peek(k):
    agg, e = k.aggregator(), IntegerEntity("g", 0)
    k.call(agg.peek_current_window)
    k.fill_window(agg, e, 1)
    agg.add_sample(k.sample(e, 1500, {0: 42.0, 1: 42.0, 2: 42.0}))
    k.call(agg.peek_current_window)


def s_retain_remove(k):
    a, b = IntegerEntity("ga", 0), IntegerEntity("gb", 1)
    agg = k.aggregator()
    for w in range(1, 4):
        k.fill_window(agg, a, w)
        k.fill_window(agg, b, w)
    k.state(agg)
    agg.retain_entities({a})
    k.state(agg)
    k.call(agg.aggregate, 0, 100_000)
    agg2 = k.aggregator()
    for w in range(1, 4):
        k.fill_window(agg2, a, w)
        k.fill_window(agg2, b, w)
    agg2.remove_entity_group({"gb"})
    k.call(agg2.aggregate, 0, 100_000)
    agg2.remove_entities({a})
    agg2.retain_entity_group({"ga"})
    k.state(agg2)
    agg2.clear()
    k.state(agg2)


def s_generation(k):
    agg, e = k.aggregator(), IntegerEntity("g", 0)
    k.fill_window(agg, e, 1)
    k.state(agg)
    k.fill_window(agg, e, 2)
    k.state(agg)


def s_seeded_stream(k):
    """40 entities in 4 groups, 1-9 samples an entity-window over 12
    windows (some empty), values spanning six decades, times in random
    order within a window; then every query."""
    g = np.random.default_rng(18)
    agg = k.aggregator(num_windows=6)
    ents = [IntegerEntity(f"g{i % 4}", i) for i in range(40)]
    for w in range(1, 13):
        batch = []
        for e in ents:
            n = int(g.integers(0, 10))
            for _ in range(n):
                t = float((w - 1) * WINDOW_MS + int(g.integers(1, 1000)))
                vals = g.lognormal(3.0, 2.5, size=3)
                batch.append((t, e, {m: float(vals[m]) for m in range(3)}))
        order = g.permutation(len(batch))
        for j in order:
            t, e, v = batch[j]
            k.log.append(agg.add_sample(k.sample(e, t, v)))
        k.state(agg)
    opts = [k.options(),
            k.options(min_valid_entity_ratio=0.3,
                      max_allowed_extrapolations_per_entity=2),
            k.options(granularity="entity_group",
                      interested_entities=set(ents[:20]),
                      include_invalid_entities=True)]
    for o in opts:
        k.call(agg.aggregate, -np.inf, np.inf, o)
        k.call(agg.aggregate, 3000, 9000, o)
        k.call(agg.completeness, 0, 100_000, o)
    k.call(agg.peek_current_window)


SCENARIOS = [s_avg_max_latest, s_avg_available, s_avg_adjacent,
             s_forced_insufficient, s_window_rolling, s_too_old_rejected,
             s_partial_rejected, s_sparse_window, s_completeness_cache,
             s_granularity, s_not_enough_windows, s_min_valid_entity_ratio,
             s_peek, s_retain_remove, s_generation, s_seeded_stream]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[2:] for s in SCENARIOS])
def test_aggregator_equals_reference(scenario):
    ref, port = Pkg(JA, JM), Pkg(PA, PM)
    scenario(ref)
    scenario(port)
    assert len(port.log) == len(ref.log) and port.log, scenario.__name__
    for i, (a, b) in enumerate(zip(port.log, ref.log)):
        assert a == b, f"{scenario.__name__}: entry {i} differs"


def test_metric_defs_equal_reference():
    """The monitor's two registries give every metric the reference's id,
    aggregation function and group (samples and stored bytes carry the
    ids), and the raw-type maps agree."""
    from cruise_control_tpu.monitor import metricdef as JMD
    from cruise_control_tpu_torch.monitor import metricdef as PMD

    def infos(md):
        return [(m.name, m.metric_id, m.aggregation_function.value, m.group)
                for m in md.all_metric_infos()]
    assert infos(PMD.common_metric_def()) == infos(JMD.common_metric_def())
    assert infos(PMD.broker_metric_def()) == infos(JMD.broker_metric_def())
    assert ({r.name: (r.scope.value, v)
             for r, v in PMD.RAW_TO_BROKER_METRIC.items()}
            == {r.name: (r.scope.value, v)
                for r, v in JMD.RAW_TO_BROKER_METRIC.items()})
    md = PM.MetricDef()
    md.define("a")
    md.size()
    with pytest.raises(RuntimeError, match="frozen"):
        md.define("b")
