"""OpenMetrics rendering of the sensor registry (port of
cruise_control_tpu/obs/export.py).

The registry stays what it is (utils/metrics.py, JSON through the
facade's `state()`); this module renders the same sensors as an
OpenMetrics/Prometheus text page.  Names go through the one canonical
mapping in utils/metrics.py (`openmetrics_sensor`): `sensor-name` becomes
`cc_tpu_sensor_name`, and a `cluster.<id>.<sensor>` key becomes a
`{cluster="<id>"}` label.

Type mapping:

* counter  -> `<name>_total` counter
* meter    -> `<name>_total` counter + `<name>_rate` gauge (recent)
* timer    -> `<name>_count` / `_mean_seconds` / `_max_seconds` /
              `_p99_seconds` gauges
* histogram-> a histogram family: cumulative `_bucket{le=...}`, `_sum`,
              `_count`
* gauge    -> gauge (a broken gauge exports no sample)
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from cruise_control_tpu_torch.utils.metrics import openmetrics_sensor

#: the content type Prometheus scrapes negotiate for OpenMetrics
CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"


def _escape(value) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"')


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Family:
    __slots__ = ("name", "kind", "samples")

    def __init__(self, name: str, kind: str) -> None:
        self.name = name
        self.kind = kind
        #: (sample suffix, labels, value)
        self.samples: List[Tuple[str, Dict[str, str], object]] = []


def _families_of(sensors: Dict[str, dict]) -> List[_Family]:
    fams: Dict[str, _Family] = {}

    def fam(name: str, kind: str) -> _Family:
        f = fams.get(name)
        if f is None:
            f = fams[name] = _Family(name, kind)
        return f

    for raw_name in sorted(sensors):
        data = sensors[raw_name]
        if not isinstance(data, dict):
            continue
        name, labels = openmetrics_sensor(raw_name)
        kind = data.get("type")
        if kind == "counter":
            fam(name, "counter").samples.append(
                ("_total", labels, data.get("count", 0)))
        elif kind == "meter":
            fam(name, "counter").samples.append(
                ("_total", labels, data.get("count", 0)))
            fam(name + "_rate", "gauge").samples.append(
                ("", labels, data.get("recentRate", 0.0)))
        elif kind == "timer":
            fam(name + "_count", "gauge").samples.append(
                ("", labels, data.get("count", 0)))
            for key, suffix in (("meanMs", "_mean_seconds"),
                                ("maxMs", "_max_seconds"),
                                ("p99Ms", "_p99_seconds")):
                if key in data:
                    fam(name + suffix, "gauge").samples.append(
                        ("", labels, data[key] / 1e3))
        elif kind == "histogram":
            f = fam(name + "_seconds", "histogram")
            buckets = data.get("buckets", {})
            for le, count in buckets.items():
                f.samples.append(("_bucket",
                                  {**labels, "le": str(le)}, count))
            f.samples.append(("_sum", labels, data.get("sum", 0.0)))
            f.samples.append(("_count", labels, data.get("count", 0)))
        elif kind == "gauge":
            value = data.get("value")
            if value is not None:
                fam(name, "gauge").samples.append(("", labels, value))
            else:
                # the family still announces itself so a scrape knows
                # the sensor exists even while its callable is broken
                fam(name, "gauge")
        else:
            # unknown sensor shape: export what we can as a gauge
            value = data.get("value", data.get("count"))
            if value is not None:
                fam(name, "gauge").samples.append(("", labels, value))
    return [fams[k] for k in sorted(fams)]


def render_openmetrics(sensors: Dict[str, dict]) -> str:
    """One OpenMetrics page from a registry JSON (a
    `MetricRegistry.to_json()` dict; `cluster.<id>.` tagged keys become
    labels)."""
    lines: List[str] = []
    for family in _families_of(sensors):
        lines.append(f"# TYPE {family.name} {family.kind}")
        for suffix, labels, value in family.samples:
            lines.append(f"{family.name}{suffix}{_fmt_labels(labels)} "
                         f"{_fmt_value(value)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def render_for(cc) -> str:
    """The OpenMetrics page of a facade's registry (the reference's
    `/metrics`; the port has no fleet)."""
    return render_openmetrics(cc.metrics.to_json())
