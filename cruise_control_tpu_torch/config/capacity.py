"""Broker capacity resolution (port of cruise_control_tpu/config/capacity.py).

`BrokerCapacity` is the per-broker record; a `BrokerCapacityConfigResolver`
resolves it at model-build time (Cruise Control's
BrokerCapacityConfigResolver.java).  `StaticCapacityResolver` gives every
broker the same capacities; `BrokerCapacityConfigFileResolver` reads the
JSON capacity file in its three flavours (flat capacities, JBOD per-logdir
DISK maps, per-broker core counts) with the default entry (broker id -1)
for brokers not listed (Cruise Control's
BrokerCapacityConfigFileResolver.java).  Units follow Cruise Control: DISK
in MiB, NW_IN / NW_OUT in KiB/s, CPU in percent (cores x 100).
"""
from __future__ import annotations

import abc
import dataclasses
import json
from typing import Dict, Mapping, Optional, Tuple

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource

DEFAULT_CAPACITY_BROKER_ID = -1


@dataclasses.dataclass(frozen=True)
class BrokerCapacity:
    """Per-broker capacity info (reference BrokerCapacityInfo)."""

    capacity: Tuple[float, float, float, float]  # indexed by Resource
    disk_capacity_by_logdir: Optional[Mapping[str, float]] = None
    num_cpu_cores: float = 1.0
    is_estimated: bool = False
    estimation_info: str = ""

    def resource(self, r: Resource) -> float:
        return self.capacity[int(r)]


class BrokerCapacityConfigResolver(abc.ABC):
    """SPI: resolve broker capacities at model-build time
    (reference capacityForBroker(rack, host, id, timeout, allowEstimation))."""

    def configure(self, configs) -> None:  # pragma: no cover - plugin hook
        pass

    @abc.abstractmethod
    def capacity_for_broker(self, rack: Optional[str], host: str,
                            broker_id: int,
                            allow_estimation: bool = True) -> BrokerCapacity:
        ...

    def close(self) -> None:  # pragma: no cover
        pass


class StaticCapacityResolver(BrokerCapacityConfigResolver):
    """Uniform capacities for every broker (test/demo default)."""

    def __init__(self, cpu: float = 100.0, nw_in: float = 200_000.0,
                 nw_out: float = 200_000.0, disk: float = 1_000_000.0,
                 num_cpu_cores: float = 1.0):
        self._cap = BrokerCapacity((cpu, nw_in, nw_out, disk),
                                   num_cpu_cores=num_cpu_cores)

    def capacity_for_broker(self, rack, host, broker_id,
                            allow_estimation=True) -> BrokerCapacity:
        return self._cap


class BrokerCapacityConfigFileResolver(BrokerCapacityConfigResolver):
    """JSON capacity file resolver (reference
    BrokerCapacityConfigFileResolver.java:1-333).

    File format (same shape as the reference's config/capacity.json /
    capacityJBOD.json / capacityCores.json):

        {"brokerCapacities": [
           {"brokerId": "-1",
            "capacity": {"DISK": "1000000", "CPU": "100",
                         "NW_IN": "100000", "NW_OUT": "100000"}},
           {"brokerId": "0",
            "capacity": {"DISK": {"/data/d0": "500000",
                                  "/data/d1": "500000"},
                         "CPU": {"num.cores": "8"},
                         "NW_IN": "200000", "NW_OUT": "200000"}}]}

    brokerId -1 supplies the default for brokers not listed; using the
    default marks the capacity estimated.
    """

    def __init__(self, path: str):
        with open(path) as f:
            doc = json.load(f)
        self._by_id: Dict[int, BrokerCapacity] = {}
        for entry in doc.get("brokerCapacities", []):
            broker_id = int(entry["brokerId"])
            self._by_id[broker_id] = self._parse(entry, broker_id)
        if DEFAULT_CAPACITY_BROKER_ID not in self._by_id:
            raise ValueError(
                f"{path}: missing default capacity entry "
                f"(brokerId {DEFAULT_CAPACITY_BROKER_ID})")

    @staticmethod
    def _parse(entry: Mapping, broker_id: int) -> BrokerCapacity:
        cap_doc = entry["capacity"]
        # every resource must be present: a silent 0.0 capacity would make
        # capacity goals perpetually violated (the reference resolver
        # likewise rejects incomplete entries)
        missing = [k for k in ("DISK", "CPU", "NW_IN", "NW_OUT")
                   if k not in cap_doc]
        if missing:
            raise ValueError(
                f"capacity entry for broker {broker_id} is missing "
                f"resource(s) {missing}")
        caps = [0.0] * NUM_RESOURCES
        disk_by_logdir = None
        num_cores = 1.0

        disk = cap_doc["DISK"]
        if isinstance(disk, Mapping):  # JBOD per-logdir map
            disk_by_logdir = {str(k): float(v) for k, v in disk.items()}
            caps[Resource.DISK] = sum(disk_by_logdir.values())
        else:
            caps[Resource.DISK] = float(disk)

        cpu = cap_doc["CPU"]
        if isinstance(cpu, Mapping):  # capacityCores.json flavor
            num_cores = float(cpu.get("num.cores", 1))
            caps[Resource.CPU] = 100.0 * num_cores
        else:
            caps[Resource.CPU] = float(cpu)

        caps[Resource.NW_IN] = float(cap_doc["NW_IN"])
        caps[Resource.NW_OUT] = float(cap_doc["NW_OUT"])
        return BrokerCapacity(tuple(caps), disk_by_logdir, num_cores,
                              is_estimated=False)

    def capacity_for_broker(self, rack, host, broker_id,
                            allow_estimation=True) -> BrokerCapacity:
        cap = self._by_id.get(broker_id)
        if cap is not None:
            return cap
        if not allow_estimation:
            raise KeyError(
                f"no capacity configured for broker {broker_id} and "
                f"estimation not allowed")
        default = self._by_id[DEFAULT_CAPACITY_BROKER_ID]
        return dataclasses.replace(
            default, is_estimated=True,
            estimation_info=f"default capacity used for broker {broker_id}")
