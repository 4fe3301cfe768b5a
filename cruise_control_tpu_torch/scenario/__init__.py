"""What-if scenarios (port of cruise_control_tpu/scenario/).

`spec` — declarative ScenarioSpec and its JSON schema; `compiler` — K
specs -> K variant models of one padded geometry; `engine` — the batch's
lanes through the goal pipeline, with out-of-memory halving and its own
degradation ladder; `report` — ranking and the diff against the base
solve.
"""
from cruise_control_tpu_torch.scenario.engine import (BASE_SCENARIO_NAME,
                                                      ScenarioBatchResult,
                                                      ScenarioEngine,
                                                      ScenarioOutcome)
from cruise_control_tpu_torch.scenario.spec import (SCENARIO_SPEC_SCHEMA,
                                                    SCENARIOS_REQUEST_SCHEMA,
                                                    BrokerAdd, ScenarioSpec,
                                                    ScenarioSpecError,
                                                    candidate_broker_sets,
                                                    parse_scenarios_payload)

__all__ = [
    "BASE_SCENARIO_NAME", "BrokerAdd", "SCENARIO_SPEC_SCHEMA",
    "SCENARIOS_REQUEST_SCHEMA", "ScenarioBatchResult", "ScenarioEngine",
    "ScenarioOutcome", "ScenarioSpec", "ScenarioSpecError",
    "candidate_broker_sets", "parse_scenarios_payload",
]
