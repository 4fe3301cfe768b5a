"""Machine-readable JSON Schemas for every REST response body (port of
cruise_control_tpu/api/schema.py).

The reference publishes OpenAPI YAML per endpoint and walks its
@JsonResponseClass annotations against it in a conformance test
(reference: cruise-control/src/test/java/.../ResponseTest.java:1-227,
cruise-control/src/yaml/endpoints/*.yaml).  Here the schemas are the
source of truth in code: `ENDPOINT_SCHEMAS` maps endpoint → JSON Schema
(draft 2020-12) for the 200 body, plus shared schemas for the 202
async-progress body, the purgatory 202 review body, and the error body.
`python -m cruise_control_tpu_torch.api.schema` emits the whole set as one
JSON document, the same document as docs/RESPONSE_SCHEMAS.json (its title
names the reference's package, whose schemas these are);
tests/test_torch_response_schema.py validates the port's live server
output against these.
"""
from __future__ import annotations

import json
from typing import Dict

_NUM = {"type": "number"}
_INT = {"type": "integer"}
_STR = {"type": "string"}
_BOOL = {"type": "boolean"}


def _obj(properties: dict, required=None, extra=True) -> dict:
    out = {"type": "object", "properties": properties,
           "additionalProperties": extra}
    if required:
        out["required"] = sorted(required)
    return out


def _arr(items: dict) -> dict:
    return {"type": "array", "items": items}


_BROKER_ROW = _obj({
    "Broker": _INT, "Host": _STR, "Rack": _STR,
    "BrokerState": {"enum": ["ALIVE", "DEAD"]},
    "Replicas": _INT, "Leaders": _INT,
    "CpuPct": _NUM, "NwInRate": _NUM, "NwOutRate": _NUM,
    "DiskMB": _NUM, "DiskPct": _NUM,
}, required=["Broker", "BrokerState", "Replicas", "Leaders"])

_HOST_ROW = _obj({
    "Host": _STR, "Replicas": _INT, "Leaders": _INT,
    "CpuPct": _NUM, "NwInRate": _NUM, "NwOutRate": _NUM, "DiskMB": _NUM,
}, required=["Host", "Replicas", "Leaders"])

BROKER_STATS = _obj({
    "brokers": _arr(_BROKER_ROW),
    "hosts": _arr(_HOST_ROW),
}, required=["brokers", "hosts"])

_PARTITION_ROW = _obj({
    "topic": _STR, "partition": _INT, "leader": _INT,
    "followers": _arr(_INT),
    "cpu": _NUM, "networkInbound": _NUM, "networkOutbound": _NUM,
    "disk": _NUM,
}, required=["topic", "partition", "leader", "followers"])

PARTITION_LOAD = _obj({
    "records": _arr(_PARTITION_ROW), "version": _INT,
}, required=["records", "version"])

_PROPOSAL = _obj({
    "topicPartition": _obj({"topic": _STR, "partition": _INT}),
    "oldLeader": _INT,
    "oldReplicas": _arr(_INT),
    "newReplicas": _arr(_INT),
}, required=["topicPartition", "newReplicas"])

#: which solver produced an optimization result (portfolio/): absent
#: entirely for a plain greedy solve with no portfolio in play, so
#: pre-portfolio response bodies stay byte-identical
_SOLVER_PROVENANCE = _obj({
    "solver": {"enum": ["greedy", "portfolio"]},
    "portfolioWidth": _INT,
    "portfolioSeed": _INT,
    "generation": {},
    "rung": {"enum": ["FUSED", "EAGER", "CPU"]},
    "candidateIndex": _INT,
    "perturbation": _STR,
    "greedyFitness": _NUM,
    "bestCandidateFitness": {"type": ["number", "null"]},
    "error": _STR,
}, required=["solver", "portfolioWidth", "portfolioSeed"])

OPTIMIZATION_RESULT = _obj({
    "summary": _obj({
        "numReplicaMovements": _INT,
        "numLeaderMovements": _INT,
        "dataToMoveMB": _NUM,
        "numProposals": _INT,
        "excludedTopics": _arr(_STR),
        "onDemandBalancednessScoreBefore": {"type": ["number", "null"]},
        "onDemandBalancednessScoreAfter": _NUM,
        "provisionStatus": _STR,
    }, required=["numReplicaMovements", "numProposals"]),
    "goalSummary": _arr(_obj({
        "goal": _STR,
        "status": {"enum": ["FIXED", "VIOLATED", "NO-ACTION"]},
    }, required=["goal", "status"])),
    "violatedGoalsBefore": _arr(_STR),
    "violatedGoalsAfter": _arr(_STR),
    "solverProvenance": _SOLVER_PROVENANCE,
    "proposals": _arr(_PROPOSAL),
}, required=["summary", "goalSummary"])

KAFKA_CLUSTER_STATE = _obj({
    "KafkaBrokerState": _obj({
        "LeaderCountByBrokerId": _obj({}, extra=True),
        "ReplicaCountByBrokerId": _obj({}, extra=True),
        "OutOfSyncCountByBrokerId": _obj({}, extra=True),
        "OfflineReplicaCountByBrokerId": _obj({}, extra=True),
        "IsController": _obj({}, extra=True),
    }, required=["LeaderCountByBrokerId", "ReplicaCountByBrokerId"]),
    "KafkaPartitionState": _obj({}, extra=True),
    "version": _INT,
}, required=["KafkaBrokerState", "KafkaPartitionState", "version"])

#: crash-recovery telemetry inside ExecutorState (executor/journal.py +
#: recovery.py): present only when journaling is configured or a
#: recovery ran — journal-less deployments see the pre-journal body
_EXECUTOR_RECOVERY = _obj({
    "journalEnabled": _BOOL,
    "recoveryInProgress": _BOOL,
    "journal": _obj({
        "directory": _STR, "broken": _BOOL, "writes": _INT,
        "bytesWritten": _INT, "errors": _INT,
    }),
    "lastRecovery": _obj({
        "mode": {"enum": ["resume", "abort"]},
        "uuid": _STR,
        "resumed": _BOOL,
        "tasksTotal": _INT, "tasksTerminal": _INT,
        "tasksAdopted": _INT, "tasksPending": _INT,
        "clearedThrottleBrokers": _arr(_INT),
        "cancelledReassignments": _INT,
        "journalTruncated": _BOOL,
        "phaseAtCrash": {"type": ["string", "null"]},
        "recoveredAtMs": _NUM,
    }),
}, required=["journalEnabled", "recoveryInProgress"])

#: per-class SLO burn state (obs/slo.py; substate `slo`)
_SLO_CLASS = _obj({
    "objective": _obj({
        "latencyMs": _NUM, "queueWaitMs": _NUM, "errorBudget": _NUM,
    }),
    "windowSolves": _INT,
    "queueWaitBurn": _NUM,
    "deviceTimeBurn": _NUM,
    "burn": _NUM,
    "budgetRemaining": _NUM,
    "status": {"enum": ["ok", "burning", "breach"]},
}, required=["burn", "status"])

SLO_STATUS = _obj({
    "enabled": _BOOL,
    "windowS": _NUM,
    "alertThreshold": _NUM,
    "status": {"enum": ["ok", "burning", "breach"]},
    "worstBurn": _NUM,
    "worstClass": {"type": ["string", "null"]},
    "classes": {"type": "object", "additionalProperties": _SLO_CLASS},
    "detector": _obj({
        "breachedClasses": _arr(_STR), "reported": _INT,
    }),
}, required=["enabled", "status", "worstBurn"])

STATE = _obj({
    "MonitorState": _obj({}, extra=True),
    "ExecutorState": _obj({"recovery": _EXECUTOR_RECOVERY}, extra=True),
    "AnalyzerState": _obj({}, extra=True),
    "AnomalyDetectorState": _obj({}, extra=True),
    "PortfolioState": _obj({}, extra=True),
    "SchedulerState": _obj({}, extra=True),
    "FleetState": _obj({}, extra=True),
    "IncrementalStoreState": _obj({}, extra=True),
    "sloStatus": SLO_STATUS,
    "version": _INT,
}, required=["version"])

_FLEET_TENANT = _obj({
    "clusterId": _STR,
    "status": {"enum": ["ACTIVE", "DRAINING"]},
    "isDefault": _BOOL,
    "registeredAtMs": _INT,
    "monitor": _obj({}, extra=True),
    "solverRung": {"enum": ["FUSED", "EAGER", "CPU"]},
    "hasOngoingExecution": _BOOL,
    "state": _obj({}, extra=True),
    "stateError": _STR,
}, required=["clusterId", "status", "isDefault"])

#: fleet tenant listing (multi-cluster serving, fleet/registry.py)
FLEET = _obj({
    "clusters": _arr(_FLEET_TENANT),
    "defaultTenant": {"oneOf": [_STR, {"type": "null"}]},
    "buckets": _obj({
        "bucketFloor": _INT,
        "trackedCombos": _INT,
        "totalCombos": _INT,
        "maxTracked": _INT,
    }, required=["bucketFloor", "totalCombos"]),
    "foldEnabled": _BOOL,
    "router": _obj({
        "totalFoldedSolves": _INT,
        "totalFoldBatches": _INT,
        "totalFallbacks": _INT,
        "maxGroup": _INT,
    }),
    "version": _INT,
}, required=["clusters", "defaultTenant", "buckets", "foldEnabled",
             "version"])

_USER_TASK = _obj({
    "UserTaskId": _STR,
    "Status": {"enum": ["Active", "Completed", "CompletedWithError"]},
    "RequestURL": _STR,
    "ClientIdentity": _STR,
    "StartMs": _NUM,
    # device-time scheduler visibility (present while the task's solve
    # is queued or running): priority class, 1-based dispatch-order
    # position while queued with 0 reserved for on-the-device-now, and
    # the estimated/actual start
    "SchedulerClass": {"enum": ["ANOMALY_HEAL", "USER_INTERACTIVE",
                                "PRECOMPUTE", "SCENARIO_SWEEP"]},
    "QueuePosition": {"type": "integer", "minimum": 0},
    "EstimatedStartMs": _NUM,
    "SolverProvenance": _SOLVER_PROVENANCE,
}, required=["UserTaskId", "Status"])

USER_TASKS = _obj({
    "userTasks": _arr(_USER_TASK), "version": _INT,
}, required=["userTasks", "version"])

_REVIEW_REQUEST = _obj({
    "Id": _INT, "Status": _STR, "EndPoint": _STR, "Reason": _STR,
    "SubmitterAddress": _STR,
}, required=["Id", "Status", "EndPoint"])

REVIEW_BOARD = _obj({
    "requestInfo": _arr(_REVIEW_REQUEST), "version": _INT,
}, required=["requestInfo", "version"])

_SCENARIO_OUTCOME = _obj({
    "name": _STR,
    "feasible": _BOOL,
    "rung": {"enum": ["FUSED", "EAGER", "CPU"]},
    "reason": _STR,
    "balancedness": _NUM,
    "numReplicaMoves": _INT,
    "numLeadershipMoves": _INT,
    "dataToMoveMB": _NUM,
    "violatedGoalsBefore": _arr(_STR),
    "violatedGoalsAfter": _arr(_STR),
    "statsAfter": _obj({}, extra=True),
    "vsBase": _obj({
        "balancednessDelta": _NUM,
        "violatedGoalsAfterDelta": _INT,
        "dataToMoveDeltaMB": _NUM,
        "numReplicaMovesDelta": _INT,
    }),
    "numProposals": _INT,
    "proposals": _arr(_PROPOSAL),
}, required=["name", "feasible", "rung", "balancedness"])

SCENARIOS = _obj({
    "scenarios": _arr(_SCENARIO_OUTCOME),
    "base": {"oneOf": [_SCENARIO_OUTCOME, {"type": "null"}]},
    "batch": _obj({
        "numScenarios": _INT,
        "rung": {"enum": ["FUSED", "EAGER", "CPU"]},
        "oomHalvings": _INT,
        "deviceBatchSizes": _arr(_INT),
        "compileS": _NUM,
        "solveS": _NUM,
        "durationS": _NUM,
    }, required=["numScenarios", "rung", "oomHalvings"]),
    "dryRun": {"const": True},
    "version": _INT,
}, required=["scenarios", "batch", "dryRun", "version"])

#: one span node in a trace tree (recursive via $ref-free nesting: the
#: validator in tests walks `children` with the same shape)
_TRACE_SPAN = _obj({
    "spanId": _INT,
    "name": _STR,
    "startMs": _NUM,
    "durationMs": _NUM,
    "tags": _obj({}, extra=True),
    "events": _arr(_obj({}, extra=True)),
    "children": _arr(_obj({}, extra=True)),
}, required=["spanId", "name", "durationMs"])

_TRACE = _obj({
    "traceId": _STR,
    "name": _STR,
    "outcome": {"enum": ["ok", "failed", "degraded", "fallback",
                         "preempted", "rejected"]},
    "tags": _obj({}, extra=True),
    "startMs": _NUM,
    "durationMs": _NUM,
    "numSpans": _INT,
    "droppedSpans": _INT,
    "root": _TRACE_SPAN,
}, required=["traceId", "outcome", "durationMs"])

TRACES = _obj({
    "traces": _arr(_TRACE),
    "recorder": _obj({
        "capacity": _INT, "retained": _INT, "pinned": _INT,
        "recorded": _INT, "pinnedTotal": _INT, "exportedPins": _INT,
        "sampledOut": _INT,
    }),
    "version": _INT,
}, required=["traces", "version"])

MESSAGE = _obj({"message": _STR, "version": _INT},
               required=["message", "version"])

ADMIN = _obj({
    "selfHealing": _obj({}, extra=True), "version": _INT,
}, required=["version"])

#: 202 body while an async operation is still running
ASYNC_PROGRESS = _obj({
    "progress": _arr(_obj({
        "operation": _STR, "status": _STR,
    }, required=["operation"])),
    "version": _INT,
}, required=["progress", "version"])

#: 202 body when two-step verification parks a POST
REVIEW_PARKED = _obj({
    "reviewResult": _REVIEW_REQUEST, "version": _INT,
}, required=["reviewResult", "version"])

ERROR = _obj({"errorMessage": _STR, "version": _INT},
             required=["errorMessage", "version"])

#: 429 body when the device-time scheduler rejects at a class queue cap
#: (the same hint also rides the `Retry-After` response header)
RATE_LIMITED = _obj({
    "errorMessage": _STR,
    "retryAfterSeconds": _NUM,
    "version": _INT,
}, required=["errorMessage", "retryAfterSeconds", "version"])

#: endpoint → JSON Schema of the 200 response body
ENDPOINT_SCHEMAS: Dict[str, dict] = {
    "STATE": STATE,
    "KAFKA_CLUSTER_STATE": KAFKA_CLUSTER_STATE,
    "LOAD": BROKER_STATS,
    "PARTITION_LOAD": PARTITION_LOAD,
    "PROPOSALS": OPTIMIZATION_RESULT,
    "USER_TASKS": USER_TASKS,
    "REVIEW_BOARD": REVIEW_BOARD,
    "REVIEW": REVIEW_BOARD,
    "BOOTSTRAP": MESSAGE,
    "TRAIN": MESSAGE,
    "STOP_PROPOSAL_EXECUTION": MESSAGE,
    "PAUSE_SAMPLING": MESSAGE,
    "RESUME_SAMPLING": MESSAGE,
    "ADMIN": ADMIN,
    "REBALANCE": OPTIMIZATION_RESULT,
    "ADD_BROKER": OPTIMIZATION_RESULT,
    "REMOVE_BROKER": OPTIMIZATION_RESULT,
    "DEMOTE_BROKER": OPTIMIZATION_RESULT,
    "FIX_OFFLINE_REPLICAS": OPTIMIZATION_RESULT,
    "TOPIC_CONFIGURATION": OPTIMIZATION_RESULT,
    "SCENARIOS": SCENARIOS,
    "FLEET": FLEET,
    "TRACES": TRACES,
}

#: non-200 body schemas by meaning
AUX_SCHEMAS: Dict[str, dict] = {
    "async_progress_202": ASYNC_PROGRESS,
    "review_parked_202": REVIEW_PARKED,
    "rate_limited_429": RATE_LIMITED,
    "error": ERROR,
}


def document() -> dict:
    """The full schema artifact as one JSON document."""
    from cruise_control_tpu_torch.scenario.spec import \
        SCENARIOS_REQUEST_SCHEMA
    return {
        "$schema": "https://json-schema.org/draft/2020-12/schema",
        "title": "cruise_control_tpu REST response schemas",
        "endpoints": ENDPOINT_SCHEMAS,
        "aux": AUX_SCHEMAS,
        # endpoints that take a JSON request BODY publish its schema too
        "requests": {"SCENARIOS": SCENARIOS_REQUEST_SCHEMA},
    }


if __name__ == "__main__":
    print(json.dumps(document(), indent=2, sort_keys=True))
