"""`cccli`-style command-line client (port of cruise_control_tpu/client/
cli.py).

Reference cruise-control-client/cruisecontrolclient/client/cccli.py +
docs/wiki "cccli Command Line Usage": one subcommand per endpoint with
typed flags, printing the JSON response.
"""
from __future__ import annotations

import argparse
import base64
import json
import sys
from typing import List, Optional

from cruise_control_tpu_torch.client.client import (
    CruiseControlClient, CruiseControlClientError)


def _csv_ints(s: str) -> List[int]:
    return [int(x) for x in s.split(",") if x.strip()]


def _csv(s: str) -> List[str]:
    return [x for x in s.split(",") if x.strip()]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="cccli",
        description="Command-line client for the cruise-control-tpu REST "
                    "API")
    parser.add_argument("-a", "--address", default="http://127.0.0.1:9090"
                        "/kafkacruisecontrol",
                        help="base URL of the REST API")
    parser.add_argument("--user", help="basic-auth user:password")
    parser.add_argument("--no-wait", action="store_true",
                        help="do not poll async operations to completion")
    parser.add_argument("--max-retries", type=int, default=4,
                        help="retries after HTTP 429 (scheduler "
                             "backpressure), honoring Retry-After with "
                             "capped exponential backoff + deterministic "
                             "jitter; 0 fails fast (default: 4)")
    parser.add_argument("--cluster",
                        help="fleet tenant to address (rides as "
                             "cluster=<id> on every subcommand; the "
                             "server's default tenant when omitted; an "
                             "unknown tenant is a clean 404 error)")
    sub = parser.add_subparsers(dest="command", required=True)

    def add(name: str, **kwargs) -> argparse.ArgumentParser:
        return sub.add_parser(name, **kwargs)

    p = add("state", help="component states")
    p.add_argument("--substates", type=_csv)

    add("load", help="per-broker load stats")

    p = add("partition_load", help="per-partition load")
    p.add_argument("--resource", default="disk")
    p.add_argument("--entries", type=int)
    p.add_argument("--topic")

    p = add("proposals", help="current rebalance proposals")
    p.add_argument("--goals", type=_csv)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--ignore-proposal-cache", action="store_true")
    p.add_argument("--portfolio-width", type=int, metavar="K",
                   help="search K perturbed solver candidates in one "
                        "batched device solve and answer with the "
                        "best-by-fitness winner (portfolio/); the "
                        "response's solverProvenance says which solver "
                        "won (server default when omitted)")

    add("kafka_cluster_state", help="raw cluster metadata")
    add("user_tasks", help="async task history")
    add("review_board", help="pending two-step reviews")

    p = add("fleet", help="fleet tenant listing (multi-cluster servers)")
    p.add_argument("--verbose", action="store_true",
                   help="include each tenant's full state")

    for name, needs_brokers in (("rebalance", False), ("add_broker", True),
                                ("remove_broker", True),
                                ("demote_broker", True),
                                ("fix_offline_replicas", False)):
        p = add(name, help=f"{name.replace('_', ' ')} (POST)")
        if needs_brokers:
            p.add_argument("brokers", type=_csv_ints,
                           help="CSV broker ids")
        p.add_argument("--execute", action="store_true",
                       help="actually execute (default is dry run)")
        if name in ("rebalance", "add_broker", "remove_broker",
                    "fix_offline_replicas"):
            p.add_argument("--goals", type=_csv)
        if name == "rebalance":
            p.add_argument("--portfolio-width", type=int, metavar="K",
                           help="device-parallel portfolio search width "
                                "(see `proposals --portfolio-width`)")
        p.add_argument("--verbose", action="store_true")
        p.add_argument("--reason")
        p.add_argument("--review-id", type=int)

    p = add("scenarios", help="batched what-if analysis (dry run)")
    p.add_argument("--spec-file",
                   help="JSON file with the request body "
                        '({"scenarios": [...]}) or a bare scenario list')
    p.add_argument("--spec",
                   help="inline JSON (same format as --spec-file)")
    p.add_argument("--goals", type=_csv,
                   help="goal-list override for every scenario")
    p.add_argument("--no-base", action="store_true",
                   help="skip the implicit base (do-nothing) solve")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--reason")
    p.add_argument("--review-id", type=int)

    p = add("topic_configuration", help="change topic replication factor")
    p.add_argument("topic")
    p.add_argument("replication_factor", type=int)
    p.add_argument("--execute", action="store_true")

    p = add("stop_execution", help="stop the ongoing execution")
    p.add_argument("--force", action="store_true")

    p = add("pause_sampling", help="pause metric sampling")
    p.add_argument("--reason", default="paused via cccli")
    p = add("resume_sampling", help="resume metric sampling")
    p.add_argument("--reason", default="resumed via cccli")

    p = add("admin", help="toggle self-healing etc.")
    p.add_argument("--enable-self-healing-for", type=_csv)
    p.add_argument("--disable-self-healing-for", type=_csv)

    p = add("review", help="approve/discard two-step requests")
    p.add_argument("--approve", type=_csv_ints)
    p.add_argument("--discard", type=_csv_ints)
    p.add_argument("--reason", default="")

    p = add("traces", help="flight-recorder trace query (obs/)")
    p.add_argument("--trace-id",
                   help="fetch the span tree a solve response's traceId "
                        "named")
    p.add_argument("--outcome",
                   choices=["ok", "failed", "degraded", "fallback",
                            "preempted", "rejected"],
                   help="filter by outcome (degraded/failed traces are "
                        "pinned until exported)")
    p.add_argument("--limit", type=int)
    p.add_argument("--verbose", action="store_true",
                   help="include full span trees in listings")
    p.add_argument("--since", type=float, metavar="EPOCH_MS",
                   help="only traces started at/after this epoch-ms "
                        "timestamp (drills under load: never page the "
                        "whole ring)")
    p.add_argument("--min-duration-ms", type=float,
                   help="only traces at least this slow")

    add("metrics", help="raw OpenMetrics page (/metrics scrape)")

    add("slo", help="per-class SLO burn status (STATE sloStatus: burn "
                    "rate, queue-wait vs device-time, budget remaining)")

    add("portfolio", help="portfolio-search status (STATE "
                          "PortfolioState: width/seed, ladder rung, "
                          "improvement/stale-drop counters, "
                          "portfolio-vs-greedy fitness gap)")

    add("loadgen", help="trace-replay load harness (the reference's "
                        "loadgen/, which the port does not have yet: this "
                        "subcommand exits with that message)")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    auth = None
    if args.user:
        auth = "Basic " + base64.b64encode(args.user.encode()).decode()
    client = CruiseControlClient(args.address, auth_header=auth,
                                 wait_default=not args.no_wait,
                                 max_retries_429=args.max_retries,
                                 cluster=args.cluster)

    cmd = args.command
    try:
        if cmd == "state":
            out = client.state(args.substates)
        elif cmd == "load":
            out = client.load()
        elif cmd == "partition_load":
            out = client.partition_load(args.resource, args.entries,
                                        args.topic)
        elif cmd == "proposals":
            out = client.proposals(args.goals, args.verbose,
                                   args.ignore_proposal_cache,
                                   portfolio_width=args.portfolio_width)
        elif cmd == "kafka_cluster_state":
            out = client.kafka_cluster_state()
        elif cmd == "user_tasks":
            out = client.user_tasks()
        elif cmd == "review_board":
            out = client.review_board()
        elif cmd == "fleet":
            out = client.fleet(verbose=args.verbose)
        elif cmd in ("rebalance", "add_broker", "remove_broker",
                     "demote_broker", "fix_offline_replicas"):
            params = {"dryrun": not args.execute,
                      "verbose": args.verbose}
            if getattr(args, "goals", None):
                params["goals"] = args.goals
            if args.reason:
                params["reason"] = args.reason
            if args.review_id is not None:
                params["review_id"] = args.review_id
            if cmd == "rebalance":
                if args.portfolio_width is not None:
                    params["portfolio_width"] = args.portfolio_width
                out = client.rebalance(**params)
            elif cmd == "fix_offline_replicas":
                out = client.fix_offline_replicas(**params)
            else:
                fn = {"add_broker": client.add_broker,
                      "remove_broker": client.remove_broker,
                      "demote_broker": client.demote_broker}[cmd]
                dryrun = params.pop("dryrun")
                out = fn(args.brokers, dryrun=dryrun, **params)
        elif cmd == "scenarios":
            if bool(args.spec_file) == bool(args.spec):
                raise SystemExit(
                    "scenarios needs exactly one of --spec-file/--spec")
            raw = (open(args.spec_file).read() if args.spec_file
                   else args.spec)
            payload = json.loads(raw)
            if isinstance(payload, list):     # bare scenario list
                payload = {"scenarios": payload}
            params = {}
            if args.reason:
                params["reason"] = args.reason
            if args.review_id is not None:
                params["review_id"] = args.review_id
            out = client.scenarios(
                payload.get("scenarios", []),
                goals=args.goals or payload.get("goals"),
                include_base=(not args.no_base
                              and payload.get("includeBase", True)),
                verbose=args.verbose, **params)
        elif cmd == "topic_configuration":
            out = client.topic_configuration(args.topic,
                                             args.replication_factor,
                                             dryrun=not args.execute)
        elif cmd == "stop_execution":
            out = client.stop_execution(force=args.force)
        elif cmd == "pause_sampling":
            out = client.pause_sampling(args.reason)
        elif cmd == "resume_sampling":
            out = client.resume_sampling(args.reason)
        elif cmd == "admin":
            params = {}
            if args.enable_self_healing_for:
                params["enable_self_healing_for"] = \
                    args.enable_self_healing_for
            if args.disable_self_healing_for:
                params["disable_self_healing_for"] = \
                    args.disable_self_healing_for
            out = client.admin(**params)
        elif cmd == "review":
            out = client.review(args.approve, args.discard, args.reason)
        elif cmd == "traces":
            out = client.traces(trace_id=args.trace_id,
                                outcome=args.outcome, limit=args.limit,
                                verbose=args.verbose,
                                since_ms=args.since,
                                min_duration_ms=args.min_duration_ms)
        elif cmd == "metrics":
            print(client.metrics_text(), end="")
            return 0
        elif cmd == "slo":
            out = client.slo_status()
        elif cmd == "portfolio":
            out = client.portfolio_status()
        elif cmd == "loadgen":
            raise SystemExit("cccli loadgen needs the reference's loadgen/ "
                             "package, which the port does not have yet")
        else:  # pragma: no cover
            raise SystemExit(f"unhandled command {cmd}")
    except CruiseControlClientError as exc:
        print(json.dumps({"error": exc.message, "status": exc.status},
                         indent=2), file=sys.stderr)
        return 1
    print(json.dumps(out, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
