"""CLI — the gst-launch-1.0 parity surface.

    python -m nnstreamer_tpu_torch 'videotestsrc num-buffers=16 ! \
        tensor_converter ! tensor_filter model=zoo://mobilenet_v2 ! \
        tensor_decoder mode=image_labeling ! tensor_sink'
    python -m nnstreamer_tpu_torch --stats '...pipeline...'
                                            # per-element stats JSON
    python -m nnstreamer_tpu_torch trace '...pipeline...' --out t.json
                                            # traced run: report() and a
                                            #  Chrome trace (Perfetto)
    python -m nnstreamer_tpu_torch trace --merge a.json b.json --out m.json
                                            # traces onto one timeline
    python -m nnstreamer_tpu_torch models list           # store contents
    python -m nnstreamer_tpu_torch models describe NAME  # versions/stats
    python -m nnstreamer_tpu_torch models swap NAME [VER]  # hot swap
    python -m nnstreamer_tpu_torch serve --workers 2 --pipeline '...' \
        --metrics-port 0 [--slo slo.json]   # supervised worker pool
    python -m nnstreamer_tpu_torch top http://127.0.0.1:PORT/metrics

Runs the pipeline string to EOS on the CUDA device (set
NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR=cpu to run on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _trace_main(argv) -> int:
    """`trace` subcommand: run a pipeline with the tracer on, print the
    observability report, write a Chrome-trace JSON (Perfetto /
    chrome://tracing); or, with --merge, merge trace files."""
    ap = argparse.ArgumentParser(
        prog="nnstreamer_tpu_torch trace",
        description="run a pipeline traced: element report + Chrome trace")
    ap.add_argument("pipeline", nargs="+",
                    help="pipeline description string (with --merge: two "
                         "or more Chrome-trace JSON files)")
    ap.add_argument("--out", default="trace.json", metavar="FILE",
                    help="Chrome-trace JSON output path (default trace.json)")
    ap.add_argument("--merge", action="store_true",
                    help="merge already-written trace JSONs onto one "
                         "timeline (distinct process track groups) "
                         "instead of running a pipeline")
    ap.add_argument("--timeout", type=float, default=None,
                    help="max run seconds")
    ap.add_argument("--no-optimize", action="store_true",
                    help="disable transform-into-filter fusion")
    args = ap.parse_args(argv)

    if args.merge:
        from nnstreamer_tpu_torch.runtime.tracing import merge_chrome_traces

        docs = []
        for path in args.pipeline:
            with open(path) as f:
                docs.append(json.load(f))
        merged = merge_chrome_traces(
            docs, labels=[os.path.basename(p) for p in args.pipeline])
        with open(args.out, "w") as f:
            json.dump(merged, f)
        print(f"merged {len(docs)} trace(s) -> {args.out} "
              f"({len(merged['traceEvents'])} events)", file=sys.stderr)
        return 0
    if len(args.pipeline) != 1:
        print("trace takes one pipeline description (or --merge with "
              "trace files)", file=sys.stderr)
        return 2

    from nnstreamer_tpu_torch.graph.parse import parse_launch
    from nnstreamer_tpu_torch.runtime.scheduler import PipelineRunner

    pipe = parse_launch(args.pipeline[0])
    runner = PipelineRunner(pipe, optimize=not args.no_optimize, trace=True)
    interrupted = False
    try:
        runner.start()
        runner.wait(args.timeout)
    except KeyboardInterrupt:
        interrupted = True
        print("interrupted — writing partial trace", file=sys.stderr)
    finally:
        runner.stop()
    with open(args.out, "w") as f:
        json.dump(runner.tracer.to_chrome_trace(pipe.name), f)
    print(runner.report())
    print(f"chrome trace written to {args.out} "
          f"(load in Perfetto or chrome://tracing)", file=sys.stderr)
    return 130 if interrupted else 0


def _models_main(argv) -> int:
    """`models` subcommand: the model store's operator surface — list
    served names, describe one (versions, aliases, stats, swaps), trigger
    a hot swap. The store is this process's: `list` and `describe` show
    the zoo seeds (``@0``) and whatever the process registered."""
    ap = argparse.ArgumentParser(
        prog="nnstreamer_tpu_torch models",
        description="model store: list / describe NAME / swap NAME [VER]")
    sub = ap.add_subparsers(dest="cmd")
    sub.add_parser("list", help="list store models (zoo builtins seed @0)")
    p_desc = sub.add_parser("describe", help="versions, aliases, stats")
    p_desc.add_argument("name")
    p_swap = sub.add_parser("swap",
                            help="hot-swap NAME to VERSION (default latest)")
    p_swap.add_argument("name")
    p_swap.add_argument("version", nargs="?", default=None)
    p_swap.add_argument("--no-prewarm", action="store_true",
                        help="skip pre-warming attached backends (the "
                             "first post-swap invokes then meet a cold "
                             "version)")
    args = ap.parse_args(argv)

    from nnstreamer_tpu_torch.models.zoo import list_models
    from nnstreamer_tpu_torch.serving.store import get_store

    store = get_store()
    if args.cmd in (None, "list"):
        for m in sorted(set(store.names()) | set(list_models())):
            e = store.entry(m)
            cur, epoch = e.state
            print(f"store://{m}  current=@{cur} epoch={epoch} "
                  f"versions={sorted(e.versions)}")
        return 0
    if args.cmd == "describe":
        print(json.dumps(store.describe(args.name), indent=2,
                         default=float))
        return 0
    report = store.update(args.name, args.version,
                          prewarm=not args.no_prewarm)
    print(json.dumps(report, indent=2, default=float))
    return 0


#: seconds `serve` allows a worker to reach its ready handshake
SERVE_START_S = 60.0


def _serve_main(argv) -> int:
    """`serve` subcommand: run a supervised multi-process worker pool
    behind a query server until SIGTERM/SIGINT, then drain gracefully
    (serving/pool.py). Each worker runs one copy of --pipeline (a
    mid-pipeline description, e.g. 'tensor_filter framework=pallas
    model=normalize_u8 ! tensor_filter model=store://mobilenet_v2');
    without --pipeline the workers echo after --service-ms, which gives
    a known-capacity pool for drills and demos. The JAX package's flags,
    with their behaviour; the flight recorder and the mesh are refused
    until their modules are ported."""
    ap = argparse.ArgumentParser(
        prog="nnstreamer_tpu_torch serve",
        description="supervised multi-process serving pool")
    ap.add_argument("--workers", type=int, default=2,
                    help="worker processes (pipeline copies)")
    ap.add_argument("--pipeline", default=None,
                    help="mid-pipeline each worker runs between appsrc "
                         "and tensor_sink (default: echo)")
    ap.add_argument("--dims", default="8:1",
                    help="accepted input dims (HELLO contract)")
    ap.add_argument("--types", default="float32")
    ap.add_argument("--service-ms", type=float, default=5.0,
                    help="echo mode per-frame service time")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks a free port (printed at startup)")
    ap.add_argument("--id", type=int, default=0, help="server pair id")
    ap.add_argument("--max-pending", type=int, default=64)
    ap.add_argument("--max-inflight", type=int, default=0)
    ap.add_argument("--shed-policy", default="reject-newest",
                    choices=("reject-newest", "reject-oldest",
                             "deadline-drop"))
    ap.add_argument("--tenants", default=None, metavar="FILE",
                    help="tenant table JSON: weighted-fair admission per "
                         "tenant class; when classes bind models, "
                         "workers run in multiplex mode and route "
                         "tenant->model")
    ap.add_argument("--resident-models", type=int, default=0,
                    help="multiplex mode: max models holding CUDA graphs "
                         "and batch verdicts per worker (LRU release; "
                         "0 = unbounded)")
    ap.add_argument("--slo", default=None, metavar="FILE",
                    help="SLO spec JSON: runs the closed-loop autotuner "
                         "against this pool's admission queue, defending "
                         "the declared p99 budget by re-deriving "
                         "max_pending from the measured reply rate")
    ap.add_argument("--autotune-dry-run", action="store_true",
                    help="with --slo: record every decision (audit "
                         "ring, metrics, tracer) without actuating "
                         "any knob")
    ap.add_argument("--stats-every", type=float, default=0.0,
                    help="print pool stats JSON every N seconds")
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve Prometheus text exposition on "
                         "http://HOST:PORT/metrics (0 picks a free "
                         "port; also turns on the pool tracer)")
    ap.add_argument("--metrics-host", default="127.0.0.1")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write the merged multi-process Chrome trace "
                         "here at drain (also turns on the pool tracer)")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="not ported yet (Queue 1 item 4f)")
    ap.add_argument("--join", default=None, metavar="HOST:PORT",
                    help="not ported yet (Queue 1 item 4g)")
    ap.add_argument("--join-name", default=None,
                    help="not ported yet (Queue 1 item 4g)")
    ap.add_argument("--zone", default=None,
                    help="not ported yet (Queue 1 item 4g)")
    args = ap.parse_args(argv)

    if args.flight_dir is not None:
        print("serve --flight-dir: the flight recorder "
              "(runtime/flightrec.py) is not ported yet (Queue 1 item "
              "4f)", file=sys.stderr)
        return 2
    for flag, v in (("--join", args.join), ("--join-name", args.join_name),
                    ("--zone", args.zone)):
        if v is not None:
            print(f"serve {flag}: the serving mesh (serving/mesh.py) is "
                  f"not ported yet (Queue 1 item 4g)", file=sys.stderr)
            return 2

    from nnstreamer_tpu_torch.serving.pool import PooledQueryServer
    from nnstreamer_tpu_torch.serving.worker import WorkerSpec

    tracer = None
    if args.metrics_port is not None or args.trace_out:
        from nnstreamer_tpu_torch.runtime.tracing import Tracer

        tracer = Tracer()
    table = None
    if args.tenants:
        from nnstreamer_tpu_torch.serving.tenancy import TenantTable

        table = TenantTable.from_json(args.tenants)
    if table is not None and table.models():
        spec = WorkerSpec(kind="multiplex", dims=args.dims,
                          types=args.types, tenants=table.to_dict(),
                          resident_models=args.resident_models)
    elif args.pipeline:
        spec = WorkerSpec(kind="pipeline", pipeline=args.pipeline,
                          dims=args.dims, types=args.types)
    else:
        spec = WorkerSpec(kind="echo", service_ms=args.service_ms,
                          dims=args.dims, types=args.types)
    pqs = PooledQueryServer(
        spec, workers=args.workers, sid=args.id, host=args.host,
        port=args.port, max_pending=args.max_pending,
        max_inflight=args.max_inflight, shed_policy=args.shed_policy,
        tenants=table, tracer=tracer,
        # a CUDA child's start (torch, its context, the pipeline) takes
        # ~10 s on an H100 host: room for it at start and at a restart
        ready_timeout_s=SERVE_START_S, spawn_grace_s=SERVE_START_S)
    pqs.install_signal_handlers()
    tuner = None
    if args.slo:
        from nnstreamer_tpu_torch.serving.autotune import AutoTuner, SLOSpec

        def _shrink_victims(victims):
            # entries shed by a live max_pending shrink: each is owed
            # a BUSY, same contract as every other admission victim
            for v in victims:
                try:
                    pqs.qs.send_busy(v.meta.get("client_id"), v.pts,
                                     "bound_shrink")
                except Exception:
                    pass

        tuner = AutoTuner(
            SLOSpec.from_json(args.slo), admission=pqs.qs.frames,
            tracer=tracer, dry_run=args.autotune_dry_run,
            on_victims=_shrink_victims).start()
        print(f"slo autotuner active "
              f"(dry_run={bool(args.autotune_dry_run)})",
              file=sys.stderr)

    def collect():
        from nnstreamer_tpu_torch.serving.metrics import metrics_snapshot

        s = pqs.stats()
        return metrics_snapshot(
            tracer=tracer, admission=s.pop("admission"), pool=s,
            autotune=tuner.stats() if tuner is not None else None,
            devprof=None)

    msrv = None
    if args.metrics_port is not None:
        from nnstreamer_tpu_torch.serving.metrics import MetricsServer

        msrv = MetricsServer(collect, host=args.metrics_host,
                             port=args.metrics_port,
                             health=lambda: {"pool": pqs.stats()["pool"]})
        print(f"metrics on http://{args.metrics_host}:{msrv.port}"
              f"/metrics", file=sys.stderr)
    print(f"pool serving on {args.host}:{pqs.port} "
          f"({args.workers} worker(s); SIGTERM/^C drains)",
          file=sys.stderr, flush=True)
    last_stats = time.monotonic()
    try:
        while not pqs.pool.closed:
            time.sleep(0.2)
            if args.stats_every and \
                    time.monotonic() - last_stats >= args.stats_every:
                last_stats = time.monotonic()
                print(json.dumps(pqs.stats(), default=float),
                      file=sys.stderr)
    except KeyboardInterrupt:
        pass
    finally:
        if tuner is not None:
            tuner.stop()
        pqs.close()
        if msrv is not None:
            msrv.close()
        if args.trace_out and tracer is not None:
            with open(args.trace_out, "w") as f:
                json.dump(tracer.to_chrome_trace("serve"), f)
            print(f"chrome trace written to {args.trace_out}",
                  file=sys.stderr)
    return 0


def _top_main(argv) -> int:
    """`top` subcommand: live terminal view over any /metrics
    exposition endpoint (serving/metrics.py) — counters as rates,
    gauges as current values, refreshed in place."""
    ap = argparse.ArgumentParser(
        prog="nnstreamer_tpu_torch top",
        description="live terminal view over a /metrics endpoint")
    ap.add_argument("url", nargs="?", default=None,
                    help="endpoint URL (or use --port for localhost)")
    ap.add_argument("--port", type=int, default=None,
                    help="shorthand for http://127.0.0.1:PORT/metrics")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="refresh seconds")
    ap.add_argument("--iterations", type=int, default=0,
                    help="stop after N refreshes (0 = until ^C)")
    args = ap.parse_args(argv)

    url = args.url
    if url is None and args.port is not None:
        url = f"http://127.0.0.1:{args.port}/metrics"
    if url is None:
        print("top needs a URL or --port", file=sys.stderr)
        return 2

    from nnstreamer_tpu_torch.serving.metrics import top_view

    try:
        top_view(url, interval_s=args.interval,
                 iterations=args.iterations)
    except KeyboardInterrupt:
        pass
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "trace":
        return _trace_main(argv[1:])
    if argv and argv[0] == "models":
        return _models_main(argv[1:])
    if argv and argv[0] == "serve":
        return _serve_main(argv[1:])
    if argv and argv[0] == "top":
        return _top_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="nnstreamer_tpu_torch",
        description="streaming AI pipelines on PyTorch/CUDA (gst-launch parity)")
    ap.add_argument("pipeline", help="pipeline description string")
    ap.add_argument("--timeout", type=float, default=None,
                    help="max run seconds")
    ap.add_argument("--stats", action="store_true",
                    help="print per-element stats JSON after EOS")
    ap.add_argument("--no-optimize", action="store_true",
                    help="disable transform-into-filter fusion")
    args = ap.parse_args(argv)

    from nnstreamer_tpu_torch.graph.parse import parse_launch
    from nnstreamer_tpu_torch.runtime.scheduler import PipelineRunner

    runner = PipelineRunner(parse_launch(args.pipeline),
                            optimize=not args.no_optimize)
    try:
        runner.run(args.timeout)
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    if args.stats:
        print(json.dumps(runner.stats(), indent=2, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
