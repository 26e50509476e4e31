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
        --metrics-port 0 [--slo slo.json] [--flight-dir DIR]
                                            # supervised worker pool
    python -m nnstreamer_tpu_torch top http://127.0.0.1:PORT/metrics
    python -m nnstreamer_tpu_torch flight DIR [--inspect NAME] [--json]
                                            # flight-recorder bundles
    python -m nnstreamer_tpu_torch llm --requests 8
                                            # continuous-batching LLM
                                            #  serving demo (tensor_llm;
                                            #  NNS_PAGED_KERNEL=pallas for
                                            #  the paged CUDA kernels)
    python -m nnstreamer_tpu_torch mesh --listen
                                            # multi-host router (pools
                                            #  join with serve --join)
    python -m nnstreamer_tpu_torch mesh --hosts 2
                                            # partition-chaos demo + SLO
                                            #  report
    python -m nnstreamer_tpu_torch serve --join HOST:PORT [--zone Z]
                                            # a pool joins a mesh router
    python -m nnstreamer_tpu_torch traffic [--workers N] [--tenants N] \
        [--autotune] [--host H --port P --dims D --types T --rate R]
                                            # open-loop SLO harness
    python -m nnstreamer_tpu_torch scenario run|replay|shrink|list
                                            # seeded adversarial drills

    python -m nnstreamer_tpu_torch lint [--json]  # project static
                                            #  analysis (nnlint)
    python -m nnstreamer_tpu_torch --inspect [ELEMENT]  # elements /
                                            #  element detail
    python -m nnstreamer_tpu_torch --models  # list zoo models
    python -m nnstreamer_tpu_torch --profile DIR '...pipeline...'
                                            # torch.profiler Chrome trace
    python -m nnstreamer_tpu_torch --broker [PORT] [--bind ADDR]
                                            # standalone EdgeBroker

Runs the pipeline string to EOS on the CUDA device (set
NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR=cpu to run on the CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def _inspect(name: str | None) -> int:
    """`--inspect [ELEMENT]`: the registry's elements and decoder modes,
    or one element's doc and properties (gst-inspect-1.0 parity)."""
    import nnstreamer_tpu_torch.elements  # noqa: F401 (register built-ins)
    from nnstreamer_tpu_torch.core.registry import PluginKind, registry

    if not name:
        print("elements:")
        for n in sorted(registry.names(PluginKind.ELEMENT)):
            cls = registry.get(PluginKind.ELEMENT, n)
            doc = (cls.__doc__ or "").strip().splitlines()
            print(f"  {n:24s} {doc[0] if doc else ''}")
        print("\ndecoder modes:")
        import nnstreamer_tpu_torch.decoders  # noqa: F401

        for n in sorted(registry.names(PluginKind.DECODER)):
            print(f"  {n}")
        return 0
    cls = registry.get(PluginKind.ELEMENT, name)
    print(f"element {name} ({cls.__name__})")
    if cls.__doc__:
        print(cls.__doc__)
    print("properties:")
    for prop, pd in cls.PROPS.items():
        print(f"  {prop.replace('_', '-'):24s} default={pd.default!r}  {pd.doc}")
    return 0


def _models() -> int:
    """`--models`: the zoo's builtin model names."""
    from nnstreamer_tpu_torch.models.zoo import list_models

    for m in list_models():
        print(f"zoo://{m}")
    return 0


def _broker(bind: str, port: int) -> int:
    """`--broker [PORT]`: a standalone EdgeBroker (discovery, pub/sub,
    the clock service, MQTT 3.1.1 on a second port) until SIGINT."""
    from nnstreamer_tpu_torch.edge.broker import EdgeBroker

    broker = EdgeBroker(bind, port)
    print(f"edge broker listening on {bind}:{broker.port} "
          f"(mqtt 3.1.1 on :{broker.mqtt_port}; ^C to stop)",
          file=sys.stderr, flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        broker.close()
        return 0


@contextlib.contextmanager
def _profile(out_dir):
    """`--profile DIR` around a run: a torch.profiler capture (CPU ops,
    plus CUDA kernels when CUDA is available) written as a Chrome trace
    JSON into DIR, which stderr names. The JAX package writes an xprof
    trace there instead (ROADMAP N43). No DIR, no capture."""
    if not out_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"device trace written to {path} (Chrome trace: open in "
          f"Perfetto or chrome://tracing)", file=sys.stderr)


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


def _llm_main(argv) -> int:
    """`llm` subcommand: push N synthetic prompts through an
    appsrc → tensor_llm → tensor_sink pipeline and stream tokens as
    they arrive — the smallest end-to-end serving loop. Runs on the CUDA
    device (NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR=cpu for the CPU);
    NNS_PAGED_KERNEL=pallas serves through the hand-written paged
    attention kernels, as it does for any tensor_llm."""
    ap = argparse.ArgumentParser(
        prog="nnstreamer_tpu_torch llm",
        description="continuous-batching LLM serving demo (tensor_llm)")
    ap.add_argument("--model", default="store://transformer",
                    help="store:// ref or zoo name")
    ap.add_argument("--requests", type=int, default=8,
                    help="synthetic prompts to serve")
    ap.add_argument("--max-new-tokens", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--scheduling", default="continuous",
                    choices=("continuous", "static"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stats", action="store_true",
                    help="print engine stats JSON at the end")
    args = ap.parse_args(argv)

    import numpy as np

    from nnstreamer_tpu_torch.elements import AppSrc, TensorLLM, TensorSink
    from nnstreamer_tpu_torch.graph.pipeline import Pipeline
    from nnstreamer_tpu_torch.runtime.scheduler import PipelineRunner
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
    from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorsSpec

    src = AppSrc(name="src", spec=TensorsSpec(
        tensors=(), format=TensorFormat.FLEXIBLE))
    llm = TensorLLM(
        name="llm", model=args.model, max_batch=args.max_batch,
        num_blocks=args.num_blocks, block_size=args.block_size,
        max_len=args.max_len, max_new_tokens=args.max_new_tokens,
        temperature=args.temperature, scheduling=args.scheduling)

    def on_chunk(buf):
        m = buf.meta["llm"]
        toks = " ".join(str(int(t)) for t in np.asarray(buf.tensors[0]))
        tail = ""
        if m["done"]:
            ft = m.get("first_token_ms")
            tail = (f"   [done: {m['n_tokens']} tokens, "
                    f"first token {ft:.1f} ms]" if ft is not None
                    else "   [done]")
        print(f"{m['request_id']:>8s}  {toks}{tail}")

    sink = TensorSink(name="sink", new_data=on_chunk)
    pipe = Pipeline()
    for e in (src, llm, sink):
        pipe.add(e)
    pipe.link(src, llm)
    pipe.link(llm, sink)
    runner = PipelineRunner(pipe)
    runner.start()
    rng = np.random.default_rng(args.seed)
    vocab = 256
    try:
        for i in range(args.requests):
            plen = int(rng.integers(1, 17))
            prompt = rng.integers(0, vocab, size=plen).astype(np.int32)
            src.push(TensorBuffer(
                tensors=(prompt,), pts=i,
                meta={"llm": {"request_id": f"req{i}",
                              "seed": int(args.seed) + i}}))
        src.end()
        runner.wait(None)
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    finally:
        runner.stop()
    if args.stats:
        print(json.dumps(llm.extra_stats(), indent=2, default=float))
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
    with their behaviour: --join registers the pool as a host of a mesh
    router (serving/mesh.py) and the agent stops at the drain."""
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
                    help="arm the SLO-breach flight recorder: forensic "
                         "bundles dumped into DIR on SLO breach / "
                         "conservation mismatch / worker fence / "
                         "watchdog (also turns on the pool tracer and "
                         "the device profiler)")
    ap.add_argument("--join", default=None, metavar="HOST:PORT",
                    help="register this pool as a host of a mesh "
                         "router (python -m nnstreamer_tpu_torch mesh "
                         "--listen); the pool keeps serving its own "
                         "port too")
    ap.add_argument("--join-name", default=None,
                    help="host name advertised to the router "
                         "(default host:port of this pool)")
    ap.add_argument("--zone", default="",
                    help="locality zone advertised to the router")
    args = ap.parse_args(argv)

    from nnstreamer_tpu_torch.serving.pool import PooledQueryServer
    from nnstreamer_tpu_torch.serving.worker import WorkerSpec

    tracer = None
    if args.metrics_port is not None or args.trace_out or args.flight_dir:
        from nnstreamer_tpu_torch.runtime.tracing import Tracer

        tracer = Tracer()
    prof = None
    if args.metrics_port is not None or args.flight_dir:
        from nnstreamer_tpu_torch.runtime import devprof

        prof = devprof.get().enable()
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
            devprof=prof.stats() if prof is not None else None)

    msrv = None
    if args.metrics_port is not None:
        from nnstreamer_tpu_torch.serving.metrics import MetricsServer

        msrv = MetricsServer(collect, host=args.metrics_host,
                             port=args.metrics_port,
                             health=lambda: {"pool": pqs.stats()["pool"]})
        print(f"metrics on http://{args.metrics_host}:{msrv.port}"
              f"/metrics", file=sys.stderr)
    flight = None
    if args.flight_dir:
        from nnstreamer_tpu_torch.runtime.flightrec import FlightRecorder
        from nnstreamer_tpu_torch.serving.metrics import render_prometheus

        def _flight_env():
            return {"cmd": "serve", "argv": list(argv),
                    "workers": args.workers, "port": pqs.port,
                    "devprof": prof.stats() if prof is not None else None}

        flight = FlightRecorder(args.flight_dir).attach(
            tracer=tracer, autotune=tuner,
            prom=lambda: render_prometheus(collect()),
            env=_flight_env)
        flight.run_background(
            lambda: {"admission": pqs.stats().get("admission")})
        print(f"flight recorder armed -> {args.flight_dir}",
              file=sys.stderr)
    agent = None
    if args.join:
        from nnstreamer_tpu_torch.serving.mesh import pool_join

        rhost, _, rport = args.join.rpartition(":")
        agent = pool_join(
            pqs, rhost or "127.0.0.1", int(rport),
            name=args.join_name or f"{args.host}:{pqs.port}",
            zone=args.zone)
        print(f"joined mesh router {args.join} as "
              f"{agent.name!r}", file=sys.stderr, flush=True)
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
        if flight is not None:
            flight.close()
        if agent is not None:
            agent.stop()
        pqs.close()
        if msrv is not None:
            msrv.close()
        if args.trace_out and tracer is not None:
            with open(args.trace_out, "w") as f:
                json.dump(tracer.to_chrome_trace("serve"), f)
            print(f"chrome trace written to {args.trace_out}",
                  file=sys.stderr)
    return 0


def _mesh_main(argv) -> int:
    """`mesh` subcommand. Two modes:

    --listen: run a MeshRouter until ^C or SIGTERM — clients dial it
    like any query server; pools join with `serve --join HOST:PORT`.

    default (demo): the chaos drill — spin up N local pool hosts (echo
    workers) behind one router, flood it open-loop above aggregate
    capacity while one host is blackholed mid-flood, and print the SLO
    + conservation report. Exit 0 iff nothing was lost and the per-host
    counters conserve."""
    ap = argparse.ArgumentParser(
        prog="nnstreamer_tpu_torch mesh",
        description="multi-host serving mesh: router (--listen) or "
                    "partition-chaos demo")
    ap.add_argument("--listen", action="store_true",
                    help="run a router until ^C instead of the demo")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="router port (0 picks a free one, printed)")
    ap.add_argument("--id", type=int, default=0, help="server pair id")
    ap.add_argument("--dims", default="8:1",
                    help="accepted input dims (HELLO contract)")
    ap.add_argument("--types", default="float32")
    ap.add_argument("--max-pending", type=int, default=64)
    ap.add_argument("--shed-policy", default="reject-newest",
                    choices=("reject-newest", "reject-oldest",
                             "deadline-drop"))
    ap.add_argument("--lease-s", type=float, default=2.0,
                    help="host lease: silent for this long => fenced")
    ap.add_argument("--max-redeliver", type=int, default=1,
                    help="cross-host re-offers per frame after a fence")
    ap.add_argument("--zone", default="",
                    help="router zone (locality-aware routing)")
    ap.add_argument("--stats-every", type=float, default=0.0,
                    help="--listen: print router stats JSON every N s")
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="--listen: Prometheus exposition with per-host "
                         "series on http://HOST:PORT/metrics")
    # demo mode
    ap.add_argument("--hosts", type=int, default=2,
                    help="demo: local pool hosts to spin up")
    ap.add_argument("--workers-per-host", type=int, default=1)
    ap.add_argument("--pattern", default="poisson",
                    choices=("poisson", "bursty"))
    ap.add_argument("--load-x", type=float, default=1.5,
                    help="demo: offered load vs aggregate capacity")
    ap.add_argument("--requests", type=int, default=300)
    ap.add_argument("--service-ms", type=float, default=20.0)
    ap.add_argument("--blackhole-at", type=float, default=None,
                    help="demo: partition one host at t seconds "
                         "(default: the median arrival)")
    ap.add_argument("--heal-after", type=float, default=None,
                    help="demo: heal the partition after N more "
                         "seconds and wait for the host to rejoin")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget-ms", type=float, default=250.0)
    ap.add_argument("--json", action="store_true",
                    help="print the raw report JSON only")
    args = ap.parse_args(argv)

    if args.listen:
        import signal

        from nnstreamer_tpu_torch.serving.mesh import MeshRouter

        router = MeshRouter(
            host=args.host, port=args.port, sid=args.id,
            dims=args.dims, types=args.types,
            max_pending=args.max_pending, shed_policy=args.shed_policy,
            lease_s=args.lease_s, max_redeliver=args.max_redeliver,
            zone=args.zone)
        msrv = None
        if args.metrics_port is not None:
            from nnstreamer_tpu_torch.serving.metrics import (
                MetricsServer, metrics_snapshot)

            def collect():
                s = router.stats()
                return metrics_snapshot(admission=s.get("admission"),
                                        mesh=s)

            msrv = MetricsServer(collect, host=args.host,
                                 port=args.metrics_port,
                                 health=lambda: router.stats()["mesh"])
            print(f"metrics on http://{args.host}:{msrv.port}/metrics",
                  file=sys.stderr)
        stop = []
        prev = signal.signal(signal.SIGTERM,
                             lambda signum, frame: stop.append(signum))
        print(f"mesh router on {args.host}:{router.port} "
              f"(lease {args.lease_s}s; join pools with: python -m "
              f"nnstreamer_tpu_torch serve --join {args.host}:"
              f"{router.port}; ^C or SIGTERM stops)", file=sys.stderr,
              flush=True)
        last = time.monotonic()
        try:
            while not stop:
                time.sleep(0.2)
                if args.stats_every and \
                        time.monotonic() - last >= args.stats_every:
                    last = time.monotonic()
                    print(json.dumps(router.stats(), default=float),
                          file=sys.stderr)
        except KeyboardInterrupt:
            pass
        finally:
            signal.signal(signal.SIGTERM, prev)
            router.close()
            if msrv is not None:
                msrv.close()
        return 0

    from nnstreamer_tpu_torch.traffic import run_against_mesh

    report = run_against_mesh(
        hosts=args.hosts, workers_per_host=args.workers_per_host,
        pattern=args.pattern, load_x=args.load_x, n=args.requests,
        service_ms=args.service_ms, max_pending=args.max_pending,
        p99_budget_ms=args.budget_ms, seed=args.seed,
        lease_s=args.lease_s, max_redeliver=args.max_redeliver,
        blackhole_at_s=args.blackhole_at, heal_after_s=args.heal_after)
    if args.json:
        print(json.dumps(report, default=float))
    else:
        report.pop("queue_depth_timeline", None)
        print(json.dumps(report, indent=2, default=float))
        ex = (report.get("redelivered_examples") or [None])[0]
        if ex:
            print(f"cross-host redelivery: pts={ex['pts']} "
                  f"trace={ex['trace_id']} hosts={ex['hosts']}",
                  file=sys.stderr)
    ok = report.get("lost", 1) == 0 and report.get("conserved", False)
    return 0 if ok else 1


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


def _traffic_main(argv) -> int:
    """`traffic` subcommand: open-loop load against a bounded query
    server (a self-contained echo server by default, or --host/--port
    for a live one) and print the latency-SLO report."""
    ap = argparse.ArgumentParser(
        prog="nnstreamer_tpu_torch traffic",
        description="open-loop traffic harness: Poisson/bursty load, "
                    "admission-control SLO report")
    ap.add_argument("--pattern", default="poisson",
                    choices=("poisson", "bursty"))
    ap.add_argument("--load-x", type=float, default=2.0,
                    help="offered load as a multiple of server capacity "
                         "(self-contained mode; default 2.0)")
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--service-ms", type=float, default=5.0,
                    help="echo server's per-frame service time")
    ap.add_argument("--max-pending", type=int, default=16,
                    help="server admission queue bound")
    ap.add_argument("--max-inflight", type=int, default=0)
    ap.add_argument("--shed-policy", default="reject-newest",
                    choices=("reject-newest", "reject-oldest",
                             "deadline-drop"))
    ap.add_argument("--budget-ms", type=float, default=None,
                    help="p99 latency budget for goodput (default: a "
                         "full queue's wait + one service time)")
    ap.add_argument("--host", default=None,
                    help="attack a LIVE server instead (with --port, "
                         "--dims; --rate becomes absolute rps)")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--dims", default="8:1")
    ap.add_argument("--types", default="float32")
    ap.add_argument("--rate", type=float, default=100.0,
                    help="absolute offered rps in --host mode")
    ap.add_argument("--seed", type=int, default=0,
                    help="rng seed for the arrival process AND the "
                         "chaos-kill schedule (reproducible runs; the "
                         "report records it)")
    ap.add_argument("--workers", type=int, default=0,
                    help="serve from a supervised worker POOL of N "
                         "processes instead of the in-process echo "
                         "server (enables --kill-at chaos mode)")
    ap.add_argument("--kill-at", type=float, default=None,
                    help="SIGKILL one rng-chosen pool worker at t "
                         "seconds into the send window (default: the "
                         "median arrival; needs --workers)")
    ap.add_argument("--kills", type=int, default=1,
                    help="number of staggered worker kills (--workers)")
    ap.add_argument("--tenants", type=int, default=0, metavar="N",
                    help="multi-tenant mode: N equal-weight tenant "
                         "classes behind a weighted-fair admission "
                         "front over a worker pool; tenant t0 floods "
                         "at --flood x its fair share, the others "
                         "offer 0.5x theirs; report gains per-tenant "
                         "groups + per-class conservation")
    ap.add_argument("--flood", type=float, default=3.0, metavar="K",
                    help="flooding tenant's offered load as a "
                         "multiple of its fair share (--tenants)")
    ap.add_argument("--autotune", action="store_true",
                    help="SLO-autotuner drill: open-loop ramp "
                         "0.5→2.5x capacity against a deliberately "
                         "mis-set bounded server, closed-loop tuned "
                         "vs the same static config on the same trace")
    ap.add_argument("--autotune-dry-run", action="store_true",
                    help="with --autotune: the controller records "
                         "every decision without actuating any knob")
    ap.add_argument("--json", action="store_true",
                    help="print the raw report JSON only")
    ap.add_argument("--trace", action="store_true",
                    help="give every request a trace context and print "
                         "the per-hop latency decomposition of the "
                         "worst-p99 request")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="with --workers: run the pool traced and "
                         "write the merged multi-process Chrome trace "
                         "here (implies --trace)")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="post-run forensic scan: if the drill "
                         "breached its p99 budget or broke admission "
                         "conservation, dump a flight bundle into DIR")
    args = ap.parse_args(argv)

    import numpy as np

    from nnstreamer_tpu_torch.traffic import (
        bursty_arrivals, poisson_arrivals, run_against_echo,
        run_against_pool, run_open_loop)

    if args.trace_out:
        args.trace = True
    if args.autotune:
        from nnstreamer_tpu_torch.traffic import run_autotune_ramp

        kw = dict(n_per_step=max(20, args.requests // 5),
                  service_ms=args.service_ms,
                  p99_budget_ms=args.budget_ms, seed=args.seed)
        static = run_autotune_ramp(tuned=False, **kw)
        tuned = run_autotune_ramp(
            tuned=True, dry_run=args.autotune_dry_run, **kw)
        report = {"static": static, "tuned": tuned,
                  "goodput_gain_rps": round(
                      tuned["goodput_rps"] - static["goodput_rps"], 2)}
        if args.json:
            print(json.dumps(report, default=float))
        else:
            for r in (static, tuned):
                r.pop("queue_depth_timeline", None)
            print(json.dumps(report, indent=2, default=float))
        ok = (static["lost"] == 0 and tuned["lost"] == 0
              and tuned["conservation_final"]
              and all(tuned.get("conservation_after_apply") or [True]))
        return 0 if ok else 1
    if args.tenants > 0:
        from nnstreamer_tpu_torch.traffic import run_multitenant

        if args.tenants < 2:
            print("--tenants needs N >= 2", file=sys.stderr)
            return 2
        workers = args.workers or 2
        capacity = workers * 1e3 / args.service_ms
        fair = capacity / args.tenants
        names = [f"t{k}" for k in range(args.tenants)]
        budget = args.budget_ms or \
            (args.max_pending + 2) * args.service_ms
        rate_hz = {nm: (args.flood if k == 0 else 0.5) * fair
                   for k, nm in enumerate(names)}
        per = max(1, args.requests // args.tenants)
        n_per = {nm: max(1, int(round(per * rate_hz[nm] / fair)))
                 for nm in names}
        report = run_multitenant(
            tenants={nm: {"weight": 1.0, "deadline_ms": budget}
                     for nm in names},
            n_per_tenant=n_per, rate_hz=rate_hz,
            workers=workers, service_ms=args.service_ms,
            max_pending=args.max_pending,
            shed_policy=args.shed_policy
            if args.shed_policy != "reject-newest" else "reject-oldest",
            p99_budget_ms=budget, seed=args.seed)
        if args.json:
            print(json.dumps(report, default=float))
        else:
            report.pop("queue_depth_timeline", None)
            print(json.dumps(report, indent=2, default=float))
        ok = report["lost"] == 0 and report["conserved"]
        return 0 if ok else 1
    if args.workers > 0:
        tracer = None
        pool_kw = {}
        if args.trace_out:
            from nnstreamer_tpu_torch.runtime.tracing import Tracer

            tracer = Tracer()
            pool_kw["tracer"] = tracer
        report = run_against_pool(
            pattern=args.pattern, load_x=args.load_x, n=args.requests,
            service_ms=args.service_ms, workers=args.workers,
            max_pending=args.max_pending, max_inflight=args.max_inflight,
            shed_policy=args.shed_policy,
            p99_budget_ms=args.budget_ms or 90.0, seed=args.seed,
            kill_at_s=args.kill_at, kills=args.kills,
            trace=args.trace, **pool_kw)
        if tracer is not None:
            with open(args.trace_out, "w") as f:
                json.dump(tracer.to_chrome_trace("traffic"), f)
            print(f"chrome trace written to {args.trace_out} "
                  f"(load in Perfetto or chrome://tracing)",
                  file=sys.stderr)
    elif args.host is not None:
        if args.port is None:
            print("--host needs --port", file=sys.stderr)
            return 2
        from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
        from nnstreamer_tpu_torch.tensor.info import TensorsSpec

        rng = np.random.default_rng(args.seed)
        if args.pattern == "poisson":
            arrivals = poisson_arrivals(args.rate, args.requests, rng)
        else:
            arrivals = bursty_arrivals(
                args.requests, rate_high_hz=2 * args.rate,
                rate_low_hz=max(args.rate / 4, 0.5), rng=rng)
        spec = TensorsSpec.from_strings(args.dims, args.types)
        x = np.zeros(spec.tensors[0].shape, spec.tensors[0].dtype.np_dtype)
        report = run_open_loop(
            args.host, args.port, dims=args.dims, types=args.types,
            arrivals=arrivals,
            make_frame=lambda i: TensorBuffer.of(x, pts=i),
            p99_budget_ms=args.budget_ms or 250.0, trace=args.trace)
        report["seed"] = args.seed
    else:
        report = run_against_echo(
            pattern=args.pattern, load_x=args.load_x, n=args.requests,
            service_ms=args.service_ms, max_pending=args.max_pending,
            max_inflight=args.max_inflight, shed_policy=args.shed_policy,
            p99_budget_ms=args.budget_ms, seed=args.seed,
            trace=args.trace)
    if args.flight_dir:
        from nnstreamer_tpu_torch.runtime.flightrec import FlightRecorder

        rec = FlightRecorder(args.flight_dir)
        rec.attach(env=lambda: {"cmd": "traffic", "report": report})
        rec.tick({"report_summary": {
            k: report.get(k) for k in ("goodput_rps", "lost",
                                       "conserved", "p99_budget_ms")}})
        lat = report.get("latency_ms") or {}
        sig = {"p99_ms": lat.get("p99"),
               "p99_budget_ms": report.get("p99_budget_ms"),
               "admission": report.get("admission")}
        # two scans: the conservation predicate needs two consecutive
        # mismatched reads before it trusts a final, settled ledger
        fired = rec.scan(**sig)
        fired += [k for k in rec.scan(**sig) if k not in fired]
        for kind in fired:
            print(f"flight bundle dumped ({kind}) -> {args.flight_dir}",
                  file=sys.stderr)
    if args.json:
        print(json.dumps(report, default=float))
        return 0
    tl = report.pop("queue_depth_timeline", None)
    print(json.dumps(report, indent=2, default=float))
    hb = report.get("hop_breakdown")
    if hb:
        spans = hb.get("spans", {})
        stages = [(k.replace("_ms", "").replace("_", " "), spans[k])
                  for k in ("admission_wait_ms", "route_ms",
                            "worker_queue_ms", "service_ms", "reply_ms")
                  if spans.get(k) is not None]
        parts = " + ".join(f"{name} {v:.2f}ms" for name, v in stages)
        print(f"worst-p99 request (pts={hb['pts']}, "
              f"trace={hb.get('trace_id')}): {hb['latency_ms']:.2f}ms"
              + (f" = {parts}" if parts else "")
              + (f" (+{spans['retries']} retry)"
                 if spans.get("retries") else "")
              + (f" (+{spans['redeliveries']} redelivery)"
                 if spans.get("redeliveries") else ""),
              file=sys.stderr)
    if tl:
        # crude depth-over-time sparkline so overload is visible at a
        # glance without loading the JSON anywhere
        peak = max(d for _, d in tl) or 1
        blocks = " ▁▂▃▄▅▆▇█"
        line = "".join(blocks[min(8, round(8 * d / peak))] for _, d in tl)
        print(f"queue depth (peak {peak}): |{line}|", file=sys.stderr)
    lost = report.get("lost", 0)
    return 0 if lost == 0 else 1



def _flight_main(argv) -> int:
    """`flight` subcommand: list / inspect the forensic bundles a flight
    recorder (runtime/flightrec.py) dumped into a directory."""
    ap = argparse.ArgumentParser(
        prog="nnstreamer_tpu_torch flight",
        description="inspect SLO-breach flight-recorder bundles")
    ap.add_argument("dir", help="flight directory (serve --flight-dir)")
    ap.add_argument("--inspect", default=None, metavar="NAME",
                    help="print one bundle's parsed artifacts "
                         "(bundle dir name, e.g. flight-0001-slo_breach)")
    ap.add_argument("--json", action="store_true",
                    help="print raw JSON instead of the table")
    args = ap.parse_args(argv)

    from nnstreamer_tpu_torch.runtime.flightrec import (
        list_bundles, load_bundle)

    if args.inspect:
        bundle = load_bundle(os.path.join(args.dir, args.inspect))
        # scenario_violation bundles carry the failing spec in the
        # cause — surface the repro recipe before the raw dump
        cause = (bundle.get("cause") or {}).get("cause") or {}
        spec = cause.get("scenario_spec")
        if spec and not args.json:
            print(f"scenario {cause.get('scenario')!r} "
                  f"seed={cause.get('seed')} — "
                  f"{len(cause.get('violations') or [])} violation(s); "
                  f"replay: python -m nnstreamer_tpu_torch scenario run "
                  f"SPEC.json (spec below in cause.scenario_spec)",
                  file=sys.stderr)
        print(json.dumps(bundle, indent=None if args.json else 2,
                         default=str))
        return 0
    bundles = list_bundles(args.dir)
    if args.json:
        print(json.dumps(bundles, default=str))
        return 0
    if not bundles:
        print(f"no flight bundles in {args.dir}", file=sys.stderr)
        return 1
    print(f"{'bundle':<36} {'kind':<16} {'when':<20} cause")
    print("-" * 100)
    for b in bundles:
        when = time.strftime("%Y-%m-%d %H:%M:%S",
                             time.localtime(b.get("wall_time") or 0))
        cause = json.dumps(b.get("cause") or {}, default=str)
        if len(cause) > 40:
            cause = cause[:37] + "..."
        print(f"{b['name']:<36} {str(b.get('kind')):<16} {when:<20} "
              f"{cause}")
    return 0


def _scenario_load(ref: str, seed=None):
    """Resolve `ref` to a ScenarioSpec: a builtin catalog name, a spec
    JSON file, or a saved `scenario run` result JSON (spec embedded)."""
    from nnstreamer_tpu_torch.scenario import ScenarioSpec, builtin_specs

    specs = builtin_specs()
    if ref in specs:
        spec = specs[ref]
    else:
        with open(ref, "r", encoding="utf-8") as f:
            d = json.load(f)
        if isinstance(d.get("spec"), dict):   # a saved result
            d = d["spec"]
        spec = ScenarioSpec.from_dict(d)
    if seed is not None:
        import dataclasses

        spec = dataclasses.replace(spec, seed=int(seed))
    return spec


def _scenario_emit(result: dict, out, full: bool) -> None:
    """Print a result (stdout or --out FILE); per-reply trace contexts
    are dropped unless --full — they dwarf the ledger."""
    slim = dict(result)
    if not full and isinstance(slim.get("report"), dict):
        slim["report"] = {k: v for k, v in slim["report"].items()
                          if k != "traces"}
    text = json.dumps(slim, indent=2, default=str)
    if out:
        with open(out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    else:
        print(text)


def _scenario_main(argv) -> int:
    """`scenario` subcommand: run / replay / shrink / list seeded
    adversarial world drills."""
    ap = argparse.ArgumentParser(
        prog="nnstreamer_tpu_torch scenario",
        description="composable seeded scenario drills: declarative "
                    "arrival+fault programs against a real worker pool "
                    "or mesh, one property checker, deterministic "
                    "replay and shrinking")
    sub = ap.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser("run", help="run a scenario; exit 0 iff all "
                                      "invariants hold")
    runp.add_argument("spec", help="builtin name (see `scenario list`) "
                                   "or spec/result JSON file")
    runp.add_argument("--seed", type=int, default=None,
                      help="override the root seed")
    runp.add_argument("--flight-dir", default=None, metavar="DIR",
                      help="dump a flight bundle here on violation")
    runp.add_argument("--out", default=None, metavar="FILE",
                      help="write the result JSON here (else stdout)")
    runp.add_argument("--full", action="store_true",
                      help="keep per-reply trace contexts in the JSON")
    rep = sub.add_parser("replay", help="re-run a saved result's spec "
                                        "under the same seed and demand "
                                        "bit-equal ledger totals")
    rep.add_argument("result", help="result JSON from `scenario run`")
    rep.add_argument("--out", default=None, metavar="FILE")
    rep.add_argument("--full", action="store_true")
    shr = sub.add_parser("shrink", help="ddmin a failing scenario to a "
                                        "minimal still-failing repro")
    shr.add_argument("spec", help="builtin name or spec/result JSON")
    shr.add_argument("--max-runs", type=int, default=40,
                     help="live-run budget for the search (default 40)")
    shr.add_argument("--out", default=None, metavar="FILE",
                     help="write the minimal spec JSON here")
    sub.add_parser("list", help="list the builtin drill catalog")
    args = ap.parse_args(argv)

    from nnstreamer_tpu_torch.scenario import builtin_specs

    if args.cmd == "list":
        print(f"{'name':<16} {'topology':<22} {'arrivals':<9} "
              f"{'faults':<7} size")
        print("-" * 62)
        for name, s in builtin_specs().items():
            topo = (f"{s.topology.kind}"
                    f"({s.topology.hosts}x{s.topology.workers}w)")
            print(f"{name:<16} {topo:<22} {len(s.arrivals):<9} "
                  f"{len(s.faults):<7} {s.size()}")
        return 0

    from nnstreamer_tpu_torch.scenario import run_scenario

    if args.cmd == "run":
        spec = _scenario_load(args.spec, args.seed)
        result = run_scenario(spec, flight_dir=args.flight_dir)
        check = result.get("check") or {}
        _scenario_emit(result, args.out, args.full)
        for v in check.get("violations") or []:
            print(f"VIOLATION [{v['invariant']}] {v['detail']}",
                  file=sys.stderr)
        print(f"scenario {spec.name!r} seed={spec.seed}: "
              f"{result['totals']} "
              f"{'OK' if check.get('ok') else 'FAIL'}",
              file=sys.stderr)
        return 0 if check.get("ok") else 1

    if args.cmd == "replay":
        from nnstreamer_tpu_torch.scenario import replay_scenario

        with open(args.result, "r", encoding="utf-8") as f:
            prev = json.load(f)
        result = replay_scenario(prev)
        _scenario_emit(result, args.out, args.full)
        match = result.get("replay_match")
        ok = bool((result.get("check") or {}).get("ok"))
        if match is False:
            print(f"replay DIVERGED: {result.get('replay_diff')}",
                  file=sys.stderr)
        else:
            print(f"replay totals match: {result['totals']}",
                  file=sys.stderr)
        return 0 if (match is not False and ok) else 1

    # shrink
    from nnstreamer_tpu_torch.scenario import ShrinkBudgetExceeded, shrink

    spec = _scenario_load(args.spec)

    def fails(candidate) -> bool:
        r = run_scenario(candidate)
        return not (r.get("check") or {}).get("ok", False)

    try:
        minimal, stats = shrink(spec, fails, max_runs=args.max_runs)
    except ValueError as e:
        print(f"shrink: {e}", file=sys.stderr)
        return 1
    except ShrinkBudgetExceeded as e:
        print(f"shrink: {e}", file=sys.stderr)
        return 1
    text = minimal.to_json()
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    else:
        print(text)
    print(f"shrunk {spec.name!r}: size {stats['initial_size']} -> "
          f"{stats['final_size']} in {stats['runs']} run(s)",
          file=sys.stderr)
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
    if argv and argv[0] == "flight":
        return _flight_main(argv[1:])
    if argv and argv[0] == "llm":
        return _llm_main(argv[1:])
    if argv and argv[0] == "mesh":
        return _mesh_main(argv[1:])
    if argv and argv[0] == "traffic":
        return _traffic_main(argv[1:])
    if argv and argv[0] == "scenario":
        return _scenario_main(argv[1:])
    if argv and argv[0] == "lint":
        from nnstreamer_tpu_torch.analysis.cli import main as lint_main

        return lint_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="nnstreamer_tpu_torch",
        description="streaming AI pipelines on PyTorch/CUDA (gst-launch parity)")
    ap.add_argument("pipeline", nargs="?", help="pipeline description string")
    ap.add_argument("--inspect", nargs="?", const="", default=None,
                    metavar="ELEMENT", help="list elements / element detail")
    ap.add_argument("--models", action="store_true", help="list zoo models")
    ap.add_argument("--timeout", type=float, default=None,
                    help="max run seconds")
    ap.add_argument("--stats", action="store_true",
                    help="print per-element stats JSON after EOS")
    ap.add_argument("--no-optimize", action="store_true",
                    help="disable transform-into-filter fusion")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler Chrome trace of the run "
                         "(host ops, plus the card's kernels when CUDA is "
                         "available) into DIR")
    ap.add_argument("--broker", nargs="?", const=1883, default=None,
                    type=int, metavar="PORT",
                    help="run a standalone EdgeBroker (discovery + pub/sub "
                         "+ clock service) on PORT (default 1883)")
    ap.add_argument("--bind", default="0.0.0.0",
                    help="bind address for --broker (default 0.0.0.0)")
    args = ap.parse_args(argv)

    if args.broker is not None:
        return _broker(args.bind, args.broker)
    if args.inspect is not None:
        return _inspect(args.inspect or None)
    if args.models:
        return _models()
    if not args.pipeline:
        ap.print_help()
        return 2

    from nnstreamer_tpu_torch.graph.parse import parse_launch
    from nnstreamer_tpu_torch.runtime.scheduler import PipelineRunner

    runner = PipelineRunner(parse_launch(args.pipeline),
                            optimize=not args.no_optimize)
    try:
        with _profile(args.profile):
            runner.run(args.timeout)
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    if args.stats:
        print(json.dumps(runner.stats(), indent=2, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
