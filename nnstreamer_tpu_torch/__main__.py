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

Runs the pipeline string to EOS on the CUDA device (set
NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR=cpu to run on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


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


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "trace":
        return _trace_main(argv[1:])
    if argv and argv[0] == "models":
        return _models_main(argv[1:])
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
