"""CLI — the gst-launch-1.0 parity surface.

    python -m nnstreamer_tpu_torch 'videotestsrc num-buffers=16 ! \
        tensor_converter ! tensor_filter model=zoo://mobilenet_v2 ! \
        tensor_decoder mode=image_labeling ! tensor_sink'

Runs the pipeline string to EOS on the CUDA device (set
NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR=cpu to run on the CPU).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nnstreamer_tpu_torch",
        description="streaming AI pipelines on PyTorch/CUDA (gst-launch parity)")
    ap.add_argument("pipeline", help="pipeline description string")
    ap.add_argument("--timeout", type=float, default=None,
                    help="max run seconds")
    args = ap.parse_args(argv)

    from nnstreamer_tpu_torch.graph.parse import parse_launch
    from nnstreamer_tpu_torch.runtime.scheduler import PipelineRunner

    runner = PipelineRunner(parse_launch(args.pipeline))
    try:
        runner.run(args.timeout)
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    return 0


if __name__ == "__main__":
    sys.exit(main())
