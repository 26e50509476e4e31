"""Entry `pipeline_vision`: a recorded clip through the configuration's
pipeline string (`parse_launch` and `PipelineRunner`, `appsrc` to
`tensor_sink`), the model registered in the port's model store.

The run:
1. set-up: weights on the card from the seed (one normal draw, sliced),
   the port's MobileNetV2 built on the meta device and given them, the
   clip's frames from the seed, the pipeline started; then the clip is
   pushed until every compiled-window size the feed forms has run
   (the mix's `warmup_s`), all counted as set-up;
2. the window: frames keep flowing, pushed as fast as `appsrc` accepts
   them behind a bound of `inflight` frames not yet at the sink; the
   frames reaching the sink in the window are counted;
3. after it: the feed ends, every frame pushed is waited for, the
   memory peak is read, and a sample of the window's answers drawn from
   the seed is judged against the plain reference.
"""

from __future__ import annotations

import gc
import sys
import threading
import time
from typing import List

import numpy as np

from benchmark import harness
from benchmark.reference import mobilenet_v2 as ref

#: the store name the run registers its weights under
STORE_NAME = "bench_model"


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The benchmark's weights: one standard-normal draw on the card
    from a generator seeded with `seed`, sliced and scaled per tensor:
    conv weights at He's std sqrt(2 / fan-in), batch-norm scale
    1 + 0.1·n, bias and mean 0.1·n, var 1 + 0.1·|n|, the classifier at
    sqrt(1 / fan-in) and its bias 0.01·n. float32, as the port's
    MobileNetV2 keeps its parameters."""
    import torch

    shapes = ref.param_shapes(cfg)
    total = sum(int(np.prod(s)) for _, s, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, kind in shapes:
        n = int(np.prod(shape))
        t = flat[off:off + n].view(shape)
        off += n
        if kind == "conv":
            t.mul_((2.0 / (shape[1] * shape[2] * shape[3])) ** 0.5)
        elif kind == "dense":
            t.mul_((1.0 / shape[1]) ** 0.5)
        elif kind in ("scale",):
            t.mul_(0.1).add_(1.0)
        elif kind == "var":
            t.abs_().mul_(0.1).add_(1.0)
        elif kind == "dense_bias":
            t.mul_(0.01)
        else:                               # bias, mean
            t.mul_(0.1)
        out[name] = t
    return out


def make_frames(cfg: dict, mix: dict, seed: int) -> np.ndarray:
    """The clip: `frames` uint8 NHWC frames from the seed."""
    size = int(cfg["input_size"])
    rng = np.random.default_rng(int(seed))
    return rng.integers(0, 256, (int(mix["frames"]), size, size, 3),
                        dtype=np.uint8)


def build_model(cfg: dict, weights: dict):
    """The port's MobileNetV2 holding the benchmark's weights (built on
    the meta device, so nothing is drawn twice)."""
    import torch
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2
    from nnstreamer_tpu_torch.tensor.dtypes import DType
    from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

    with torch.device("meta"):
        model = MobileNetV2(float(cfg["width_multiplier"]),
                            int(cfg["num_classes"]),
                            DType.from_name(cfg["dtype"]).torch_dtype)
    model.load_state_dict(weights, strict=True, assign=True)
    model.eval()
    size, ncls = int(cfg["input_size"]), int(cfg["num_classes"])
    return ModelBundle(
        fn=lambda m, x: m(x), params=model,
        in_spec=TensorsSpec.of(TensorInfo((1, size, size, 3), DType.FLOAT32)),
        out_spec=TensorsSpec.of(TensorInfo((1, ncls), DType.FLOAT32)),
        name=STORE_NAME)


class Feed:
    """Pushes the clip into `appsrc` from its own thread, frame i with
    pts i, as fast as the in-flight bound lets it; the sink's callback
    records every answer and frees a slot."""

    def __init__(self, src, frames: np.ndarray, inflight: int):
        self.src, self.frames = src, frames
        self.slots = threading.Semaphore(int(inflight))
        self.pushed = 0
        self.stop = threading.Event()
        # (arrival perf_counter, pts, label index, score) per answer
        self.answers: List[tuple] = []
        self.thread = threading.Thread(target=self._loop, name="bench-feed",
                                       daemon=True)

    def on_answer(self, buf) -> None:
        meta = buf.meta
        self.answers.append((time.perf_counter(), int(buf.pts),
                             int(meta["label_index"]), float(meta["score"])))
        self.slots.release()

    def _loop(self) -> None:
        from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

        n = len(self.frames)
        while not self.stop.is_set():
            if not self.slots.acquire(timeout=0.1):
                continue
            i = self.pushed
            self.src.push(TensorBuffer(tensors=(self.frames[i % n][None],),
                                       pts=i))
            self.pushed += 1

    def count_in(self, t0: float, t1: float) -> int:
        return sum(1 for a in list(self.answers) if t0 <= a[0] < t1)


def run(cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", control: bool = False,
        judge: bool = True) -> dict:
    import torch
    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.serving.store import reset_store

    cfg, mix = cell.config, cell.traffic
    dev = torch.device(device)
    store = reset_store()        # nothing of an earlier run stays held
    weights = make_weights(cfg, seed, dev)
    store.register(STORE_NAME, build_model(cfg, weights))
    frames = make_frames(cfg, mix, seed)
    size = int(cfg["input_size"])
    pipe = nt.parse_launch(cfg["pipeline"].format(
        dims=f"3:{size}:{size}:1", model=f"store://{STORE_NAME}"))
    src, sink = pipe.get("src"), pipe.get("out")
    feed = Feed(src, frames, int(mix["inflight"]))
    sink.set_props(new_data=feed.on_answer, collect=False)
    if trace:
        harness.DeviceTrace.warm()
    runner = nt.PipelineRunner(pipe, **mix.get("runner", {})).start()
    traced = None
    try:
        feed.thread.start()
        _warm(runner, mix)
        compiles0 = _window_compiles(runner)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        setup_s = harness.process_age_s()
        if trace:
            # the window's last `trace_s`: the profiler is stopped only
            # once the pipeline has drained, because stopping it while
            # another thread launches a CUDA graph can hang both
            harness.sleep_until(t0 + seconds - float(mix["trace_s"]))
            tracer = harness.DeviceTrace()
            snaps = [runner.stats()]
            tracer.start()
        harness.sleep_until(t0 + seconds)
        t1 = t0 + seconds
        if trace:
            tracer.mark_stop()
            snaps.append(runner.stats())
        compiles1 = _window_compiles(runner)
        feed.stop.set()
        feed.thread.join(10)
        src.end()
        runner.wait(120)
        if trace:
            tracer.finish()
            traced = tracer.reduce(), snaps
    finally:
        feed.stop.set()
        harness.stop_runner(runner, 120)
    if compiles1 != compiles0:
        print(f"warning: {compiles1 - compiles0} window graphs were captured "
              f"inside the window", file=sys.stderr)
    frames_in = feed.count_in(t0, t1)
    rec = {
        "setup_s": setup_s,
        "window_s": seconds,
        "frames_in_window": frames_in,
        "attempted": feed.pushed,
        "failed": feed.pushed - len(feed.answers),
        "config": cfg,
    }
    if device == "cuda":
        rec["device"] = harness.card_info(dev.index or 0)
    if traced is not None:
        rec["trace"], stats = traced
        h0, h1 = rec["trace"]["host_window"]
        rec["sub"] = {"stats": list(stats), "frames": feed.count_in(h0, h1),
                      "host_s": h1 - h0}
    answers = feed.answers
    # the pipeline's objects refer to each other: drop every name and
    # collect, so the program's state is gone before the reference runs
    del runner, pipe, src, sink, feed
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    rec["checks"], rec["control"] = (
        check(cell, seed, weights, frames, answers, t0, t1, dev,
              control) if judge else ([], None))
    reset_store()
    return rec


def _window_compiles(runner) -> int:
    """Compiled windows captured so far (the filters' counters)."""
    return sum(d.get("backend_window_compile_count", 0)
               for d in runner.stats().values())


def _warm(runner, mix: dict) -> None:
    """Feed the clip for `warmup_s`, then on until no window size has
    been captured for `settle_s` (at most `warmup_max_s` in all): every
    window the feed forms is built before the window opens."""
    t_start = time.perf_counter()
    time.sleep(float(mix["warmup_s"]))
    last, t_last = _window_compiles(runner), time.perf_counter()
    while time.perf_counter() - t_start < float(mix["warmup_max_s"]):
        time.sleep(0.1)
        n = _window_compiles(runner)
        if n != last:
            last, t_last = n, time.perf_counter()
        elif time.perf_counter() - t_last >= float(mix["settle_s"]):
            return


def sample(answers, t0: float, t1: float, n: int, seed: int) -> list:
    """Up to `n` of the answers that reached the sink in [t0, t1), drawn
    from the seed."""
    in_window = [a for a in answers if t0 <= a[0] < t1]
    if not in_window:
        raise RuntimeError("no answer reached the sink in the window")
    rng = np.random.default_rng(int(seed) ^ 0x5EED)
    n = min(int(n), len(in_window))
    return [in_window[i] for i in rng.choice(len(in_window), size=n,
                                             replace=False)]


def judge(logits: np.ndarray, rows) -> tuple:
    """(label_gap, score_err) of answers `rows` = (frame, label, score)
    against reference logits (frames, classes): the largest amount by
    which an answer's label lies below the reference's best logit, and
    the largest gap between an answer's score (the model filter's logit
    of its label) and the reference's logit of that label. Only
    `label_gap` is compared: `score_err` has no upper reading (PERF.md)
    and is reported beside it."""
    gap = err = 0.0
    for frame, label, score in rows:
        row = logits[frame]
        gap = max(gap, float(row.max() - row[label]))
        err = max(err, abs(float(score) - float(row[label])))
    return gap, err


def check(cell, seed, weights, frames, answers, t0, t1, dev,
          control: bool = False):
    """Judge a sample of the window's answers, drawn from the seed,
    against the float32 reference on the same frames and weights (see
    `judge`); frames never answered count through `failed`. With
    `control`, the fp8 reference's answers for the same frames are
    judged too. → (checks, control readings or None)."""
    picked = sample(answers, t0, t1, cell.traffic["check_sample"], seed)
    rows = [pts % len(frames) for _, pts, _, _ in picked]
    logits = reference_logits(cell.config, weights, frames, dev)
    gap, err = judge(logits, [(f, label, score) for f, (_, _, label, score)
                              in zip(rows, picked)])
    print(f"score_err (not compared): {err!r}", file=sys.stderr)
    checks = [("label_gap", gap, float(cell.limits["label_gap"]))]
    if not control:
        return checks, None
    ctrl = reference_logits(cell.config, weights, frames, dev, "fp8")
    labels = ctrl.argmax(axis=1)
    cgap, cerr = judge(logits, [(f, int(labels[f]), float(ctrl[f, labels[f]]))
                                for f in rows])
    return checks, {"label_gap": cgap, "score_err": cerr,
                    "program_score_err": err, "answers_judged": len(rows)}


def reference_logits(cfg, weights, frames, dev, precision: str = "f32",
                     batch: int = 64) -> np.ndarray:
    """The reference's logits of every frame of the clip (host)."""
    import torch

    from benchmark.reference.precision import no_tf32

    no_tf32()
    out = []
    with torch.no_grad():
        for i in range(0, len(frames), batch):
            x = torch.from_numpy(frames[i:i + batch]).to(dev)
            out.append(ref.forward(weights, x, cfg, precision).cpu())
    return torch.cat(out).numpy()
