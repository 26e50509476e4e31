"""Entry `pipeline_llm`: token streams through `tensor_llm`, built from
the configuration's pipeline string (`parse_launch` and
`PipelineRunner`, `appsrc` to `tensor_sink`), the element's properties
from the mix's `element` group.

The run:
1. set-up: the weights on the card from the seed (one normal draw in
   the served dtype, sliced), registered in the port's model store; the
   pipeline started, which places them, builds the KV pool and runs
   every bucket the element's `prewarm` names; then the mix's closed
   loop runs for its `warmup_s`, so the window opens on a full batch
   and not on the first prompts' prefill;
2. the window: the loop goes on. `clients` requests are in flight, each
   client sending its next request when its last token arrives; every
   token is stamped as its buffer reaches the sink (`stream_chunk`
   tokens a buffer, the mix's element property). In a traced run the
   executor's spans are kept too (`SpanTap`);
3. after it: no request is sent; the memory peak is read, the program
   is stopped and freed, and a sample of the served requests drawn from
   the seed, the one with the most served tokens among them, is judged
   against the plain reference over every token it served.

Greedy decoding, no stop token: every request emits exactly its
`max_new_tokens`, so the work of a seed is fixed by the mix.
"""

from __future__ import annotations

import gc
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from benchmark import arrivals, harness
from benchmark.cost import transformer as cost
from benchmark.reference import decoder as ref

STORE_NAME = "bench_llm"


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The benchmark's weights in the served dtype: one normal draw of
    std `initializer_range` on the card, sliced into the layout the
    reference documents; each norm weight is 1 plus its slice."""
    import torch

    m = cost.dims(cfg)
    d, qd, kvd, ff, vocab = (m["d"], m["h"] * m["hd"], m["kv"] * m["hd"],
                             m["ff"], m["vocab"])
    dtype = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(cost.params_count(cfg), dtype=dtype, device=device)
    flat.normal_(0.0, float(cfg["initializer_range"]), generator=gen)
    off = 0

    def take(*shape, norm=False):
        nonlocal off
        n = int(np.prod(shape))
        t = flat[off:off + n].view(shape)
        off += n
        return t.add_(1.0) if norm else t

    params = {"embed": take(vocab, d), "blocks": []}
    for _ in range(m["layers"]):
        params["blocks"].append({
            "ln1": take(d, norm=True), "wqkv": take(d, qd + 2 * kvd),
            "wo": take(qd, d), "ln2": take(d, norm=True),
            "wi": take(d, 2 * ff), "wd": take(ff, d)})
    params["ln_f"] = take(d, norm=True)
    params["head"] = take(d, vocab)
    assert off == flat.numel()
    return params


class Request:
    __slots__ = ("rid", "prompt", "max_new", "sent", "tokens", "arrivals",
                 "done")

    def __init__(self, rid: str, prompt: np.ndarray, max_new: int):
        self.rid, self.prompt, self.max_new = rid, prompt, int(max_new)
        self.sent: Optional[float] = None
        self.tokens: List[int] = []
        self.arrivals: List[float] = []
        self.done = False

    @property
    def plen(self) -> int:
        return int(self.prompt.shape[0])


class Clients:
    """The mix's closed loop: `clients` requests in flight. Request k
    takes the k-th size of the mix's `requests` sizes (cycled), the
    multiset the mix's `base_seed` draws in the order the run's seed
    gives, and fresh token ids from the seed."""

    def __init__(self, cfg: dict, mix: dict, seed: int, src):
        self.mix, self.src = mix, src
        self.plen, self.olen = arrivals.request_sizes(
            mix, int(mix["requests"]), seed)
        self.rng = np.random.default_rng(int(seed) + 1)
        self.vocab = int(cfg["vocab_size"])
        self.pool: List[Request] = []
        self.by_id: Dict[str, Request] = {}
        self.closing = threading.Event()
        self.lock = threading.Lock()

    def send(self, req: Request) -> None:
        from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

        req.sent = time.perf_counter()
        self.by_id[req.rid] = req
        self.src.push(TensorBuffer(tensors=(req.prompt,), meta={"llm": {
            "request_id": req.rid, "max_new_tokens": req.max_new,
            "temperature": 0.0, "eos_id": -1}}))

    def _take(self) -> Request:
        with self.lock:
            k = len(self.pool)
            i = k % len(self.plen)
            req = Request(f"r{k}", self.rng.integers(
                0, self.vocab, int(self.plen[i]), dtype=np.int32),
                self.olen[i])
            self.pool.append(req)
            return req

    def start(self) -> None:
        for _ in range(int(self.mix["clients"])):
            self.send(self._take())

    def on_chunk(self, buf) -> None:
        now = time.perf_counter()
        meta = buf.meta["llm"]
        req = self.by_id[meta["request_id"]]
        toks = np.asarray(buf.tensors[0]).reshape(-1).tolist()
        req.tokens.extend(int(t) for t in toks)
        req.arrivals.extend([now] * len(toks))
        if meta["done"]:
            req.done = True
            if not self.closing.is_set():
                self.send(self._take())

    def sent(self) -> List[Request]:
        return [r for r in self.pool if r.sent is not None]


class SpanTap:
    """The executor's spans, taken through its tracer hook in a traced
    run: for every decode call its end (host clock), its rows and each
    row's context; for every prefill call its end, first position and
    length. A span is taken inside the call it closes, so the positions
    are read from that call's own arguments (`decode`'s `pos`,
    `prefill_chunk`'s `pos0`). Nothing raised here reaches the program:
    a span that cannot be read is counted in `misses`."""

    def __init__(self, engine):
        from nnstreamer_tpu_torch.runtime.tracing import NullTracer

        class _Tap(NullTracer):
            active = True

            def backend_span(tap, name, kind, t0, t1, **args):
                if kind == "invoke":
                    try:
                        self._span(t1, args)
                    except Exception:
                        self.misses += 1

        self.engine = engine
        self.tracer = _Tap()
        self.decodes: List[tuple] = []    # (t1, rows, [context a row])
        self.prefills: List[tuple] = []   # (t1, first position, length)
        self.misses = 0

    def _span(self, t1: float, args: dict) -> None:
        what = args.get("what")
        if what == "llm_decode":
            n = int(args["rows"])
            pos = _call_arg("decode", "pos")
            self.decodes.append((t1, n, [int(p) + 1 for p in pos[:n]]))
        elif what == "llm_prefill_chunk":
            self.prefills.append((t1, int(_call_arg("prefill_chunk",
                                                    "pos0")),
                                  int(args["clen"])))
        elif what == "llm_prefill":
            self.prefills.append((t1, 0, int(args["plen"])))

    def attach(self) -> None:
        self.engine.executor.tracer = self.tracer

    def between(self, h0: float, h1: float) -> dict:
        """The calls whose spans closed in [h0, h1)."""
        return {"decodes": [d for d in self.decodes if h0 <= d[0] < h1],
                "prefills": [p for p in self.prefills if h0 <= p[0] < h1],
                "misses": self.misses}


def _call_arg(function: str, name: str):
    """Argument `name` of the innermost call of `function` on this
    thread's stack (the executor call whose span is being taken)."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == function and name in f.f_code.co_varnames:
            return f.f_locals[name]
        f = f.f_back
    raise LookupError(f"no call of {function} on the stack")


def pipeline_string(cfg: dict, mix: dict) -> str:
    props = {"model": f"store://{STORE_NAME}",
             "n_heads": cfg["num_attention_heads"], "dtype": cfg["dtype"],
             "temperature": 0, "eos_id": -1, **mix["element"]}
    return cfg["pipeline"].format(
        props=" ".join(f"{k}={v}" for k, v in props.items()))


def run(cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", control: bool = False,
        judge: bool = True) -> dict:
    import torch
    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.serving.store import reset_store
    from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorsSpec

    cfg, mix = cell.config, cell.traffic
    dev = torch.device(device)
    store = reset_store()        # nothing of an earlier run stays held
    params = make_weights(cfg, seed, dev)
    store.register(STORE_NAME, ModelBundle(fn=None, params=params))
    pipe = nt.parse_launch(pipeline_string(cfg, mix))
    src, llm, sink = pipe.get("src"), pipe.get("llm"), pipe.get("out")
    src.set_props(spec=TensorsSpec(tensors=(), format=TensorFormat.FLEXIBLE))
    clients = Clients(cfg, mix, seed, src)
    sink.set_props(new_data=clients.on_chunk, collect=False)
    if trace:
        harness.DeviceTrace.warm()
    runner = nt.PipelineRunner(pipe, **mix.get("runner", {})).start()
    tap = None
    try:
        if trace:
            tap = SpanTap(llm.engine)
            tap.attach()
        clients.start()
        harness.sleep_until(time.perf_counter() + float(mix["warmup_s"]))
        t0 = time.perf_counter()
        setup_s = harness.process_age_s()
        traced = None
        if trace:
            traced = harness.trace_window(t0, seconds,
                                          float(mix["trace_s"]))
        harness.sleep_until(t0 + seconds)
        t1 = t0 + seconds
        clients.closing.set()
        high_water = llm.engine.cache.allocator.high_water
        blocks = llm.engine.cache.allocator.total
        info = harness.card_info(dev.index or 0) if device == "cuda" else None
    finally:
        clients.closing.set()
        harness.stop_runner(runner, 60)
    sent = clients.sent()
    rec = {
        "setup_s": setup_s, "window_s": seconds, "t0": t0, "t1": t1,
        "config": cfg, "mix": mix, "requests": sent,
        "attempted": len(sent),
        "failed": _missing(sent, t0, t1),
        "kv_high_water": high_water / blocks,
    }
    if info is not None:
        rec["device"] = info
    if traced is not None:
        rec["trace"] = traced
        h0, h1 = rec["trace"]["host_window"]
        rec["sub"] = dict(tap.between(h0, h1), host_s=h1 - h0)
        if tap.misses:
            print(f"warning: {tap.misses} executor spans could not be "
                  f"read; the span readers report nothing", file=sys.stderr)
    # the pipeline's objects refer to each other: drop every name and
    # collect, so the weights' last holder is this frame and the KV pool
    # is gone before the reference runs
    del runner, pipe, src, llm, sink, clients, tap
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    rec["checks"], rec["control"] = (
        check(cell, seed, params, sent, dev, control) if judge
        else ([], None))
    reset_store()
    return rec


def _missing(sent: List[Request], t0: float, t1: float) -> int:
    """Requests sent before the window opened that had no token when it
    closed: a whole window is far longer than a prompt's prefill behind
    a full batch, so such a request never came. (One sent later and cut
    at the window's end is late, not failed.)"""
    return sum(1 for r in sent if r.sent < t0
               and not any(a < t1 for a in r.arrivals))


def pick_requests(sent: List[Request], n: int, seed: int) -> List[Request]:
    """Up to `n` served requests: the one with the most served tokens,
    finished or still in flight when the window closed (its served
    prefix is judged), and the rest drawn from the seed among the
    finished ones (among every served one where none finished)."""
    served = [r for r in sent if r.tokens]
    if not served:
        raise RuntimeError("no request was served in the run")
    longest = max(served, key=lambda r: (len(r.tokens), r.plen))
    rest = [r for r in served if r is not longest]
    done = [r for r in rest if r.done]
    rest = done or rest
    rng = np.random.default_rng(int(seed) ^ 0x5EED)
    k = min(len(rest), max(0, int(n) - 1))
    picked = [rest[i] for i in rng.choice(len(rest), size=k, replace=False)]
    return [longest] + picked


def served_gaps(params: dict, reqs: List[Request], cfg: dict, device,
                precisions=("f32",)) -> List[List[np.ndarray]]:
    """For each precision, each request: the reference's logits at every
    position that chose a served token, over the prompt followed by the
    served tokens. → per precision a list of (logits host arrays)."""
    import torch

    seqs, rows = [], []
    for r in reqs:
        toks = np.concatenate([r.prompt, np.asarray(r.tokens[:-1],
                                                    np.int32)])
        seqs.append(torch.from_numpy(toks).to(device))
        rows.append(torch.arange(r.plen - 1, r.plen - 1 + len(r.tokens),
                                 device=device))
    out = ref.logits_at(params, seqs, rows, cfg, precisions)
    return [[lg.cpu().numpy() for lg in per] for per in out]


def token_gap(logits: List[np.ndarray], tokens: List[List[int]]) -> float:
    """The largest amount by which a chosen token's reference logit lies
    below the reference's best at its position."""
    gap = 0.0
    for lg, toks in zip(logits, tokens):
        chosen = lg[np.arange(len(toks)), np.asarray(toks)]
        gap = max(gap, float((lg.max(axis=1) - chosen).max()))
    return gap


def check(cell, seed: int, params: dict, sent: List[Request], dev,
          control: bool = False):
    """The sample's `token_gap` against the float32 reference; with
    `control`, also the control's: at each position of the same prompts
    and served tokens, the gap of the token the fp8 reference puts
    first. → (checks, control readings or None)."""
    from benchmark.reference.precision import no_tf32

    no_tf32()
    reqs = pick_requests(sent, int(cell.traffic["check_requests"]), seed)
    precisions = ("f32", "fp8") if control else ("f32",)
    got = served_gaps(params, reqs, cell.config, dev, precisions)
    gap = token_gap(got[0], [r.tokens for r in reqs])
    checks = [("token_gap", gap, float(cell.limits["token_gap"]))]
    if not control:
        return checks, None
    firsts = [lg.argmax(axis=1).tolist() for lg in got[1]]
    return checks, {"token_gap": token_gap(got[0], firsts),
                    "tokens_judged": sum(len(r.tokens) for r in reqs)}
