"""Tiny-size rehearsals of each driver on the CPU (the torch paged
attention, `paged_kernel=xla`): a sound run comes out correct, the
control reads worse than the program, and a run with the timed path
broken underneath comes out not correct, once for each fault a cell
can have: a token or an answer altered where it is produced, and for
the LLM also a decode step that leaves the KV state unchanged and half
of a decode batch answered with the other half's logits."""

import json
import os
from types import SimpleNamespace

import pytest

from benchmark import readers
from benchmark.drivers import pipeline_llm, pipeline_vision

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 33 + 12345       # larger than 32 bits, as the driver's are

#: the tiny models' limits, set from their readings on this CPU: sound
#: runs read token_gap ~0.002 (control ~0.02) and label_gap ~0.004
#: (control ~0.15); the faults read token_gap 0.26 and more, label_gap
#: 3.5 and more
TINY_LIMITS = {"token_gap": 0.05, "label_gap": 0.05}


def _json(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def _vision_cell():
    cfg = _json("configs", "mobilenet_v2_1.0_224.json")
    cfg.update(input_size=32, width_multiplier=0.35)
    mix = _json("traffic", "video_file.json")
    mix.update(frames=8, inflight=8, warmup_s=0.8, settle_s=0.2, trace_s=0.5,
               check_sample=64)
    return SimpleNamespace(name="tiny.video", config=cfg, traffic=mix,
                           limits=TINY_LIMITS)


def _llm_cell(stream_chunk=1):
    cfg = _json("configs", "mistral_7b_v0.1.json")
    cfg.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               vocab_size=256)
    mix = _json("traffic", "batch_decode.json")
    mix.update(requests=40, check_requests=8, clients=8, warmup_s=0.3,
               prompt={"dist": "loguniform", "lo": 4, "hi": 24},
               output={"dist": "uniform", "lo": 8, "hi": 32})
    mix["element"].update(paged_kernel="xla", max_len=64, num_blocks=129,
                          max_batch=8, prefill_chunk=16, prewarm=32,
                          stream_chunk=stream_chunk)
    return SimpleNamespace(name="tiny.batch_decode", config=cfg,
                           traffic=mix, limits=TINY_LIMITS)


def _correct(rec):
    return all(v <= lim for _, v, lim in rec["checks"]) and \
        rec["failed"] == 0


def test_vision_run_is_correct_and_the_control_reads_worse(on_cpu):
    rec = pipeline_vision.run(_vision_cell(), SEED, 1.5, False,
                              device="cpu", control=True)
    assert _correct(rec), rec["checks"]
    assert rec["frames_in_window"] > 0 and rec["attempted"] > 0
    assert readers.frames_per_s(rec) > 0
    prog = {n: v for n, v, _ in rec["checks"]}
    assert rec["control"]["label_gap"] > 3 * prog["label_gap"]


def test_llm_run_is_correct_and_the_control_reads_worse(on_cpu):
    rec = pipeline_llm.run(_llm_cell(), SEED, 2.0, False, device="cpu",
                           control=True)
    assert _correct(rec), rec["checks"]
    assert rec["attempted"] > 0
    assert readers.output_tokens_per_s(rec) > 0
    assert rec["control"]["token_gap"] > 3 * rec["checks"][0][1]


@pytest.mark.parametrize("prefill", ["prefill", "chunk"])
def test_llm_traced_rows_from_spans_never_pass_the_batch(on_cpu,
                                                         monkeypatch,
                                                         prefill):
    """Tokens reach the sink 4 to a buffer; the rows a decode step reads
    come from the executor's spans, so they never pass `max_batch`, and
    each call's contexts are one per row. Whole prompts go through the
    plain prefill or, as on the card's paged kernels, through
    `prefill_chunk` from position 0; every span is read."""
    import time

    from benchmark import harness
    from nnstreamer_tpu_torch.backends.llm_exec import PagedLLMExecutor

    monkeypatch.setattr(PagedLLMExecutor, "_prefill_kind",
                        lambda self: prefill)

    def window(t0, seconds, span):
        harness.sleep_until(t0 + seconds / 2)
        h0 = time.perf_counter()
        harness.sleep_until(h0 + span)
        return {"host_window": [h0, time.perf_counter()], "valid": False,
                "busy_s": 0.0, "window_s": span}

    monkeypatch.setattr(harness.DeviceTrace, "warm", staticmethod(
        lambda: None))
    monkeypatch.setattr(harness, "trace_window", window)
    cell = _llm_cell(stream_chunk=4)
    cell.traffic["trace_s"] = 0.8
    rec = pipeline_llm.run(cell, SEED, 2.0, True, device="cpu")
    assert _correct(rec), rec["checks"]
    decodes = rec["sub"]["decodes"]
    assert decodes and all(len(c) == n for _, n, c in decodes)
    rows = readers.rows_per_decode_step(rec)
    assert 1 <= rows <= cell.traffic["element"]["max_batch"]
    assert rec["sub"]["misses"] == 0
    chunk = cell.traffic["element"]["prefill_chunk"]
    prefills = rec["sub"]["prefills"]
    assert prefills and all(p0 % chunk == 0 and 0 < n <= 24
                            for _, p0, n in prefills)


def _label_shifted(monkeypatch):
    from nnstreamer_tpu_torch.decoders import label

    orig = label.ImageLabeling.decode

    def decode(self, buf):
        out = orig(self, buf)
        out.meta["label_index"] = (out.meta["label_index"] + 1) % 1001
        return out
    monkeypatch.setattr(label.ImageLabeling, "decode", decode)


def test_vision_answer_altered_is_not_correct(on_cpu, monkeypatch):
    _label_shifted(monkeypatch)
    rec = pipeline_vision.run(_vision_cell(), SEED, 1.5, False,
                              device="cpu")
    assert not _correct(rec), rec["checks"]


def _token_altered(monkeypatch):
    from nnstreamer_tpu_torch.llm import engine

    orig = engine.LLMEngine._sample
    calls = [0]

    def sample(self, req, logits):
        calls[0] += 1
        tok = orig(self, req, logits)
        return (tok + 1) % logits.shape[-1] if calls[0] % 7 == 0 else tok
    monkeypatch.setattr(engine.LLMEngine, "_sample", sample)


def _state_unchanged(monkeypatch):
    from nnstreamer_tpu_torch.llm import paged_model

    orig = paged_model.paged_decode_step

    def step(params, cur, tables, pos, k_pool, v_pool, **kw):
        logits, _, _ = orig(params, cur, tables, pos, k_pool.clone(),
                            v_pool.clone(), **kw)
        return logits, k_pool, v_pool
    monkeypatch.setattr(paged_model, "paged_decode_step", step)


def _half_batch(monkeypatch):
    from nnstreamer_tpu_torch.llm import paged_model

    orig = paged_model.paged_decode_step

    def step(params, cur, tables, pos, k_pool, v_pool, **kw):
        logits, k, v = orig(params, cur, tables, pos, k_pool, v_pool, **kw)
        half = logits.shape[0] // 2
        if half:
            logits = logits.clone()
            logits[half:2 * half] = logits[:half]
        return logits, k, v
    monkeypatch.setattr(paged_model, "paged_decode_step", step)


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _half_batch])
def test_llm_faults_are_not_correct(on_cpu, monkeypatch, fault):
    fault(monkeypatch)
    rec = pipeline_llm.run(_llm_cell(), SEED, 2.0, False,
                           device="cpu")
    assert not _correct(rec), rec["checks"]
