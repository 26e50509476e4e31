#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (nnstreamer_tpu_torch).

    python3 chip_smoke.py             # every phase, on one card
    python3 chip_smoke.py --slice4    # phases 1, 2 and 20-23 only
    python3 chip_smoke.py --slice6    # phases 1, 2 and 24-26 only
    python3 chip_smoke.py --batching  # phases 1, 2, 27 and 28 only
    python3 chip_smoke.py --window    # phases 1, 2, 29 and 30 only
    python3 chip_smoke.py --modelio   # phases 1, 2 and 31-38 only
    python3 chip_smoke.py --elements  # phases 1, 2, 39 and 40 only
    python3 chip_smoke.py --streaming # phases 1, 2, 41 and 42 only
    python3 chip_smoke.py --serving   # phases 1, 2, 43 and 44 only
    python3 chip_smoke.py --pool      # phases 1, 2, 45 and 46 only
    python3 chip_smoke.py --placement # phases 1, 2 and 47-49 only
    python3 chip_smoke.py --mesh      # phases 1, 2, 50 and 51 only
    python3 chip_smoke.py --traffic   # phases 1, 2, 52 and 53 only
    python3 chip_smoke.py --interop   # phases 1, 2 and 54 only
    python3 chip_smoke.py --train     # phases 1, 2 and 55 only
    python3 chip_smoke.py --parallel  # phases 1, 2, 56 and 57 only

Needs one CUDA card, nvcc, g++ (phase 42) and the repository checkout
around this file;
imports nothing of JAX. On a machine with several cards, phases 21-22
put their four logical devices one per card (--slice4 runs just those
phases there). Phases:

1. environment: torch/CUDA/nvcc versions and the card's name and power
   limit (nvidia-smi); which of grpc, google.protobuf, flatbuffers and
   optax are found (by import spec, none imported);
2. build the hand-written kernels from the checkout's sources (nvcc);
3. normalize_u8 against its plain torch version on the card, bit for
   bit: every dtype a stream carries in (u8, i8, u16, i16, i32, u32, i64,
   u64, f16, bf16, f32, f64; full-range integers) into every float dtype
   out (f32, bf16, f16, f64), each at the frame, at n 1001 and misaligned,
   and u8 at 16M elements; then the float16 pipeline (`tensor_transform
   mode=typecast option=float16 ! tensor_filter framework=pallas
   model=normalize_u8`) on the card, 4 launches, bit for bit its CPU run;
4. the main path: pipelines A (quick start, fused transform) and B
   (kernel path, host and device=true label decode) at full width,
   MobileNetV2 1.0 on 224x224x3 uint8 frames, bf16, on cuda; the launch
   counts and a torch.profiler capture show B went through the kernel;
5. B in f32 on cuda and on the CPU with the same weights: equal labels,
   logits within 1e-3 of max |logit| (cuDNN and the CPU sum in different
   orders and may use different conv algorithms; TF32 off);
6. timings: per-frame latency p50/p99 and FPS of A and B with the
   card's busy share; normalize_u8's device time at the frame and at 16M
   beside its bound, the launch floor and its plain version's time; per
   call from Python (host time, and CUDA events back to back); and each
   step of one call's launch on the host (perf_counter_ns over 10,000
   calls) on the path before the shared Launcher and on the shipped one
   (tools/kernel_variants.py launch_breakdown);
7. the paged-attention kernels (decode, each row's walk split over the
   KV axis; prefill, whose products run on the tensor cores as split
   TF32) against their plain torch versions on the card: full width (8
   heads, hd 128, block 16) and GQA (8 heads on 2 kv heads), holey and
   out-of-order tables, staggered rows (one at a block boundary), pow2
   padding rows, one long row alone (B 1 at pos 1567), rows on the
   decode plan's split boundaries (the last key of a split, the first of
   the next, the table's last slot), a multi-chunk prefill with pos0 >
   0, q in f32 and bf16 — within 1e-5 * max|plain| + 1e-6; each decode
   case launched twice, the two outputs equal bit for bit;
8. LLM serving at full width through tensor_llm (d_model 1024, 8 heads,
   4 layers, vocab 512, max_len 2048; paged_kernel=pallas,
   prefill_chunk=512): 8 requests of 64-1536 prompt tokens, 64 new tokens
   each, all at t=0. In f32 the kernel arm's tokens equal the torch
   reference arm's (paged_kernel=xla);
9. the same in bf16 activations: tokens/s, time to first token and
   inter-token latency p50/p99, and the kernels' launches counted by the
   wrappers and by name in a profiler trace (4 per decode step, 4 per
   prefill chunk);
10. each paged kernel's device time at the serving shapes (decode also
   at one row alone, B 1 at pos 1567) beside its bounds (bytes; f32
   operations on the CUDA cores; for prefill also its split-TF32
   operations on the tensor cores), its plain version's time and
   scaled_dot_product_attention's on K/V gathered beforehand; for decode
   the CTAs the launch ran and how many of them were live;
11. quantize_rows against its plain version, bit for bit (int8 rows and
   f32 scales): the serving shapes (M 1/8/512 x K 1024/4096), the
   forward's M 16384, ragged M, all-zero rows, K not a multiple of the
   vector width, a misaligned strided view, expanded and overlapping
   rows, the register path's longest rows, rows on the shared-memory
   path (long ones, ragged ones at the 48 KB edge, the longest), f32
   and bf16; the launcher's path for each shape (the main path's on the
   register path);
12. flash_attention against its plain version (f32 on the CUDA-core
   kernel, bf16 on the tensor-core kernel): f32 causal and not at
   (2, 2048, 8, 128) within 1e-5 * max|plain| + 1e-6; bf16 at the
   forward's (8, 2048, 8, 128), causal and not, and at the long
   (1, 32768, 8, 128) (its first and last 1024 query rows, each slice on
   its own) element by element within 2^-7 * |plain| + 2^-6 * the row's
   rms; a GQA-expanded case, strided q/v views of one qkv tensor, S 640,
   ragged S 1000, 520 and 72 (not multiples of the kernels' 64-row
   tiles), D 16, bf16 D 64 and 256, and bf16 D 40 and 24 (which the
   tensor-core kernel zero-pads to 64);
13. the full-sequence forward at full width (d_model 1024, 8 heads, 4
   layers, vocab 512, B 8, S 2048): f32 apply_seq with the flash kernel
   against the reference attention (TF32 off), then bf16 timings of
   apply_seq (flash and reference) and apply_seq_w8a8 (flash), with
   4 flash and 17 quantize_rows launches per W8A8 forward counted by the
   wrappers and by name in a profiler trace, every bf16 flash launch on
   the tensor-core kernel (the wrapper's variant counts, and no record
   of the CUDA-core kernel);
14. W8A8 serving: phase 8's model quantized (models/quant.py) and
   registered as a second store entry, served through tensor_llm — f32
   kernel arm against torch reference arm, teacher-forced logits within
   W8A8_SPREAD, which a control (bf16-rounded scales) must exceed (both
   arms run quantize_rows on the card; W8A8 turns float-rounding
   differences into whole int8 steps), their served tokens compared for
   information, 2 short requests on the card against the port on the CPU
   token for token (phase 8's near-tie rule), then bf16 tokens/s, TTFT
   and ITL with 17 quantize_rows launches per decode step and per chunk;
15. quantize_rows and flash_attention device times at the main path's
   shapes beside their bounds, their plain versions' times and, for
   flash, scaled_dot_product_attention's; beside quantize_rows, the
   launch floor (a kernel that returns at once, queued the same way);
16. clamp_scale against its plain version, bit for bit (NaN positions
   compared): P's frame (1x257x257x3 f32), 16M f32 elements spread over
   60 binades, strided views, bf16 and f16 (affine, an offset of +0,
   bounds the dtype cannot hold), integer clamps, f64, and the
   contiguous kernel's edges (n below one CTA's work and below one
   vector, n not a multiple of the vector, bases not 16-byte aligned);
   its device time at P's frame and at 16M (queued, in turns with
   torch.clamp, and by the profiler) beside its bytes bound, its plain
   version's and torch.clamp's;
17. BASELINE configs 2-4 at full width in bf16, bench.py's pipelines with
   uint8 ingest: D (SSD-MobileNetV2 300², 1917 anchors, 91 classes) with
   the bounding_boxes decoder compact (max_in_flight 4 and 1), device=true
   and on the host; P (PoseNet 257², the normalize and a clamp fused into
   the filter) with the pose decoder on the host (max_in_flight 4) and
   device=true; C (two-tensor appsrc, tensor_demux, two MobileNetV2 224²
   sharing one model, tensor_mux nosync): kernels and kernel time per
   frame from a profiled capture, frames/s, latency p50/p99 where the
   decoder emits each frame at once, the card's busy share, and exactly
   one clamp_scale launch per P frame (wrapper and profiler);
18. D and P in f32 (TF32 off) on the card against the port on the CPU,
   same frames and weights: raw outputs within 1e-3 of max |.|, kept
   detections and keypoints identical up to a reported near-tie flip; on
   the card device=true against the host decode of the same frames, and
   compact against the host decode (of the same top-100 candidates when
   the 100th clears the threshold, as random weights make it);
19. C holds one model: memory_allocated rises by about one MobileNetV2
   when the shared filters open, and the muxed logits equal two
   single-filter runs;
20. flash_block_update (the ring-attention step) against its plain
   version, bf16 on the tensor-core kernel and f32 on the CUDA-core one
   (the wrapper's variant counts): non-causal and causal, blocks wholly
   below, on and wholly above the diagonal (above: the carry unchanged
   bit for bit), diagonal blocks whose first rows meet no live key (those
   rows' carry bit for bit) at the serving ring's BH 8 and the forward's
   BH 64, offsets that are not multiples of 64, Sq != Sk, ragged Sk and
   Sq (72), head dims 64, 256 and 40, a chain of 4 steps from
   flash_carry_init compared after finalize, q/k/v as the ring's strided
   (B, H, S, D) views; f32 within 1e-5 * max|plain| + 1e-6, bf16 element
   by element under phase 12's rule;
21. with [parallel] virtual_devices=4 (all four shards on cuda:0 on one
   card, one shard per card on four; the mapping is printed):
   ring_attention over 4 shards (both arms, causal and not, and dp 2 x
   sp 2 with batch_axis) against reference_attention, then apply_seq
   over an sp=4 mesh at phase 13's shape, f32 (TF32 off) against
   apply_seq without a mesh within FWD_F32_REL, bf16 ms per forward with
   and without the mesh, and 64 kernel launches per forward by the
   wrapper and by name in a profiler capture, all on the tensor-core
   kernel (the wrapper's variant counts, no CUDA-core record);
22. sharded serving at full width: phase 8's model and requests through
   tensor_llm shards=4 ring_prefill_min=1024 paged_kernel=xla (no
   prefill_chunk): in f32 shards=4 with the ring off equals shards=1 bit
   for bit (tokens, and teacher-forced logits of the shortest and
   longest request), the ring arm's tokens equal the blocked arm's under
   phase 8's near-tie rule, exactly 64 kernel launches per ring prefill
   (prompts of 1024 tokens or more, bucket 2048; f32 on the CUDA-core
   kernel); then bf16 tokens/s, TTFT and ITL p50/p99, and
   memory_allocated per physical device once the weights and pools are
   placed, every bf16 ring step on the tensor-core kernel by the
   wrapper's count and, in a second profiled run with 2 new tokens, by
   name;
23. flash_block_update's device time at the serving shape (BH 8) and the
   forward's (BH 64), a block below the diagonal (the full step): the
   bf16 tensor-core kernel (queued CUDA events and the profiler) beside
   its bytes bound, its plain version's time and the CUDA-core kernel's
   in bf16 (through its launcher alone) and in f32;
24. A and B, 64 frames each, untraced and then with
   PipelineRunner(trace=True), compiled windows off (the per-frame
   path's spans are counted by name): the traced labels, scores and pts bit for
   bit the untraced run's, 64 process spans for every element, 64
   backend invoke spans on each filter, the decoder's 64 read-backs the
   only forced syncs (traced and counted), normalize_u8 launched 64 times
   in B, the Chrome trace written to chiprun_out/trace_{A,B}.json and
   parsed back with one track per element; report() printed;
25. the LLM cell (bf16, phase 8's 8 requests) untraced and traced:
   tokens identical, kernel_spans()[(llm, "pallas")] equal to the
   executor's decode steps plus prefill chunks, 4 paged launches per
   each, 8 request records whose TTFT equal the engine's samples and
   whose ITL lie within them;
26. B with tensor_fault mode=raise probability=0.05 seed=7
   error-policy=skip before the normalize: emitted + skipped + dropped =
   64, the skipped pts the seed's draws, the survivors bit for bit
   phase 24's clean frames; B with a 30 s delay fault under
   stall_budget_s=0.5 watchdog_action=fail raises WatchdogStall; B cold
   in a fresh process with an empty kernel directory (nvcc at the first
   launch, the first cuDNN call) draws no watchdog warning at the default
   30 s budget; then timings of two arms held in this one process at
   once, in turns: A and B with the tracer off and on, D compact-1,
   P host-1 and P host-1 with its transforms unfused with chain fusion
   off and on (closed-loop latency p50/p99 over 64 frames interleaved
   frame by frame, frames/s over bursts of 64 frames in turns a b b a),
   and the tracer hooks' host cost per recorded event;
27. B micro-batched at full width (bf16): `videotestsrc ! tensor_converter
   ! tensor_batch max-batch=8 max-latency-ms=20 ! tensor_filter
   framework=pallas model=normalize_u8 ! tensor_filter
   model=zoo://mobilenet_v2 ! tensor_unbatch ! tensor_decoder
   mode=image_labeling ! tensor_sink` over 203 frames: normalize_u8
   launched exactly 203 times (once a frame, through the base
   invoke_batched), the model filter's buckets within {1, 2, 4, 8} and its
   batch_size_hist summing to 203 frames, pts in order, labels equal to
   unbatched B's (a flip only where the top-2 gap is within the two runs'
   logit difference), f32 logits (TF32 off) within 1e-3 of max |logit| of
   unbatched B's; a traced run's process span per batch; then batched and
   unbatched B live at once (compiled windows off: the per-frame path),
   every bucket warmed, bursts of 64 frames in turns a b b a: frames/s to the last frame, latency p50/p99 under the
   burst, kernel time a frame (a profiled burst) and the card's busy
   share;
28. tensor_filter's properties and FLEXIBLE invokes on the card:
   output_combination=i0,o0 on B's model filter (the normalize output and
   the logits bit for bit; the passed tensor is the input object, on the
   card), latency_mode=sync (forced_syncs = frames, outputs bit for bit
   the async run's), C (two filters on one key, f32, TF32 off) reloaded
   through one filter after frame 2 (both branches switch at the next
   frame: within 1e-3 of the new model's logits), crop → MobileNetV2
   invoke_dynamic=true custom=dynamic_spatial=true over 6 regions in 3
   frames, card vs CPU within 1e-3 of max |logit|, the bucket shapes
   exactly those the rule predicts;
29. compiled windows (one CUDA-graph replay a window) on A, B, P
   (PoseNet 257², the clamp fused) and D (SSD, device=true) at full
   width in bf16: 64 frames pushed at once, compiled_loop off and on:
   outputs bit for bit, frame by frame (and B in f32, TF32 off), the
   windows, frames in windows, bails by cause (no "error" on A, B, P),
   windows by K (within {2, 4, 8}), graphs captured, seconds per
   capture, memory_allocated before and after, the model's traced
   process span a frame; P's clamp_scale launches = frames (replays
   counted), and in a profiled run of 48 frames = the profiler's records
   by name; C (f32) reloaded
   through one shared filter mid-stream: the other takes the "swap"
   bail, both serve the new model from the next frame, its graphs are
   the new model's; then both arms live at once, bursts of 64 frames in
   turns a b b a: frames/s, latency p50/p99 under the burst, kernel
   time a frame and the card's busy share;
30. the LLM cell through LLMEngine(decode_window=8) against
   decode_window=0: tokens identical in f32 and bf16; bf16 runs in turns
   a b b a (tokens/s, TTFT, ITL p50/p99), then a profiled run per arm
   (busy share, cudaLaunchKernel and cudaGraphLaunch calls,
   paged_decode_attn launches = 4 x decode steps = the profiler's
   records, replays counted; the (b_b, steps) graphs held); W8A8 bf16
   tokens identical with 17 quantize_rows launches per step and chunk;
31. model files (nnstreamer_tpu_torch/tools/tflite_fixture.py writes
   config 1's MobileNetV2 1.0 at 224², 1001 classes, zoo://mobilenet_v2's
   seed-0 params with BN folded, into a temporary directory: F float32,
   Q uint8 calibrated on 8 seeded frames, the WHILE counter, and m.npz
   through the port's save_params): F (`tensor_filter
   framework=tensorflow-lite model=mbv2_float.tflite` after the
   normalize_u8 filter) in f32 (TF32 off) within 1e-3 of max |logit| of
   its CPU run and of zoo://mobilenet_v2 on the card, labels equal; F in
   its default bf16 with normalize_u8 launched once a frame (wrapper and
   profiler, profiled_agreement) and its labels against f32 printed; Q
   through custom=dtype=int8 (uint8 frames straight in) bit for bit its
   CPU run over 16 frames, Q under dtype=bfloat16 against it printed;
   model=m.npz bit for bit the zoo bundle; F behind tensor_batch
   max-batch=8: one invoke a frame (the file's baked batch), labels equal
   to unbatched F's;
32. B (zoo), F, Q int8-native and Q under bf16 live at once: closed-loop
   latency p50/p99 frame by frame in turns, then bursts of 64 frames in
   turns a b b a with compiled windows off and on (frames/s, latency under
   the burst, CUDA kernels and kernel time a frame from a profiled burst,
   the card's busy share); F's and Q's windows bit for bit their per-frame
   runs (64 frames);
33. the WHILE counter (a LESS cond subgraph, an ADD/MUL body) on the card,
   32 frames pushed at once: its window captures refused by the WHILE op
   (one attempt a window size, remembered, one warning, "error" bails),
   the frames run per frame, outputs bit for bit the CPU's;
34. model files, second group (nnstreamer_tpu_torch/tools/model_fixtures.py
   writes them at full width, weights from seed 0, into a temporary
   directory): G config 1's MobileNetV2 as a frozen GraphDef (`tensor_filter
   model=mbv2.pb inputname=input outputname=logits` after the normalize_u8
   filter), S the speech-commands conv model (seeded one-second WAV bytes
   into `inputname=wav_data`: DecodeWav on the host, AudioSpectrogram, Mfcc,
   two convs, FC to 12), M MobileNetV1 0.25 at 224² as .rtm after the
   normalize_u8 filter (`framework=deepview-rt`), L Caffe's LeNet
   (.caffemodel), R a CIFAR-10 ResNet-20 caffe2 init,predict pair
   (`framework=caffe2`), U LeNet-5 as .uff (`framework=tensorrt inputname=in
   outputname=out`), the add2 .dlc pair (`framework=snpe`): each f32 on the
   card (TF32 off) within 1e-3 of max |y| of its CPU run with labels equal,
   G also of zoo://mobilenet_v2; the add2 pair bit for bit its CPU run, x + 2
   exact (uint8 saturating at 255); normalize_u8 once a frame on G and M
   (wrapper and profiler, profiled_agreement); S's host stage (the WAV
   decode) once a frame; G, M and S with compiled windows (64 frames pushed
   at once) bit for bit their per-frame outputs, S's host stage run before
   each window's copy, once a frame;
35. every cell of phase 34 closed-loop, all live at once, frame by frame in
   turns (latency p50/p99); G, M and S in bursts of 64 frames in turns a b
   b a, compiled windows off, then on (frames/s, latency under the burst,
   CUDA kernels and kernel time a frame from a profiled burst, the card's
   busy share);
36. TorchScript (tools/model_fixtures.py writes the archives at full width,
   weights from seed 0, into the same temporary directory): T config 1's
   MobileNetV2 (zoo://mobilenet_v2, f32) traced, behind the normalize_u8
   filter (`tensor_filter framework=pytorch model=mbv2.pt`); T-bf16 the
   same with custom=dtype=bfloat16; TX an nn.TransformerEncoder at the LLM
   cell's widths (d_model 1024, 8 heads, FFN 4096, 4 layers, batch first)
   scripted, on (1, 512, 1024) f32 frames; LT LeNet-5 as a legacy
   (model.json) archive, uint8 in and out, auto-detected by extension. T,
   TX f32 on the card (TF32 off) within 1e-3 of max |y| of their CPU runs
   with labels equal and of torch.jit.load(map_location="cuda") on the
   card (convolutions in cuDNN's TF32 there: the traced calls carry
   allow_tf32=True, which torch's executor obeys), T also of
   zoo://mobilenet_v2; T-bf16's labels those of T but at a near tie
   (phase 27's rule); LT bit for bit its CPU run; normalize_u8 once a frame
   on T (wrapper and profiler, profiled_agreement); T's and TX's compiled
   windows bit for bit their per-frame outputs; then the decoders:
   image_segment
   (tflite-deeplab) on seeded (1, 257, 257, 21) scores, the device uint8
   class map equal to the host decoder's argmax; direct_video giving back
   config 1's converter frames; octet_stream giving back T's logits'
   bytes;
37. T, G and F (one network from a .pt, a .pb and a .tflite) with TX and LT
   closed-loop, all live at once, frame by frame in turns (latency p50/p99);
   T, G and F in bursts of 64 frames in turns a b b a, compiled windows
   off, then on (frames/s, latency under the burst, CUDA kernels and kernel
   time a frame, the card's busy share); host ms a call of T's code walk,
   of its recorded call list and of G's bound steps.
38. item 2's pieces that had run only on the CPU: the TorchScript LSTM
   (uni- and bidirectional), GRU, SDPA block (full and causal),
   MultiheadAttention and TransformerDecoder archives
   (tools/model_fixtures.write_torchscript_nn, written here) and the
   TFLite files only TensorFlow writes, committed in
   nnstreamer_tpu_torch/tools/data/ (the breadth ops, the
   TFLite_Detection_PostProcess custom op, the keras LSTM's WHILE graph),
   and custom=batch=4 on config 1's MobileNetV2 file, each f32 on the card
   (TF32 off) within 1e-3 of max |y| of its own CPU run (detections: the
   same count and classes, boxes and scores within 1e-4), batch=4 also of
   four batch-1 invokes;
39. the DSL's elements at full width (MobileNetV2 1.0, 224², seed 0; f32
   with TF32 off for the checks, bf16 for the launch counts and windows;
   frames from seeded numpy): E1 a 640×480 source tee'd into normalize_u8
   → tensor_resize 224² bilinear (on the card: its output CUDA tensors
   within 1e-5 of max |.| of the CPU run) → the model → labels (equal to
   the CPU run's, logits within 1e-3 of max |logit|), and a preview
   branch (tensor_rate 10/1 throttle=false → tensor_resize 120×160 →
   transpose; bit for bit the CPU run, as many frames); normalize_u8 once
   a frame (wrapper and profiler); windows on = off bit for bit. E2
   tensor_if on one device logit (a threshold between two first-pass
   values), passthrough / fill_zero through queues into join: every
   frame's label that of the host decision, one forced sync a frame under
   tensor_if; an average / range_inclusive gate before B's head: the model
   runs exactly on the frames that pass. E3 (1, 224, 448, 3) → normalize_u8
   → tensor_split → two shared MobileNetV2 filters → tensor_merge →
   tensor_aggregator 4 every 2: CUDA tensors, merged logits within 1e-6 of
   max |logit| of single-filter runs on contiguous halves, each window the
   stack of its frames, windows on = off, one model's memory. A
   transposed view into the model (fused and unfused) against the CPU
   run. E4 a
   tensor_repo loop s ← 0.9·s + 0.1·logits: the recurrence within 1e-6,
   no forced sync, no thread left. 3b: filesrc .npy → B → filesink gives
   B's labels' bytes; tensor_sink to-host=false max-results=4 keeps the
   last 4 as CUDA tensors;
40. E1, E3 and B (bf16) live at once: closed-loop p50/p99 frame by frame
   in turns; bursts of 64 in turns a b b a, compiled windows off, then on
   (frames/s, latency under the burst, CUDA kernels and kernel time a
   frame, busy share); host and device ms a call of E1's resize, host ms
   a frame of its preview branch; E2's forced syncs a frame.
41. Queue 1 item 3c (seeded weights, frames from seeded numpy): E5 the
   reference's repo-looped LSTM (tensor_repo_src (h, c) and an appsrc's x
   → tensor_mux → zoo://lstm at its widths, d_in 32, d_hidden 64 →
   tensor_demux 0,1+2 → sink and tensor_repo_sink), 64 steps: every y a
   torch recurrence of the same weights on the card (held to 1e-6),
   within 1e-5 of max |y| of the CPU run (TF32 off), no forced sync,
   windows on = off bit for bit. E6 keyword spotting at window 1024
   (audiotestsrc → tensor_converter frames-per-tensor=1024 → typecast →
   zoo://audio_classifier), beside the same string with normalize_u8
   (int16 → f32) for the typecast: logits within 1e-4 of max |logit|,
   labels equal, normalize_u8 on each int16 (1024, 1) window of the path
   = its plain version bit for bit (wrapper and filter), normalize_u8
   once a window (wrapper = profiler), the
   batch=4 bundle through SingleShot = four batch-1 calls. E7 B with a
   framework=custom ×0.5 scaler before the model and a framework=python3
   passthrough after it, beside tensor_transform mul:0.5 and no script:
   logits bit for bit, labels equal, 1.000 forced syncs a frame (the
   script's), the scaler's CUDA output the plain normalize ×0.5; the
   python3 decoder → mode=custom-script: round trip of a frame of logits;
42. Queue 1 item 3d: wire frames of buffers of CUDA tensors (8 dtypes,
   meta) byte for byte those of the same buffers on the host, one counted
   sync a frame; ipc_sink in a spawned process → ipc_src → B at B's frame,
   the native library built at first use with g++, labels equal B
   direct's, frames/s of both in turns B, ipc, ipc, B; tensor_src_iio
   from a fake sysfs tree into a filter on the card; prefetch_to_device at
   depth 2 at B's frame and at 16 MB: in order, each batch its source,
   the side copy stream's overlap with a busy consumer as a share of copy
   time (CUDA events).
43. Queue 1 items 4a-4b (config 1 at full width, MobileNetV2 1.0 at 224²,
   uint8 frames, bf16 unless stated; store://mbv2 v1 = the zoo's seed-0
   weights, v2 = seed 1): Q1 `tensor_query_serversrc ! normalize_u8 !
   tensor_filter model=store://mbv2 ! tensor_query_serversink` against
   `appsrc ! tensor_query_client ! image_labeling`, 32 frames: logits bit
   for bit B run directly on the same version, normalize_u8 launched 32
   times (wrapper and profiler, profiled_agreement), 1.000 forced syncs a
   frame (the reply's); two clients at once, each in its own order, bit
   for bit; Q3 canary `store://mbv2@2:0.25 canary_seed=7` (windows on):
   every frame one version's direct output bit for bit, the version
   sequence the port's CPU routing over the card's split of invokes and
   windows; Q3 hot swap (a second entry, 1 → 2 once 40 of 160 frames are
   back with frames up to 80 in flight, the rest pushed after the flip,
   so frames flow under the barrier): no torn frame, versions never go back, barrier_ok, a
   prewarmed adoption, every window on the version adopted before it,
   the adoption at an invoke boundary (a "swap" bail, a window's own
   version pick or a leftover frame's per-frame invoke, from the
   tracer's event order); then on the same server 2 → 3 with the filter
   idle (16 of 32 frames run, the rest pushed after the flip): versions
   16 x 2 then 16 x 3, barrier_ok, the adoption after a "swap" bail; overload
   (max_pending=2, 64 frames at once from a raw client): answered + typed
   BUSY = 64, results in pts order; hybrid (a broker and a topic), bit for
   bit; Q2 BatchedQueryServer (bucket 8, pre = the normalize_u8 kernel on
   the card batch, f32 with TF32 off), 4 clients x 16 frames: the
   normalized batch bit for bit the plain version's, launches = the
   dispatcher's batches (wrapper and profiler), each client's logits
   within 1e-3 of max |logit| of B's per frame, in pts order; the bucket
   manifest: a spawned process replays it at start and its first frame
   equals this process's;
44. (no claim) Q1 beside B direct: closed-loop p50/p99 frame by frame in
   turns, bursts of 64 in turns a b b a with windows on (frames/s,
   latency under the burst, kernel time a frame, busy share); Q2 (bf16)
   with 1, 4 and 8 clients in turns 1 4 8 8 4 1 (aggregate frames/s,
   mean batch occupancy, p50/p99); B on store:// beside zoo://, closed
   loop in turns (the routing's cost a frame).

45. Queue 1 items 4c-4d: pipeline B's two filters (`normalize_u8 !
   tensor_filter model=store://mobilenet_v2`, the zoo's seed 0, bf16,
   (1, 224, 224, 3) uint8 frames) in supervised pool workers, a 2-worker
   pool with the shm lane and a 1-worker pool on the pipe, both traced,
   every child on cuda:0: pooled logits within 1e-5·max|logit| of B run
   directly in this process (bit for bit reported), the two lanes'
   logits; normalize_u8 once a frame in the children, as each child's
   wrapper counts its launches (shipped in its trace deltas, beside the
   norm filter's spans); SIGKILL of one worker with frames in flight (every
   frame answered once, none off B direct's, conservation exact, the
   replacement up on the card); a two-phase swap to a preloaded version
   2 (seed 1) under traffic (no torn frame, the epoch flips on both
   workers, every frame sent after the flip v2); the autotuner bound to
   the live admission queue, dry run then applied (every applied
   decision in the audit ring, the invariants after each); a /metrics
   scrape parsed against pqs.stats();
46. (no claim) closed-loop p50/p99 of pooled B with 1 and 2 workers
   beside B direct, frame by frame in turns; bursts from 1, 2 and 4
   clients in turns 1 2 4 4 2 1; each child's start; the shm lane
   against the pipe per hop (serving/shm.hop_latency_ab at B's frame);
   then drain: no orphan pid, no shm segment left; the children's
   launches of normalize_u8 over both phases against the norm spans and
   the replies (the kernels line adds them).

47. Queue 1 item 4e, placement, on 4 logical devices (virtual_devices=4,
   all on cuda:0 with one card), pipeline B's model filter (MobileNetV2
   1.0, 224², bf16, seed 0) behind normalize_u8, 32 frames: R2
   (devices=2) bit for bit B's, Σ replica invokes = replied; SH1/SH2
   (shards=1/2) and SH2x2 (devices=4 shards=2, two groups), SH2 bit for
   bit SH1; normalize_u8 once a frame on each; memory_allocated when
   each of B, R2 and SH2 is opened, and SH2's param bytes per logical
   device; a replica fenced mid-stream (R2) and a member device fenced
   mid-stream (SH2x2: its whole group, both lease rows fenced), every
   frame answered once, bit for bit B's, the sum conserved; a store://
   swap 1 → 2 (seed 1) under traffic across R2's replicas: no torn
   frame, versions never go back, both replicas in the new epoch; B, R2
   and SH2 closed loop frame by frame in turns (p50/p99);
48. device segments: SEG is B's model cut at the pooled features into
   two store:// models built here from one zoo module's params
   (backbone, then classifier) joined by `tensor_transform
   mode=typecast option=bfloat16`: one composed segment reported, logits
   bit for bit device_segments=False's and within 1e-3·max|.| of B's,
   normalize_u8 once a frame; with windows on, a warmed burst of 32
   frames under the profiler: cudaGraphLaunch calls = the head's windows
   replayed (one window, one replay) and the windowed logits its
   per-frame ones; a 2-stage plan (plan_from_tracer on the traced
   segments-off run, apply_plan): stages on ordinals 0 and 1, bit for
   bit, one staging transfer a frame at the cut; B and SEG in bursts of
   64 in turns, windows off then on (frames/s, latency, kernels and
   kernel time a frame);
49. Queue 1 item 4f: the device profiler on B per frame — the model
   bucket's FLOPs (FlopCounterMode) within 1% of the analytic count of
   its convs and dense layer, device ms an invoke (CUDA events) beside
   the profiler's kernel time a frame, achieved TFLOP/s and MFU against
   the spec-sheet peak, the memory ledger against
   torch.cuda.memory_allocated; /metrics carrying the nns_jit_*,
   nns_invoke_* and nns_device_hbm_* families with stats()' values; a
   FlightRecorder on a traced Q1 with a p99 budget it must breach: one
   bundle per cooldown window, `flight --json` and `flight --inspect`
   read back; the profiler's cost, B closed loop off on on off;
   normalize_u8 on R2, SH2 and SEG counted by its wrapper and by name in
   one profile (profiled_agreement); the plain run's `--profile DIR` on B
   over PROF_CLI_FRAMES frames (main in this process): exit 0, the
   Chrome trace it names parses and holds the card's kernels (at least
   one; the profiler drops records, so no exact count), normalize_u8
   launched once a frame;
50. Queue 1 item 4g: pipeline B from a two-host serving mesh — a port
   MeshRouter over two 1-worker pools of B's two filters (phase 45's
   pool_start: store://mobilenet_v2 @0, @2 preloaded), each joined by
   pool_join, h0 through a seeded ChaosProxy; each pool's capacity from
   a burst to it alone; 96 frames open loop
   (run_open_loop, Poisson at 1.5x the measured sum), h0 blackholed at
   the median arrival and healed 2.5 s later: lost 0, every frame
   completed once, both admission invariants, Σ per-host replies = the
   router's, a lease fence of h0, a frame redelivered across hosts under
   one trace_id naming both, h0 rejoined, every reply within POOL_REL of
   B direct's (bit for bit counted); then a two-phase swap to @2 across
   both hosts (epoch +1, both commit) and 16 frames all @2; normalize_u8
   launches in the children (their shipped trace deltas) = their pools'
   replies, which cover the router's; p50/p99, fence detection, frames/s;
51. the `llm` subcommand in this process on the card (`--requests 4`,
   NNS_PAGED_KERNEL=pallas): exit 0, every request done, both paged
   wrappers launched; again on the torch reference (xla): every request
   done, the tokens equal the pallas run's but for near-ties (LLM_TIE);
   both paged kernels at the subcommand's shapes (4 heads of 16 on 4 kv
   heads, block 16, q f32) within PAGED_REL/PAGED_ABS of their plain
   versions; then tensor_llm on the same model, 2 requests, with the
   device profiler on (LLM_PROF_*): its model:<element> row equal to the
   placed params plus the KV pool's k and v (all on the card), an invoke
   row for every bucket the executor ran with one sample a dispatch,
   a first-run row for each, and the paged wrappers' launches equal to
   the profiler's records by name (profiled_agreement);
52. Queue 1 item 4h: pipeline B's two filters in a 1-worker pool (phase
   45's pool_start, traced), its capacity from a burst of 16 after 4
   warm-up frames, then flooded open loop by the port's own `traffic`
   subcommand in this process (`--host --port --dims 3:224:224:1 --types
   uint8 --rate` 1.5x the capacity `--requests 96 --seed 0 --json`):
   exit 0, lost 0, completed + rejected = 96 with one completed at
   least, the pool's admission invariants; then 16 of phase 4's test
   images (videotestsrc) through run_open_loop(on_result=...) at 0.5x
   the capacity, every reply within POOL_REL of B direct's (bit for bit
   counted); normalize_u8's launches in the child (its shipped trace
   deltas) = the pool's replies = warm-up + burst + flood + check;
   p50/p99, goodput and frames/s of the flood;
53. Queue 1 item 5a: B's logits across one EdgeBroker (its MQTT listener
   on): `appsrc ! normalize_u8 ! zoo://mobilenet_v2 ! mqttsink
   protocol=mqtt qos=1` into `mqttsrc protocol=mqtt queue_size=128 !
   tensor_sink` in this process, 64 frames: all arrive once, in order,
   with their pts, logits bit for bit B direct's, normalize_u8 +64; a raw
   port MqttClient on the same topic counts 64 PUBLISH packets whose
   payloads decode (decode_buffer) to the same frames; the same 64 over
   the edge protocol with `sync=broker` (pts rebased to 0, never
   decreasing) and through `edgesink port=0` → `edgesrc`, each bit for
   bit with +64 launches; frames/s from the first push to the last
   arrival beside B direct's (no claim);
54. Queue 1 item 5b: B (`appsrc ! normalize_u8 ! zoo://mobilenet_v2`)
   into `tensor_decoder mode=<codec> ! tensor_converter
   mode=custom:<codec> ! tensor_sink` for protobuf, flatbuf and flexbuf,
   64 frames each: logits and pts bit for bit B direct's, normalize_u8
   +64 a codec, the decoder's read-back the only forced sync (64, traced
   under it); phase 28's crop → invoke-dynamic MobileNetV2 (a FLEXIBLE
   frame of one (1, 1001) tensor a region) through each codec's
   GstTensorMetaInfo header: the exact shapes back, bit for bit; then B's
   logits from `tensor_sink_grpc server=true` to `tensor_src_grpc
   server=false` in a second pipeline, 64 in order, bit for bit, +64 —
   or, where grpc is not installed, "grpc: not installed on this
   machine" and the PipelineError naming the package when the element
   starts; frames/s of 64 frames, first push to last result, for each
   beside B direct's before and after them (no claim), and each codec's
   host µs a frame to encode and decode B's logits; 16 frames of the
   protobuf leg profiled: normalize_u8's launches by the wrapper = by
   name (profiled_agreement);
55. Queue 1 item 5c: `appsrc x ! normalize_u8 ! mux.sink_0 appsrc y !
   mux.sink_1 tensor_mux ! tensor_trainer model=zoo://mobilenet_v2?
   width=1.0&num_classes=1001 optimizer=adam:0.001 checkpoint_dir=<tmp>
   checkpoint_every=4 ! tensor_sink`, f32, 8 steps on one seeded batch
   of (8, 224, 224, 3) uint8: finite losses that fall, normalize_u8 once
   a step, one forced sync a step traced under the trainer (the loss),
   checkpoints step_4 and step_8; `resume_from` step_4 then steps 5-8:
   losses and every parameter bit for bit the uninterrupted run's (both
   runs under cudnn.deterministic); batch 2, `sgd:0.01`, TF32 off, 2
   steps on the card and on the CPU from the same params and step 2 on
   the card again from the CPU's step-1 checkpoint: the losses at the
   same params within 1e-5 relative, the free-running step 2's within
   1e-3; each step's parameters from the same start (sgd's update is
   lr·grad, so they hold the backward), |card − CPU| over each leaf's
   movement: median within 5e-2, largest within 3e-1; 8 closed-loop
   steps (push →
   loss on the host) after 2: step ms p50 and images/s; 3 steps profiled:
   kernels, kernel ms and the busy share a step, the top kernels by
   time, normalize_u8's launches by the wrapper and by name; then
   `zoo://audio_classifier?num_classes=12 optimizer=sgd:0.05` on (8,
   1024, 1) int16 windows behind normalize_u8, profiled: the loss falls,
   8 launches by the wrapper = by name (profiled_agreement);
56. Queue 1 item 6, on 4 logical devices of the card ([parallel]
   virtual_devices=4, restored after): MD2, `BatchedQueryServer(
   "zoo://mobilenet_v2", bucket=8, pre=normalize_u8, mesh=dp 2)`, 4
   clients x 16 uint8 224² frames, f32 with TF32 off, against the
   one-card server of bucket 4 (the per-shard batch): replies bit for bit
   where the batches match, else within 1e-5 of max |logit| (the count
   of bit-equal replies printed), in pts order; batches per device equal,
   normalize_u8 once a shard batch, wrapper = profiler; then MD2 and the
   one-card Q2 (bucket 8) in bf16, in turns a b b a: frames/s and p50.
   TRS, `appsrc x ! normalize_u8` and labels through tensor_mux into
   `tensor_trainer model=zoo://mobilenet_v2 mesh=dp=2,tp=2` (1001
   classes, f32, TF32 off, batch 8, sgd:0.01) against the one-device
   trainer on the card: step 1 from the zoo's params, step 2 from the
   mesh's step-1 checkpoint (teacher-forced): losses at the same params
   within 1e-5 relative, parameters over each leaf's movement median
   within 5e-2 and largest within 3e-1; a control with per-shard BN
   statistics must miss the median; placed bytes by logical device, the
   card's peak memory_allocated, closed-loop step ms p50 of both arms in
   turns a b b a;
57. PP, 4 residual stages (the transformer's rmsnorm and _mlp at d_model
   1024, d_ff 4096) on 4 logical devices, 8 microbatches of (2, 2048,
   1024) f32 (TF32 off): bit for bit reference_pipeline (else within
   1e-5 of max |.|), ms a forward pipelined and serial; MOE, E 8 over ep
   4, 16,384 tokens of d 1024 (hidden 4096), f32: ample capacity within
   1e-5 of max |reference_moe|; at capacity factor 1.25 the dropped
   tokens are `_route`'s per shard, their rows exactly zero, every kept
   row within 1e-5; bf16 ms a layer; DRY, `dryrun_multichip(4)` with
   the ring's block at 128 (flash_block_update runs every ring step):
   the ring within 1e-5 of max |ref| + 1e-6, the composed dp x tp x sp
   forward within 5e-4, flash_block_update's launches by the wrapper =
   by name; MH2, two processes of
   `nnstreamer_tpu_torch/tools/multihost_check.py` (gloo: NCCL refuses
   two ranks on one card), 2 logical devices each, a dp 4 global mesh:
   the cross-process sum exact, one train step within 1e-5 of the
   serial numpy step, one loss in both.

Each kernel's timing phase (6, 10, 15, 16, 23) also prints its time per
call from Python, back to back — the host's time (the launch path's own
cost) and CUDA events — and, where one torch call computes the same
function (SDPA, torch.clamp), that call's; phase 15 also times the f32
flash kernel at the forward's shape beside SDPA in f32 (TF32 off).

It prints the seconds of each phase, the card line and a JSON line of
kernel numbers (each with host_ms_per_call) before the last line, and ends with {"ok": true,
"device": {...}}. Any failed check raises, so the exit code is non-zero
and no result line is printed. Without a CUDA device, or run outside the
checkout, it exits non-zero at once. A JSON record of the run goes to
chiprun_out/chip_smoke.json (chip_smoke_slice4.json with --slice4,
chip_smoke_slice6.json with --slice6, chip_smoke_batching.json with
--batching, chip_smoke_window.json with --window,
chip_smoke_modelio.json with --modelio, chip_smoke_elements.json with
--elements, chip_smoke_streaming.json with --streaming,
chip_smoke_serving.json with --serving, chip_smoke_pool.json with
--pool, chip_smoke_placement.json with --placement,
chip_smoke_mesh.json with --mesh, chip_smoke_traffic.json with
--traffic, chip_smoke_interop.json with --interop, chip_smoke_train.json
with --train, chip_smoke_parallel.json with --parallel).
"""

from __future__ import annotations

import gc
import json
import logging
import math
import subprocess
import sys
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FRAMES = 16
#: H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32
#: (non-tensor-core) FLOP/s and TF32 tensor-core FLOP/s (dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
CPU_TOLERANCE = 1e-3     # card vs CPU, relative to max |logit|
#: paged kernel vs plain: max |diff| <= REL * max |plain| + ABS (f32;
#: the kernel's online softmax sums in another order than the plain one)
PAGED_REL, PAGED_ABS = 1e-5, 1e-6
#: the widest transformer the repo ran on a chip (bench.py:1154), MHA
LLM_DIMS = dict(d_model=1024, n_heads=8, n_layers=4, vocab=512)
LLM_PROPS = dict(model="store://llm_full", n_heads=8, paged_kernel="pallas",
                 prefill_chunk=512, block_size=16, max_len=2048,
                 num_blocks=1025, max_batch=8, prewarm=512)
LLM_REQUESTS, LLM_NEW_TOKENS = 8, 64
#: the top-2 logit gap below which a token flip between the two f32 arms
#: is a near-tie, not a fault (relative to max |logit|)
LLM_TIE = 1e-4
#: bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet, dense)
BF16_FLOPS = 989e12
#: the repo's compute-bound prefill forward (bench.py:1140-1237,
#: family transformer_prefill): LLM_DIMS at B 8, S 2048
FWD_B, FWD_S = 8, 2048
#: flash kernel vs plain in bf16, element by element: |diff| <=
#: FLASH_BF16_ULP * |plain| + FLASH_BF16_ROW * (rms of plain's row over
#: D). The first term is one bf16 ulp of the element (the output rounds
#: to bf16); the second covers p rounded to bf16 against the running max
#: in the kernel and the row's final max in the plain version (each p off
#: by <= 2^-9), which moves a row by a fraction of its own size however
#: small its values are (late causal rows average thousands of keys).
#: Each case prints its largest |diff| / limit (PERF.md)
FLASH_BF16_ULP, FLASH_BF16_ROW = 2 ** -7, 2 ** -6
#: f32 forward, flash kernel vs reference attention, relative to max
#: |logit|: only the attention's summation order differs
FWD_F32_REL = 1e-4
#: W8A8 logits of two computations that differ only in float rounding
#: (the attention's summation order) lie 1.893e-2 of max|logit| apart,
#: teacher-forced (PERF.md): once one activation rounds to the other int8
#: step, every later quantization of its row re-rounds. The kernel arm's
#: teacher-forced logits must stay within W8A8_SPREAD of the reference
#: arm's; the control (the kernel arm's scales rounded to bf16, the fault
#: the executor's placement guards against) read 2.2465e-2 and must
#: exceed it. Token flips between W8A8 arms are reported, not held: the
#: spread is the size of a typical top-2 gap
W8A8_SPREAD = 2.1e-2
#: kernel names in a profiler trace, by wrapper (flash_attention and
#: flash_block_update: their bf16 kernels, the main path's; "... simt"
#: their f32 kernels on the CUDA cores)
KERNEL_SYMBOL = {"paged_decode_attn": "nns_paged_decode_kernel",
                 "paged_prefill_attn": "nns_paged_prefill_tf32_kernel",
                 "quantize_rows": "nns_quantize_rows_kernel",
                 "flash_attention": "nns_flash_attn_tc_kernel",
                 "flash_attention simt": "nns_flash_attn_kernel",
                 "flash_block_update": "nns_flash_block_tc_kernel",
                 "flash_block_update simt": "nns_flash_block_kernel"}
#: the throwaway kernel that opens every profiler capture (ATen's
#: at::cuda::sleep, torch.cuda._sleep)
OPEN_KERNEL = "spin_kernel"
#: in the names of both clamp_scale kernels (contiguous and strided), each
#: of which the wrapper counts
CLAMP_SYMBOL = "nns_clamp_scale_"

SRC = f"videotestsrc num-buffers={FRAMES} ! tensor_converter"
NORM_A = ("tensor_transform mode=arithmetic "
          "option=typecast:float32,add:-127.5,div:127.5")
NORM_B = "tensor_filter framework=pallas model=normalize_u8"
MODEL = "tensor_filter model=zoo://mobilenet_v2"
LABEL = "tensor_decoder mode=image_labeling"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def run_pipeline(nt, desc: str, **runner_kw):
    pipe = nt.parse_launch(desc)
    nt.PipelineRunner(pipe, **runner_kw).run(600)
    return pipe.get("out").results


#: throwaway kernels that open a profiler capture, and how many more each
#: repeat of a profiled run adds (profiled_agreement)
OPEN_KERNELS, OPEN_SHIFT = 8, 37
_open_extra = [0]


def open_capture(torch) -> None:
    """Run first inside every profiler capture: throwaway kernels, waited
    for. In runs of this script the tracer missed the first few kernel
    records of a capture whose work began at once (in one run every
    record of a timed flash shape, PERF.md); the misses fall on these,
    which kernel_events leaves out. A repeat of a profiled run launches
    OPEN_SHIFT more of them each time (profiled_agreement says why)."""
    for _ in range(OPEN_KERNELS + _open_extra[0]):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(0.01)


def close_capture(torch) -> None:
    """Run last inside every profiler capture: a pause, then throwaway
    kernels, waited for. The profiler drops kernel records that end near
    its stop (in runs of this script: three of phase 9's 300 paged decode
    records, one of P's clamp records twice), so no counted kernel may be
    among a capture's last; kernel_events leaves these out."""
    time.sleep(0.02)
    open_capture(torch)


def kernel_events(prof):
    """The card's kernel records in a capture, open_capture's left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and OPEN_KERNEL not in e.name]


#: profiled runs a wrapper-against-profiler launch count may take (late
#: in a whole run the profiler lost all 8 and then 3 of the 8 records of
#: phase 55's audio capture before it kept them all)
PROFILE_ATTEMPTS = 6


def profiled_agreement(label: str, attempt):
    """Repeat `attempt()` → (wrapper counts, profiler counts by name,
    result) until the two agree, at most PROFILE_ATTEMPTS times → (the
    agreeing attempt's result, attempts taken). The profiler drops a
    kernel record now and then even inside padded captures (in one full
    run of this script, one of P's 48 clamp records in phase 29), so an
    attempt whose profiler count falls short of the wrapper's is printed
    and repeated. In some processes the profiler lost one record at the
    same place of every repeat (one record of one graph replay in each
    of ten repeats of P's capture; a clamp record in each of three), so
    each repeat opens its captures with OPEN_SHIFT more throwaway kernels
    and the records that follow move. A profiler count above the
    wrapper's (a launch the wrapper did not count) fails at once, and so
    does no agreement in PROFILE_ATTEMPTS runs."""
    for i in range(1, PROFILE_ATTEMPTS + 1):
        _open_extra[0] = OPEN_SHIFT * (i - 1)
        try:
            wrapper, named, res = attempt()
        finally:
            _open_extra[0] = 0
        if wrapper == named:
            return res, i
        check(all(named[k] <= wrapper[k] for k in wrapper),
              f"{label}: the profiler counts more launches than the "
              f"wrapper: {named} against {wrapper}")
        # on stderr too: a refused run shows only that stream's end
        for stream in (sys.stdout, sys.stderr):
            print(f"{label}: profiled run {i} of {PROFILE_ATTEMPTS}: "
                  f"wrapper "
                  f"{wrapper}, profiler {named} (records missing); run "
                  f"again", file=stream, flush=True)
    raise RuntimeError(f"chip_smoke check failed: {label}: wrapper and "
                       f"profiler disagree in {PROFILE_ATTEMPTS} profiled "
                       f"runs, the last {wrapper} against {named}")


def device_ms_per_call(torch, fn, iters: int) -> float:
    """Device time per call of `fn`: CUDA events around `iters` calls
    queued behind a spin kernel that outlasts their enqueueing, so the
    card runs them back to back and the host's launch time is hidden.
    (Summing profiler kernel records per call is not used: the tracer
    dropped records in runs of this script, PERF.md.)"""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    # ~2e9 cycles per second at the H100's boost clock; twice the host's
    # enqueue time, at least 10 ms
    torch.cuda._sleep(int(max(2 * host_s, 0.01) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms_per_launch(torch, fn, symbol: str, iters: int):
    """Mean device time of the kernel `symbol`'s records in a profiler
    trace of `iters` calls of `fn` (an average over the records the
    tracer kept) → (ms or None when it kept none, records kept)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        open_capture(torch)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        close_capture(torch)
    durs = [e.time_range.elapsed_us() for e in kernel_events(prof)
            if symbol in e.name]
    # a second reading beside the CUDA-event time: a capture that kept no
    # record leaves it unmeasured
    return (sum(durs) / len(durs) / 1e3 if durs else None), len(durs)


def event_ms_per_call(torch, fn, iters: int) -> float:
    """CUDA-event time per call over back-to-back calls as Python makes
    them (host launch cost included when it exceeds the device time)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms_per_call(torch, fn, iters: int = 200) -> float:
    """Host time per call of `fn` from Python, back to back, the card's
    work not waited for: the launch path's own cost (`iters` stays far
    below what the launch queue holds, so the host never waits on it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host_s * 1e3 / iters


def closed_loop_latency(nt, norm: str, n: int, warmup: int, **runner_kw):
    """Per-frame latency: push one frame into an appsrc pipeline and wait
    for its label at the sink, n times (`runner_kw` to PipelineRunner).
    → (latencies in ms)."""
    from nnstreamer_tpu_torch.elements.sources import AppSrc

    got = threading.Event()
    pipe = nt.parse_launch(
        f"appsrc name=src dims=3:224:224:1 types=uint8 ! {norm} ! {MODEL} ! "
        f"{LABEL} ! tensor_sink name=out collect=false")
    pipe.get("out").set_props(new_data=lambda buf: got.set())
    runner = nt.PipelineRunner(pipe, **runner_kw).start()
    src: AppSrc = pipe.get("src")
    frame = np.random.default_rng(0).integers(0, 256, (1, 224, 224, 3),
                                              np.uint8)
    lat = []
    try:
        for i in range(warmup + n):
            got.clear()
            t0 = time.perf_counter()
            src.push(frame)
            check(got.wait(60), "no label came back within 60 s")
            if i >= warmup:
                lat.append((time.perf_counter() - t0) * 1e3)
        src.end()
        runner.wait(60)
    finally:
        runner.stop()
    return lat


class Phases:
    """Prints each phase's seconds as it ends."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.seconds = {}

    def done(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t0
        print(f"phase {name}: {now - self.t0:.2f} s")
        self.t0 = now


# -- paged attention: kernels vs plain ----------------------------------------

def sm_count(torch, dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def decode_split_keys(torch, dev, batch, n_kv, hd=128, bs=16, mb=128) -> int:
    """Keys per split of the decode kernel's plan for this shape."""
    from nnstreamer_tpu_torch.backends import paged_attn as pa

    return pa.decode_plan(batch, 8, n_kv, hd, bs, mb,
                          sm_count(torch, dev)).bps * bs


def decode_rows(rng, perm, depths, bs, mb):
    """Block tables (holey, out of order, disjoint rows) and positions of
    rows at the given depths (one past a row's table: its last slot)."""
    tables = np.zeros((len(depths), mb), np.int32)
    for b, depth in enumerate(depths):
        n = min(mb, depth // bs + 1)
        tables[b, :n] = perm[b * mb:b * mb + n]
    return tables, np.asarray(depths, np.int32)


def paged_cases(torch, dev):
    """(name, kernel fn, plain fn, args) for every checked case: decode
    and prefill at full width (8 heads, 8 kv heads, hd 128, block 16)
    and GQA (8 heads on 2 kv heads), q f32 and bf16; decode also one long
    row alone (B 1 at pos 1567) and rows on the kernel's split boundaries
    (the last key of a split, the first of the next, the table's last
    slot)."""
    from nnstreamer_tpu_torch.backends import paged_attn as pa

    rng = np.random.default_rng(1)
    nb, bs, hd, mb = 1025, 16, 128, 128
    cases = []
    for n_kv in (8, 2):
        pools = [torch.from_numpy(rng.standard_normal(
            (nb, bs, n_kv, hd)).astype(np.float32)).to(dev)
            for _ in range(2)]
        # rows: holey/out-of-order tables, staggered depths (row 1 at a
        # block boundary), two pow2 padding rows on the scratch block
        perm = rng.permutation(np.arange(1, nb))
        tables, pos = decode_rows(rng, perm, (1535, 16, 700, 63, 1000, 3,
                                              0, 0), bs, mb)
        tables[6:] = 0
        split = decode_split_keys(torch, dev, 4, n_kv)
        rows = {"B8": (tables, pos),
                "B1 pos 1567": decode_rows(rng, perm, (1567,), bs, mb),
                f"B4 split boundaries (split {split} keys)": decode_rows(
                    rng, perm, (split - 1, split, 3 * split, mb * bs - 1),
                    bs, mb)}
        seq = torch.from_numpy(tables[0]).to(dev)   # 96 holey blocks
        for qdt in (torch.float32, torch.bfloat16):
            tag = f"kv{n_kv} {str(qdt).split('.')[-1]}"
            for rname, (tab, ps) in rows.items():
                q = torch.from_numpy(rng.standard_normal(
                    (len(ps), 8, hd)).astype(np.float32)).to(dev, qdt)
                cases.append((f"decode {tag} {rname}", pa.paged_decode_attn,
                              pa.paged_decode_attn_plain,
                              (q, *pools, torch.from_numpy(tab).to(dev),
                               torch.from_numpy(ps).to(dev))))
            # chunks: first of a long prompt, later chunks (pos0 > 0,
            # one not block-aligned), a short chunk padded to its bucket
            for s_c, pos0 in ((512, 0), (512, 1024), (64, 1000), (8, 0)):
                qp = torch.from_numpy(rng.standard_normal(
                    (8, s_c, hd)).astype(np.float32)).to(dev, qdt)
                cases.append((f"prefill {tag} S{s_c} pos0={pos0}",
                              pa.paged_prefill_attn,
                              pa.paged_prefill_attn_plain,
                              (qp, *pools, seq, pos0)))
    return cases


def check_paged_case(torch, phase, name, kern, plain, args,
                     record) -> float:
    """One paged kernel case against its plain version, within
    PAGED_REL/PAGED_ABS (decode also bitwise equal to a second launch)
    → its largest abs error."""
    got = kern(*args)
    ref = plain(*args)
    # decode folds its splits' partials in split order, whichever CTA
    # ends last: a second launch gives the same bits
    again = kern(*args) if name.startswith("decode") else got
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    lim = PAGED_REL * ref.abs().max().item() + PAGED_ABS
    same = bits_equal(torch, got, again)
    print(f"phase {phase}: {name}: max_abs_err {err:.3e} (limit {lim:.3e})"
          + (f"; second launch bitwise {'equal' if same else 'DIFFERENT'}"
             if name.startswith("decode") else ""))
    check(torch.isfinite(got).all().item(), f"{name}: non-finite output")
    check(err <= lim, f"{name}: kernel differs from its plain version "
                      f"by {err:.3e} > {lim:.3e}")
    check(same, f"{name}: two launches on the same input differ")
    record.setdefault("paged_kernel_errs", {})[name] = err
    return err


def check_paged_kernels(torch, dev, record) -> dict:
    """Each paged kernel against its plain version on every case → the
    largest abs error per kernel at the main-path shape (kv8, bf16)."""
    errs = {}
    for case in paged_cases(torch, dev):
        err = check_paged_case(torch, "7", *case, record)
        name = case[0]
        if "kv8 bfloat16" in name:
            key = name.split()[0]
            errs[key] = max(errs.get(key, 0.0), err)
    return errs


# -- LLM serving ---------------------------------------------------------------

def on_device(params, dev):
    """A transformer params dict (nested dicts/lists of tensors) on dev."""
    if isinstance(params, dict):
        return {k: on_device(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [on_device(v, dev) for v in params]
    return params.to(dev)


def llm_requests():
    """8 prompts of lengths spread over 64-1536 (seeded)."""
    rng = np.random.default_rng(0)
    lens = rng.permutation(np.linspace(64, 1536, LLM_REQUESTS).astype(int))
    return [rng.integers(0, LLM_DIMS["vocab"], n).astype(np.int32)
            for n in lens]


def named_launches(prof, names) -> dict:
    """Launches of each kernel by its symbol in a profiler trace."""
    evs = kernel_events(prof)
    return {k: sum(KERNEL_SYMBOL[k] in e.name for e in evs) for k in names}


def serve(nt, torch, requests, prof=None, new_tokens=LLM_NEW_TOKENS,
          mem=None, trace=False, **props):
    """appsrc ! tensor_llm ! tensor_sink with every request pushed at
    t=0. The launch counts are zeroed after start() (which prewarms) and
    read after the run; `mem` (a dict), when given, gets each card's
    memory_allocated right after start(); `trace` goes to the runner
    (the element's `_tracer` is then the run's Tracer). → (tokens by
    request id, element, seconds from the first push to the last token,
    launches by kernel)."""
    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.backends import paged_attn as pa
    from nnstreamer_tpu_torch.elements import AppSrc, TensorLLM, TensorSink
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
    from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorsSpec

    src = AppSrc(spec=TensorsSpec(tensors=(), format=TensorFormat.FLEXIBLE))
    llm = TensorLLM(**{**LLM_PROPS, **props})
    sink = TensorSink()
    pipe = nt.Pipeline("llm")
    for e in (src, llm, sink):
        pipe.add(e)
    pipe.link(src, llm)
    pipe.link(llm, sink)
    runner = nt.PipelineRunner(pipe, trace=trace).start()
    try:
        torch.cuda.synchronize()
        if mem is not None:
            mem.update({i: torch.cuda.memory_allocated(i)
                        for i in range(torch.cuda.device_count())})
        pa.paged_decode_attn.launches = 0
        pa.paged_prefill_attn.launches = 0
        kernels.quantize_rows.launches = 0
        kernels.flash_block_update.launches = 0
        kernels.flash_block_update.launches_tc = 0
        kernels.flash_block_update.launches_simt = 0
        with prof or nullcontext():
            if prof is not None:
                open_capture(torch)
            t0 = time.perf_counter()
            for i, p in enumerate(requests):
                src.push(TensorBuffer(tensors=(p,), pts=i, meta={"llm": {
                    "request_id": f"r{i}",
                    "max_new_tokens": new_tokens}}))
            src.end()
            runner.wait(600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if prof is not None:
                close_capture(torch)
        launches = {"paged_decode_attn": pa.paged_decode_attn.launches,
                    "paged_prefill_attn": pa.paged_prefill_attn.launches,
                    "quantize_rows": kernels.quantize_rows.launches,
                    # ring steps by variant, as KERNEL_SYMBOL names them
                    "flash_block_update":
                        kernels.flash_block_update.launches_tc,
                    "flash_block_update simt":
                        kernels.flash_block_update.launches_simt}
    finally:
        runner.stop()
    tokens = {}
    for b in sink.results:
        tokens.setdefault(b.meta["llm"]["request_id"], []).extend(
            int(t) for t in b.tensors[0])
    for i in range(len(requests)):
        check(len(tokens.get(f"r{i}", ())) == new_tokens,
              f"request r{i} got {len(tokens.get(f'r{i}', ()))} tokens")
    return tokens, llm, wall, launches


def check_f32_parity(torch, last_logits, requests, got, ref,
                     phase="8", tie=LLM_TIE) -> int:
    """One arm vs another, token for token. A flip where the reference's
    top-2 logits (`last_logits(seq)`: the model's logits after the
    (1, n) token sequence seq) are within tie * max|logit| is a
    near-tie and tolerated; any other flip fails. With tie None the
    flips are only reported. → flips."""
    ties = 0
    for i, p in enumerate(requests):
        a, b = got[f"r{i}"], ref[f"r{i}"]
        if a == b:
            continue
        k = next(j for j in range(len(a)) if a[j] != b[j])
        seq = torch.from_numpy(np.concatenate(
            [p, np.asarray(b[:k], np.int32)])[None])
        with torch.inference_mode():
            logits = last_logits(seq)
        top2 = torch.topk(logits, 2).values
        gap = (top2[0] - top2[1]).item()
        top = logits.abs().max().item()
        print(f"phase {phase}: r{i} (prompt {len(p)}): tokens differ at "
              f"step {k} ({a[k]} vs {b[k]}); reference top-2 gap "
              f"{gap:.3e} = {gap / top:.3e} of max|logit|" +
              (" (informational)" if tie is None else
               f", near-tie limit {tie * top:.3e}"))
        if tie is not None:
            check(gap <= tie * top, f"r{i}: the arms differ at step {k} "
                                    f"with a top-2 gap {gap:.3e}")
        ties += 1
    return ties


def paged_timing(torch, dev, requests, card) -> dict:
    """Each paged kernel at the serving shapes (bf16 q as in phase 9;
    decode: the 8 rows midway through their 64 new tokens, and one row
    alone at pos 1567; prefill: the third 512-token chunk of the longest
    prompt) → kernel, plain and SDPA-on-pre-gathered times, the bytes
    bound and, for decode, the CTAs the launch ran and how many were
    live."""
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.backends import paged_attn as pa

    rng = np.random.default_rng(2)
    nb, bs, n_kv, hd, mb, heads = 1025, 16, 8, 128, 128, 8
    pools = [torch.from_numpy(rng.standard_normal(
        (nb, bs, n_kv, hd)).astype(np.float32)).to(dev) for _ in range(2)]
    perm = rng.permutation(np.arange(1, nb))
    pos = np.array([len(p) + LLM_NEW_TOKENS // 2 for p in requests],
                   np.int32)
    tables = np.zeros((len(requests), mb), np.int32)
    for b, p in enumerate(pos):
        n = (len(requests[b]) + LLM_NEW_TOKENS - 1) // bs + 1
        tables[b, :n] = perm[b * mb:b * mb + n]
    t_tab, t_pos = (torch.from_numpy(a).to(dev) for a in (tables, pos))
    q_dec = torch.from_numpy(rng.standard_normal(
        (len(requests), heads, hd)).astype(np.float32)).to(dev, torch.bfloat16)
    s_c, pos0 = 512, 1024
    q_pre = torch.from_numpy(rng.standard_normal(
        (heads, s_c, hd)).astype(np.float32)).to(dev, torch.bfloat16)
    seq = t_tab[int(np.argmax([len(p) for p in requests]))]

    def gathered(table, rows):
        kv = [pl[table].reshape(rows, -1, n_kv, hd).transpose(1, 2)
              for pl in pools]
        return kv

    # decode yardstick: q (B, H, 1, hd) f32 against K/V gathered beforehand
    kd, vd = gathered(t_tab, len(requests))
    dmask = (torch.arange(mb * bs, device=dev)[None, :]
             <= t_pos[:, None])[:, None, None, :]
    qd32 = q_dec.float()[:, :, None]
    # one long row alone: the case the split over the KV axis is for
    pos1 = np.array([1567], np.int32)
    tab1 = np.zeros((1, mb), np.int32)
    tab1[0, :pos1[0] // bs + 1] = perm[:pos1[0] // bs + 1]
    t_tab1, t_pos1 = (torch.from_numpy(a).to(dev) for a in (tab1, pos1))
    q_one = q_dec[:1].contiguous()
    k1, v1 = gathered(t_tab1, 1)
    mask1 = (torch.arange(mb * bs, device=dev)
             <= t_pos1[0])[None, None, None, :]
    q1_32 = q_one.float()[:, :, None]
    kp, vp = gathered(seq, 1)
    pmask = (torch.arange(mb * bs, device=dev)[None, :]
             <= pos0 + torch.arange(s_c, device=dev)[:, None])[None, None]
    qp32 = q_pre.float()[None]
    kv_row = n_kv * hd * 4 * 2
    def dec_work(pos, tables, q):
        # each attended K/V row read once, q read, out written; 4 flops a
        # key and dim per query head
        nbytes = (int((pos + 1).sum()) * kv_row + q.numel() * 2
                  + q.numel() * 4 + tables.nbytes + pos.nbytes)
        return nbytes, int((pos + 1).sum()) * 4 * hd * heads

    dec_bytes, dec_ops = dec_work(pos, tables, q_dec)
    one_bytes, one_ops = dec_work(pos1, tab1, q_one)
    kv_tokens = min(pos0 + s_c, mb * bs)
    pre_bytes = (kv_tokens * kv_row + q_pre.numel() * 2 + q_pre.numel() * 4
                 + seq.numel() * 4)
    pre_ops = sum(pos0 + r + 1 for r in range(s_c)) * 4 * hd * heads
    # the prefill kernel's split-TF32 products: Q.K^T with a bf16 q (exact
    # in TF32) takes 2, P.V 3, each of half the flops
    pre_tf32_ops = pre_ops // 2 * (2 + 3)
    work = {
        "paged_decode_attn": (
            lambda: pa.paged_decode_attn(q_dec, *pools, t_tab, t_pos),
            lambda: pa.paged_decode_attn_plain(q_dec, *pools, t_tab, t_pos),
            lambda: F.scaled_dot_product_attention(qd32, kd, vd,
                                                   attn_mask=dmask),
            dec_bytes, dec_ops, None, f"B{len(requests)} rows at pos "
                                      f"{pos.tolist()}"),
        "paged_decode_attn B1": (
            lambda: pa.paged_decode_attn(q_one, *pools, t_tab1, t_pos1),
            lambda: pa.paged_decode_attn_plain(q_one, *pools, t_tab1,
                                               t_pos1),
            lambda: F.scaled_dot_product_attention(q1_32, k1, v1,
                                                   attn_mask=mask1),
            one_bytes, one_ops, None, "B1 row at pos 1567"),
        "paged_prefill_attn": (
            lambda: pa.paged_prefill_attn(q_pre, *pools, seq, pos0),
            lambda: pa.paged_prefill_attn_plain(q_pre, *pools, seq, pos0),
            lambda: F.scaled_dot_product_attention(qp32, kp, vp,
                                                   attn_mask=pmask),
            pre_bytes, pre_ops, pre_tf32_ops, f"S_c {s_c} at pos0 {pos0}"),
    }
    out = {}
    sms = sm_count(torch, dev)
    live_splits = lambda p, plan: sum(                       # noqa: E731
        max(1, -(-(int(x) // bs + 1) // plan.bps)) for x in p)
    for name, (kern, plain, lib, nbytes, ops, tf32_ops, shape) in \
            work.items():
        wrapper = getattr(pa, name.split()[0])
        launches = wrapper.launches
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f32_ms = ops / F32_FLOPS * 1e3
        # the bound of the design built: decode's f32 FMAs on the CUDA
        # cores, prefill's split-TF32 products on the tensor cores
        ops_ms = f32_ms if tf32_ops is None else tf32_ops / TF32_FLOPS * 1e3
        res = {"ms": device_ms_per_call(torch, kern, 20),
               "event_ms": event_ms_per_call(torch, kern, 200),
               "host_ms": host_ms_per_call(torch, kern, 200),
               "plain_ms": device_ms_per_call(torch, plain, 20),
               "plain_event_ms": event_ms_per_call(torch, plain, 50),
               "library_ms": device_ms_per_call(torch, lib, 20),
               "library_event_ms": event_ms_per_call(torch, lib, 50),
               "bytes": nbytes, "ops": ops, "tf32_ops": tf32_ops,
               "bytes_bound_ms": bytes_ms, "f32_bound_ms": f32_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        wrapper.launches = launches   # timing launches not counted
        out[name] = res
        extra = "" if tf32_ops is None else (
            f"; split TF32 {tf32_ops} flop at 495 TFLOP/s = "
            f"{ops_ms:.6f} ms (the kernel's)")
        if name.startswith("paged_decode_attn"):
            p = pos1 if name.endswith("B1") else pos
            plan = pa.decode_plan(len(p), heads, n_kv, hd, bs, mb, sms)
            res.update(splits=plan.splits, blocks_per_split=plan.bps,
                       ctas=len(p) * n_kv * plan.splits,
                       live_ctas=n_kv * live_splits(p, plan))
            extra = (f"; grid {len(p)} x {n_kv} x {plan.splits} splits of "
                    f"{plan.bps} blocks = {res['ctas']} CTAs on {sms} SMs, "
                    f"{res['live_ctas']} live")
        print(f"phase 10: {name} ({shape}, kv8 hd128 bs16, q bf16): "
              f"device {res['ms']:.5f} ms per launch (queued); per call "
              f"from Python, back to back: host {res['host_ms']:.5f} ms, "
              f"{res['event_ms']:.5f} ms by CUDA events; plain torch "
              f"{res['plain_ms']:.5f} ms device, {res['plain_event_ms']:.5f} "
              f"ms per call; SDPA on pre-gathered K/V, gather not timed, "
              f"{res['library_ms']:.5f} ms device, "
              f"{res['library_event_ms']:.5f} ms per call; bound "
              f"{res['bound_ms']:.6f} ms ({res['bound_by']}); bounds: bytes "
              f"{nbytes} B at 3.35 TB/s = {bytes_ms:.6f} ms, f32 CUDA cores "
              f"{ops} flop at 67 TFLOP/s = {f32_ms:.6f} ms{extra} [{card}]")
    return out


def llm_model(ctx) -> None:
    """Phase 8's model (LLM_DIMS, seed 0, registered as store://llm_full)
    and requests into `ctx`."""
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.models import transformer as tt
    from nnstreamer_tpu_torch.serving.store import get_store

    params = tt.init_params(**LLM_DIMS, seed=0)
    get_store().register("llm_full", ModelBundle(fn=None, params=params))
    ctx.update(params=params, requests=llm_requests())


def llm_phases(nt, torch, card, record, phases, ctx) -> list:
    """Phases 7-10. → kernel entries for the JSON line; the model's
    params, the requests and phase 9's bf16 tokens go into `ctx`."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.models import transformer as tt

    dev = torch.device("cuda", 0)
    errs = check_paged_kernels(torch, dev, record)
    phases.done("7 (paged kernels vs plain)")

    llm_model(ctx)
    params, requests = ctx["params"], ctx["requests"]
    print(f"phase 8: prompt lengths {[len(p) for p in requests]}, "
          f"{LLM_NEW_TOKENS} new tokens each")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got, _, wall_k, _ = serve(nt, torch, requests, dtype="float32")
    ref, _, wall_r, _ = serve(nt, torch, requests, dtype="float32",
                              paged_kernel="xla")
    p32 = on_device(params, dev)
    ties = check_f32_parity(
        torch, lambda seq: tt.apply_seq_kv(p32, seq.to(dev), n_heads=8)[0][
            0, -1], requests, got, ref) if got != ref else 0
    same = sum(got[k] == ref[k] for k in got)
    print(f"phase 8: f32 kernel arm vs torch reference arm: {same}/"
          f"{len(requests)} requests token-identical, {ties} near-tie "
          f"flips; {wall_k:.2f} s vs {wall_r:.2f} s")
    torch.backends.cudnn.allow_tf32 = True
    record["llm_f32"] = {"identical": same, "near_ties": ties}
    phases.done("8 (LLM f32 parity)")

    def attempt():
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        _, llm, wall_p, launches = serve(nt, torch, requests, prof=prof,
                                         dtype="bfloat16")
        named = named_launches(prof, launches)
        return launches, named, (prof, llm, wall_p, launches, named)

    (prof, llm, wall_p, launches, named), tries = profiled_agreement(
        "phase 9", attempt)
    ex = llm.engine.executor
    evs = kernel_events(prof)
    busy = sum(e.time_range.elapsed_us() for e in evs) / 1e6 / wall_p
    host = sorted(prof.key_averages(), key=lambda a: a.self_cpu_time_total,
                  reverse=True)[:8]
    print("phase 9: host time by op (profiled run, self CPU ms): " + "; ".join(
        f"{a.key} x{a.count} {a.self_cpu_time_total / 1e3:.1f}" for a in host))
    print(f"phase 9: bf16 (profiled): {ex.decode_steps} decode steps, "
          f"{ex.chunk_prefills} prefill chunks, kernel_invokes "
          f"{ex.kernel_invokes}; wrapper launches {launches}; profiler "
          f"launches by name {named} (profiled run {tries}); card busy "
          f"{100 * busy:.1f}% of {wall_p:.3f} s")
    check(launches["paged_decode_attn"] == 4 * ex.decode_steps > 0,
          "not 4 decode launches per decode step")
    check(launches["paged_prefill_attn"] == 4 * ex.chunk_prefills > 0,
          "not 4 prefill launches per chunk")
    ctx["bf16_tokens"], llm, wall, _ = serve(nt, torch, requests,
                                             dtype="bfloat16")
    lat = llm.engine.latency_ms()
    ntok = llm.engine.tokens_out
    serving = {"tokens": ntok, "seconds": wall, "tokens_per_s": ntok / wall,
               "ttft_p50_ms": float(np.percentile(lat["first_token"], 50)),
               "ttft_p99_ms": float(np.percentile(lat["first_token"], 99)),
               "itl_p50_ms": float(np.percentile(lat["inter_token"], 50)),
               "itl_p99_ms": float(np.percentile(lat["inter_token"], 99)),
               "decode_steps": llm.engine.executor.decode_steps,
               "prefill_chunks": llm.engine.executor.chunk_prefills,
               "kernel_invokes": dict(llm.engine.executor.kernel_invokes),
               "launches": launches, "profiler_launches": named,
               "busy_share_profiled": busy}
    print(f"phase 9: bf16: {ntok} tokens in {wall:.3f} s = "
          f"{serving['tokens_per_s']:.1f} tokens/s; time to first token "
          f"p50 {serving['ttft_p50_ms']:.3f} ms p99 "
          f"{serving['ttft_p99_ms']:.3f} ms; inter-token latency p50 "
          f"{serving['itl_p50_ms']:.3f} ms p99 {serving['itl_p99_ms']:.3f} "
          f"ms [{card}]")
    record["llm_bf16"] = serving
    phases.done("9 (LLM bf16 serving)")

    timing = paged_timing(torch, dev, requests, card)
    record["paged_timing"] = timing
    phases.done("10 (paged kernel timings)")
    return [{
        "name": name, "route": "cuda",
        "source": "nnstreamer_tpu_torch/backends/csrc/paged_attn.cu",
        "replaces": f"nnstreamer_tpu/backends/pallas_paged.py:{line}",
        "launches": launches[name], "max_abs_err": errs[key],
        "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"],
        "host_ms_per_call": timing[name]["host_ms"]}
        for name, key, line in (("paged_decode_attn", "decode", 69),
                                ("paged_prefill_attn", "prefill", 170))]


# -- slice 3: quantize_rows, flash attention, the forward, W8A8 serving -------

def bits_equal(torch, a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


def check_quantize_rows(torch, dev) -> float:
    """Phase 11: the kernel against its plain version, bit for bit, on
    every case → the largest abs error (int8 rows and scales)."""
    from nnstreamer_tpu_torch.backends import kernels

    rng = np.random.default_rng(3)
    bf16, f32 = torch.bfloat16, torch.float32

    def rows(m, k):
        # rows of very different magnitudes, one all-zero row
        x = rng.standard_normal((m, k)) * np.exp(rng.uniform(-4, 4, (m, 1)))
        if m > 1:
            x[m // 2] = 0.0
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    cases = [(f"M{m} K{k} {str(dt)[6:]}", rows(m, k).to(dt))
             for m in (1, 8, 512) for k in (1024, 4096) for dt in (bf16, f32)]
    cases += [("forward M16384 K1024 bfloat16", rows(16384, 1024).to(bf16)),
              ("forward M16384 K1024 float32", rows(16384, 1024)),
              ("ragged M5 K1024 bfloat16", rows(5, 1024).to(bf16)),
              ("ragged M17 K1024 float32", rows(17, 1024)),
              ("all-zero M3 K1024 float32",
               torch.zeros((3, 1024), device=dev)),
              ("K1001 float32 (not a multiple of 4)", rows(64, 1001)),
              ("K1003 bfloat16 (not a multiple of 8)",
               rows(64, 1003).to(bf16)),
              ("misaligned strided view M64 K1024 bfloat16",
               rows(64, 1040).to(bf16)[:, 3:1027]),
              ("expanded row (row stride 0) M64 K1024 float32",
               rows(1, 1024).expand(64, 1024)),
              ("overlapping rows (row stride 512) M64 K1024 bfloat16",
               torch.as_strided(rows(1, 64 * 512 + 512).to(bf16),
                                (64, 1024), (512, 1))),
              # the register path's longest rows (8 vectors a lane over
              # 16 warps), rows past it, ragged rows at the 48 KB edge of
              # shared memory without opting in, and the longest row
              ("K12288 float32 (registers, 8 vectors a lane)",
               rows(16, 12288)),
              ("K20000 float32 (shared-memory path)", rows(8, 20000)),
              ("K40000 bfloat16 (shared-memory path)",
               rows(8, 40000).to(bf16)),
              ("K12285 float32 (shared-memory path, 49140 B)",
               rows(8, 12285)),
              ("K24573 bfloat16 (shared-memory path, 49146 B)",
               rows(8, 24573).to(bf16)),
              ("K58104 float32 (shared-memory path, the longest row)",
               rows(4, 58104))]
    worst = 0.0
    for name, x in cases:
        q, s = kernels.quantize_rows(x)
        qp, sp = kernels.quantize_rows_plain(x)
        torch.cuda.synchronize()
        err = max((q.int() - qp.int()).abs().max().item(),
                  (s - sp).abs().max().item())
        same = bits_equal(torch, q, qp) and bits_equal(torch, s, sp)
        # the launcher's path for a contiguous x (views: after the
        # wrapper's copy, or strided rows the kernel reads in place)
        path = kernels.quantize_rows_layout(
            x.shape[1], x.dtype, x.is_contiguous() and x.data_ptr() % 16 == 0)
        print(f"phase 11: quantize_rows {name}: max_abs_err {err} bitwise "
              f"{'equal' if same else 'DIFFERENT'}; path for contiguous "
              f"rows: {path[0]}" + (f" ({path[1]} vectors a lane, {path[2]} "
                                   f"warps a row)" if path[1] else ""))
        check(same, f"quantize_rows {name} differs from its plain version")
        if name.startswith(("M", "forward")) or "(registers" in name:
            check(path[0] == "registers",
                  f"quantize_rows {name}: the main path's shape takes "
                  f"{path[0]}")
        if "shared-memory path" in name:
            check(path[0] == "shared memory", f"{name}: takes {path[0]}")
        worst = max(worst, err)
    return worst


def check_flash(torch, dev, record) -> float:
    """Phase 12: the flash kernel against its plain version → the largest
    abs error at the forward's shape (bf16 (8, 2048, 8, 128), causal)."""
    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.models.transformer import _expand_kv

    rng = np.random.default_rng(4)
    f32, bf16 = torch.float32, torch.bfloat16

    def rand(shape, dt):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dt)

    def qkv(b, s, h, d, dt):
        return [rand((b, s, h, d), dt) for _ in range(3)]

    gq = rand((2, 1024, 8, 128), f32)
    gk, gv = (_expand_kv(rand((2, 1024, 2, 128), f32), 8) for _ in range(2))
    fused = rand((2, 1024, 3 * 8 * 128), bf16)     # one qkv projection
    views = [fused[..., i * 1024:(i + 1) * 1024].reshape(2, 1024, 8, 128)
             for i in range(3)]
    cases = [("f32 (2,2048,8,128) causal", qkv(2, 2048, 8, 128, f32), True),
             ("f32 (2,2048,8,128) full", qkv(2, 2048, 8, 128, f32), False),
             ("bf16 (8,2048,8,128) causal (forward)",
              qkv(8, 2048, 8, 128, bf16), True),
             ("f32 GQA 8 on 2 kv heads expanded (2,1024,8,128) causal",
              [gq, gk, gv], True),
             ("bf16 strided q/k/v views of one qkv (2,1024,8,128) causal",
              views, True),
             ("f32 S640 (2,640,8,128) causal", qkv(2, 640, 8, 128, f32), True),
             # S a multiple of 8 but not of the kernel's 64-row/64-key
             # tiles: zero-filled keys past S, masked rows and stores
             ("f32 ragged S1000 (2,1000,8,128) causal",
              qkv(2, 1000, 8, 128, f32), True),
             ("f32 ragged S1000 (2,1000,8,128) full",
              qkv(2, 1000, 8, 128, f32), False),
             ("bf16 ragged S1000 (2,1000,8,128) causal",
              qkv(2, 1000, 8, 128, bf16), True),
             ("bf16 ragged S72 (2,72,8,128) full",
              qkv(2, 72, 8, 128, bf16), False),
             ("f32 D16 (2,256,4,16) full", qkv(2, 256, 4, 16, f32), False),
             # the tensor-core kernel's other paths: no mask at the
             # forward's shape, its 64- and 256-wide head dims, and head
             # dims it zero-pads (not multiples of 16)
             ("bf16 (8,2048,8,128) full", qkv(8, 2048, 8, 128, bf16), False),
             ("bf16 D64 (2,1024,8,64) causal", qkv(2, 1024, 8, 64, bf16),
              True),
             ("bf16 D256 (1,512,4,256) causal", qkv(1, 512, 4, 256, bf16),
              True),
             ("bf16 D40 (2,520,4,40) causal", qkv(2, 520, 4, 40, bf16), True),
             ("bf16 D24 (2,256,4,24) full", qkv(2, 256, 4, 24, bf16), False),
             ("bf16 long S (1,32768,8,128) causal",
              qkv(1, 32768, 8, 128, bf16), True)]
    main_err = None
    for name, (q, k, v), causal in cases:
        out = kernels.flash_attention(q, k, v, causal=causal)
        check(out.dtype == q.dtype and out.shape == q.shape,
              f"{name}: output {out.dtype} {tuple(out.shape)}")
        check(torch.isfinite(out).all().item(), f"{name}: non-finite output")
        s, n = q.shape[1], 1024
        if "long S" in name:
            # the plain version's S x S scores would need 34 GB: each
            # slice of query rows is held on its own
            slices = [("first 1024 rows", out[:, :n], kernels.
                       flash_attention_plain(q[:, :n], k, v, causal=True)),
                      ("last 1024 rows", out[:, -n:], kernels.
                       flash_attention_plain(q[:, -n:], k, v, causal=True,
                                             q_start=s - n))]
        else:
            slices = [("", out,
                       kernels.flash_attention_plain(q, k, v, causal=causal))]
        for part, got, ref in slices:
            label = f"{name} {part}".strip()
            diff = (got.float() - ref.float()).abs()
            ref = ref.float()
            top = ref.abs().max().item()
            rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
            if q.dtype == bf16:
                lim = FLASH_BF16_ULP * ref.abs() + FLASH_BF16_ROW * rms
                rule = "2^-7 * |plain| + 2^-6 * row rms"
            else:
                lim = torch.full_like(ref, PAGED_REL * top + PAGED_ABS)
                rule = f"{PAGED_REL * top + PAGED_ABS:.3e}"
            err = diff.max().item()
            excess = diff / lim
            ratio = excess.max().item()
            at = tuple(int(i) for i in np.unravel_index(
                excess.argmax().item(), excess.shape))
            print(f"phase 12: flash_attention {label}: max_abs_err {err:.3e}, "
                  f"largest |diff| / limit {ratio:.3f} (limit {rule}; "
                  f"max|plain| {top:.3e}, median row rms "
                  f"{rms.median().item():.3e}); at (b, s, h, d) "
                  f"{at}: kernel "
                  f"{got[at].item():.6e}, plain {ref[at].item():.6e}, row "
                  f"rms {rms[at[:3]].item():.3e}")
            check(ratio <= 1.0, f"flash_attention {label}: kernel differs "
                                f"from its plain version by {ratio:.3f} x "
                                f"its limit")
            record.setdefault("flash_errs", {})[label] = {
                "max_abs_err": err, "ratio_to_limit": ratio,
                "max_plain": top}
            if "(forward)" in name:
                main_err = err
        del q, k, v, out, slices, got, ref, diff, lim, rms
    torch.cuda.empty_cache()
    return main_err


def bf16_params(torch, params, dev):
    """Float params on dev in bf16, as the executor places them."""
    if isinstance(params, dict):
        return {k: bf16_params(torch, v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [bf16_params(torch, v, dev) for v in params]
    return params.to(dev, torch.bfloat16)


def forward_phase(torch, dev, card, record, params) -> dict:
    """Phase 13: apply_seq / apply_seq_w8a8 at full width. → the counted
    main-path launches of the flash and quantize_rows kernels."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.models import quant
    from nnstreamer_tpu_torch.models import transformer as tt

    vocab, heads = LLM_DIMS["vocab"], LLM_DIMS["n_heads"]
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, vocab, (FWD_B, FWD_S))).to(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    p32 = on_device(params, dev)
    with torch.inference_mode():
        flash = tt.apply_seq(p32, ids, n_heads=heads, attn="pallas")
        ref = tt.apply_seq(p32, ids, n_heads=heads, attn="xla")
    torch.cuda.synchronize()
    check(flash.shape == (FWD_B, FWD_S, vocab) and
          torch.isfinite(flash).all().item(), "f32 forward not finite")
    rel = ((flash - ref).abs().max() / ref.abs().max()).item()
    agree = (flash.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"phase 13: f32 apply_seq flash vs reference attention (TF32 "
          f"off): max |diff| / max |logit| = {rel:.3e} (limit "
          f"{FWD_F32_REL}), greedy tokens equal at {100 * agree:.3f}% of "
          f"{FWD_B * FWD_S} positions")
    check(rel <= FWD_F32_REL, f"f32 forward differs by {rel:.3e}")
    record["forward_f32"] = {"rel_err": rel, "argmax_agree": agree}
    del flash, ref
    p16 = bf16_params(torch, params, dev)
    pq = quant.quantize_transformer(p32)
    del p32
    runs = {
        "apply_seq flash": lambda: tt.apply_seq(
            p16, ids, n_heads=heads, dtype=torch.bfloat16, attn="pallas"),
        "apply_seq reference": lambda: tt.apply_seq(
            p16, ids, n_heads=heads, dtype=torch.bfloat16, attn="xla"),
        "apply_seq_w8a8 flash": lambda: quant.apply_seq_w8a8(
            pq, ids, n_heads=heads, dtype=torch.bfloat16, attn="pallas"),
    }
    with torch.inference_mode():
        out = {name: fn() for name, fn in runs.items()}   # warm-up
        torch.cuda.synchronize()
        for name, o in out.items():
            check(o.shape == (FWD_B, FWD_S, vocab) and
                  torch.isfinite(o).all().item(), f"bf16 {name} not finite")
        agree = (out["apply_seq_w8a8 flash"].argmax(-1) ==
                 out["apply_seq flash"].argmax(-1)).float().mean().item()
        del out
        # the counted main-path run: one bf16 and one W8A8 forward
        def attempt():
            kernels.flash_attention.launches = 0
            kernels.flash_attention.launches_tc = 0
            kernels.flash_attention.launches_simt = 0
            kernels.quantize_rows.launches = 0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                open_capture(torch)
                runs["apply_seq flash"]()
                runs["apply_seq_w8a8 flash"]()
                torch.cuda.synchronize()
                close_capture(torch)
            launches = {"flash_attention": kernels.flash_attention.launches,
                        "quantize_rows": kernels.quantize_rows.launches}
            variants = {"tc": kernels.flash_attention.launches_tc,
                        "simt": kernels.flash_attention.launches_simt}
            named = named_launches(prof, launches)
            return launches, named, (prof, launches, variants, named)

        (prof, launches, variants, named), tries = profiled_agreement(
            "phase 13", attempt)
        simt_named = named_launches(prof, ["flash_attention simt"])
        print(f"phase 13: one bf16 apply_seq + one apply_seq_w8a8 forward: "
              f"wrapper launches {launches}, flash by variant {variants}; "
              f"profiler launches by name {named} (flash: "
              f"{KERNEL_SYMBOL['flash_attention']}; profiled run {tries}), "
              f"{KERNEL_SYMBOL['flash_attention simt']} "
              f"{simt_named['flash_attention simt']}")
        check(launches == {"flash_attention": 8, "quantize_rows": 17},
              "not 4 flash launches per forward and 17 quantize_rows per "
              "W8A8 forward")
        check(variants == {"tc": 8, "simt": 0} and
              simt_named["flash_attention simt"] == 0,
              f"the bf16 forwards' flash launches did not all run on the "
              f"tensor-core kernel: {variants}, {simt_named}")
        by_name = {}
        for e in kernel_events(prof):
            row = by_name.setdefault(e.name[:60], [0, 0.0])
            row[0] += 1
            row[1] += e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        print("phase 13: kernel time by name over the two forwards: " +
              "; ".join(f"{name} x{n} {ms:.3f} ms" for name, (n, ms) in top))
        timing = {}
        for name, fn in runs.items():
            ms = event_ms_per_call(torch, fn, 5)
            timing[name] = {"ms": ms, "tokens_per_s": FWD_B * FWD_S / ms * 1e3}
            print(f"phase 13: bf16 {name} (B {FWD_B}, S {FWD_S}): {ms:.3f} ms "
                  f"per forward, {timing[name]['tokens_per_s']:.0f} tokens/s "
                  f"[{card}]")
    ratio = (timing["apply_seq_w8a8 flash"]["ms"] /
             timing["apply_seq flash"]["ms"])
    print(f"phase 13: W8A8 / bf16 forward time {ratio:.3f}; W8A8 greedy "
          f"tokens equal to bf16's at {100 * agree:.2f}% of positions")
    record["forward_bf16"] = {"timing": timing, "w8a8_over_bf16": ratio,
                              "w8a8_argmax_agree": agree,
                              "launches": launches,
                              "flash_launches_by_variant": variants}
    return launches


def arm_spread(torch, params, requests, steps=8,
               kernel_params=None) -> float:
    """Teacher-forced: the shortest and the longest request's prompt (in
    512-token chunks) and `steps` decode steps through a kernel-arm
    executor on `kernel_params` (default `params`) and a reference-arm
    executor on `params`, fed the same tokens → the largest max|diff| /
    max|logit| between the arms."""
    from nnstreamer_tpu_torch.backends.llm_exec import PagedLLMExecutor

    worst = 0.0
    for prompt in (min(requests, key=len), max(requests, key=len)):
        blocks = list(range(1, 1 + (len(prompt) + steps + 15) // 16))
        exs = [PagedLLMExecutor(p, n_heads=8, dtype=torch.float32,
                                block_size=16, num_blocks=len(blocks) + 1,
                                max_len=LLM_PROPS["max_len"], paged_kernel=k)
               for p, k in ((kernel_params or params, "pallas"),
                            (params, "xla"))]
        logits = [[ex.prefill_chunk(prompt[c0:c0 + 512], c0, blocks,
                                    bucket=512)
                   for c0 in range(0, len(prompt), 512)][-1] for ex in exs]
        for step in range(steps + 1):
            a, b = (np.asarray(lg, np.float32).ravel() for lg in logits)
            worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
            if step < steps:
                tok = int(np.argmax(b))
                logits = [ex.decode([tok], [blocks], [len(prompt) + step])
                          for ex in exs]
        for ex in exs:
            ex.close()
    return worst


def bf16_scales(torch, params):
    """W8A8 params with every `*_scale` rounded to bf16 (kept in f32):
    the fault the executor's placement guards against in a bf16 run."""
    if isinstance(params, dict):
        return {k: v.to(torch.bfloat16).float() if k.endswith("_scale")
                else bf16_scales(torch, v) for k, v in params.items()}
    if isinstance(params, list):
        return [bf16_scales(torch, v) for v in params]
    return params


def w8a8_serving_phase(nt, torch, dev, card, record, ctx) -> dict:
    """Phase 14: the W8A8 version of phase 8's model through tensor_llm.
    → the bf16 run's launches by wrapper."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.models import quant
    from nnstreamer_tpu_torch.serving.store import get_store

    qparams = quant.quantize_transformer(ctx["params"])
    get_store().register("llm_w8a8", ModelBundle(fn=None, params=qparams))
    requests = ctx["requests"]
    w8 = dict(model="store://llm_w8a8")
    qdev = on_device(qparams, dev)

    def last_logits(seq):
        return quant.apply_seq_w8a8(qdev, seq.to(dev), n_heads=8,
                                    attn="xla")[0, -1]

    torch.backends.cuda.matmul.allow_tf32 = False
    spread = arm_spread(torch, qparams, requests)
    control = arm_spread(torch, qparams, requests,
                         kernel_params=bf16_scales(torch, qparams))
    float_spread = arm_spread(torch, ctx["params"], requests)
    # the size of the quantization itself: W8A8 kernel arm, float
    # reference arm
    quant_spread = arm_spread(torch, ctx["params"], requests,
                              kernel_params=qparams)
    print(f"phase 14: f32, kernel arm vs reference arm teacher-forced "
          f"(prompt chunks and 8 decode steps of the shortest and longest "
          f"request, the same tokens fed to both): max |diff| / max |logit| "
          f"= {spread:.4e} W8A8 (limit {W8A8_SPREAD}); control, the kernel "
          f"arm's scales rounded to bf16: {control:.4e} (must exceed the "
          f"limit); float model {float_spread:.4e}; W8A8 kernel arm vs "
          f"float reference arm {quant_spread:.4e} (informational)")
    check(spread <= W8A8_SPREAD, f"W8A8 arms differ by {spread:.4e}")
    check(control > W8A8_SPREAD, f"the W8A8 spread limit {W8A8_SPREAD} does "
                                 f"not see bf16 scales ({control:.4e})")
    got, _, wall_k, launches = serve(nt, torch, requests, dtype="float32",
                                     **w8)
    ref, _, wall_r, _ = serve(nt, torch, requests, dtype="float32",
                              paged_kernel="xla", **w8)
    check(launches["quantize_rows"] > 0, "f32 W8A8 run made no quantize_rows "
                                         "launch")
    flips = check_f32_parity(torch, last_logits, requests, got, ref, "14",
                             None)
    same = sum(got[k] == ref[k] for k in got)
    print(f"phase 14: W8A8 f32 kernel arm vs torch reference arm "
          f"(informational): {same}/{len(requests)} requests "
          f"token-identical, {flips} flipped; {wall_k:.2f} s vs "
          f"{wall_r:.2f} s")
    # two short requests on the card and on the CPU (plain kernels, the
    # CPU's _int_mm), the same W8A8 params
    short = sorted(requests, key=len)[:2]
    # (the CPU's int8 product takes ~60 ms per 8M weights: few tokens)
    lite = dict(new_tokens=8, prewarm=0, **w8)
    card_tok, *_ = serve(nt, torch, short, dtype="float32", **lite)
    env = "NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR"
    old = os.environ.get(env)
    os.environ[env] = "cpu"
    try:
        cpu_tok, cpu_llm, wall_c, _ = serve(nt, torch, short, dtype="float32",
                                            **lite)
    finally:
        if old is None:
            os.environ.pop(env)
        else:
            os.environ[env] = old
    check(cpu_llm.engine.executor.device.type == "cpu", "CPU run not on CPU")
    cpu_ties = check_f32_parity(torch, last_logits, short, card_tok,
                                cpu_tok, "14")
    print(f"phase 14: W8A8 f32 card vs CPU (prompts {[len(p) for p in short]}"
          f", 8 new tokens): {sum(card_tok[k] == cpu_tok[k] for k in cpu_tok)}"
          f"/2 token-identical, {cpu_ties} near-tie flips (limit {LLM_TIE} "
          f"of max|logit|); CPU {wall_c:.2f} s")
    torch.backends.cuda.matmul.allow_tf32 = True
    record["w8a8_f32"] = {"identical": same, "flips": flips,
                          "cpu_near_ties": cpu_ties, "arm_spread": spread,
                          "control_spread_bf16_scales": control,
                          "float_arm_spread": float_spread,
                          "w8a8_vs_float_spread": quant_spread}

    def attempt():
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        _, llm, wall_p, launches = serve(nt, torch, requests, prof=prof,
                                         dtype="bfloat16", **w8)
        named = named_launches(prof, launches)
        return launches, named, (prof, llm, wall_p, launches, named)

    (prof, llm, wall_p, launches, named), tries = profiled_agreement(
        "phase 14", attempt)
    ex = llm.engine.executor
    busy = sum(e.time_range.elapsed_us() for e in kernel_events(prof)) \
        / 1e6 / wall_p
    print(f"phase 14: W8A8 bf16 (profiled): {ex.decode_steps} decode steps, "
          f"{ex.chunk_prefills} prefill chunks; wrapper launches {launches}; "
          f"profiler launches by name {named} (profiled run {tries}); card "
          f"busy {100 * busy:.1f}% of {wall_p:.3f} s")
    check(launches["quantize_rows"] ==
          17 * (ex.decode_steps + ex.chunk_prefills) > 0,
          "not 17 quantize_rows launches per decode step and per chunk")
    check(launches["paged_decode_attn"] == 4 * ex.decode_steps > 0 and
          launches["paged_prefill_attn"] == 4 * ex.chunk_prefills > 0,
          "not 4 paged launches per decode step and per chunk")
    tok, llm, wall, _ = serve(nt, torch, requests, dtype="bfloat16", **w8)
    lat = llm.engine.latency_ms()
    ntok = llm.engine.tokens_out
    f16 = ctx["bf16_tokens"]
    agree = np.mean([a == b for k in tok for a, b in zip(tok[k], f16[k])])
    serving = {"tokens": ntok, "seconds": wall, "tokens_per_s": ntok / wall,
               "ttft_p50_ms": float(np.percentile(lat["first_token"], 50)),
               "ttft_p99_ms": float(np.percentile(lat["first_token"], 99)),
               "itl_p50_ms": float(np.percentile(lat["inter_token"], 50)),
               "itl_p99_ms": float(np.percentile(lat["inter_token"], 99)),
               "decode_steps": llm.engine.executor.decode_steps,
               "prefill_chunks": llm.engine.executor.chunk_prefills,
               "launches": launches, "profiler_launches": named,
               "busy_share_profiled": busy,
               "tokens_equal_to_float_bf16": float(agree)}
    print(f"phase 14: W8A8 bf16: {ntok} tokens in {wall:.3f} s = "
          f"{serving['tokens_per_s']:.1f} tokens/s; time to first token "
          f"p50 {serving['ttft_p50_ms']:.3f} ms p99 "
          f"{serving['ttft_p99_ms']:.3f} ms; inter-token latency p50 "
          f"{serving['itl_p50_ms']:.3f} ms p99 {serving['itl_p99_ms']:.3f} "
          f"ms; tokens equal to the float bf16 run's at {100 * agree:.1f}% "
          f"of positions (informational) [{card}]")
    record["w8a8_bf16"] = serving
    return launches


def slice3_timing(torch, dev, card) -> dict:
    """Phase 15: device time per launch (CUDA events, calls queued) and
    per call (CUDA events, as Python makes them) of quantize_rows and
    flash_attention at the main path's shapes, beside their plain
    versions', SDPA's for flash, and their bounds."""
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.backends import kernels

    rng = np.random.default_rng(6)
    out = {}

    def measure(key, kern, plain, lib, nbytes, ops, peak, iters):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / peak * 1e3
        symbol = KERNEL_SYMBOL[key.split()[0] +
                               (" simt" if " f32 " in key else "")]
        prof_ms, kept = profiled_ms_per_launch(torch, kern, symbol, iters)
        res = {"ms": device_ms_per_call(torch, kern, iters),
               "profiler_ms": prof_ms, "profiler_records": kept,
               "event_ms": event_ms_per_call(torch, kern, iters),
               "host_ms": host_ms_per_call(torch, kern,
                                           200 if iters >= 20 else iters),
               "plain_ms": None, "plain_event_ms": None, "library_ms": None,
               "library_event_ms": None,
               "bytes": nbytes, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        if plain is not None:
            res["plain_ms"] = device_ms_per_call(torch, plain, iters)
            res["plain_event_ms"] = event_ms_per_call(torch, plain, iters)
        if lib is not None:
            res["library_ms"] = device_ms_per_call(torch, lib, iters)
            res["library_event_ms"] = event_ms_per_call(torch, lib, iters)
        out[key] = res
        fmt = (lambda v: "not measured" if v is None else f"{v:.5f} ms")
        print(f"phase 15: {key}: device {res['ms']:.5f} ms per launch "
              f"(queued), {fmt(prof_ms)} per launch by the profiler "
              f"({kept} of {iters} records kept); per call from Python, back "
              f"to back: host {res['host_ms']:.5f} ms, {res['event_ms']:.5f} "
              f"ms by CUDA events; plain torch {fmt(res['plain_ms'])} "
              f"device, {fmt(res['plain_event_ms'])} per call; library "
              f"{fmt(res['library_ms'])} device, "
              f"{fmt(res['library_event_ms'])} per call; bound "
              f"{res['bound_ms']:.6f} ms "
              f"({res['bound_by']}: {nbytes} B at 3.35 TB/s, {ops} op at "
              f"{peak / 1e12:.0f} TOP/s) [{card}]")

    fa = kernels.flash_attention
    launches = (kernels.quantize_rows.launches, fa.launches, fa.launches_tc,
                fa.launches_simt)
    # the launch floor: a kernel that returns at once (ATen's spin kernel
    # for 0 cycles), queued as the kernels below are
    floor_ms = device_ms_per_call(torch, lambda: torch.cuda._sleep(0), 50)
    out["launch floor"] = {"ms": floor_ms}
    print(f"phase 15: launch floor (torch.cuda._sleep(0), a kernel that "
          f"returns at once): device {floor_ms:.5f} ms per launch (queued) "
          f"[{card}]")
    for m, k in ((8, 1024), (8, 4096), (512, 1024), (512, 4096),
                 (16384, 1024)):
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(
            np.float32)).to(dev, torch.bfloat16)
        # read bf16, write int8 and one f32 scale per row; abs, max,
        # divide, round, clip per element on the f32 units
        key = f"quantize_rows M{m} K{k} bf16"
        measure(key, lambda x=x: kernels.quantize_rows(x),
                lambda x=x: kernels.quantize_rows_plain(x), None,
                m * k * 3 + m * 4, 5 * m * k, F32_FLOPS, 50)
        r = out[key]
        print(f"phase 15: {key}: {r['ms']:.5f} ms = {r['ms'] / floor_ms:.3f}"
              f" x the launch floor, {r['bound_ms'] / r['ms']:.3f} of its "
              f"bound [{card}]")
    for b, s in ((8, 2048), (1, 32768)):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, s, 8, 128)).astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        # causal: S(S+1)/2 (query, key) pairs, 2 * 128 flops each in
        # q.k and in p.v
        pairs = b * 8 * s * (s + 1) // 2
        long = s > 4096
        measure(f"flash_attention ({b},{s},8,128) bf16 causal",
                lambda q=q, k=k, v=v: kernels.flash_attention(
                    q, k, v, causal=True),
                # the plain version's (B, H, S, S) f32 scores would need
                # 34 GB at the long shape: not measured there
                None if long else (lambda q=q, k=k, v=v:
                                   kernels.flash_attention_plain(
                                       q, k, v, causal=True)),
                lambda qt=qt, kt=kt, vt=vt: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True),
                4 * b * s * 8 * 128 * 2, pairs * 4 * 128, BF16_FLOPS,
                5 if long else 20)
        if not long:
            # the f32 kernel on the CUDA cores at the forward's shape,
            # beside SDPA in f32 with TF32 off
            q32, k32, v32 = (t.float() for t in (q, k, v))
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            measure(f"flash_attention ({b},{s},8,128) f32 causal",
                    lambda: kernels.flash_attention(q32, k32, v32,
                                                    causal=True),
                    None, lambda: F.scaled_dot_product_attention(
                        q32.transpose(1, 2), k32.transpose(1, 2),
                        v32.transpose(1, 2), is_causal=True),
                    4 * b * s * 8 * 128 * 4, pairs * 4 * 128, F32_FLOPS, 5)
            torch.backends.cuda.matmul.allow_tf32 = tf32
            del q32, k32, v32
        del q, k, v, qt, kt, vt
    # the int8 product (torch._int_mm, not a kernel of the port) at the
    # W8A8 forward's wqkv shape, with the weight row- and column-major
    xq = torch.randint(-127, 128, (16384, 1024), dtype=torch.int8,
                       device=dev)
    wq = torch.randint(-127, 128, (1024, 3072), dtype=torch.int8,
                       device=dev)
    int_mm = {layout: device_ms_per_call(
        torch, lambda w=w: torch._int_mm(xq, w), 20)
        for layout, w in (("row-major", wq),
                          ("column-major", wq.t().contiguous().t()))}
    out["int_mm 16384x1024x3072"] = int_mm
    print(f"phase 15: torch._int_mm 16384x1024x3072 int8: weight row-major "
          f"{int_mm['row-major']:.5f} ms, column-major "
          f"{int_mm['column-major']:.5f} ms (queued) [{card}]")
    (kernels.quantize_rows.launches, fa.launches, fa.launches_tc,
     fa.launches_simt) = launches           # timing launches not counted
    return out


def slice3_phases(nt, torch, card, record, phases, ctx) -> list:
    """Phases 11-15. → kernel entries for the JSON line."""
    dev = torch.device("cuda", 0)
    q_err = check_quantize_rows(torch, dev)
    phases.done("11 (quantize_rows vs plain)")
    f_err = check_flash(torch, dev, record)
    phases.done("12 (flash_attention vs plain)")
    fwd = forward_phase(torch, dev, card, record, ctx["params"])
    phases.done("13 (full-sequence forward)")
    serving = w8a8_serving_phase(nt, torch, dev, card, record, ctx)
    phases.done("14 (W8A8 serving)")
    timing = slice3_timing(torch, dev, card)
    record["slice3_timing"] = timing
    phases.done("15 (quantize_rows and flash timings)")
    qt = timing["quantize_rows M16384 K1024 bf16"]
    ft = timing["flash_attention (8,2048,8,128) bf16 causal"]
    return [{
        "name": "quantize_rows", "route": "cuda",
        "source": "nnstreamer_tpu_torch/backends/csrc/quantize_rows.cu",
        "replaces": "nnstreamer_tpu/backends/pallas_ops.py:57",
        "launches": serving["quantize_rows"], "max_abs_err": q_err,
        "ms": qt["ms"], "plain_ms": qt["plain_ms"], "bound_ms": qt["bound_ms"],
        "bound_by": qt["bound_by"], "library_ms": None,
        "host_ms_per_call": qt["host_ms"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "nnstreamer_tpu_torch/backends/csrc/flash_attn_tc.cu",
        "replaces": "nnstreamer_tpu/backends/pallas_ops.py:335 "
                    "(flash_attention) and :286 (_flash_attention_kgrid)",
        "launches": fwd["flash_attention"], "max_abs_err": f_err,
        "ms": ft["ms"], "plain_ms": ft["plain_ms"], "bound_ms": ft["bound_ms"],
        "bound_by": ft["bound_by"], "library_ms": ft["library_ms"],
        "host_ms_per_call": ft["host_ms"]}]


# -- slice 5: clamp_scale, detection, pose, composite ------------------------

NORM_OPT = "typecast:float32,add:-127.5,div:127.5"
D_DEC = ("tensor_decoder mode=bounding_boxes option1=mobilenet-ssd "
         "option3=0.5:0.5 option4=300:300")
D_MODES = {"D compact-4": "device=compact max_in_flight=4",
           "D compact-1": "device=compact max_in_flight=1",
           "D device": "device=true",
           "D host": "max_in_flight=1"}
P_DEC = "tensor_decoder mode=pose_estimation option1=257:257 option4=0.0"
P_MODES = {"P host": "max_in_flight=4",
           "P device": "device=true option2=257:257"}
#: SSD thresholds of D's decoder (option3)
SCORE_THRESH, IOU_THRESH = 0.5, 0.5
#: f32 card vs CPU: a flip of a kept detection or keypoint is a near-tie
#: when its margin (score to threshold, score to the other candidate's,
#: IoU to the NMS threshold, top-2 heatmap gap) is within this share of
#: the raw output's max |.| (CPU_TOLERANCE; a sigmoid moves a score by at
#: most 1/4 of its logit's change)
FLIP_SHARE = CPU_TOLERANCE
SLICE5_FRAMES = 8


def ingest(dims: str) -> str:
    """bench.py's uint8 ingest (_ingest): appsrc, then the normalize."""
    return (f"appsrc name=src dims={dims} types=uint8 ! tensor_transform "
            f"mode=arithmetic option={NORM_OPT} ! ")


def d_head(dtype="bfloat16", accel="") -> str:
    acc = f" accelerator={accel}" if accel else ""
    return (ingest("3:300:300:1") + f"tensor_filter name=f "
            f"model=zoo://ssd_mobilenet?dtype={dtype}{acc} ! ")


def p_head(dtype="bfloat16", accel="") -> str:
    acc = f" accelerator={accel}" if accel else ""
    return (ingest("3:257:257:1") + "tensor_transform mode=clamp "
            f"option=-1.0:1.0 ! tensor_filter name=f "
            f"model=zoo://posenet?dtype={dtype}{acc} ! ")


def u8_frames(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, np.uint8) for _ in range(n)]


def push_all(nt, pipe, frames, timeout=600):
    """Start `pipe`, push every frame (a tuple is one multi-tensor
    buffer), end, wait; → the pipeline."""
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    runner = nt.PipelineRunner(pipe).start()
    src = pipe.get("src")
    try:
        for i, f in enumerate(frames):
            src.push(TensorBuffer.of(*f, pts=i) if isinstance(f, tuple)
                     else TensorBuffer.of(f, pts=i))
        src.end()
        runner.wait(timeout)
    finally:
        runner.stop()
    return pipe


def run_desc(nt, desc, frames):
    return push_all(nt, nt.parse_launch(desc), frames).get("out").results


def composite_pipe(nt, model="zoo://mobilenet_v2?dtype=bfloat16",
                   sink="fakesink"):
    """bench.py's config 4 (_build_composite): a two-tensor uint8 appsrc,
    tensor_demux, per branch the normalize and a MobileNetV2 sharing one
    model by shared_tensor_filter_key, tensor_mux nosync."""
    from nnstreamer_tpu_torch.elements import (
        FakeSink, TensorDemux, TensorFilter, TensorMux, TensorSink,
        TensorTransform)
    from nnstreamer_tpu_torch.elements.sources import AppSrc
    from nnstreamer_tpu_torch.tensor.dtypes import DType
    from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

    pipe = nt.Pipeline("composite")
    frame = TensorInfo((1, 224, 224, 3), DType.UINT8)
    src = AppSrc(spec=TensorsSpec.of(frame, frame), name="src")
    demux = TensorDemux(name="dm")
    ta = TensorTransform(name="ta", mode="arithmetic", option=NORM_OPT)
    tb = TensorTransform(name="tb", mode="arithmetic", option=NORM_OPT)
    fa = TensorFilter(name="fa", model=model, shared_tensor_filter_key="smoke")
    fb = TensorFilter(name="fb", model=model, shared_tensor_filter_key="smoke")
    mux = TensorMux(name="mx", sync_mode="nosync")
    out = (FakeSink(name="sink", sync_device=True) if sink == "fakesink"
           else TensorSink(name="out"))
    for e in (src, demux, ta, tb, fa, fb, mux, out):
        pipe.add(e)
    pipe.link(src, demux)
    pipe.link(demux, ta, 0, 0)
    pipe.link(demux, tb, 1, 0)
    pipe.link(ta, fa)
    pipe.link(tb, fb)
    pipe.link(fa, mux, 0, 0)
    pipe.link(fb, mux, 0, 1)
    pipe.link(mux, out)
    return pipe


def check_clamp_scale(torch, dev, card) -> dict:
    """Phase 16: clamp_scale against its plain version on the card, bit
    for bit (NaN positions compared, not payloads), then its device time
    at P's frame shape and at 16M elements beside its bound, its plain
    version's time and torch.clamp's."""
    from nnstreamer_tpu_torch.backends import kernels

    rng = np.random.default_rng(16)
    special = torch.tensor([math.nan, math.inf, -math.inf, -0.0, 0.0,
                            1e-30, -1e-30, 3.0, -3.0])

    def spread(n):
        x = rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))
        return torch.cat([special, torch.from_numpy(x.astype(np.float32))])

    frame = torch.from_numpy(rng.uniform(-1.2, 1.2, (1, 257, 257, 3)).astype(
        np.float32)).to(dev)
    big = spread(1 << 24).to(dev)
    cases = {"P frame f32 (1,257,257,3)": (frame, (-1.0, 1.0, 1.0, 0.0)),
             "16M f32 affine": (big, (-1e9, 1e9, 3.0000001, 1e-7)),
             "strided f32 view": (big[:1 << 20].view(1024, 1024)[:, 3:900:3],
                                  (-2.0, 2.0, 0.5, 0.25))}
    for dt in (torch.bfloat16, torch.float16):
        x = spread(1 << 20)
        lim = 6e4 if dt == torch.float16 else 1e30
        x = x.clamp(-lim, lim).to(dt).to(dev)
        for label, args in (("affine", (-1.3, 2.7, 1.1, 0.3)),
                            ("offset +0", (-5.0, 5.0, -2.5, 0.0)),
                            ("unrepresentable bounds",
                             (-1.00390625000001, 1.0004882812500002, 0.1,
                              1e-7))):
            cases[f"1M {str(dt).split('.')[-1]} {label}"] = (x, args)
        cases[f"strided {str(dt).split('.')[-1]} view"] = (
            x[:1 << 16].view(256, 256).t(), (-1.0, 1.0, 2.0, -0.5))
    for dt in (torch.uint8, torch.int16, torch.int32):
        info = torch.iinfo(dt)
        x = torch.from_numpy(rng.integers(info.min, info.max, 1 << 20,
                                          endpoint=True)).to(dt).to(dev)
        cases[f"1M {str(dt).split('.')[-1]} clamp"] = (x, (10.5, 100.5,
                                                           1.0, 0.0))
    # the contiguous kernel's edges: fewer elements than one CTA's
    # vectors or than one vector (the last CTA's tail alone), a length
    # that is not a multiple of the vector, and bases that are not 16-byte
    # aligned (one element a thread)
    flat_frame = frame.view(-1)
    cases.update({
        "f32 n 100 (below one CTA's work)": (big[:100], (-1.0, 1.0, 2.0,
                                                           0.5)),
        "f32 n 3 (below one vector)": (big[:3], (-1.0, 1.0, 1.0, 0.0)),
        "f32 n 4099 (not a multiple of the vector)": (big[:4099],
                                                      (-2.0, 2.0, 0.5, 0.0)),
        "f32 P frame from a 4-byte-misaligned base": (flat_frame[1:],
                                                       (-1.0, 1.0, 1.0, 0.0)),
        "bf16 2-byte-misaligned base, n 65535":
            (cases["1M bfloat16 affine"][0][1:1 << 16], (-1.3, 2.7, 1.1,
                                                          0.3)),
        "u8 n 1M + 5 (tail of 5)": (torch.from_numpy(rng.integers(
            0, 256, (1 << 20) + 5)).to(torch.uint8).to(dev), (10.5, 200.5,
                                                              1.0, 0.0)),
        "f64 1M affine": (spread(1 << 20).double().to(dev),
                          (-1e9, 1e9, 3.0000001, 1e-7)),
    })
    errs = {}
    for name, (x, args) in cases.items():
        got = kernels.clamp_scale(x, *args)
        ref = kernels.clamp_scale_plain(x, *args)
        torch.cuda.synchronize()
        check(got.dtype == x.dtype and got.shape == x.shape,
              f"clamp_scale {name}: dtype/shape {got.dtype} {got.shape}")
        if got.dtype.is_floating_point:
            nan_g, nan_r = torch.isnan(got), torch.isnan(ref)
            check(torch.equal(nan_g, nan_r),
                  f"clamp_scale {name}: NaN in other places than the plain "
                  f"version's")
            bits = {2: torch.int16, 4: torch.int32,
                8: torch.int64}[got.element_size()]
            same = torch.equal(got[~nan_g].view(bits), ref[~nan_r].view(bits))
            err = (got[~nan_g].double() - ref[~nan_r].double()).abs()
            err = err[torch.isfinite(err)]
            err = err.max().item() if err.numel() else 0.0
        else:
            same = torch.equal(got, ref)
            err = (got.long() - ref.long()).abs().max().item()
        errs[name] = err
        print(f"phase 16: clamp_scale {name}: max_abs_err {err} bitwise "
              f"{'equal' if same else 'DIFFERENT'}")
        check(same, f"clamp_scale {name} differs from its plain version "
                    f"(max abs err {err})")
    launches = kernels.clamp_scale.launches
    timing = {}
    for key, x, iters in (("P frame", frame, 200), ("16M", big, 50)):
        n = x.numel()
        nbytes = 2 * n * x.element_size()
        # two compares, a select and an FMA per element on the f32 units
        ops = 4 * n
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_FLOPS * 1e3
        kern = (lambda: kernels.clamp_scale(x, -1.0, 1.0))
        lib = (lambda: torch.clamp(x, -1.0, 1.0))
        # in turns: library, kernel, kernel, library
        turns = [device_ms_per_call(torch, fn, iters)
                 for fn in (lib, kern, kern, lib)]
        prof_ms, kept = profiled_ms_per_launch(
            torch, kern, "nns_clamp_scale_kernel", iters)
        lib_prof_ms, lib_kept = profiled_ms_per_launch(torch, lib, "clamp",
                                                       iters)
        res = {
            "ms": (turns[1] + turns[2]) / 2, "turns_ms": turns,
            "profiler_ms": prof_ms, "profiler_records": kept,
            "event_ms": event_ms_per_call(torch, kern, iters),
            "host_ms": host_ms_per_call(torch, kern, iters),
            "plain_ms": device_ms_per_call(
                torch, lambda: kernels.clamp_scale_plain(x, -1.0, 1.0), iters),
            "library_ms": (turns[0] + turns[3]) / 2,
            "library_event_ms": event_ms_per_call(torch, lib, iters),
            "library_host_ms": host_ms_per_call(torch, lib, iters),
            "library_profiler_ms": lib_prof_ms,
            "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        timing[key] = res
        fmt = (lambda v: "not measured" if v is None else f"{v:.5f} ms")
        print(f"phase 16: clamp_scale {key} ({n} f32): device "
              f"{res['ms']:.5f} ms per launch (queued; in turns torch.clamp, "
              f"kernel, kernel, torch.clamp: "
              f"{', '.join(f'{t:.5f}' for t in turns)}), "
              f"{fmt(prof_ms)} by the profiler ({kept} records; torch.clamp "
              f"{fmt(lib_prof_ms)}, {lib_kept} records), "
              f"per call from Python, back to back: host "
              f"{res['host_ms']:.5f} ms, {res['event_ms']:.5f} ms by CUDA "
              f"events (torch.clamp: host {res['library_host_ms']:.5f} ms, "
              f"{res['library_event_ms']:.5f} ms by events); plain torch "
              f"{res['plain_ms']:.5f} ms; torch.clamp {res['library_ms']:.5f} "
              f"ms; bound {res['bound_ms']:.6f} ms ({nbytes} B at 3.35 TB/s) "
              f"[{card}]")
    kernels.clamp_scale.launches = launches     # timing launches not counted
    return {"errs": errs, "timing": timing,
            "main_err": errs["P frame f32 (1,257,257,3)"]}


def measure_cell(nt, torch, pipe, frame, lag, n_lat, n_fps, **runner_kw):
    """One cell in one pipeline ending in a tensor_sink named out, run
    by PipelineRunner(pipe, **runner_kw): start
    it (model build and negotiation outside every measurement), push
    SLICE5_FRAMES frames inside one profiler capture opened with
    open_capture (the clamp_scale count zeroed just before, read just
    after), then n_lat closed-loop frames (push one, wait for it at the
    sink; only where the decoder holds no frame back, lag 0), then n_fps
    frames pushed at once up to EOS for frames/s. → (results, kernel
    records)."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    arrived = threading.Event()
    count = [0]

    def on_buf(buf):
        count[0] += 1
        arrived.set()

    def wait_for(n):
        deadline = time.monotonic() + 300
        while count[0] < n:
            check(time.monotonic() < deadline,
                  f"{count[0]} of {n} frames reached the sink in 300 s")
            time.sleep(0.0005)

    pipe.get("out").set_props(new_data=on_buf, collect=False)
    buf = (TensorBuffer.of(*frame) if isinstance(frame, tuple)
           else TensorBuffer.of(frame))
    runner = nt.PipelineRunner(pipe, **runner_kw).start()
    src = pipe.get("src")
    res = {"fused_chains": runner.fused_chains()}
    try:
        kernels.clamp_scale.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_capture(torch)
            for _ in range(SLICE5_FRAMES):
                src.push(buf)
            wait_for(SLICE5_FRAMES - lag)
            torch.cuda.synchronize()
            close_capture(torch)
        res["clamp_launches"] = kernels.clamp_scale.launches
        lat = []
        for _ in range(n_lat if not lag else 0):
            arrived.clear()
            t0 = time.perf_counter()
            src.push(buf)
            check(arrived.wait(60), "no frame came back within 60 s")
            lat.append((time.perf_counter() - t0) * 1e3)
        seen = count[0]
        t0 = time.perf_counter()
        for _ in range(n_fps):
            src.push(buf)
        src.end()
        runner.wait(600)
        res["fps"] = (count[0] - seen) / (time.perf_counter() - t0)
    finally:
        runner.stop()
    total = SLICE5_FRAMES + len(lat) + n_fps
    check(count[0] == total, f"sink saw {count[0]} of {total} frames")
    res["lat"] = lat
    return res, kernel_events(prof)


def slice5_timings(nt, torch, card, record) -> dict:
    """Phase 17: D (4 decoder modes), P (host with max_in_flight 4 and 1,
    device=true) and C at full width in bf16, each cell one pipeline
    (measure_cell): kernels and kernel ms per frame, the clamp's launches
    in P by wrapper and by name, latency p50/p99 where the decoder emits
    each frame at once, frames/s, the card's busy share."""
    fd = u8_frames((1, 300, 300, 3), 1, 1)[0]
    fp = u8_frames((1, 257, 257, 3), 1, 2)[0]
    fc = tuple(u8_frames((1, 224, 224, 3), 2, 3))
    sink = "tensor_sink name=out"
    cells = {name: (lambda mode=mode: nt.parse_launch(
        d_head() + f"{D_DEC} {mode} ! {sink}"), fd, mode)
        for name, mode in D_MODES.items()}
    p_modes = dict(P_MODES)
    p_modes["P host-1"] = "max_in_flight=1"
    cells.update({name: (lambda mode=mode: nt.parse_launch(
        p_head() + f"{P_DEC} {mode} ! {sink}"), fp, mode)
        for name, mode in p_modes.items()})
    cells["C"] = (lambda: composite_pipe(nt, sink="tensor_sink"), fc, "")
    out = {}
    for name, (build, frame, mode) in cells.items():
        lag = (int(mode.split("max_in_flight=")[1].split()[0]) - 1
               if "max_in_flight" in mode else 0)
        # D host: numpy NMS over ~1,900 boxes, ~5 frames/s
        slow = name == "D host"

        def attempt():
            r, evs = measure_cell(nt, torch, build(), frame, lag,
                                  10 if slow else 20, 8 if slow else 40)
            named = sum(CLAMP_SYMBOL in e.name for e in evs)
            return ({"clamp_scale": r["clamp_launches"]},
                    {"clamp_scale": named}, (r, evs, named))

        (r, evs, clamp_named), tries = profiled_agreement(
            f"phase 17: {name}", attempt)
        kern = len(evs) / SLICE5_FRAMES
        dev_ms = sum(e.time_range.elapsed_us() for e in evs) / 1e3 \
            / SLICE5_FRAMES
        nms = sum("addcmul" in e.name for e in evs) / SLICE5_FRAMES
        res = {"kernels_per_frame": kern, "device_ms_per_frame": dev_ms,
               "fps": r["fps"], "device_busy_share": dev_ms * r["fps"] / 1e3,
               "clamp_launches": r["clamp_launches"],
               "clamp_kernels_by_name": clamp_named,
               "profiled_runs": tries,
               "addcmul_kernels_per_frame": nms}
        if name.startswith("P"):
            check(r["clamp_launches"] == SLICE5_FRAMES,
                  f"{name}: clamp_scale launched {r['clamp_launches']} times "
                  f"for {SLICE5_FRAMES} frames, expected one per frame")
        else:
            check(r["clamp_launches"] == 0, f"{name}: clamp launched off P")
        if r["lat"]:
            res["latency_p50_ms"] = float(np.percentile(r["lat"], 50))
            res["latency_p99_ms"] = float(np.percentile(r["lat"], 99))
            lat_note = (f"latency p50 {res['latency_p50_ms']:.3f} ms p99 "
                        f"{res['latency_p99_ms']:.3f} ms, ")
        else:
            lat_note = (f"latency not measured (the decoder holds {lag} "
                        f"frames back), ")
        out[name] = res
        print(f"phase 17: {name}: {lat_note}{r['fps']:.1f} frames/s; "
              f"{kern:.1f} CUDA kernels and {dev_ms:.3f} ms of kernel time "
              f"per frame, device busy {100 * res['device_busy_share']:.1f}%; "
              f"clamp_scale {r['clamp_launches']} launches for "
              f"{SLICE5_FRAMES} frames ({clamp_named} by name, profiled run "
              f"{tries}); addcmul "
              f"(greedy NMS steps) {nms:g} per frame [{card}]")
    record["slice5_pipelines"] = out
    return out


def first_divergence(a, b, box_tol, score_tol):
    """Index of the first rank where two score-ordered detection lists
    (rows [y0,x0,y1,x1,score,class]) differ, or None."""
    for i in range(max(len(a), len(b))):
        if i >= len(a) or i >= len(b):
            return i
        if (a[i, 5] != b[i, 5] or abs(a[i, 4] - b[i, 4]) > score_tol
                or np.abs(a[i, :4] - b[i, :4]).max() > box_tol):
            return i
    return None


def iou(p, q):
    y0, x0 = max(p[0], q[0]), max(p[1], q[1])
    y1, x1 = min(p[2], q[2]), min(p[3], q[3])
    inter = max(0.0, y1 - y0) * max(0.0, x1 - x0)
    union = ((p[2] - p[0]) * (p[3] - p[1]) + (q[2] - q[0]) * (q[3] - q[1])
             - inter)
    return inter / union if union > 0 else 0.0


def hold_detections(what, a, b, box_tol, score_tol, margin_tol):
    """a and b agree rank by rank; a first divergence is allowed only as
    a near-tie flip (reported with its margin), after which NMS cascades
    and later ranks are not compared."""
    i = first_divergence(a, b, box_tol, score_tol)
    if i is None:
        print(f"phase 18: {what}: {len(a)} detections identical")
        return 0
    rows = [r[i] for r in (a, b) if i < len(r)]
    margins = [abs(r[4] - SCORE_THRESH) for r in rows]
    if len(rows) == 2:
        margins.append(abs(rows[0][4] - rows[1][4]))
    for r in rows:      # IoU against every detection ranked above it
        margins += [abs(iou(r[:4] / 300, k[:4] / 300) - IOU_THRESH)
                    for k in a[:i]]
    margin = min(margins)
    print(f"phase 18: {what}: first flip at rank {i} of {len(a)}/{len(b)} "
          f"with margin {margin:.3e} (limit {margin_tol:.3e}); later ranks "
          f"not compared (NMS cascades)")
    check(margin <= margin_tol, f"{what}: detections differ at rank {i} "
                                f"with margin {margin:.3e} > {margin_tol:.3e}")
    return 1


def slice5_correctness(nt, torch, card, record) -> dict:
    """Phase 18: D and P in f32, TF32 off, on the card against the port on
    the CPU with the same frames and weights (the zoo's seeded init): raw
    outputs within CPU_TOLERANCE of max |.|, kept detections and
    keypoints identical up to a reported near-tie flip; on the card,
    device=true against the host decode of the same frame and compact
    against the host decode (of the same top-K candidates when the
    compact tensor's last row clears the threshold)."""
    from nnstreamer_tpu_torch.decoders.boundingbox import BoundingBoxes
    from nnstreamer_tpu_torch.decoders.pose import PoseEstimation
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
    from nnstreamer_tpu_torch.tensor.info import TensorsSpec

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    frames = u8_frames((1, 300, 300, 3), 2, 21)
    raw = {acc: run_desc(nt, d_head("float32", acc) + "tensor_sink name=out",
                         frames) for acc in ("cuda", "cpu")}
    props = {"option1": "mobilenet-ssd", "option3": "0.5:0.5",
             "option4": "300:300"}

    def host_decode(tensors, compact=False):
        sub = BoundingBoxes()
        sub.init(props)
        sub.negotiate(TensorsSpec.from_strings("4:1917:1,91:1917:1"))
        sub.consume_compact = compact
        return sub.decode(TensorBuffer.of(*tensors)).meta["boxes"]

    out = {"flips": 0}
    for i in range(len(frames)):
        g, c = raw["cuda"][i].tensors, raw["cpu"][i].tensors
        for name, gt, ct in zip(("loc", "logits"), g, c):
            rel = float(np.abs(gt - ct).max() / np.abs(ct).max())
            print(f"phase 18: D frame {i} {name} f32 cuda vs cpu: max |diff| "
                  f"/ max |.| = {rel:.3e} (tolerance {CPU_TOLERANCE})")
            check(rel <= CPU_TOLERANCE, f"D {name} differs by {rel:.3e}")
        lmax = float(np.abs(c[1]).max())
        out["flips"] += hold_detections(
            f"D frame {i} host decode cuda vs cpu", host_decode(g),
            host_decode(c), box_tol=300 * CPU_TOLERANCE,
            score_tol=0.25 * CPU_TOLERANCE * lmax,
            margin_tol=0.25 * CPU_TOLERANCE * lmax)
    # on the card: device=true and compact against the host decode of
    # the same frames (the raw outputs above, f32)
    dev = run_desc(nt, d_head("float32") + f"{D_DEC} device=true ! "
                   f"tensor_sink name=out", frames)
    comp = run_desc(nt, d_head("float32") + f"{D_DEC} device=compact "
                    f"max_in_flight=1 option7=100 ! tensor_sink name=out",
                    frames)
    for i in range(len(frames)):
        host = host_decode(raw["cuda"][i].tensors)
        det = dev[i].tensors[0]
        det = det[det[:, 4] > 0]
        # the first 16 kept of NMS over the 100 best candidates: a prefix
        # of the host's kept list (fewer rows only if NMS over those 100
        # keeps fewer than 16)
        check(0 < len(det) <= min(16, len(host)),
              f"D device=true frame {i}: {len(det)} rows, host kept "
              f"{len(host)}")
        out["flips"] += hold_detections(
            f"D frame {i} device=true vs host decode (first {len(det)})",
            det, host[:len(det)], box_tol=1e-3, score_tol=1e-5,
            margin_tol=1e-5)
        loc, logits = raw["cuda"][i].tensors
        sc = logits.reshape(1917, -1).astype(np.float32)
        sc = 1.0 / (1.0 + np.exp(-sc)) if (sc.min() < 0 or sc.max() > 1) \
            else sc
        best = sc[:, 1:].max(-1)
        top = np.sort(best)[::-1][:100]
        truncated = top[-1] >= SCORE_THRESH
        if truncated:
            # the compact tensor may cut detections above the threshold:
            # the reference is the host decode of the same 100 rows
            from nnstreamer_tpu_torch.models.ssd_mobilenet import (
                decode_boxes, generate_anchors)

            cls = sc[:, 1:].argmax(-1) + 1
            score = sc[np.arange(1917), cls]
            idx = np.argsort(-score, kind="stable")[:100]
            rows = np.concatenate([
                decode_boxes(loc.reshape(-1, 4), generate_anchors())[idx],
                score[idx, None], cls[idx, None].astype(np.float32)], 1)
            ref = host_decode((rows,), compact=True)
            print(f"phase 18: D frame {i} compact: the 100th candidate's "
                  f"score {top[-1]:.4f} clears {SCORE_THRESH}: compact held "
                  f"to the host decode of the same top-100 candidates")
        else:
            ref = host
        out["flips"] += hold_detections(
            f"D frame {i} compact vs host decode", comp[i].meta["boxes"],
            ref, box_tol=1e-3, score_tol=1e-5, margin_tol=1e-5)
    # P: heatmaps/offsets and keypoints, card vs CPU
    pframes = u8_frames((1, 257, 257, 3), 2, 22)
    praw = {acc: run_desc(nt, p_head("float32", acc) + "tensor_sink name=out",
                          pframes) for acc in ("cuda", "cpu")}
    pose = PoseEstimation()
    # option2 as device=true has it: the frame the offsets are in
    pose.init({"option1": "257:257", "option2": "257:257", "option4": "0.0"})

    def keypoints(tensors):
        pose.negotiate(TensorsSpec.from_strings("17:17:17:1,34:17:17:1"))
        return pose.decode(TensorBuffer.of(*tensors)).meta["keypoints"]

    pdev = run_desc(nt, p_head("float32") + f"{P_DEC} device=true "
                    "option2=257:257 ! tensor_sink name=out", pframes)
    for i in range(len(pframes)):
        g, c = praw["cuda"][i].tensors, praw["cpu"][i].tensors
        for name, gt, ct in zip(("heatmaps", "offsets"), g, c):
            rel = float(np.abs(gt - ct).max() / np.abs(ct).max())
            print(f"phase 18: P frame {i} {name} f32 cuda vs cpu: max |diff| "
                  f"/ max |.| = {rel:.3e} (tolerance {CPU_TOLERANCE})")
            check(rel <= CPU_TOLERANCE, f"P {name} differs by {rel:.3e}")
        hm = c[0][0].reshape(-1, c[0].shape[-1])
        gk, ck = keypoints(g), keypoints(c)
        cell = 257 / c[0].shape[2]
        flips = []
        for k in range(len(ck)):
            if np.abs(gk[k, :2] - ck[k, :2]).max() <= cell / 2:
                continue
            top2 = np.sort(hm[:, k])[-2:]
            flips.append((k, float(top2[1] - top2[0])))
        for k, gap in flips:
            print(f"phase 18: P frame {i} keypoint {k}: argmax cell flips "
                  f"with top-2 heatmap gap {gap:.3e}")
            check(gap <= FLIP_SHARE * float(np.abs(c[0]).max()),
                  f"P keypoint {k} flips with gap {gap:.3e}")
        kept = [k for k in range(len(ck)) if k not in dict(flips)]
        np.testing.assert_allclose(gk[kept], ck[kept], rtol=0,
                                   atol=300 * CPU_TOLERANCE)
        np.testing.assert_allclose(pdev[i].tensors[0], gk, rtol=0, atol=1e-3)
        print(f"phase 18: P frame {i}: {len(kept)} of {len(ck)} keypoints "
              f"equal card vs CPU; device=true equals the host decode")
        out["flips"] += len(flips)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    record["slice5_correctness"] = out
    return out


def composite_one_model(nt, torch, card, record) -> dict:
    """Phase 19: C holds one MobileNetV2 on the card. memory_allocated
    rises by about one model's parameters when both shared filters open,
    and the muxed outputs equal two single-filter runs of the branches."""
    from nnstreamer_tpu_torch.models.zoo import build_model

    model = build_model("mobilenet_v2?dtype=bfloat16").params
    one = sum(t.numel() * t.element_size()
              for t in (*model.parameters(), *model.buffers()))
    del model
    frames = [tuple(u8_frames((1, 224, 224, 3), 2, 30 + i)) for i in range(3)]
    pipe = composite_pipe(nt, sink="tensor_sink")
    # models of earlier phases left in reference cycles are freed now,
    # not by a collection that happens to run while C opens (one such
    # run read -14524928 B)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    runner = nt.PipelineRunner(pipe).start()
    opened = torch.cuda.memory_allocated() - before
    same = pipe.get("fa").backend._params is pipe.get("fb").backend._params
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    src = pipe.get("src")
    try:
        for i, f in enumerate(frames):
            src.push(TensorBuffer.of(*f, pts=i))
        src.end()
        runner.wait(600)
    finally:
        runner.stop()
    muxed = pipe.get("out").results
    print(f"phase 19: C: memory_allocated rose {opened} B when the two "
          f"shared filters opened; one MobileNetV2 holds {one} B; one "
          f"model object: {same} [{card}]")
    check(same, "the shared filters hold two models")
    check(0.5 * one <= opened <= 1.5 * one,
          f"opening C took {opened} B, not about one model ({one} B)")
    worst = 0.0
    for branch in (0, 1):
        single = run_desc(
            nt, ingest("3:224:224:1") + "tensor_filter "
            "model=zoo://mobilenet_v2?dtype=bfloat16 ! tensor_sink name=out",
            [f[branch] for f in frames])
        for m, s in zip(muxed, single):
            ref = s.tensors[0]
            diff = float(np.abs(m.tensors[branch].astype(np.float32)
                                - ref).max())
            worst = max(worst, diff / float(np.abs(ref).max()))
    print(f"phase 19: C muxed logits vs two single-filter runs: max |diff| "
          f"/ max |logit| = {worst:.3e}")
    check(worst <= CPU_TOLERANCE, f"C outputs differ from single runs by "
                                  f"{worst:.3e}")
    record["composite"] = {"opened_bytes": opened, "model_bytes": one,
                           "rel_diff_vs_single": worst}
    return record["composite"]


def slice5_phases(nt, torch, card, record, phases) -> list:
    """Phases 16-19. → the clamp_scale entry of the JSON line."""
    dev = torch.device("cuda", 0)
    clamp = check_clamp_scale(torch, dev, card)
    record["clamp_scale"] = clamp
    phases.done("16 (clamp_scale vs plain)")
    cells = slice5_timings(nt, torch, card, record)
    phases.done("17 (pipelines D, P, C)")
    slice5_correctness(nt, torch, card, record)
    phases.done("18 (D and P f32 card vs CPU)")
    composite_one_model(nt, torch, card, record)
    phases.done("19 (C one model)")
    t = clamp["timing"]["P frame"]
    launches = cells["P host"]["clamp_launches"]
    return [{
        "name": "clamp_scale", "route": "cuda",
        "source": "nnstreamer_tpu_torch/backends/csrc/clamp_scale.cu",
        "replaces": "nnstreamer_tpu/backends/pallas_ops.py:126",
        "launches": launches, "max_abs_err": clamp["main_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "host_ms_per_call": t["host_ms"]}]


# -- slice 4: the ring step, ring attention, sharded serving -------------------

#: env key of [parallel] virtual_devices (serving/placement.py)
VIRTUAL_ENV = "NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES"
#: the ring's group: 4 logical devices, round-robin over the cards
RING_SHARDS = 4
#: phase 22's sharded serving (LLM_PROPS without chunking, on the torch
#: attention: the sharded path's attention is not a kernel)
SHARD_PROPS = dict(paged_kernel="xla", prefill_chunk=0, shards=RING_SHARDS,
                   ring_prefill_min=1024)
#: the ring's local block at phase 22's ring bucket (2048 / 4) and at the
#: forward's S
RING_BLOCK = 512


def close_rule(torch, got, ref, bf16: bool):
    """→ (largest |diff| / limit, max_abs_err): f32 within
    PAGED_REL * max|ref| + PAGED_ABS, bf16 element by element within
    phase 12's flash rule (ref an attention output, rows on the last
    axis)."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    if bf16:
        rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
        lim = FLASH_BF16_ULP * ref.abs() + FLASH_BF16_ROW * rms
    else:
        lim = torch.full_like(ref, PAGED_REL * ref.abs().max().item()
                              + PAGED_ABS)
    return (diff / lim).max().item(), diff.max().item()


def check_flash_block(torch, dev, record) -> float:
    """Phase 20: flash_block_update against its plain version, bf16 on
    the tensor-core kernel and f32 on the CUDA-core one → the largest abs
    error of the finalized output at the serving shape (bf16, (1, 8, 512,
    128) views, a block below the diagonal)."""
    from nnstreamer_tpu_torch.backends import kernels

    rng = np.random.default_rng(8)
    f32, bf16 = torch.float32, torch.bfloat16
    d, sl = 128, RING_BLOCK

    def rand(shape, dt):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dt)

    def started(bh, sq, dh):
        """A carry one non-causal plain step in: finite m, l > 0."""
        carry = kernels.flash_carry_init(bh, sq, dh, device=dev)
        kernels.flash_block_update_plain(
            rand((bh, sq, dh), f32), rand((bh, sq, dh), f32),
            rand((bh, sq, dh), f32), *carry, q_offset=0, k_offset=0,
            causal=False)
        return carry

    def views(b, s, dt, dh=d):
        """q/k/v as the ring hands them over: (B, H, S, D) views of
        (B, S, H, D) tensors."""
        return [rand((b, s, 8, dh), dt).transpose(1, 2) for _ in range(3)]

    def flat(bh, sq, sk, dt, dh=d):
        return [rand((bh, sq, dh), dt), rand((bh, sk, dh), dt),
                rand((bh, sk, dh), dt)]

    # name → (q, k, v, q_offset, k_offset, causal); "dead N": rows 0 .. N-1
    # meet no live key inside computed tiles (carry bit for bit)
    cases = {
        "f32 (8,512,512) full": (*flat(8, sl, sl, f32), 0, 0, False),
        "f32 (8,512,512) causal below (q 1024, k 0)":
            (*flat(8, sl, sl, f32), 1024, 0, True),
        "f32 (8,512,512) causal diagonal (512, 512)":
            (*flat(8, sl, sl, f32), 512, 512, True),
        "f32 (8,512,512) causal above (0, 512)":
            (*flat(8, sl, sl, f32), 0, 512, True),
        "f32 (8,512,512) causal offsets 100, 37":
            (*flat(8, sl, sl, f32), 100, 37, True),
        "f32 Sq 256 Sk 512 causal (300, 0)":
            (*flat(8, 256, sl, f32), 300, 0, True),
        "f32 Sq 512 Sk 128 causal (64, 200)":
            (*flat(8, sl, 128, f32), 64, 200, True),
        "bf16 (8,512,512) causal diagonal (512, 512)":
            (*flat(8, sl, sl, bf16), 512, 512, True),
        "bf16 serving views (1,8,512,128) causal below (1024, 0)":
            (*views(1, sl, bf16), 1024, 0, True),
        "bf16 forward views (8,8,512,128) causal below (1536, 512)":
            (*views(8, sl, bf16), 1536, 512, True),
        "bf16 forward views (8,8,512,128) causal above (0, 1024)":
            (*views(8, sl, bf16), 0, 1024, True),
        "f32 views (2,8,512,128) full": (*views(2, sl, f32), 0, 0, False),
        # the tensor-core kernel's two layouts (BH 8: eight key warps over
        # 128-key tiles; BH 64: the flash kernel's CTA) on a diagonal
        # block whose first rows meet no live key
        "bf16 serving views (1,8,512,128) causal dead 100 (0, 100)":
            (*views(1, sl, bf16), 0, 100, True),
        "bf16 forward views (8,8,512,128) causal dead 37 (40, 77)":
            (*views(8, sl, bf16), 40, 77, True),
        # its other paths: no mask, head dims 64 and 256 and one it pads
        # (40), a ragged Sk (keys past it zero-filled and masked), Sq != Sk
        "bf16 serving views (1,8,512,128) full": (*views(1, sl, bf16), 0, 0,
                                                  False),
        "bf16 D64 (8,512,512) causal offsets 100, 37":
            (*flat(8, sl, sl, bf16, 64), 100, 37, True),
        "bf16 D256 (4,256,256) causal diagonal (256, 256)":
            (*flat(4, 256, 256, bf16, 256), 256, 256, True),
        "bf16 D40 (8,256,256) full": (*flat(8, 256, 256, bf16, 40), 0, 0,
                                      False),
        "bf16 ragged Sk 72 (8,512,72) causal (64, 200)":
            (*flat(8, sl, 72, bf16), 64, 200, True),
        "bf16 ragged Sq 72 (8,72,512) causal (600, 0)":
            (*flat(8, 72, sl, bf16), 600, 0, True),
    }
    kernels.flash_block_update.launches_tc = 0
    kernels.flash_block_update.launches_simt = 0
    want = {"tc": 0, "simt": 0}
    main_err = None
    for name, (q, k, v, q_off, k_off, causal) in cases.items():
        bh, dh = math.prod(q.shape[:-2]), q.shape[-1]
        start = started(bh, q.shape[-2], dh)
        got = [t.clone() for t in start]
        ref = [t.clone() for t in start]
        kernels.flash_block_update(q, k, v, *got, q_offset=q_off,
                                   k_offset=k_off, causal=causal)
        want["tc" if q.dtype == bf16 else "simt"] += 1
        kernels.flash_block_update_plain(q, k, v, *ref, q_offset=q_off,
                                         k_offset=k_off, causal=causal)
        torch.cuda.synchronize()
        check(all(torch.isfinite(t).all().item() for t in got),
              f"{name}: non-finite carry")
        if "above" in name:
            same = all(bits_equal(torch, g, s) and bits_equal(torch, r, s)
                       for g, r, s in zip(got, ref, start))
            print(f"phase 20: flash_block_update {name}: carry "
                  f"{'unchanged bit for bit' if same else 'CHANGED'}")
            check(same, f"{name}: a block above the diagonal changed the "
                        f"carry")
            continue
        if " dead " in name:
            n = int(name.split(" dead ")[1].split()[0])
            same = all(bits_equal(torch, g[:, :n], s[:, :n]) and
                       bits_equal(torch, r[:, :n], s[:, :n])
                       for g, r, s in zip(got, ref, start))
            print(f"phase 20: flash_block_update {name}: the {n} rows with "
                  f"no live key {'unchanged bit for bit' if same else 'CHANGED'}")
            check(same, f"{name}: rows with no live key changed the carry")
        worst = {}
        for part, g, r in (("m", got[0], ref[0]), ("l", got[1], ref[1])):
            worst[part] = close_rule(torch, g, r, False)
        out = kernels.flash_carry_finalize(got[1], got[2])
        out_ref = kernels.flash_carry_finalize(ref[1], ref[2])
        worst["out"] = close_rule(torch, out, out_ref, q.dtype == bf16)
        print(f"phase 20: flash_block_update {name}: largest |diff| / limit "
              + ", ".join(f"{p} {r:.3f} (max_abs_err {e:.3e})"
                          for p, (r, e) in worst.items()))
        for p, (r, _) in worst.items():
            check(r <= 1.0, f"flash_block_update {name}: {p} differs from "
                            f"the plain version by {r:.3f} x its limit")
        record.setdefault("flash_block_errs", {})[name] = worst
        if name.startswith("bf16 serving views (1,8,512,128) causal below"):
            main_err = worst["out"][1]
    # a 4-step ring chain from flash_carry_init (shard 1 of 4, causal),
    # compared after finalize
    for dt in (f32, bf16):
        q = rand((1, sl, 8, d), dt).transpose(1, 2)
        blocks = [views(1, sl, dt)[1:] for _ in range(RING_SHARDS)]
        chains = [kernels.flash_carry_init(8, sl, d, device=dev)
                  for _ in range(2)]
        for step in range(RING_SHARDS):
            src = (1 - step) % RING_SHARDS
            for fn, carry in zip((kernels.flash_block_update,
                                  kernels.flash_block_update_plain), chains):
                fn(q, *blocks[src], *carry, q_offset=sl, k_offset=src * sl,
                   causal=True)
            want["tc" if dt == bf16 else "simt"] += 1
        got, ref = (kernels.flash_carry_finalize(c[1], c[2]) for c in chains)
        ratio, err = close_rule(torch, got, ref, dt == bf16)
        label = f"{str(dt).split('.')[-1]} chain of 4 steps from init"
        print(f"phase 20: flash_block_update {label}: largest |diff| / "
              f"limit {ratio:.3f} (max_abs_err {err:.3e})")
        check(ratio <= 1.0, f"flash_block_update {label}: {ratio:.3f} x its "
                            f"limit")
        record.setdefault("flash_block_errs", {})[label] = {"out": (ratio,
                                                                    err)}
    variants = {"tc": kernels.flash_block_update.launches_tc,
                "simt": kernels.flash_block_update.launches_simt}
    print(f"phase 20: flash_block_update launches by variant {variants} "
          f"(every bf16 call on the tensor-core kernel, every f32 call on "
          f"the CUDA-core one: {want})")
    check(variants == want, f"ring-step variants {variants}, not {want}")
    record["flash_block_variants"] = variants
    return main_err


def ring_phase(nt, torch, dev, card, record, params) -> int:
    """Phase 21: ring_attention over 4 logical devices and apply_seq over
    an sp=4 mesh. → the kernel's launches in one bf16 mesh forward."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.models import transformer as tt
    from nnstreamer_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from nnstreamer_tpu_torch.parallel.ring_attention import (
        reference_attention, ring_attention)

    mesh = make_mesh(MeshSpec(dp=1, sp=RING_SHARDS))
    dp_mesh = make_mesh(MeshSpec(dp=2, sp=2))
    print(f"phase 21: logical devices -> physical: "
          f"{[str(x) for x in mesh.devices.flat]} (sp {RING_SHARDS}); "
          f"dp 2 x sp 2: {[str(x) for x in dp_mesh.devices.flat]}")
    record["ring_devices"] = [str(x) for x in mesh.devices.flat]
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, 2048, 8, 128)).astype(np.float32)).to(dev) for _ in range(3))
    for causal in (False, True):
        ref = reference_attention(q, k, v, causal=causal)
        for impl in ("pallas", "xla"):
            got = ring_attention(q, k, v, mesh=mesh, causal=causal,
                                 block_impl=impl)
            ratio, err = close_rule(torch, got, ref, False)
            label = f"{impl} {'causal' if causal else 'full'}"
            print(f"phase 21: ring_attention sp {RING_SHARDS} (2,2048,8,128) "
                  f"f32 {label} vs reference: |diff| / limit {ratio:.3f} "
                  f"(max_abs_err {err:.3e})")
            check(ratio <= 1.0, f"ring_attention {label}: {ratio:.3f} x its "
                                f"limit")
            record.setdefault("ring_errs", {})[label] = err
    qb, kb, vb = (t[:, :1024].repeat(2, 1, 1, 1) for t in (q, k, v))
    ref = reference_attention(qb, kb, vb, causal=True)
    for impl in ("pallas", "xla"):
        got = ring_attention(qb, kb, vb, mesh=dp_mesh, causal=True,
                             block_impl=impl, batch_axis="dp")
        ratio, err = close_rule(torch, got, ref, False)
        print(f"phase 21: ring_attention dp 2 x sp 2 batch_axis (4,1024,8,"
              f"128) f32 {impl} causal vs reference: |diff| / limit "
              f"{ratio:.3f} (max_abs_err {err:.3e})")
        check(ratio <= 1.0, f"ring_attention dp x sp {impl}: {ratio:.3f}")
    del q, k, v, qb, kb, vb, ref, got

    vocab, heads = LLM_DIMS["vocab"], LLM_DIMS["n_heads"]
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, vocab, (FWD_B, FWD_S))).to(dev)
    p32 = on_device(params, dev)
    with torch.inference_mode():
        ring = tt.apply_seq(p32, ids, n_heads=heads, mesh=mesh)
        flat = tt.apply_seq(p32, ids, n_heads=heads)
    torch.cuda.synchronize()
    check(ring.shape == (FWD_B, FWD_S, vocab) and
          torch.isfinite(ring).all().item(), "f32 mesh forward not finite")
    rel = ((ring - flat).abs().max() / flat.abs().max()).item()
    print(f"phase 21: f32 apply_seq over the sp {RING_SHARDS} mesh vs "
          f"without a mesh (B {FWD_B}, S {FWD_S}, TF32 off): max |diff| / "
          f"max |logit| = {rel:.3e} (limit {FWD_F32_REL})")
    check(rel <= FWD_F32_REL, f"f32 mesh forward differs by {rel:.3e}")
    del ring, flat, p32
    p16 = bf16_params(torch, params, dev)
    runs = {"apply_seq mesh sp4": lambda: tt.apply_seq(
                p16, ids, n_heads=heads, dtype=torch.bfloat16, mesh=mesh),
            "apply_seq flash": lambda: tt.apply_seq(
                p16, ids, n_heads=heads, dtype=torch.bfloat16)}
    with torch.inference_mode():
        runs["apply_seq mesh sp4"]()
        torch.cuda.synchronize()

        def attempt():
            kernels.flash_block_update.launches = 0
            kernels.flash_block_update.launches_tc = 0
            kernels.flash_block_update.launches_simt = 0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                open_capture(torch)
                runs["apply_seq mesh sp4"]()
                torch.cuda.synchronize()
                close_capture(torch)
            launches = kernels.flash_block_update.launches
            variants = {"tc": kernels.flash_block_update.launches_tc,
                        "simt": kernels.flash_block_update.launches_simt}
            named = named_launches(prof, ["flash_block_update",
                                          "flash_block_update simt"])
            wrapper = {"flash_block_update": variants["tc"],
                       "flash_block_update simt": variants["simt"]}
            return wrapper, named, (launches, variants, named)

        (launches, variants, named), tries = profiled_agreement(
            "phase 21", attempt)
        print(f"phase 21: one bf16 mesh forward: flash_block_update wrapper "
              f"launches {launches}, by variant {variants}; profiler "
              f"launches by name {named} "
              f"({KERNEL_SYMBOL['flash_block_update']}, "
              f"{KERNEL_SYMBOL['flash_block_update simt']}; profiled run "
              f"{tries})")
        per_forward = LLM_DIMS["n_layers"] * RING_SHARDS ** 2
        check(launches == named["flash_block_update"] == per_forward,
              f"not {RING_SHARDS ** 2} ring-step launches per layer")
        check(variants == {"tc": per_forward, "simt": 0} and
              named["flash_block_update simt"] == 0,
              f"the bf16 mesh forward's ring steps did not all run on the "
              f"tensor-core kernel: {variants}, {named}")
        timing = {}
        for name, fn in runs.items():
            ms = event_ms_per_call(torch, fn, 3)
            timing[name] = {"ms": ms, "tokens_per_s": FWD_B * FWD_S / ms * 1e3}
            print(f"phase 21: bf16 {name} (B {FWD_B}, S {FWD_S}): {ms:.3f} ms "
                  f"per forward, {timing[name]['tokens_per_s']:.0f} tokens/s "
                  f"[{card}]")
    ratio = timing["apply_seq mesh sp4"]["ms"] / timing["apply_seq flash"]["ms"]
    print(f"phase 21: bf16 mesh / flash forward time {ratio:.3f}")
    record["ring_forward"] = {"f32_rel_err": rel, "timing": timing,
                              "mesh_over_flash": ratio, "launches": launches,
                              "launches_by_variant": variants,
                              "profiler_launches": named}
    return launches


def shard_logits(torch, params, prompt, shards, steps=4):
    """Teacher-forced through a sharded executor (f32, blocked path):
    prefill, then `steps` decode steps fed the reference's argmax → every
    step's logits."""
    from nnstreamer_tpu_torch.backends.llm_exec import PagedLLMExecutor

    blocks = list(range(1, 1 + (len(prompt) + steps + 15) // 16))
    ex = PagedLLMExecutor(params, n_heads=8, dtype=torch.float32,
                          block_size=16, num_blocks=len(blocks) + 1,
                          max_len=LLM_PROPS["max_len"], paged_kernel="xla",
                          shards=shards)
    outs = [ex.prefill(prompt, blocks)]
    for step in range(steps):
        outs.append(ex.decode([int(np.argmax(outs[-1]))], [blocks],
                              [len(prompt) + step])[0])
    ex.close()
    return outs


def shard_serving_phase(nt, torch, card, record, ctx) -> int:
    """Phase 22: tensor_llm shards=4 at full width. → the kernel's
    launches in the bf16 run (its ring prefills)."""
    from nnstreamer_tpu_torch.models import transformer as tt

    dev = torch.device("cuda", 0)
    params, requests = ctx["params"], ctx["requests"]
    n_ring = sum(len(p) >= SHARD_PROPS["ring_prefill_min"] for p in requests)
    for prompt in (min(requests, key=len), max(requests, key=len)):
        one, four = (shard_logits(torch, params, prompt, n) for n in (1, 4))
        same = all(np.array_equal(a, b) for a, b in zip(one, four))
        print(f"phase 22: f32 prompt {len(prompt)}: shards=4 vs shards=1 "
              f"logits (prefill + 4 decode steps) "
              f"{'bit-equal' if same else 'DIFFERENT'}")
        check(same, "shards=4 logits differ from shards=1")
    blocked = dict(SHARD_PROPS, ring_prefill_min=0)
    one, _, wall_1, _ = serve(nt, torch, requests, dtype="float32",
                              **dict(blocked, shards=1))
    four, llm4, wall_4, _ = serve(nt, torch, requests, dtype="float32",
                                  **blocked)
    check(one == four, "shards=4 tokens differ from shards=1")
    ring, llm_r, wall_r, launches = serve(nt, torch, requests,
                                          dtype="float32", **SHARD_PROPS)
    ring_steps = (launches["flash_block_update"] +
                  launches["flash_block_update simt"])
    p32 = on_device(params, dev)
    ties = check_f32_parity(
        torch, lambda seq: tt.apply_seq_kv(p32, seq.to(dev), n_heads=8)[0][
            0, -1], requests, ring, four, "22") if ring != four else 0
    del p32
    same = sum(ring[k] == four[k] for k in ring)
    print(f"phase 22: f32 shards=4 tokens equal shards=1 for all "
          f"{len(requests)} requests ({wall_4:.2f} s vs {wall_1:.2f} s); ring "
          f"arm vs blocked arm: {same}/{len(requests)} token-identical, "
          f"{ties} near-tie flips ({wall_r:.2f} s); {n_ring} ring prefills, "
          f"flash_block_update launches {ring_steps} (CUDA-core kernel "
          f"{launches['flash_block_update simt']}); "
          f"shard devices {llm_r.engine.executor.stats()['shard_devices']}")
    check(ring_steps == 64 * n_ring > 0,
          "not 64 flash_block_update launches per ring prefill")
    check(launches["flash_block_update simt"] == 64 * n_ring,
          "f32 ring steps not on the CUDA-core kernel")
    record["shard_f32"] = {"ring_identical": same, "ring_near_ties": ties,
                           "ring_prefills": n_ring}
    del llm4, llm_r                     # their pools, before the baseline
    gc.collect()                        # and whatever cycles still hold

    base = {i: torch.cuda.memory_allocated(i)
            for i in range(torch.cuda.device_count())}
    mem = {}
    _, llm, wall, launches = serve(nt, torch, requests, dtype="bfloat16",
                                   mem=mem, **SHARD_PROPS)
    check(launches["flash_block_update"] == 64 * n_ring and
          launches["flash_block_update simt"] == 0,
          "bf16: not 64 flash_block_update launches per ring prefill, all "
          "on the tensor-core kernel")
    lat = llm.engine.latency_ms()
    ntok = llm.engine.tokens_out
    ex = llm.engine.executor
    serving = {"tokens": ntok, "seconds": wall, "tokens_per_s": ntok / wall,
               "ttft_p50_ms": float(np.percentile(lat["first_token"], 50)),
               "ttft_p99_ms": float(np.percentile(lat["first_token"], 99)),
               "itl_p50_ms": float(np.percentile(lat["inter_token"], 50)),
               "itl_p99_ms": float(np.percentile(lat["inter_token"], 99)),
               "decode_steps": ex.decode_steps, "prefills": ex.prefills,
               "ring_prefills": n_ring, "launches": launches,
               "shard_devices": ex.stats()["shard_devices"],
               "memory_allocated": mem,
               "memory_added": {i: mem[i] - base[i] for i in mem}}
    print(f"phase 22: bf16 shards=4 ring_prefill_min=1024: {ntok} tokens in "
          f"{wall:.3f} s = {serving['tokens_per_s']:.1f} tokens/s; time to "
          f"first token p50 {serving['ttft_p50_ms']:.3f} ms p99 "
          f"{serving['ttft_p99_ms']:.3f} ms; inter-token latency p50 "
          f"{serving['itl_p50_ms']:.3f} ms p99 {serving['itl_p99_ms']:.3f} "
          f"ms; memory_allocated after start by card {mem} (+"
          f"{serving['memory_added']} B over the idle card) [{card}]")
    record["shard_bf16"] = serving
    del llm
    # the bf16 ring prefills again under the profiler (2 new tokens, so
    # the capture is the prefills): every ring step by name on the
    # tensor-core kernel
    from torch.profiler import ProfilerActivity, profile

    def attempt():
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        _, _, _, plaunch = serve(nt, torch, requests, prof=prof,
                                 new_tokens=2, dtype="bfloat16",
                                 **SHARD_PROPS)
        named = named_launches(prof, ["flash_block_update",
                                      "flash_block_update simt"])
        wrapper = {k: plaunch[k] for k in named}
        return wrapper, named, (wrapper, named)

    (wrapper, named), tries = profiled_agreement("phase 22", attempt)
    print(f"phase 22: profiled bf16 run (2 new tokens): flash_block_update "
          f"wrapper launches by variant {wrapper}, profiler launches by name "
          f"{named} (profiled run {tries})")
    check(named == wrapper == {"flash_block_update": 64 * n_ring,
                               "flash_block_update simt": 0},
          f"bf16 ring prefills: profiler {named}, wrapper {wrapper}")
    serving["profiler_launches"] = named
    return launches["flash_block_update"]


def flash_block_timing(torch, dev, card) -> dict:
    """Phase 23: flash_block_update's device time (queued CUDA events) at
    the ring's shapes — serving (B 1, H 8) and forward (B 8, H 8), local
    blocks of 512, a block below the diagonal — in bf16 on the
    tensor-core kernel (the main path's), beside its bound, its plain
    version's time and two CUDA-core readings: bf16 through the launcher
    alone (what the main path ran before the tensor-core kernel; the
    wrapper never takes it) and f32 through the wrapper."""
    from nnstreamer_tpu_torch.backends import kernels

    rng = np.random.default_rng(10)
    d, sl, out = 128, RING_BLOCK, {}
    fb = kernels.flash_block_update
    counts = (fb.launches, fb.launches_tc, fb.launches_simt)
    for b, what in ((1, "serving"), (FWD_B, "forward")):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, sl, 8, d)).astype(np.float32)).to(dev, torch.bfloat16)
            .transpose(1, 2) for _ in range(3))
        q32, k32, v32 = (t.float() for t in (q, k, v))
        bh = b * 8
        carry = kernels.flash_carry_init(bh, sl, d, device=dev)
        # q, k, v read once (bf16); m, l and acc (f32) read and written
        nbytes = 3 * bh * sl * d * 2 + 2 * (2 * bh * sl + bh * sl * d) * 4
        ops = 4 * bh * sl * sl * d            # q.k and p.v, every key
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / BF16_FLOPS * 1e3
        args = dict(q_offset=2 * sl, k_offset=0, causal=True)
        step = (lambda: kernels.flash_block_update(q, k, v, *carry, **args))
        prof_ms, kept = profiled_ms_per_launch(
            torch, step, KERNEL_SYMBOL["flash_block_update"], 20)
        res = {"ms": device_ms_per_call(torch, step, 20),
               "profiler_ms": prof_ms, "profiler_records": kept,
               "simt_bf16_ms": device_ms_per_call(
                   torch, lambda: kernels._flash_block_launch(
                       "simt", q, k, v, *carry, 2 * sl, 0, True), 20),
               "simt_f32_ms": device_ms_per_call(
                   torch, lambda: kernels.flash_block_update(
                       q32, k32, v32, *carry, **args), 20),
               "plain_ms": device_ms_per_call(
                   torch, lambda: kernels.flash_block_update_plain(
                       q, k, v, *carry, **args), 20),
               "library_ms": None, "bytes": nbytes, "ops": ops,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        res["ms_again"] = device_ms_per_call(torch, step, 20)
        res["host_ms"] = host_ms_per_call(torch, step, 200)
        res["event_ms"] = event_ms_per_call(torch, step, 200)
        out[what] = res
        fmt = (lambda v: "not measured" if v is None else f"{v:.5f} ms")
        print(f"phase 23: flash_block_update {what} (BH {bh}, Sq = Sk = {sl}, "
              f"D {d}, below the diagonal): bf16 tensor-core kernel "
              f"{res['ms']:.5f} / {res['ms_again']:.5f} ms per launch "
              f"(queued, before and after the others), {fmt(prof_ms)} by the "
              f"profiler ({kept} records); per call from Python, back to "
              f"back: host {res['host_ms']:.5f} ms, {res['event_ms']:.5f} ms "
              f"by CUDA events; CUDA-core kernel bf16 "
              f"{res['simt_bf16_ms']:.5f} ms, f32 {res['simt_f32_ms']:.5f} "
              f"ms; plain torch {res['plain_ms']:.5f} ms; library: none (no "
              f"one torch call continues a softmax carry); bf16 bound "
              f"{res['bound_ms']:.6f} ms ({res['bound_by']}: {nbytes} B at "
              f"3.35 TB/s, {ops} flop at 989 TFLOP/s bf16) [{card}]")
    fb.launches, fb.launches_tc, fb.launches_simt = counts   # not counted
    return out


def slice4_phases(nt, torch, card, record, phases, ctx) -> list:
    """Phases 20-23 (ctx: phase 8's params and requests). → the
    flash_block_update entry of the JSON line."""
    import os

    dev = torch.device("cuda", 0)
    # f32 products in full f32 (the plain versions, the f32 comparisons);
    # bf16 products do not read this flag
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    err = check_flash_block(torch, dev, record)
    phases.done("20 (flash_block_update vs plain)")
    old = os.environ.get(VIRTUAL_ENV)
    os.environ[VIRTUAL_ENV] = str(RING_SHARDS)
    try:
        fwd = ring_phase(nt, torch, dev, card, record, ctx["params"])
        phases.done("21 (ring attention and the mesh forward)")
        launches = shard_serving_phase(nt, torch, card, record, ctx)
        phases.done("22 (sharded serving)")
    finally:
        if old is None:
            os.environ.pop(VIRTUAL_ENV)
        else:
            os.environ[VIRTUAL_ENV] = old
    timing = flash_block_timing(torch, dev, card)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    record["flash_block_timing"] = timing
    record["flash_block_launches"] = {"serving_bf16": launches,
                                      "mesh_forward_bf16": fwd}
    phases.done("23 (flash_block_update timings)")
    t = timing["serving"]
    return [{
        "name": "flash_block_update", "route": "cuda",
        "source": "nnstreamer_tpu_torch/backends/csrc/flash_attn_tc.cu",
        "replaces": "nnstreamer_tpu/backends/pallas_ops.py:431",
        "launches": launches, "max_abs_err": err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "host_ms_per_call": t["host_ms"]}]


def slice1_phases(nt, torch, card, record, phases) -> list:
    """Phases 3-6. → the normalize_u8 entry of the JSON line."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.backends import kernels

    # -- 3. kernel vs plain -------------------------------------------------
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def rand(dtype, shape):
        if np.dtype(dtype).kind == "f":
            return (rng.standard_normal(shape) * 100).astype(dtype)
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, shape, dtype, endpoint=True)

    def on_card(dtype, shape):
        """Full-range integers, floats ~N(0, 100); 16-bit floats made by
        torch (numpy has no bfloat16 without ml_dtypes)."""
        if dtype in (torch.float16, torch.bfloat16):
            return torch.from_numpy(rand(np.float32, shape)).to(dev, dtype)
        return torch.from_numpy(rand(dtype, shape)).to(dev)

    frame_u8 = on_card(np.uint8, (1, 224, 224, 3))
    # every dtype a stream carries in (F4: all but the first five raised
    # on the card before), every float dtype out
    in_dtypes = {"u8": np.uint8, "i8": np.int8, "u16": np.uint16,
                 "i16": np.int16, "f32": np.float32, "i32": np.int32,
                 "u32": np.uint32, "i64": np.int64, "u64": np.uint64,
                 "f16": torch.float16, "bf16": torch.bfloat16,
                 "f64": np.float64}
    out_dtypes = (torch.float32, torch.bfloat16, torch.float16,
                  torch.float64)
    cases = {"frame u8": frame_u8,
             "16M u8": on_card(np.uint8, (1 << 24,))}
    for name, dt in in_dtypes.items():
        if name != "u8":
            cases[f"frame {name}"] = on_card(dt, (1, 224, 224, 3))
        cases[f"odd 1001 {name}"] = on_card(dt, (1001,))
        # one element past a 16-byte boundary: the unaligned path
        cases[f"misaligned {name}"] = on_card(dt, (1 + 150528,))[1:]
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    main_err, plain_on_cpu = None, set()
    for name, x in cases.items():
        for out_dtype in out_dtypes:
            got = kernels.normalize_u8(x, out_dtype=out_dtype)
            try:
                ref = kernels.normalize_u8_plain(x, out_dtype=out_dtype)
            except RuntimeError:
                # torch has no cast of this dtype on the card: the plain
                # version on a CPU copy of the same input
                plain_on_cpu.add(str(x.dtype))
                ref = kernels.normalize_u8_plain(
                    x.cpu(), out_dtype=out_dtype).to(dev)
            torch.cuda.synchronize()
            err = (got.double() - ref.double()).abs().max().item()
            view = bits[out_dtype.itemsize]
            same = got.dtype == out_dtype and torch.equal(got.view(view),
                                                          ref.view(view))
            if not same or name in ("frame u8", "16M u8", "misaligned u8"):
                print(f"phase 3: normalize_u8 {name} -> "
                      f"{str(out_dtype).split('.')[-1]}: max_abs_err {err} "
                      f"bitwise {'equal' if same else 'DIFFERENT'}")
            check(same, f"normalize_u8 {name} -> {out_dtype} differs from "
                        f"its plain version (max abs err {err})")
            if name == "frame u8" and out_dtype == torch.float32:
                main_err = err
    print(f"phase 3: normalize_u8: {len(cases)} inputs x {len(out_dtypes)} "
          f"output dtypes ({len(in_dtypes)} input dtypes at the frame, n "
          f"1001 and misaligned; u8 also at 16M) all bit for bit; plain "
          f"version on a CPU copy for {sorted(plain_on_cpu) or 'none'}")
    del cases
    # F4's pipeline: a float16 stream into the normalize filter
    f16_desc = ("videotestsrc num-buffers=4 ! tensor_converter ! "
                "tensor_transform mode=typecast option=float16 ! "
                "tensor_filter framework=pallas model=normalize_u8 "
                "accelerator={} ! tensor_sink name=out")
    launches = kernels.normalize_u8.launches
    f16_card = run_pipeline(nt, f16_desc.format("cuda"))
    f16_launches = kernels.normalize_u8.launches - launches
    f16_cpu = run_pipeline(nt, f16_desc.format("cpu"))
    check(len(f16_card) == len(f16_cpu) == 4 and f16_launches == 4,
          f"f16 pipeline: {len(f16_card)} / {len(f16_cpu)} buffers, "
          f"{f16_launches} launches")
    for a, b in zip(f16_card, f16_cpu):
        check(a.tensors[0].dtype == np.float32
              and a.tensors[0].shape == b.tensors[0].shape
              and np.array_equal(a.tensors[0].view(np.int32),
                                 b.tensors[0].view(np.int32)),
              "f16 pipeline: the card's frames differ from the CPU's")
    print(f"phase 3: typecast float16 ! normalize_u8 pipeline: 4 frames "
          f"{f16_card[0].tensors[0].shape} float32 on the card, "
          f"{f16_launches} kernel launches, bit for bit the CPU run's")
    kernels.normalize_u8.launches = launches

    phases.done("3 (normalize_u8 vs plain)")

    # -- 4. main path: pipelines A and B at full width, bf16, cuda ---------
    results = {}
    kernels.normalize_u8.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        open_capture(torch)
        results["B"] = run_pipeline(
            nt, f"{SRC} ! {NORM_B} ! {MODEL} ! {LABEL} ! tensor_sink name=out")
        torch.cuda.synchronize()
        close_capture(torch)
    launches = kernels.normalize_u8.launches
    norm_events = [e for e in kernel_events(prof)
                   if "nns_normalize_kernel" in e.name]
    print(f"phase 4: B: normalize_u8 launches {launches} for {FRAMES} "
          f"frames; profiler: {len(norm_events)} nns_normalize_kernel "
          f"launches, {len(kernel_events(prof))} CUDA kernels in all")
    check(launches == FRAMES, f"normalize_u8 launched {launches} times on "
                              f"the main path, expected {FRAMES}")
    check(len(norm_events) == FRAMES,
          f"profiler saw {len(norm_events)} normalize kernels, expected "
          f"{FRAMES}")
    per_frame = {"B": kernel_events(prof)}
    results["B device=true"] = run_pipeline(
        nt, f"{SRC} ! {NORM_B} ! {MODEL} ! {LABEL} device=true ! tensor_sink "
            f"name=out")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        open_capture(torch)
        results["A"] = run_pipeline(
            nt, f"{SRC} ! {NORM_A} ! {MODEL} ! {LABEL} ! tensor_sink name=out")
        torch.cuda.synchronize()
        close_capture(torch)
    per_frame["A"] = kernel_events(prof)
    for name, evs in per_frame.items():
        # kernels and device time per frame (first frame's setup included)
        per_frame[name] = (len(evs) / FRAMES, sum(
            e.time_range.elapsed_us() for e in evs) / 1e3 / FRAMES)
        print(f"phase 4: {name}: {per_frame[name][0]:.1f} CUDA kernels and "
              f"{per_frame[name][1]:.3f} ms of kernel time per frame")
    logits_b = run_pipeline(nt, f"{SRC} ! {NORM_B} ! {MODEL} ! tensor_sink "
                                f"name=out")
    for name in ("A", "B"):
        bufs = results[name]
        check(len(bufs) == FRAMES, f"{name}: {len(bufs)} sink buffers")
        check(all("label_index" in b.meta and math.isfinite(b.meta["score"])
                  for b in bufs), f"{name}: label_index/score missing")
    dev_idx = [int(b.tensors[0][0]) for b in results["B device=true"]]
    host_idx = [b.meta["label_index"] for b in results["B"]]
    check(dev_idx == host_idx,
          f"B device=true labels {dev_idx} != host decode {host_idx}")
    check(all(b.tensors[0].shape == (1, 1001)
              and np.isfinite(b.tensors[0]).all() for b in logits_b),
          "B logits not finite (1, 1001)")
    print(f"phase 4: A labels {[b.meta['label_index'] for b in results['A']]}")
    print(f"phase 4: B labels {host_idx} (device=true identical)")
    record["main_path"] = {"launches": launches,
                           "profiler_normalize_kernels": len(norm_events)}
    phases.done("4 (pipelines A and B)")

    # -- 5. f32 on cuda vs the CPU, same weights ---------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = {}
    for accel in ("cuda", "cpu"):
        f32[accel] = run_pipeline(
            nt, f"{SRC} ! {NORM_B} accelerator={accel} ! {MODEL}?dtype="
                f"float32 accelerator={accel} ! tensor_sink name=out")
    gpu = np.concatenate([b.tensors[0] for b in f32["cuda"]])
    cpu = np.concatenate([b.tensors[0] for b in f32["cpu"]])
    rel = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
    print(f"phase 5: f32 cuda vs cpu: labels {gpu.argmax(-1).tolist()} vs "
          f"{cpu.argmax(-1).tolist()}, max |diff| / max |logit| = {rel:.3e} "
          f"(tolerance {CPU_TOLERANCE})")
    check((gpu.argmax(-1) == cpu.argmax(-1)).all(), "f32 labels differ")
    check(rel <= CPU_TOLERANCE, f"f32 logits differ by {rel:.3e}")
    torch.backends.cudnn.allow_tf32 = True
    record["f32_cuda_vs_cpu_rel_err"] = rel
    phases.done("5 (B f32 card vs CPU)")

    # -- 6. timings ---------------------------------------------------------
    timings = {}
    for name, norm in (("A", NORM_A), ("B", NORM_B)):
        lat = closed_loop_latency(nt, norm, n=100, warmup=10)
        n = 200
        run_pipeline(nt, f"videotestsrc num-buffers=8 ! tensor_converter ! "
                         f"{norm} ! {MODEL} ! {LABEL} ! tensor_sink name=out")
        t0 = time.perf_counter()
        out = run_pipeline(nt, f"videotestsrc num-buffers={n} ! "
                               f"tensor_converter ! {norm} ! {MODEL} ! "
                               f"{LABEL} ! tensor_sink name=out")
        fps = len(out) / (time.perf_counter() - t0)
        kern_per_frame, dev_ms = per_frame[name]
        timings[name] = {"latency_p50_ms": float(np.percentile(lat, 50)),
                         "latency_p99_ms": float(np.percentile(lat, 99)),
                         "fps": fps, "kernels_per_frame": kern_per_frame,
                         "device_ms_per_frame": dev_ms,
                         "device_busy_share": dev_ms * fps / 1e3}
        print(f"phase 6: {name}: latency p50 {timings[name]['latency_p50_ms']:.3f} ms "
              f"p99 {timings[name]['latency_p99_ms']:.3f} ms, "
              f"{fps:.1f} frames/s ({n} frames); device busy "
              f"{100 * dev_ms * fps / 1e3:.1f}% (phase-4 kernel time per "
              f"frame x FPS) [{card}]")
    record["pipelines"] = timings

    from nnstreamer_tpu_torch.tools import kernel_variants

    norm = {}
    floor_ms = device_ms_per_call(torch, lambda: torch.cuda._sleep(0), 200)
    big = torch.from_numpy(rand(np.uint8, (1 << 24,))).to(dev)
    for key, x in (("frame", frame_u8), ("16M", big)):
        moved = x.numel() * x.element_size() + x.numel() * 4
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * x.numel() / F32_FLOPS * 1e3
        kern = lambda x=x: kernels.normalize_u8(x)            # noqa: E731
        plain = lambda x=x: kernels.normalize_u8_plain(x)     # noqa: E731
        r = norm[key] = {
            "ms": device_ms_per_call(torch, kern, 200),
            "host_ms": host_ms_per_call(torch, kern, 1000),
            "event_ms": event_ms_per_call(torch, kern, 1000),
            "plain_ms": device_ms_per_call(torch, plain, 200),
            "plain_event_ms": event_ms_per_call(torch, plain, 1000),
            "bytes": moved, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        print(f"phase 6: normalize_u8 {key} {tuple(x.shape)} u8->f32: device "
              f"{r['ms']:.5f} ms per launch (queued; {r['bound_ms'] / r['ms']:.3f}"
              f" of the bound, {r['ms'] / floor_ms:.3f} x the launch floor "
              f"{floor_ms:.5f} ms); per call from Python, back to back: host "
              f"{r['host_ms']:.5f} ms, {r['event_ms']:.5f} ms by CUDA events; "
              f"plain torch {r['plain_ms']:.5f} ms device, "
              f"{r['plain_event_ms']:.5f} ms per call; bound "
              f"{r['bound_ms']:.6f} ms ({moved} B at 3.35 TB/s) [{card}]")
    del big
    # what one call costs on the host, step by step, on both launch paths
    steps = kernel_variants.launch_breakdown(torch, frame_u8, 10000)
    for path, us in steps.items():
        what = ("what one call costs" if path == "calls" else
                f"launch steps, {path} the shared Launcher")
        print(f"phase 6: normalize_u8 {what}, us per call over 10000 calls: "
              + "; ".join(f"{k} {v:.3f}" for k, v in us.items())
              + f" [{card}]")
    record["normalize_u8"] = {**norm, "launch_floor_ms": floor_ms,
                              "launch_steps_us": steps}
    phases.done("6 (timings)")
    r = norm["frame"]
    return [{
        "name": "normalize_u8", "route": "cuda",
        "source": "nnstreamer_tpu_torch/backends/csrc/normalize.cu",
        "replaces": "nnstreamer_tpu/backends/pallas_ops.py:34",
        "launches": launches, "max_abs_err": main_err, "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "host_ms_per_call": r["host_ms"]}]


# -- slice 6: the traced, fault-tolerant host runtime --------------------------

TRACE_FRAMES = 64
#: B with the tensor_fault of phase 26 (seeded, as in the JAX package)
FAULT_P, FAULT_SEED = 0.05, 7
#: one process that runs B cold: fresh kernel directory (nvcc builds
#: normalize.cu at the first launch), first cuDNN call, default watchdog
#: (30 s budget, warn); prints its stats as one JSON line
COLD_B = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import nnstreamer_tpu_torch as nt
from nnstreamer_tpu_torch.backends import cuda_build, kernels
t0 = time.perf_counter()
pipe = nt.parse_launch(sys.argv[2])
runner = nt.PipelineRunner(pipe)
runner.run(600)
st = runner.stats()
print(json.dumps({
    "seconds": time.perf_counter() - t0,
    "frames": len(pipe.get("out").results),
    "watchdog_warnings": {k: v["watchdog_warnings"] for k, v in st.items()},
    "proctime_max_ms": {k: v["proctime_max_us"] / 1e3
                        for k, v in st.items()},
    "stall_budget_s": runner._stall_budget_s,
    "kernel_dir": str(cuda_build.kernel_dir()),
    "built": sorted(p.name for p in cuda_build.kernel_dir().glob("*.so")),
    "normalize_launches": kernels.normalize_u8.launches}))
"""


def b_desc(n: int, extra: str = "", norm: str = NORM_B) -> str:
    """Pipeline A or B (by `norm`) over n videotestsrc frames with every
    element named; `extra` goes between the converter and the normalize."""
    mid = f"{extra} ! " if extra else ""
    return (f"videotestsrc num-buffers={n} ! tensor_converter name=conv ! "
            f"{mid}{norm} name=norm ! {MODEL} name=model ! {LABEL} name=dec "
            f"! tensor_sink name=out")


def same_frames(a, b) -> bool:
    """Two runs' label buffers equal bit for bit: pts, payload, label
    index and score (the top logit as a float)."""
    return len(a) == len(b) and all(
        x.pts == y.pts and x.tensors[0].tobytes() == y.tensors[0].tobytes()
        and x.meta["label_index"] == y.meta["label_index"]
        and x.meta["score"] == y.meta["score"] for x, y in zip(a, b))


def traced_pipelines(nt, torch, card, record) -> dict:
    """Phase 24: A and B, TRACE_FRAMES frames each, untraced then traced.
    → the untraced B frames by pts (phase 26's reference)."""
    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.graph.pipeline import SourceElement
    from nnstreamer_tpu_torch.runtime import sync

    out = {}
    clean_b = None
    for name, norm in (("A", NORM_A), ("B", NORM_B)):
        desc = b_desc(TRACE_FRAMES, norm=norm)
        # compiled windows off: this phase counts the per-frame path's
        # spans by name (one backend invoke span a frame)
        plain = run_pipeline(nt, desc, compiled_loop=False)
        pipe = nt.parse_launch(desc)
        runner = nt.PipelineRunner(pipe, trace=True, compiled_loop=False)
        kernels.normalize_u8.launches = 0
        forced0 = sync.forced_sync_count()
        t0 = time.perf_counter()
        runner.run(600)
        wall = time.perf_counter() - t0
        launches = kernels.normalize_u8.launches
        forced = sync.forced_sync_count() - forced0
        tr = runner.tracer
        traced = pipe.get("out").results
        check(same_frames(plain, traced) and len(traced) == TRACE_FRAMES,
              f"{name}: traced outputs differ from the untraced run")
        spans, invokes = {}, {}
        for ph, cat, el, label, *_ in tr.events():
            if ph == "X" and label == "process":
                spans[el] = spans.get(el, 0) + 1
            if ph == "X" and cat == "backend" and label == "invoke":
                invokes[el] = invokes.get(el, 0) + 1
        elements = [e.name for e in pipe.elements.values()
                    if not isinstance(e, SourceElement)]
        check(all(spans.get(e) == TRACE_FRAMES for e in elements),
              f"{name}: process spans {spans}, expected {TRACE_FRAMES} for "
              f"each of {elements}")
        filters = ["model"] + (["norm"] if name == "B" else [])
        check(invokes == {f: TRACE_FRAMES for f in filters},
              f"{name}: backend invoke spans {invokes}")
        # the label decoder reads every frame back: the only forced syncs
        # of the run, one a frame, all traced under it
        check(tr.forced_syncs() == {"dec": TRACE_FRAMES} and
              forced == TRACE_FRAMES,
              f"{name}: forced syncs traced {tr.forced_syncs()}, counted "
              f"{forced}; expected {TRACE_FRAMES} at dec")
        check(launches == (TRACE_FRAMES if name == "B" else 0),
              f"{name}: normalize_u8 launched {launches} times")
        check(tr.events_dropped == 0, f"{name}: the event ring wrapped")
        path = ROOT / "chiprun_out" / f"trace_{name}.json"
        path.parent.mkdir(exist_ok=True)
        path.write_text(json.dumps(tr.to_chrome_trace(f"pipeline {name}")))
        doc = json.loads(path.read_text())
        tracks = {ev["args"]["name"] for ev in doc["traceEvents"]
                  if ev["ph"] == "M" and ev["name"] == "thread_name"}
        check(set(elements) <= tracks, f"{name}: trace tracks {tracks}")
        st = runner.stats()
        out[name] = {"seconds": wall, "events": tr.total_events,
                     "normalize_launches": launches, "forced_syncs": forced,
                     "trace_bytes": path.stat().st_size,
                     "proctime_avg_us": {k: v["proctime_avg_us"]
                                         for k, v in st.items()},
                     "queue_wait_avg_us": {k: v["queue_wait_avg_us"]
                                           for k, v in st.items()},
                     "inflight_peak": tr.inflight_gauges(),
                     "interlatency": tr.interlatency()}
        print(f"phase 24: {name} traced: {len(traced)} frames bit for bit "
              f"the untraced run's; {TRACE_FRAMES} process spans per "
              f"element, backend invoke spans {invokes}, forced syncs "
              f"{tr.forced_syncs()}, normalize_u8 launches {launches}; "
              f"{tr.total_events} events, trace {path.name} "
              f"({out[name]['trace_bytes']} B) [{card}]")
        print(runner.report())
        if name == "B":
            clean_b = {b.pts: b for b in plain}
    record["traced_pipelines"] = out
    return clean_b


def traced_llm(nt, torch, card, record, ctx) -> None:
    """Phase 25: the LLM cell (bf16, 8 requests) untraced, then traced."""
    requests = ctx["requests"]
    ref, _, wall0, _ = serve(nt, torch, requests, dtype="bfloat16")
    got, llm, wall1, launches = serve(nt, torch, requests, dtype="bfloat16",
                                      trace=True)
    ex, tr = llm.engine.executor, llm._tracer
    check(got == ref, "traced LLM tokens differ from the untraced run's")
    spans = tr.kernel_spans()
    served = ex.decode_steps + ex.chunk_prefills
    check(spans.get((llm.name, "pallas")) == ex.kernel_invokes["pallas"]
          == served > 0 and set(spans) == {(llm.name, "pallas")},
          f"kernel spans {spans}, executor kernel_invokes "
          f"{ex.kernel_invokes}, {served} decode steps and chunks")
    check(launches["paged_decode_attn"] == 4 * ex.decode_steps and
          launches["paged_prefill_attn"] == 4 * ex.chunk_prefills,
          f"paged launches {launches} for {ex.decode_steps} decode steps "
          f"and {ex.chunk_prefills} chunks")
    recs = tr.llm_requests()
    lat = llm.engine.latency_ms()
    ttft = sorted(a["first_token_ms"] for *_, a in recs)
    check(len(recs) == len(requests) and ttft == lat["first_token"],
          f"{len(recs)} request records; TTFT {ttft} vs the engine's "
          f"{lat['first_token']}")
    itl = lat["inter_token"]
    check(sum(a["n_tokens"] for *_, a in recs) == llm.engine.tokens_out and
          all(itl[0] <= a["itl_p50_ms"] <= itl[-1] for *_, a in recs),
          "request records' tokens and ITL disagree with the engine's")
    res = {"tokens": llm.engine.tokens_out, "seconds_untraced": wall0,
           "seconds_traced": wall1, "kernel_spans": spans[(llm.name,
                                                           "pallas")],
           "decode_steps": ex.decode_steps,
           "prefill_chunks": ex.chunk_prefills, "launches": launches,
           "forced_syncs": tr.forced_syncs(), "events": tr.total_events}
    record["traced_llm"] = res
    print(f"phase 25: LLM traced: tokens identical to the untraced run; "
          f"kernel spans (llm, pallas) {res['kernel_spans']} = "
          f"{ex.decode_steps} decode steps + {ex.chunk_prefills} chunks; "
          f"launches {launches}; {len(recs)} request records, TTFT p50 "
          f"{np.percentile(ttft, 50):.3f} ms; forced syncs "
          f"{tr.forced_syncs()}; {wall0:.3f} s untraced, {wall1:.3f} s "
          f"traced [{card}]")


def policies_on_card(nt, torch, card, record, clean_b) -> None:
    """Phase 26, checks: B with a seeded raise fault under skip, a delay
    fault against watchdog_action=fail, and B cold in a fresh process."""
    import shutil

    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.core.errors import StreamError, WatchdogStall

    rng = np.random.default_rng(FAULT_SEED)
    frame_ns = int(1e9 / 30)
    expect = {i * frame_ns for i in range(TRACE_FRAMES)
              if rng.random() < FAULT_P}
    pipe = nt.parse_launch(b_desc(
        TRACE_FRAMES, f"tensor_fault name=flt mode=raise probability="
        f"{FAULT_P} seed={FAULT_SEED} error-policy=skip"))
    runner = nt.PipelineRunner(pipe)
    kernels.normalize_u8.launches = 0
    runner.run(600)
    st = runner.stats()["flt"]
    got = pipe.get("out").results
    survived = {b.pts for b in got}
    check(len(got) + st["skipped"] + st["dropped"] == TRACE_FRAMES,
          f"conservation: {len(got)} out + {st['skipped']} skipped + "
          f"{st['dropped']} dropped != {TRACE_FRAMES}")
    check(set(clean_b) - survived == expect and st["skipped"] == len(expect)
          == st["errors"] > 0,
          f"faulted pts {sorted(set(clean_b) - survived)}, the seed's "
          f"{sorted(expect)}")
    check(same_frames(got, [clean_b[b.pts] for b in got]),
          "surviving frames differ from the clean run's")
    check(kernels.normalize_u8.launches == len(got),
          f"{kernels.normalize_u8.launches} normalize launches for "
          f"{len(got)} frames")
    print(f"phase 26: B with tensor_fault raise p {FAULT_P} seed "
          f"{FAULT_SEED} under skip: {len(got)} frames out + "
          f"{st['skipped']} skipped + {st['dropped']} dropped = "
          f"{TRACE_FRAMES}; skipped frames {sorted(expect)} (pts) as the "
          f"seed draws them; survivors bit for bit the clean run's")

    pipe = nt.parse_launch(b_desc(8, "tensor_fault name=delay mode=delay "
                                     "delay-ms=30000 period=1"))
    runner = nt.PipelineRunner(pipe, stall_budget_s=0.5,
                               watchdog_action="fail")
    t0 = time.perf_counter()
    try:
        runner.run(60)
        raised = None
    except StreamError as e:
        raised = e
    fired = time.perf_counter() - t0
    check(raised is not None and isinstance(raised.__cause__, WatchdogStall)
          and "element delay exceeded its stall budget" in str(raised)
          and fired < 5.0,
          f"delay fault vs stall budget 0.5 s: {raised!r} after {fired:.2f} s")
    print(f"phase 26: B with a 30 s delay fault, stall_budget_s 0.5, "
          f"watchdog_action fail: WatchdogStall after {fired:.3f} s "
          f"({raised})")

    cold_dir = ROOT / "build" / "cold_kernels"
    shutil.rmtree(cold_dir, ignore_errors=True)
    env = {**__import__("os").environ,
           "NNSTREAMER_TPU_TORCH_BUILD_KERNEL_DIR": str(cold_dir)}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", COLD_B, str(ROOT), b_desc(16)],
        capture_output=True, text=True, env=env, timeout=600)
    cold_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"cold B failed:\n{proc.stderr[-3000:]}")
    cold = json.loads(proc.stdout.strip().splitlines()[-1])
    cold["process_seconds"] = cold_s
    shutil.rmtree(cold_dir, ignore_errors=True)
    check(cold["frames"] == 16 and cold["normalize_launches"] == 16
          and cold["kernel_dir"] == str(cold_dir)
          and any(n.startswith("normalize-") for n in cold["built"]),
          f"cold B: {cold}")
    check(not any(cold["watchdog_warnings"].values()),
          f"the watchdog fired on cold B: {cold['watchdog_warnings']}")
    record["policies"] = {"fault_skip": {"out": len(got),
                                         "skipped": st["skipped"],
                                         "faulted_pts": sorted(expect)},
                          "watchdog_fail_s": fired, "cold_b": cold}
    print(f"phase 26: B cold in a fresh process (kernels built into an "
          f"empty directory): {cold['frames']} frames, no watchdog warning "
          f"at the {cold['stall_budget_s']} s budget; slowest call per "
          f"element (ms) {cold['proctime_max_ms']}; {cold['seconds']:.2f} s "
          f"in the pipeline, {cold_s:.2f} s for the process [{card}]")


def interleaved_arms(nt, build, frame, n_lat, warmup, n_burst, arms):
    """Latency and frames/s of several arms of one pipeline, in turns in
    one process: each arm's pipeline (build(): an appsrc named src to a
    tensor_sink named out) runs under its own PipelineRunner(**kw), all
    at once. Latency: each round pushes one frame into every arm in turn
    (the order reversed every other round) and waits for it at the sink.
    Frames/s: n_burst frames pushed at once into one arm, timed to the
    last one's arrival, arms in turns a b b a.
    → ({arm: latencies in ms}, {arm: [frames/s]}, {arm: runner})."""
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    runs = {}

    def arrive(arm):
        def on_buf(b):
            runs[arm][2][0] += 1
            runs[arm][3].set()
        return on_buf

    def wait_count(arm, n):
        deadline = time.monotonic() + 300
        while runs[arm][2][0] < n:
            check(time.monotonic() < deadline,
                  f"{arm}: {runs[arm][2][0]} of {n} frames in 300 s")
            time.sleep(0.0005)

    try:
        for arm, kw in arms.items():
            pipe = build()
            pipe.get("out").set_props(new_data=arrive(arm), collect=False)
            runs[arm] = (pipe, nt.PipelineRunner(pipe, **kw).start(), [0],
                         threading.Event())
        lat = {arm: [] for arm in arms}
        order = list(arms)
        pts = 0
        for i in range(warmup + n_lat):
            for arm in (order if i % 2 == 0 else order[::-1]):
                pipe, _, _, got = runs[arm]
                got.clear()
                t0 = time.perf_counter()
                pipe.get("src").push(TensorBuffer.of(frame, pts=pts))
                pts += 1
                check(got.wait(60), f"{arm}: no frame back within 60 s")
                if i >= warmup:
                    lat[arm].append((time.perf_counter() - t0) * 1e3)
        fps = {arm: [] for arm in arms}
        for arm in order + order[::-1]:
            pipe, _, count, _ = runs[arm]
            start = count[0]
            t0 = time.perf_counter()
            for _ in range(n_burst):
                pipe.get("src").push(TensorBuffer.of(frame, pts=pts))
                pts += 1
            wait_count(arm, start + n_burst)
            fps[arm].append(n_burst / (time.perf_counter() - t0))
        for pipe, runner, _, _ in runs.values():
            pipe.get("src").end()
            runner.wait(60)
    finally:
        for _, runner, _, _ in runs.values():
            runner.stop()
    return lat, fps, {arm: r[1] for arm, r in runs.items()}


def tracer_hook_us(n: int = 20000) -> float:
    """Host µs per recorded event of the scheduler's hooks on this
    machine's CPU (enqueue, dequeue, process span, backend span,
    in-flight gauge in turn, each with its perf_counter read)."""
    from nnstreamer_tpu_torch.runtime.tracing import Tracer
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    tr = Tracer()
    buf = TensorBuffer.of(np.zeros(1, np.uint8))
    tr.source_emit("src", buf, time.perf_counter())
    t0 = time.perf_counter()
    for _ in range(n):
        tr.enqueue("e", 1, time.perf_counter())
        tr.dequeue("e", 0, time.perf_counter())
        t = time.perf_counter()
        tr.record_process("e", buf, t, time.perf_counter())
        tr.backend_span("e", "invoke", t, time.perf_counter())
        tr.record_inflight("e", 1, time.perf_counter())
    return (time.perf_counter() - t0) / (5 * n) * 1e6


#: phase 26: closed-loop frames a arm (after RT_WARMUP; 64 until phases
#: 56-57 came) and the frames of each of its two bursts an arm
RT_LAT, RT_WARMUP, RT_BURST = 32, 10, 64


def runtime_timings(nt, torch, card, record) -> None:
    """Phase 26, timings, arms alternating in this one process: A and B
    with the tracer off and on, D compact-1, P host-1 and P host-1 with
    its transforms unfused with chain fusion off and on. Latency p50/p99
    over RT_LAT closed-loop frames a arm, interleaved frame by frame, and
    frames/s over bursts of RT_BURST frames, two a arm in turns
    (interleaved_arms); the tracer's own host cost per event
    (tracer_hook_us)."""
    res = {}
    fa = u8_frames((1, 224, 224, 3), 1, 0)[0]
    fd = u8_frames((1, 300, 300, 3), 1, 1)[0]
    fp = u8_frames((1, 257, 257, 3), 1, 2)[0]
    ab = "appsrc name=src dims=3:224:224:1 types=uint8 ! {} ! " + \
        f"{MODEL} ! {LABEL} ! tensor_sink name=out"
    tracer = {"tracer off": {"trace": False}, "tracer on": {"trace": True}}
    fusion = {"fusion off": {"chain_fusion": False},
              "fusion on": {"chain_fusion": True}}
    p_desc = p_head() + f"{P_DEC} max_in_flight=1 ! tensor_sink name=out"
    cells = {
        "A": (ab.format(NORM_A), fa, tracer),
        "B": (ab.format(NORM_B), fa, tracer),
        "D compact-1": (d_head() + f"{D_DEC} {D_MODES['D compact-1']} ! "
                        f"tensor_sink name=out", fd, fusion),
        "P host-1": (p_desc, fp, fusion),
        "P host-1 unfused": (p_desc, fp, {
            a: {**kw, "optimize": False} for a, kw in fusion.items()}),
    }
    for name, (desc, frame, arms) in cells.items():
        def build(desc=desc):
            return nt.parse_launch(desc)
        lat, fps, runners = interleaved_arms(nt, build, frame, RT_LAT,
                                             RT_WARMUP, RT_BURST, arms)
        res[name] = {}
        for arm in arms:
            r = res[name][arm] = {
                "p50_ms": float(np.percentile(lat[arm], 50)),
                "p99_ms": float(np.percentile(lat[arm], 99)),
                "mean_ms": float(np.mean(lat[arm])), "fps": fps[arm],
                "fused_chains": runners[arm].fused_chains()}
            tr = runners[arm].tracer
            if tr.active:
                r["events_per_frame"] = tr.total_events / (
                    RT_LAT + RT_WARMUP + 2 * RT_BURST)
            print(f"phase 26: {name}, {arm}: latency p50 {r['p50_ms']:.3f} "
                  f"ms, p99 {r['p99_ms']:.3f} ms, mean {r['mean_ms']:.3f} "
                  f"ms ({RT_LAT} frames, interleaved with the other arm); "
                  + " / ".join(f"{f:.1f}" for f in fps[arm])
                  + f" frames/s (bursts of {RT_BURST}, in turns); fused chains "
                  f"{r['fused_chains']}"
                  + (f"; {r['events_per_frame']:.1f} events a frame"
                     if "events_per_frame" in r else "") + f" [{card}]")
        a, b = list(arms)
        d = 100 * (res[name][b]["p50_ms"] / res[name][a]["p50_ms"] - 1)
        print(f"phase 26: {name}: {b} vs {a}: latency p50 {d:+.2f}% "
              f"[{card}]")
    hook = tracer_hook_us()
    res["tracer_hook_us_per_event"] = hook
    for name in ("A", "B"):
        ev = res[name]["tracer on"]["events_per_frame"]
        print(f"phase 26: tracer hooks cost {hook:.3f} us a recorded event "
              f"on this host; {name} records {ev:.1f} events a frame: "
              f"{hook * ev / 1e3:.4f} ms a frame [{card}]")
    record["runtime_timings"] = res


def slice6_phases(nt, torch, card, record, phases, ctx) -> None:
    """Phases 24-26."""
    clean_b = traced_pipelines(nt, torch, card, record)
    phases.done("24 (A and B traced)")
    traced_llm(nt, torch, card, record, ctx)
    phases.done("25 (LLM traced)")
    policies_on_card(nt, torch, card, record, clean_b)
    runtime_timings(nt, torch, card, record)
    phases.done("26 (policies, watchdog, tracer and fusion timings)")


# -- Queue 1 items 1c-1d: micro-batched B, filter properties, FLEXIBLE ------

BATCH_FRAMES = 203
BATCH_MAX = 8
#: tensor_batch's deadline in phases 27-28 (PERF.md §6): about one
#: unbatched B frame's host time, so a lone frame waits at most that long
BATCH_LATENCY_MS = 20
BATCH = (f"tensor_batch name=batch max-batch={BATCH_MAX} "
         f"max-latency-ms={BATCH_LATENCY_MS}")
#: bursts an arm in the timing arms of burst_arms
BURSTS = 1
#: phase 27's bursts
BATCH_BURST = 64
#: frames of burst_arms' profiled burst an arm (48 until phases 50-51
#: came): its kernels and kernel time a frame are means over identical
#: frames, and reading the profiler's trace takes seconds an arm
PROF_FRAMES = 16
APPSRC = "appsrc name=src dims=3:224:224:1 types=uint8"


def b_string(head: str, batched: bool, model: str = MODEL,
             label: bool = True) -> str:
    """Pipeline B after `head`, micro-batched (tensor_batch before the
    normalize filter, tensor_unbatch after the model) or not."""
    mid = (f"{BATCH} ! {NORM_B} name=norm ! {model} name=model ! "
           f"tensor_unbatch name=unb" if batched else
           f"{NORM_B} name=norm ! {model} name=model")
    tail = f" ! {LABEL} name=dec" if label else ""
    return f"{head} ! {mid}{tail} ! tensor_sink name=out"


def label_flips(nt, head, labels_b, labels_u):
    """Frames whose batched and unbatched bf16 labels differ, each with
    the unbatched run's top-2 logit gap and the two runs' largest logit
    difference on that frame (from runs without the decoder). A flip is
    a near tie when the gap is no larger than that difference."""
    flips = [i for i, (a, b) in enumerate(zip(labels_b, labels_u)) if a != b]
    if not flips:
        return []
    zb = run_pipeline(nt, b_string(head, True, label=False))
    zu = run_pipeline(nt, b_string(head, False, label=False))
    out = []
    for i in flips:
        a, b = zb[i].tensors[0][0], zu[i].tensors[0][0]
        top2 = np.sort(b)[-2:]
        out.append({"frame": i, "gap": float(top2[1] - top2[0]),
                    "diff": float(np.abs(a - b).max())})
    return out


def burst_arms(nt, torch, descs, frame, n, bursts, prof_frames=PROF_FRAMES,
               runner_kw=None):
    """Each arm's pipeline (descs: arm -> string, an appsrc named src to a
    tensor_sink named out; runner_kw: arm -> PipelineRunner keywords)
    live at once in this process. Every bucket is
    warmed first (1, 2, 4 and 8 frames, each waited for, then one untimed
    burst of n, which captures the graph of every window size a burst
    forms, so no timed burst pays for a capture). Then bursts of
    n frames pushed at once into one arm at a time, arms in turns a b b
    a: frames/s from the first push to the last arrival, and each frame's
    latency from its push to its arrival at the sink. Last, one profiled
    burst of prof_frames an arm: CUDA kernel time and kernel records per
    frame. → {arm: {"fps": [...], "lat": [ms...], "device_ms_per_frame":
    x, "kernels_per_frame": n}}. `frame`: one frame for every arm, or a
    dict of one an arm."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    frames = frame if isinstance(frame, dict) else dict.fromkeys(descs, frame)
    live, res = {}, {arm: {"fps": [], "lat": []} for arm in descs}
    pts = [0]

    def arrive(arm):
        def on_buf(b):
            live[arm][2][b.pts] = time.perf_counter()
        return on_buf

    def burst(arm, k):
        pipe, _, seen = live[arm]
        first = pts[0]
        pushed = {}
        t0 = time.perf_counter()
        for _ in range(k):
            pushed[pts[0]] = time.perf_counter()
            pipe.get("src").push(TensorBuffer.of(frames[arm], pts=pts[0]))
            pts[0] += 1
        deadline = time.monotonic() + 300
        while len([p for p in pushed if p in seen]) < k:
            check(time.monotonic() < deadline,
                  f"{arm}: burst of {k} not drained in 300 s")
            time.sleep(0.0005)
        last = max(seen[p] for p in pushed)
        return k / (last - t0), [(seen[p] - pushed[p]) * 1e3
                                 for p in range(first, pts[0])]

    try:
        for arm, desc in descs.items():
            pipe = nt.parse_launch(desc)
            pipe.get("out").set_props(new_data=arrive(arm), collect=False)
            live[arm] = (pipe, nt.PipelineRunner(
                pipe, **(runner_kw or {}).get(arm, {})).start(), {})
        for arm in descs:
            for k in (1, 2, 4, BATCH_MAX, 3, n):
                burst(arm, k)
        order = list(descs)
        for _ in range(bursts):
            for arm in order + order[::-1]:
                fps, lat = burst(arm, n)
                res[arm]["fps"].append(fps)
                res[arm]["lat"] += lat
        for arm in order:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                open_capture(torch)
                burst(arm, prof_frames)
                torch.cuda.synchronize()
                close_capture(torch)
            evs = kernel_events(prof)
            res[arm]["device_ms_per_frame"] = sum(
                e.time_range.elapsed_us() for e in evs) / 1e3 / prof_frames
            res[arm]["kernels_per_frame"] = len(evs) / prof_frames
        for pipe, runner, _ in live.values():
            pipe.get("src").end()
            runner.wait(60)
    finally:
        for _, runner, _ in live.values():
            runner.stop()
    return res


def batched_b_phase(nt, torch, card, record) -> None:
    """Phase 27: B micro-batched at full width (MobileNetV2 1.0, 224²,
    bf16): the main path's counts and buckets, labels against unbatched
    B, f32 logits against unbatched B, then batched and unbatched B timed
    in turns in this one process."""
    from nnstreamer_tpu_torch.backends import kernels

    head = f"videotestsrc num-buffers={BATCH_FRAMES} ! tensor_converter"
    pipe = nt.parse_launch(b_string(head, True))
    runner = nt.PipelineRunner(pipe)
    kernels.normalize_u8.launches = 0
    t0 = time.perf_counter()
    runner.run(600)
    wall = time.perf_counter() - t0
    launches = kernels.normalize_u8.launches
    out = pipe.get("out").results
    model = pipe.get("model").backend
    st = runner.stats()
    hist = dict(sorted(model.batch_size_hist.items()))
    buckets = sorted({k[1] for k in model.bucket_shapes})
    pts = [b.pts for b in out]
    print(f"phase 27: B micro-batched (max-batch {BATCH_MAX}, max-latency-ms "
          f"{BATCH_LATENCY_MS}), {BATCH_FRAMES} frames in {wall:.3f} s: "
          f"normalize_u8 launched {launches} times; tensor_batch occupancy "
          f"{st['batch']['occupancy_hist']} (flushes full "
          f"{st['batch']['flush_full']}, deadline "
          f"{st['batch']['flush_deadline']}, eos {st['batch']['flush_eos']}); "
          f"the model filter's occupancies {hist}, bucket batch sizes "
          f"{buckets} [{card}]")
    check(launches == BATCH_FRAMES,
          f"normalize_u8 launched {launches} times for {BATCH_FRAMES} frames")
    check(set(buckets) <= {1, 2, 4, 8} and buckets,
          f"model buckets {model.bucket_shapes} outside {{1, 2, 4, 8}}")
    check(sum(n * c for n, c in hist.items()) == BATCH_FRAMES,
          f"batch_size_hist {hist} does not sum to {BATCH_FRAMES} frames")
    check(len(out) == BATCH_FRAMES and pts == sorted(pts)
          and len(set(pts)) == BATCH_FRAMES,
          f"{len(out)} frames out, pts in order: {pts == sorted(pts)}")
    plain = run_pipeline(nt, b_string(head, False))
    labels_b = [b.meta["label_index"] for b in out]
    labels_u = [b.meta["label_index"] for b in plain]
    check([b.pts for b in plain] == pts, "unbatched B's pts differ")
    flips = label_flips(nt, head, labels_b, labels_u)
    print(f"phase 27: bf16 labels, batched vs unbatched B: "
          f"{BATCH_FRAMES - len(flips)}/{BATCH_FRAMES} equal"
          + (f"; flips (frame, top-2 gap, max |logit diff|): "
             + ", ".join(f"({f['frame']}, {f['gap']:.4g}, {f['diff']:.4g})"
                         for f in flips) if flips else "")
          + f"; {len(set(labels_u))} distinct labels")
    check(all(f["gap"] <= f["diff"] for f in flips),
          f"batched labels flip beyond a near tie: {flips}")

    # f32, TF32 off: logits of the batched path against unbatched B
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n32 = 2 * BATCH_MAX + 3
    head32 = f"videotestsrc num-buffers={n32} ! tensor_converter"
    m32 = f"{MODEL}?dtype=float32"
    zb = run_pipeline(nt, b_string(head32, True, m32, label=False))
    zu = run_pipeline(nt, b_string(head32, False, m32, label=False))
    torch.backends.cudnn.allow_tf32 = True
    gb = np.concatenate([b.tensors[0] for b in zb])
    gu = np.concatenate([b.tensors[0] for b in zu])
    rel = float(np.abs(gb - gu).max() / np.abs(gu).max())
    print(f"phase 27: f32 (TF32 off), {n32} frames: batched vs unbatched "
          f"logits max |diff| / max |logit| = {rel:.3e} (tolerance "
          f"{CPU_TOLERANCE}); labels equal: "
          f"{bool((gb.argmax(-1) == gu.argmax(-1)).all())}")
    check(gb.shape == gu.shape == (n32, 1001) and np.isfinite(gb).all(),
          f"f32 batched logits {gb.shape}")
    check((gb.argmax(-1) == gu.argmax(-1)).all(), "f32 labels differ")
    check(rel <= CPU_TOLERANCE, f"f32 batched logits differ by {rel:.3e}")

    # the model filter's process span per batch, from the tracer
    pipe = nt.parse_launch(b_string(
        f"videotestsrc num-buffers={TRACE_FRAMES} ! tensor_converter", True))
    runner = nt.PipelineRunner(pipe, trace=True)
    runner.run(600)
    spans = {}
    batched_spans = []
    for ph, cat, el, label, ts, dur, args in runner.tracer.events():
        if ph == "X" and label == "process":
            spans.setdefault(el, []).append(dur * 1e3)
        if ph == "X" and cat == "backend" and label == "invoke_batched":
            batched_spans.append((args["n"], args["bucket"]))
    # median: a bucket's first batch also takes the batchability verdict
    span_ms = {el: {"median": float(np.median(v)), "max": float(max(v))}
               for el, v in spans.items()}
    print(f"phase 27: traced, {TRACE_FRAMES} frames: process spans "
          f"(count, median ms, max ms) "
          + ", ".join(f"{el} ({len(spans[el])}, {span_ms[el]['median']:.3f}"
                      f", {span_ms[el]['max']:.3f})" for el in sorted(spans))
          + f"; the model's invoke_batched spans (n, bucket) "
          f"{batched_spans} [{card}]")
    check(len(spans.get("norm", ())) == len(batched_spans)
          == len(spans.get("model", ())) and sum(
              n for n, _ in batched_spans) == TRACE_FRAMES,
          "one normalize and one model span per batch")

    descs = {"unbatched": b_string(APPSRC, False),
             "batched": b_string(APPSRC, True)}
    frame = u8_frames((1, 224, 224, 3), 1, 0)[0]
    # compiled windows off: the unbatched arm measures the per-frame path
    # (phase 29 measures windows against it)
    arms = burst_arms(nt, torch, descs, frame, BATCH_BURST, BURSTS,
                      runner_kw={a: {"compiled_loop": False} for a in descs})
    res = {}
    for arm, r in arms.items():
        fps = float(np.median(r["fps"]))
        res[arm] = {"fps": r["fps"], "fps_median": fps,
                    "p50_ms": float(np.percentile(r["lat"], 50)),
                    "p99_ms": float(np.percentile(r["lat"], 99)),
                    "device_ms_per_frame": r["device_ms_per_frame"],
                    "busy_share": r["device_ms_per_frame"] * fps / 1e3}
        print(f"phase 27: {arm} B, bursts of {BATCH_BURST} frames in turns: "
              + " / ".join(f"{f:.1f}" for f in r["fps"])
              + f" frames/s to the last frame; latency under the burst p50 "
              f"{res[arm]['p50_ms']:.3f} ms p99 {res[arm]['p99_ms']:.3f} ms; "
              f"{r['device_ms_per_frame']:.3f} ms of kernel time a frame, "
              f"card busy {100 * res[arm]['busy_share']:.1f}% [{card}]")
    ratio = res["batched"]["fps_median"] / res["unbatched"]["fps_median"]
    print(f"phase 27: batched / unbatched frames/s {ratio:.3f} [{card}]")
    record["batched_b"] = {
        "launches": launches, "occupancy_hist": st["batch"]["occupancy_hist"],
        "flushes": {k: st["batch"][k] for k in
                    ("flush_full", "flush_deadline", "flush_eos")},
        "batch_size_hist": hist, "buckets": buckets, "label_flips": flips,
        "f32_rel_err": rel, "process_span_ms": span_ms,
        "invoke_batched_spans": batched_spans, "timings": res,
        "fps_ratio": ratio}


def filter_props_phase(nt, torch, card, record) -> None:
    """Phase 28: tensor_filter's properties and FLEXIBLE invokes on the
    card: an i0,o0 output combination, latency-mode=sync, a shared-key
    reload mid-stream, crop → MobileNetV2 invoke-dynamic."""
    from nnstreamer_tpu_torch.backends.torch_backend import next_pow2
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    n = 8
    head = f"videotestsrc num-buffers={n} ! tensor_converter"
    normed = run_pipeline(nt, f"{head} ! {NORM_B} ! tensor_sink name=out")
    plain = run_pipeline(nt, b_string(head, False, label=False))
    pipe = nt.parse_launch(
        f"{head} ! {NORM_B} name=norm ! {MODEL} name=model "
        f"output_combination=i0,o0 ! tensor_sink name=out")
    runner = nt.PipelineRunner(pipe).start()
    try:
        runner.wait(600)
        # the passed-through tensor is the filter's input object, on the
        # card (asked of the filter before stop() closes its backend)
        x = torch.from_numpy(normed[0].tensors[0]).cuda()
        (_, ob), = pipe.get("model").process(0, TensorBuffer.of(x, pts=0))
    finally:
        runner.stop()
    check(ob.tensors[0] is x and ob.tensors[0].is_cuda,
          "i0 is not the input tensor itself on the card")
    combo = pipe.get("out").results
    check(len(combo) == n and all(
        c.tensors[0].tobytes() == m.tensors[0].tobytes()
        and c.tensors[1].tobytes() == p.tensors[0].tobytes()
        for c, m, p in zip(combo, normed, plain)),
        "output_combination=i0,o0: not (the normalize output, the logits)")
    print(f"phase 28: output_combination=i0,o0: {n} frames = (the normalize "
          f"output, B's logits) bit for bit; the passed tensor is the input "
          f"object on {ob.tensors[0].device}")

    pipe = nt.parse_launch(
        f"{head} ! {NORM_B} name=norm ! {MODEL} name=model "
        f"latency_mode=sync ! tensor_sink name=out")
    runner = nt.PipelineRunner(pipe)
    runner.run(600)
    synced = pipe.get("out").results
    st = runner.stats()["model"]
    check(st.get("forced_syncs") == n, f"forced_syncs {st.get('forced_syncs')}"
                                       f" for {n} frames")
    check(len(synced) == n and all(
        a.tensors[0].tobytes() == b.tensors[0].tobytes()
        for a, b in zip(synced, plain)), "sync outputs differ from async")
    print(f"phase 28: latency_mode=sync: forced_syncs {st['forced_syncs']} "
          f"for {n} frames, outputs bit for bit the async run's; invoke "
          f"latency {st['invoke_latency_us']:.1f} us (sync) [{card}]")

    # a shared-key reload mid-stream (C's two filters, f32, TF32 off)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    old, new = ("zoo://mobilenet_v2?dtype=float32",
                "zoo://mobilenet_v2?dtype=float32&seed=1")
    frames = [tuple(u8_frames((1, 224, 224, 3), 2, 40 + i)) for i in range(4)]
    pipe = composite_pipe(nt, model=old, sink="tensor_sink")
    pipe.get("fa").set_props(is_updatable=True)
    runner = nt.PipelineRunner(pipe).start()
    src, sink = pipe.get("src"), pipe.get("out")
    try:
        for i, f in enumerate(frames):
            if i == 2:
                deadline = time.monotonic() + 120
                while len(sink.results) < 2:
                    check(time.monotonic() < deadline, "C stalled")
                    time.sleep(0.001)
                pipe.get("fa").reload_model(new)
            src.push(TensorBuffer.of(*f, pts=i))
        src.end()
        runner.wait(600)
    finally:
        runner.stop()
    muxed = sink.results
    reload_worst, apart = 0.0, np.inf
    for branch in (0, 1):
        refs = {}
        for ref in (old, new):
            refs[ref] = run_desc(
                nt, ingest("3:224:224:1") + f"tensor_filter model={ref} ! "
                "tensor_sink name=out", [f[branch] for f in frames])
        for i, m in enumerate(muxed):
            want = refs[old if i < 2 else new][i].tensors[0]
            other = refs[new if i < 2 else old][i].tensors[0]
            scale = float(np.abs(want).max())
            reload_worst = max(reload_worst, float(
                np.abs(m.tensors[branch] - want).max()) / scale)
            apart = min(apart, float(np.abs(m.tensors[branch] - other).max())
                        / scale)
    torch.backends.cudnn.allow_tf32 = True
    print(f"phase 28: C reload through one of two filters on one key after "
          f"frame 2: {len(muxed)} muxed frames, each branch within "
          f"{reload_worst:.3e} of max |logit| of its expected model and "
          f">= {apart:.3e} from the other [{card}]")
    check(len(muxed) == len(frames) and reload_worst <= CPU_TOLERANCE
          and apart > 100 * CPU_TOLERANCE,
          f"shared reload: {len(muxed)} frames, worst {reload_worst:.3e}, the "
          f"other model {apart:.3e}")

    # crop → MobileNetV2 invoke-dynamic with spatial bucketing, f32
    torch.backends.cudnn.allow_tf32 = False
    regions = [np.array([[0, 0, 100, 80], [10, 10, 57, 57]], np.uint32),
               np.array([[0, 0, 224, 224]], np.uint32),
               np.array([[5, 5, 33, 120], [50, 50, 100, 80],
                         [60, 60, 100, 80]], np.uint32)]
    img = u8_frames((1, 224, 224, 3), len(regions), 50)
    predicted = set()
    for reg in regions:
        shapes = {}
        for x, y, w, h in reg:
            shapes[(1, int(h), int(w), 3)] = shapes.get(
                (1, int(h), int(w), 3), 0) + 1
        for (_, h, w, c), k in shapes.items():
            predicted.add(("bat", next_pow2(k), 1, next_pow2(h, 16),
                           next_pow2(w, 16), c))
    outs, buckets = {}, None
    for accel in ("cuda", "cpu"):
        pipe = nt.parse_launch(
            f"appsrc name=raw dims=3:224:224:1 types=uint8 ! {NORM_B} "
            f"accelerator={accel} ! crop.sink_0 appsrc name=info dims=4:1 "
            f"types=uint32 ! crop.sink_1 tensor_crop name=crop ! "
            f"tensor_filter name=f model=zoo://mobilenet_v2?dtype=float32 "
            f"accelerator={accel} invoke_dynamic=true "
            f"custom=dynamic_spatial=true ! tensor_sink name=out")
        runner = nt.PipelineRunner(pipe).start()
        try:
            for i, (f, reg) in enumerate(zip(img, regions)):
                pipe.get("raw").push(TensorBuffer.of(f, pts=i))
                pipe.get("info").push(TensorBuffer.of(reg, pts=i))
            pipe.get("raw").end()
            pipe.get("info").end()
            runner.wait(600)
        finally:
            runner.stop()
        outs[accel] = pipe.get("out").results
        if accel == "cuda":
            buckets = set(pipe.get("f").backend.bucket_shapes)
    torch.backends.cudnn.allow_tf32 = True
    worst = 0.0
    for g, c, reg in zip(outs["cuda"], outs["cpu"], regions):
        check(len(g.tensors) == len(c.tensors) == len(reg),
              f"{len(g.tensors)} region outputs for {len(reg)} regions")
        for a, b in zip(g.tensors, c.tensors):
            check(a.shape == b.shape == (1, 1001) and np.isfinite(a).all(),
                  f"region output {a.shape}")
            worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    print(f"phase 28: crop -> MobileNetV2 invoke_dynamic "
          f"dynamic_spatial, {sum(len(r) for r in regions)} regions in "
          f"{len(regions)} frames: card vs CPU max |diff| / max |logit| "
          f"{worst:.3e} (tolerance {CPU_TOLERANCE}); bucket shapes "
          f"{sorted(buckets)}, predicted {sorted(predicted)} [{card}]")
    check(len(outs["cuda"]) == len(regions), "crop frames lost")
    check(worst <= CPU_TOLERANCE, f"crop card vs CPU {worst:.3e}")
    check(buckets == predicted, f"buckets {buckets} != {predicted}")
    record["filter_props"] = {"reload_rel_err": reload_worst,
                              "reload_other_model": apart,
                              "crop_rel_err": worst,
                              "crop_buckets": sorted(buckets)}


def batching_phases(nt, torch, card, record, phases) -> None:
    """Phases 27-28."""
    batched_b_phase(nt, torch, card, record)
    phases.done("27 (B micro-batched)")
    filter_props_phase(nt, torch, card, record)
    phases.done("28 (filter properties, FLEXIBLE invokes)")


# -- Queue 1 item 1e: compiled windows (CUDA-graph replays) -----------------

#: phase 29: frames pushed at once a pipeline and arm (200 until phases
#: 50-51 came, 96 until phases 56-57 came), f32 B's, and P's profiled
#: run; its timing bursts: 64 frames (200 until phases 43-44 took the
#: whole run past 760 s; 120 until phases 45-46 took it past 820 s)
WINDOW_FRAMES, WINDOW_F32_FRAMES, WINDOW_PROF_FRAMES = 64, 64, 48
WINDOW_BURST = 64
#: phase 30: the engine's decode window
DECODE_WINDOW = 8


def window_pipes():
    """Phase 29's pipelines: name → (the string whose raw outputs are
    compared, the string timed in bursts, the model filter's name, the
    frame's shape). Each reads an appsrc named src and ends in a
    tensor_sink named out; bf16 models."""
    a = f"{APPSRC} ! {NORM_A} ! {MODEL} name=model"
    b = f"{APPSRC} ! {NORM_B} name=norm ! {MODEL} name=model"
    label = f" ! {LABEL} name=dec ! tensor_sink name=out"
    d = d_head() + f"{D_DEC} device=true ! tensor_sink name=out"
    return {
        "A": (a + " ! tensor_sink name=out", a + label, "model",
              (1, 224, 224, 3)),
        "B": (b + " ! tensor_sink name=out", b + label, "model",
              (1, 224, 224, 3)),
        "P": (p_head() + "tensor_sink name=out",
              p_head() + f"{P_DEC} max_in_flight=1 ! tensor_sink name=out",
              "f", (1, 257, 257, 3)),
        "D": (d, d, "f", (1, 300, 300, 3)),
    }


def window_run(nt, torch, desc, frames, model, prof=None, warm=(),
               **runner_kw):
    """`desc` traced over `frames` pushed at once (pts = index), the
    clamp_scale count zeroed first; `prof`, when given, around the run.
    `warm`: bursts of frames pushed and drained before, outside `prof`
    and the counts (so the graphs are captured outside the profile).
    → {"out", "stats" (the model filter's row), "khist" (windows by K),
    "span_ms" (the model's process span a frame, median), "graphs",
    "captures", "capture_s", "capture_failed", "mem" (memory_allocated
    before start and after the run), "clamp", "seconds"}."""
    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    pipe = nt.parse_launch(desc)
    runner = nt.PipelineRunner(pipe, trace=True, **runner_kw)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    runner.start()
    src, sink = pipe.get("src"), pipe.get("out")
    pts = 0
    try:
        for n in warm:
            for _ in range(n):
                src.push(TensorBuffer.of(frames[0], pts=pts))
                pts += 1
            deadline = time.monotonic() + 120
            while len(sink.results) < pts:
                check(time.monotonic() < deadline, "warm-up stalled")
                time.sleep(0.001)
        torch.cuda.synchronize()
        sink.results.clear()
        kernels.clamp_scale.launches = 0
        with prof or nullcontext():
            if prof is not None:
                open_capture(torch)
            t0 = time.perf_counter()
            for i, f in enumerate(frames):
                src.push(TensorBuffer.of(f, pts=pts + i))
            src.end()
            runner.wait(600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if prof is not None:
                close_capture(torch)
        be = pipe.get(model).backend
        res = {"graphs": sorted(k[0] for k in be._graphs.graphs),
               "captures": be.window_compile_count,
               "capture_s": list(be.capture_seconds),
               "capture_failed": sorted(set(be._graphs.failed.values())),
               "mem": (mem0, torch.cuda.memory_allocated()),
               "clamp": kernels.clamp_scale.launches, "seconds": wall}
    finally:
        runner.stop()
    tr = runner.tracer
    check(tr.events_dropped == 0, "the event ring wrapped")
    khist, spans = {}, []
    for ph, cat, el, label, ts, dur, args in tr.events():
        if el == model and label == "compiled_window":
            khist[args["frames"]] = khist.get(args["frames"], 0) + 1
        if el == model and ph == "X" and label == "process":
            spans.append(dur * 1e3)
    res.update(out=pipe.get("out").results, stats=runner.stats()[model],
               khist=dict(sorted(khist.items())),
               span_ms=float(np.median(spans)))
    return res


def same_outputs(a, b) -> bool:
    """Two runs' buffers equal bit for bit, frame by frame."""
    return len(a) == len(b) and all(
        x.pts == y.pts and len(x.tensors) == len(y.tensors) and all(
            np.asarray(u).tobytes() == np.asarray(v).tobytes()
            for u, v in zip(x.tensors, y.tensors)) for x, y in zip(a, b))


def window_reload(nt, torch, card) -> dict:
    """Phase 29's swap: C's two filters on one key (f32, TF32 off), 12
    frames pushed at once and drained, a reload through fa, 12 more: fb
    takes the "swap" bail, both branches serve the new model from frame
    12, and fb's graphs are all the new model's."""
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    old, new = ("zoo://mobilenet_v2?dtype=float32",
                "zoo://mobilenet_v2?dtype=float32&seed=1")
    half = 12
    frames = [tuple(u8_frames((1, 224, 224, 3), 2, 60 + i))
              for i in range(2 * half)]
    pipe = composite_pipe(nt, model=old, sink="tensor_sink")
    pipe.get("fa").set_props(is_updatable=True)
    runner = nt.PipelineRunner(pipe, trace=True).start()
    src, sink = pipe.get("src"), pipe.get("out")
    try:
        for i, f in enumerate(frames):
            if i == half:
                deadline = time.monotonic() + 120
                while len(sink.results) < half:
                    check(time.monotonic() < deadline, "C stalled")
                    time.sleep(0.001)
                pre = pipe.get("fb").backend.window_compile_count
                pipe.get("fa").reload_model(new)
            src.push(TensorBuffer.of(*f, pts=i))
        src.end()
        runner.wait(600)
        fb = pipe.get("fb").backend
        fresh = all(g.keep[1] is fb._params
                    for g in fb._graphs.graphs.values())
        post = fb.window_compile_count
        failed = {f: sorted(set(pipe.get(f).backend._graphs.failed.values()))
                  for f in ("fa", "fb")}
    finally:
        runner.stop()
    muxed = sink.results
    st = runner.stats()
    worst, apart = 0.0, np.inf
    for branch in (0, 1):
        refs = {ref: run_desc(nt, ingest("3:224:224:1") +
                              f"tensor_filter model={ref} ! "
                              "tensor_sink name=out",
                              [f[branch] for f in frames])
                for ref in (old, new)}
        for i, m in enumerate(muxed):
            want = refs[old if i < half else new][i].tensors[0]
            other = refs[new if i < half else old][i].tensors[0]
            scale = float(np.abs(want).max())
            worst = max(worst, float(np.abs(m.tensors[branch] - want).max())
                        / scale)
            apart = min(apart, float(np.abs(m.tensors[branch] - other).max())
                        / scale)
    torch.backends.cudnn.allow_tf32 = True
    bails = {f: st[f].get("loop_bails") for f in ("fa", "fb")}
    out = {"frames": len(muxed), "rel_err": worst, "other_model": apart,
           "loop": {f: {k: st[f].get(k) for k in
                        ("loop_entries", "compiled_steps", "loop_bails")}
                    for f in ("fa", "fb")},
           "fb_captures_before_reload": pre, "fb_captures": post,
           "fb_graphs_all_new": fresh}
    print(f"phase 29: C reloaded through fa after frame {half} (f32, TF32 "
          f"off): {len(muxed)} muxed frames, each branch within "
          f"{worst:.3e} of max |logit| of its expected model and >= "
          f"{apart:.3e} from the other; loop {out['loop']}; fb captured "
          f"{pre} graphs before the reload, {post} in all, every graph it "
          f"holds the new model's: {fresh}; captures refused: {failed} "
          f"[{card}]")
    check(len(muxed) == len(frames) and worst <= CPU_TOLERANCE
          and apart > 100 * CPU_TOLERANCE,
          f"reload: {len(muxed)} frames, worst {worst:.3e}, other "
          f"{apart:.3e}")
    check((bails["fb"] or {}).get("swap", 0) >= 1,
          f"fb took no swap bail: {bails}")
    check(fresh and post > pre, "fb's graphs are not the new model's")
    check(not any(b.get("error") for b in bails.values() if b),
          f"error bails in the reload: {bails}")
    return out


def window_vision_phase(nt, torch, card, record) -> None:
    """Phase 29: A, B, P and D with compiled windows on and off."""
    from torch.profiler import ProfilerActivity, profile

    res = {}
    for name, (desc, timed, model, shape) in window_pipes().items():
        frames = u8_frames(shape, WINDOW_FRAMES, 29)
        off = window_run(nt, torch, desc, frames, model, compiled_loop=False)
        on = window_run(nt, torch, desc, frames, model)
        st = on["stats"]
        bails = st["loop_bails"]
        share = st["compiled_steps"] / st["buffers"]
        r = {"identical": same_outputs(on["out"], off["out"]),
             "loop_entries": st["loop_entries"],
             "compiled_steps": st["compiled_steps"], "compiled_share": share,
             "loop_bails": bails, "k_hist": on["khist"],
             "graphs": on["graphs"], "captures": on["captures"],
             "capture_s": on["capture_s"],
             "capture_failed": on["capture_failed"],
             "mem_on": on["mem"], "mem_off": off["mem"],
             "span_ms": {"off": off["span_ms"], "on": on["span_ms"]},
             "seconds": {"off": off["seconds"], "on": on["seconds"]}}
        print(f"phase 29: {name}, {WINDOW_FRAMES} frames pushed at once: "
              f"loop-on outputs bit for bit loop-off's: {r['identical']}; "
              f"{st['loop_entries']} windows, {st['compiled_steps']} frames "
              f"in windows ({100 * share:.1f}%), bails {bails}, windows by "
              f"K {on['khist']}; graphs captured {on['captures']} (K "
              f"{on['graphs']}), seconds per capture "
              + ", ".join(f"{c:.3f}" for c in on["capture_s"])
              + f"; memory_allocated before/after the run: loop off "
              f"{off['mem'][0]}/{off['mem'][1]} B, on {on['mem'][0]}/"
              f"{on['mem'][1]} B; the model's process span a frame (traced "
              f"median) off {off['span_ms']:.3f} ms, on {on['span_ms']:.3f} "
              f"ms; run {off['seconds']:.3f} s off, {on['seconds']:.3f} s "
              f"on [{card}]")
        if on["capture_failed"]:
            print(f"phase 29: {name}: capture refused: "
                  f"{on['capture_failed']}")
        check(r["identical"], f"{name}: loop-on outputs differ from loop-off")
        check(set(on["khist"]) <= {2, 4, 8},
              f"{name}: windows of K {on['khist']}")
        if name != "D":
            check(st["loop_entries"] > 0 and bails.get("error", 0) == 0,
                  f"{name}: {st['loop_entries']} windows, bails {bails}")
        if name == "P":
            # the profiler against the wrapper: a shorter run (fewer
            # records) whose graphs were captured before the profile began
            # (close_capture says why the profiles are padded)
            def attempt():
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                short = window_run(nt, torch, desc,
                                   frames[:WINDOW_PROF_FRAMES], model,
                                   prof=prof, warm=(16, 3))
                clamps = [e.id for e in kernel_events(prof)
                          if CLAMP_SYMBOL in e.name]
                launches = {e.id for e in prof.events()
                            if e.name == "cudaGraphLaunch"}
                per_launch = Counter(Counter(
                    i for i in clamps if i in launches).values())
                # a replay short of its graph's kernel records lost some
                per_replay = Counter(Counter(
                    e.id for e in kernel_events(prof)
                    if e.id in launches).values())
                graphs = sum(a.count for a in prof.key_averages()
                             if a.key == "cudaGraphLaunch")
                line = (f"phase 29: P: profiled run: clamp records per "
                        f"cudaGraphLaunch {dict(per_launch)}, outside a "
                        f"replay {sum(i not in launches for i in clamps)}; "
                        f"replays by kernel records {dict(per_replay)}")
                print(line)
                if len(clamps) != short["clamp"]:
                    print(line, file=sys.stderr)
                return ({"clamp_scale": short["clamp"]},
                        {"clamp_scale": len(clamps)},
                        (short, len(clamps), graphs))

            (short, named, graphs), tries = profiled_agreement(
                "phase 29: P", attempt)
            r["clamp_launches"] = on["clamp"]
            r["clamp_profiled"] = (short["clamp"], named, graphs, tries)
            print(f"phase 29: P: clamp_scale launches {on['clamp']} by the "
                  f"wrapper (replays counted) for {WINDOW_FRAMES} frames; a "
                  f"profiled run of {WINDOW_PROF_FRAMES} frames: "
                  f"{short['clamp']} by the wrapper, {named} by name in the "
                  f"profiler, {graphs} cudaGraphLaunch calls (profiled run "
                  f"{tries} of at most {PROFILE_ATTEMPTS})")
            check(on["clamp"] == WINDOW_FRAMES and short["clamp"] == named
                  == WINDOW_PROF_FRAMES and graphs > 0,
                  f"P: clamp_scale {on['clamp']} for {WINDOW_FRAMES} frames, "
                  f"{short['clamp']} / {named} for {WINDOW_PROF_FRAMES}")
        res[name] = r

    # B in f32 (TF32 off), bit for bit
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sep = "&" if "?" in MODEL else "?"
    desc = window_pipes()["B"][0].replace(MODEL, f"{MODEL}{sep}dtype=float32")
    frames = u8_frames((1, 224, 224, 3), WINDOW_F32_FRAMES, 31)
    off = window_run(nt, torch, desc, frames, "model", compiled_loop=False)
    on = window_run(nt, torch, desc, frames, "model")
    torch.backends.cudnn.allow_tf32 = True
    same = same_outputs(on["out"], off["out"])
    print(f"phase 29: B f32 (TF32 off), {WINDOW_F32_FRAMES} frames: loop-on "
          f"bit for bit loop-off: {same}; {on['stats']['loop_entries']} "
          f"windows, bails {on['stats']['loop_bails']}")
    check(same and on["stats"]["loop_entries"] > 0,
          "B f32: loop-on outputs differ or no window ran")
    res["B f32"] = {"identical": same, "loop_entries":
                    on["stats"]["loop_entries"]}

    res["reload"] = window_reload(nt, torch, card)

    # timings: loop off and on live at once, bursts in turns a b b a
    for name, (_, timed, _, shape) in window_pipes().items():
        frame = u8_frames(shape, 1, 0)[0]
        arms = burst_arms(nt, torch, {"off": timed, "on": timed}, frame,
                          WINDOW_BURST, BURSTS,
                          runner_kw={"off": {"compiled_loop": False},
                                     "on": {}})
        t = {}
        for arm, a in arms.items():
            fps = float(np.median(a["fps"]))
            t[arm] = {"fps": a["fps"], "fps_median": fps,
                      "p50_ms": float(np.percentile(a["lat"], 50)),
                      "p99_ms": float(np.percentile(a["lat"], 99)),
                      "device_ms_per_frame": a["device_ms_per_frame"],
                      "busy_share": a["device_ms_per_frame"] * fps / 1e3}
            print(f"phase 29: {name} loop {arm}, bursts of {WINDOW_BURST} "
                  f"frames in turns: " + " / ".join(f"{f:.1f}" for f in a["fps"])
                  + f" frames/s; latency under the burst p50 "
                  f"{t[arm]['p50_ms']:.3f} ms p99 {t[arm]['p99_ms']:.3f} ms; "
                  f"{a['device_ms_per_frame']:.3f} ms of kernel time a frame, "
                  f"card busy {100 * t[arm]['busy_share']:.1f}% [{card}]")
        t["fps_ratio"] = t["on"]["fps_median"] / t["off"]["fps_median"]
        t["fps_ratio_range"] = (min(t["on"]["fps"]) / max(t["off"]["fps"]),
                                max(t["on"]["fps"]) / min(t["off"]["fps"]))
        print(f"phase 29: {name} loop on / off frames/s "
              f"{t['fps_ratio']:.3f} (median over median; burst by burst "
              f"{t['fps_ratio_range'][0]:.3f} to "
              f"{t['fps_ratio_range'][1]:.3f}) [{card}]")
        res[name]["timings"] = t
    record["windows"] = res


def decode_engine(torch, window: int, dtype, model="store://llm_full"):
    """The LLM cell's engine (phase 8's shapes) with `window`."""
    from nnstreamer_tpu_torch.llm import LLMEngine

    p = LLM_PROPS
    eng = LLMEngine(model, n_heads=p["n_heads"], dtype=dtype,
                    block_size=p["block_size"], num_blocks=p["num_blocks"],
                    max_batch=p["max_batch"], max_len=p["max_len"],
                    prefill_chunk=p["prefill_chunk"],
                    paged_kernel=p["paged_kernel"], decode_window=window)
    eng.prewarm(p["prewarm"])
    return eng


def engine_serve(torch, eng, requests, prof=None) -> dict:
    """Every request submitted at t=0, drained; the launch counts zeroed
    first. → {"tokens", "seconds", "launches", "ttft", "itl" (ms)}."""
    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.backends import paged_attn as pa

    pa.paged_decode_attn.launches = 0
    pa.paged_prefill_attn.launches = 0
    kernels.quantize_rows.launches = 0
    ex = eng.executor
    steps0, windows0 = ex.decode_steps, ex.decode_windows
    torch.cuda.synchronize()
    with prof or nullcontext():
        if prof is not None:
            open_capture(torch)
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=LLM_NEW_TOKENS, req_id=f"r{i}")
                for i, p in enumerate(requests)]
        eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            close_capture(torch)
    return {"tokens": {r.req_id: list(r.tokens) for r in reqs},
            "seconds": wall,
            "launches": {"paged_decode_attn": pa.paged_decode_attn.launches,
                         "paged_prefill_attn": pa.paged_prefill_attn.launches,
                         "quantize_rows": kernels.quantize_rows.launches},
            "decode_steps": ex.decode_steps - steps0,
            "decode_windows": ex.decode_windows - windows0,
            "ttft": [r.first_token_ms for r in reqs],
            "itl": [x for r in reqs for x in r.itl_ms]}


def decode_window_phase(nt, torch, card, record, ctx) -> None:
    """Phase 30: the LLM cell through LLMEngine(decode_window=8) against
    decode_window=0 — f32 and bf16 tokens identical, W8A8 too, launches
    with replays counted against the profiler, timings in turns."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.models import quant
    from nnstreamer_tpu_torch.serving.store import get_store

    requests = ctx["requests"]
    res = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        runs = {w: engine_serve(torch, decode_engine(torch, w, dtype),
                                requests) for w in (DECODE_WINDOW, 0)}
        same = runs[DECODE_WINDOW]["tokens"] == runs[0]["tokens"]
        print(f"phase 30: {label}: decode_window={DECODE_WINDOW} tokens "
              f"identical to per-step: {same}; "
              f"{runs[DECODE_WINDOW]['decode_windows']} windows")
        check(same, f"{label}: windowed tokens differ from per-step")
        check(runs[DECODE_WINDOW]["decode_windows"] > 0,
              f"{label}: no decode window ran")
        res[f"{label}_identical"] = same

    # bf16 timings: both engines live, warmed by one run each (every
    # window graph captured), then runs in turns a b b a, then profiled
    engines = {w: decode_engine(torch, w, torch.bfloat16)
               for w in (DECODE_WINDOW, 0)}
    for eng in engines.values():
        engine_serve(torch, eng, requests)
    timed = {w: [] for w in engines}
    for w in (DECODE_WINDOW, 0, 0, DECODE_WINDOW):
        timed[w].append(engine_serve(torch, engines[w], requests))
    for w, eng in engines.items():
        def attempt():
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            run = engine_serve(torch, eng, requests, prof=prof)
            named = named_launches(prof, ("paged_decode_attn",
                                          "paged_prefill_attn"))
            return ({k: run["launches"][k] for k in named}, named,
                    (prof, run, named))

        (prof, run, named), tries = profiled_agreement(
            f"phase 30: window {w}", attempt)
        evs = kernel_events(prof)
        busy = sum(e.time_range.elapsed_us() for e in evs) / 1e6 / \
            run["seconds"]
        launch_calls = {a.key: a.count for a in prof.key_averages()
                        if a.key.startswith(("cudaLaunchKernel",
                                             "cudaGraphLaunch"))}
        arm = f"window {w}"
        runs = timed[w]
        tps = [sum(map(len, r["tokens"].values())) / r["seconds"]
               for r in runs]
        ttft = [x for r in runs for x in r["ttft"]]
        itl = [x for r in runs for x in r["itl"]]
        ex = eng.executor
        res[arm] = {
            "tokens_per_s": tps,
            "ttft_p50_ms": float(np.percentile(ttft, 50)),
            "ttft_p99_ms": float(np.percentile(ttft, 99)),
            "itl_p50_ms": float(np.percentile(itl, 50)),
            "itl_p99_ms": float(np.percentile(itl, 99)),
            "busy_share_profiled": busy, "launch_calls": launch_calls,
            "launches": run["launches"], "profiler_launches": named,
            "profiled_runs": tries,
            "decode_steps": run["decode_steps"],
            "decode_windows": run["decode_windows"],
            "engine": {k: eng.stats()[k] for k in
                       ("decode_window", "decode_windows", "window_tokens")},
            "graphs": [list(k[:2]) for k in ex.window_graphs()]}
        print(f"phase 30: bf16 {arm}: " + " / ".join(f"{x:.1f}" for x in tps)
              + f" tokens/s; TTFT p50 {res[arm]['ttft_p50_ms']:.3f} ms p99 "
              f"{res[arm]['ttft_p99_ms']:.3f} ms; ITL p50 "
              f"{res[arm]['itl_p50_ms']:.3f} ms p99 "
              f"{res[arm]['itl_p99_ms']:.3f} ms; profiled run: card busy "
              f"{100 * busy:.1f}%, {launch_calls}, {run['decode_steps']} "
              f"decode steps in {run['decode_windows']} windows, wrapper "
              f"launches {run['launches']}, by name {named} (profiled run "
              f"{tries} of at most {PROFILE_ATTEMPTS}); engine "
              f"{res[arm]['engine']}; (b_b, steps) graphs "
              f"{res[arm]['graphs']} [{card}]")
        check(run["launches"]["paged_decode_attn"]
              == 4 * run["decode_steps"] == named["paged_decode_attn"],
              f"{arm}: paged_decode_attn {run['launches']} / {named} for "
              f"{run['decode_steps']} steps")
        check(run["launches"]["paged_prefill_attn"]
              == named["paged_prefill_attn"], f"{arm}: prefill launches")
    same = all(timed[DECODE_WINDOW][i]["tokens"] == timed[0][0]["tokens"]
               for i in range(2))
    check(same, "bf16 timed runs: windowed tokens differ")

    # W8A8: the quantized model (phase 14's), per-step against windows
    if "llm_w8a8" not in get_store().names():
        get_store().register("llm_w8a8", ModelBundle(
            fn=None, params=quant.quantize_transformer(ctx["params"])))
    runs = {w: engine_serve(torch, decode_engine(
        torch, w, torch.bfloat16, "store://llm_w8a8"), requests)
        for w in (DECODE_WINDOW, 0)}
    same = runs[DECODE_WINDOW]["tokens"] == runs[0]["tokens"]
    per_step = {w: r["launches"]["quantize_rows"] / (
        r["decode_steps"] + r["launches"]["paged_prefill_attn"] / 4)
        for w, r in runs.items()}
    print(f"phase 30: W8A8 bf16: decode_window={DECODE_WINDOW} tokens "
          f"identical to per-step: {same}; "
          f"{runs[DECODE_WINDOW]['decode_windows']} windows; quantize_rows "
          f"launches per decode step and chunk {per_step} [{card}]")
    check(same, "W8A8: windowed tokens differ from per-step")
    check(all(v == 17 for v in per_step.values()),
          f"W8A8: quantize_rows launches per step {per_step}")
    res["w8a8"] = {"identical": same, "quantize_rows_per_step": per_step}
    record["decode_window"] = res


def window_phases(nt, torch, card, record, phases, ctx) -> None:
    """Phases 29-30."""
    window_vision_phase(nt, torch, card, record)
    phases.done("29 (vision windows)")
    if "requests" not in ctx:
        llm_model(ctx)
    decode_window_phase(nt, torch, card, record, ctx)
    phases.done("30 (LLM decode window)")


# -- 31-33. model-file ingestion -------------------------------------------------

#: phase 31: frames for F's f32 checks, Q's bit-for-bit check and the
#: micro-batched run; phase 32: closed-loop frames an arm (after warm-up)
MODELIO_F32_FRAMES, MODELIO_Q_FRAMES, MODELIO_BATCH_FRAMES = 8, 16, 24
MODELIO_LAT, MODELIO_WARMUP, MODELIO_WINDOW_FRAMES = 40, 5, 64
#: phases 32, 35 and 37's bursts: 64 frames (32: 200 until phases 47-49
#: came, 100 until phases 50-51 came; 35 and 37: 200 until phases 56-57
#: came)
MODELIO_BURST = 64
#: phase 33: frames pushed at once through the WHILE model
WHILE_FRAMES = 32


def write_model_files(torch, out_dir: Path) -> dict:
    """Config 1's model as files (tools/tflite_fixture.py): MobileNetV2
    1.0 at 224², 1001 classes, from zoo://mobilenet_v2's seed 0 (f32
    params), float32 and uint8 (calibrated on the CPU over 8 seeded
    frames); the WHILE counter; and m.npz, the zoo model through the
    port's save_params. → {name: path} plus the f32 zoo module."""
    from nnstreamer_tpu_torch.modelio import save_params
    from nnstreamer_tpu_torch.models.mobilenet_v2 import build
    from nnstreamer_tpu_torch.tools import tflite_fixture as fx

    t0 = time.perf_counter()
    model = build(dtype="float32", seed=0).params
    files = {"F": out_dir / "mbv2_float.tflite",
             "Q": out_dir / "mbv2_quant.tflite",
             "W": out_dir / "while_counter.tflite",
             "npz": out_dir / "m.npz"}
    fx.write_mobilenet_v2(model, files["F"])
    fx.write_mobilenet_v2(model, files["Q"], quant=True)
    fx.write_while_counter(files["W"])
    save_params(str(files["npz"]), "zoo://mobilenet_v2", model)
    print(f"phase 31: wrote " + ", ".join(
        f"{f.name} ({f.stat().st_size} B)" for f in files.values())
        + f" in {time.perf_counter() - t0:.2f} s")
    return {k: str(v) for k, v in files.items()}


def f_model(files, extra: str = "", name: str = "model") -> str:
    return (f"tensor_filter name={name} framework=tensorflow-lite "
            f"model={files['F']}{extra}")


def q_model(files, dtype: str = "int8", name: str = "model") -> str:
    return (f"tensor_filter name={name} framework=tensorflow-lite "
            f"model={files['Q']} custom=dtype={dtype}")


def logits_of(results):
    return np.stack([np.asarray(r.tensors[0]) for r in results])


def modelio_correctness(nt, torch, card, record, files) -> None:
    """Phase 31: F against the CPU and the zoo model (f32, TF32 off), its
    bf16 labels, normalize_u8 once a frame; Q int8-native bit for bit its
    CPU run, Q under bf16; the .npz round trip; F micro-batched."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.backends import kernels

    res = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    frames = u8_frames((1, 224, 224, 3), MODELIO_F32_FRAMES, 31)
    f32 = " custom=dtype=float32"
    card_f = logits_of(run_desc(
        nt, f"{APPSRC} ! {NORM_B} ! {f_model(files, f32)} ! "
            f"tensor_sink name=out", frames))
    cpu_f = logits_of(run_desc(
        nt, f"{APPSRC} ! {NORM_B} accelerator=cpu ! "
            f"{f_model(files, f32 + ' accelerator=cpu')} ! "
            f"tensor_sink name=out", frames))
    zoo = logits_of(run_desc(
        nt, f"{APPSRC} ! {NORM_B} ! {MODEL}?dtype=float32 ! "
            f"tensor_sink name=out", frames))
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    scale = float(np.abs(cpu_f).max())
    err_cpu = float(np.abs(card_f - cpu_f).max()) / scale
    err_zoo = float(np.abs(card_f - zoo).max()) / float(np.abs(zoo).max())
    labels = [card_f.argmax(-1).ravel(), cpu_f.argmax(-1).ravel(),
              zoo.argmax(-1).ravel()]
    same_labels = all(np.array_equal(labels[0], lab) for lab in labels[1:])
    res["F_f32"] = {"frames": len(frames), "rel_err_cpu": err_cpu,
                    "rel_err_zoo": err_zoo, "labels_equal": same_labels,
                    "shape": list(card_f.shape[1:])}
    print(f"phase 31: F (mbv2_float.tflite, f32, TF32 off) on the card, "
          f"{len(frames)} frames: logits within {err_cpu:.3e} of max "
          f"|logit| of the CPU run and {err_zoo:.3e} of zoo://mobilenet_v2 "
          f"(same params, BN unfolded) on the card; labels equal: "
          f"{same_labels} [{card}]")
    check(card_f.shape[1:] == (1, 1001) and np.isfinite(card_f).all(),
          f"F logits {card_f.shape}")
    check(err_cpu <= CPU_TOLERANCE and err_zoo <= CPU_TOLERANCE,
          f"F f32: {err_cpu:.3e} from the CPU, {err_zoo:.3e} from the zoo")
    check(same_labels, f"F f32 labels card / CPU / zoo: {labels}")

    # F in its default bf16, normalize_u8 counted by wrapper and profiler
    bf_desc = (f"{APPSRC} ! {NORM_B} ! {f_model(files)} ! {LABEL} ! "
               f"tensor_sink name=out")

    def attempt():
        kernels.normalize_u8.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_capture(torch)
            out = run_desc(nt, bf_desc, frames)
            torch.cuda.synchronize()
            close_capture(torch)
        named = sum("nns_normalize_kernel" in e.name
                    for e in kernel_events(prof))
        launched = kernels.normalize_u8.launches
        return ({"normalize_u8": launched}, {"normalize_u8": named},
                (out, launched, len(kernel_events(prof))))

    (bf_out, launched, n_kernels), tries = profiled_agreement(
        "phase 31: F bf16", attempt)
    bf_labels = [r.meta["label_index"] for r in bf_out]
    agree = int(sum(a == b for a, b in zip(bf_labels, labels[0])))
    res["F_bf16"] = {"label_agreement_with_f32": agree,
                     "normalize_launches": launched,
                     "kernels_per_frame": n_kernels / len(frames),
                     "profiled_runs": tries}
    print(f"phase 31: F bf16 (the default): labels equal the f32 run's on "
          f"{agree} of {len(frames)} frames; normalize_u8 launched "
          f"{launched} times for {len(frames)} frames, by the wrapper and "
          f"by name in the profiler (profiled run {tries}); "
          f"{n_kernels / len(frames):.1f} CUDA kernels a frame, the first "
          f"frame's set-up included")
    check(len(bf_out) == len(frames) and launched == len(frames),
          f"F bf16: normalize_u8 launched {launched} times for "
          f"{len(frames)} frames ({len(bf_out)} out)")

    # Q int8-native: the card against the CPU, bit for bit
    qframes = u8_frames((1, 224, 224, 3), MODELIO_Q_FRAMES, 32)
    q_card = logits_of(run_desc(
        nt, f"{APPSRC} ! {q_model(files)} ! tensor_sink name=out", qframes))
    q_cpu = logits_of(run_desc(
        nt, f"{APPSRC} ! {q_model(files)} accelerator=cpu ! "
            f"tensor_sink name=out", qframes))
    q_same = q_card.dtype == np.uint8 and np.array_equal(q_card, q_cpu)
    q_bf = logits_of(run_desc(
        nt, f"{APPSRC} ! {q_model(files, 'bfloat16')} ! "
            f"tensor_sink name=out", qframes))
    q_agree = int((q_bf.argmax(-1) == q_card.argmax(-1)).sum())
    lsb = int(np.abs(q_bf.astype(int) - q_card.astype(int)).max())
    res["Q"] = {"frames": len(qframes), "card_equals_cpu": bool(q_same),
                "bf16_top1_agreement": q_agree, "bf16_max_lsb": lsb}
    print(f"phase 31: Q (mbv2_quant.tflite, custom=dtype=int8), "
          f"{len(qframes)} frames: uint8 logits on the card bit for bit "
          f"the CPU run's: {q_same}; Q under dtype=bfloat16 (dequantize -> "
          f"bf16) top-1 equal to int8-native's on {q_agree} of "
          f"{len(qframes)}, largest difference {lsb} LSB")
    check(q_same, f"Q int8 card != CPU (max diff "
                  f"{np.abs(q_card.astype(int) - q_cpu.astype(int)).max()})")

    # .npz: the port's save_params wrote the zoo model; model=m.npz
    zoo_b = logits_of(run_desc(
        nt, f"{APPSRC} ! {NORM_B} ! {MODEL} ! tensor_sink name=out", frames))
    npz_b = logits_of(run_desc(
        nt, f"{APPSRC} ! {NORM_B} ! tensor_filter model={files['npz']} ! "
            f"tensor_sink name=out", frames))
    npz_same = np.array_equal(zoo_b, npz_b)
    res["npz"] = {"identical": bool(npz_same)}
    print(f"phase 31: model=m.npz (save_params of zoo://mobilenet_v2, "
          f"bf16): outputs bit for bit the zoo bundle's: {npz_same}")
    check(npz_same, "m.npz outputs differ from the zoo bundle's")

    # F micro-batched: one invoke a frame (the lowered batch is 1)
    bframes = u8_frames((1, 224, 224, 3), MODELIO_BATCH_FRAMES, 33)
    pipe = nt.parse_launch(
        f"{APPSRC} ! {BATCH} ! {NORM_B} ! {f_model(files)} ! tensor_unbatch "
        f"! {LABEL} ! tensor_sink name=out")
    kernels.normalize_u8.launches = 0
    batched = push_all(nt, pipe, bframes).get("out").results
    norm_batched = kernels.normalize_u8.launches
    be = pipe.get("model").backend
    unb = run_desc(nt, f"{APPSRC} ! {NORM_B} ! {f_model(files)} ! {LABEL} "
                       f"! tensor_sink name=out", bframes)
    lb = [r.meta["label_index"] for r in batched]
    lu = [r.meta["label_index"] for r in unb]
    verdicts = sorted(set(be._batch_ok.values()))
    res["F_batched"] = {"frames": len(batched), "labels_equal": lb == lu,
                        "batch_size_hist": be.batch_size_hist,
                        "verdicts": verdicts,
                        "normalize_launches": norm_batched}
    print(f"phase 31: F behind tensor_batch max-batch={BATCH_MAX}: "
          f"{len(batched)} frames, the model's batched calls "
          f"{be.batch_size_hist or 'none'} (batchability verdicts "
          f"{verdicts}: one invoke a frame), normalize_u8 launched "
          f"{norm_batched} times, labels equal to unbatched F's: {lb == lu}")
    check(len(batched) == len(bframes) and lb == lu
          and not be.batch_size_hist and verdicts == [False]
          and norm_batched == len(bframes),
          f"F batched: {len(batched)} frames, hist {be.batch_size_hist}, "
          f"normalize_u8 {norm_batched}, labels equal {lb == lu}")
    record["modelio_correctness"] = res


def closed_loop_arms(nt, descs, frame, n_lat, warmup):
    """Closed-loop latency of several pipelines live at once (descs: arm →
    string from an appsrc named src to a tensor_sink named out): each
    round pushes one frame into every arm in turn (the order reversed
    every other round) and waits for it at the sink. `frame`: one frame
    for every arm, or a dict of one an arm. → {arm: [ms]}."""
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    frames = frame if isinstance(frame, dict) else dict.fromkeys(descs, frame)
    live, lat = {}, {arm: [] for arm in descs}
    try:
        for arm, desc in descs.items():
            got = threading.Event()
            pipe = nt.parse_launch(desc)
            pipe.get("out").set_props(new_data=lambda b, g=got: g.set(),
                                      collect=False)
            live[arm] = (pipe, nt.PipelineRunner(pipe).start(), got)
        order = list(descs)
        for i in range(warmup + n_lat):
            for arm in (order if i % 2 == 0 else order[::-1]):
                pipe, _, got = live[arm]
                got.clear()
                t0 = time.perf_counter()
                pipe.get("src").push(TensorBuffer.of(frames[arm], pts=i))
                check(got.wait(60), f"{arm}: no frame back within 60 s")
                if i >= warmup:
                    lat[arm].append((time.perf_counter() - t0) * 1e3)
        for pipe, runner, _ in live.values():
            pipe.get("src").end()
            runner.wait(60)
    finally:
        for _, runner, _ in live.values():
            runner.stop()
    return lat


def modelio_timings(nt, torch, card, record, files) -> None:
    """Phase 32: zoo B, F, Q int8-native and Q under bf16, live at once:
    closed-loop p50/p99 frame by frame in turns; bursts of MODELIO_BURST in
    turns a b b a, compiled_loop off and on (frames/s, latency under the burst,
    busy share, kernels a frame); F's and Q's windows bit for bit their
    per-frame runs."""
    tail = f"{LABEL} name=dec ! tensor_sink name=out"
    descs = {
        "B": f"{APPSRC} ! {NORM_B} ! {MODEL} name=model ! {tail}",
        "F": f"{APPSRC} ! {NORM_B} ! {f_model(files)} ! {tail}",
        "Q int8": f"{APPSRC} ! {q_model(files)} ! {tail}",
        "Q bf16": f"{APPSRC} ! {q_model(files, 'bfloat16')} ! {tail}",
    }
    frame = u8_frames((1, 224, 224, 3), 1, 0)[0]
    res = {arm: {} for arm in descs}
    lat = closed_loop_arms(nt, descs, frame, MODELIO_LAT, MODELIO_WARMUP)
    for arm, ms in lat.items():
        res[arm]["closed_p50_ms"] = float(np.percentile(ms, 50))
        res[arm]["closed_p99_ms"] = float(np.percentile(ms, 99))
        print(f"phase 32: {arm}: closed-loop latency over {len(ms)} frames "
              f"(arms in turns, frame by frame) p50 "
              f"{res[arm]['closed_p50_ms']:.3f} ms p99 "
              f"{res[arm]['closed_p99_ms']:.3f} ms [{card}]")
    for loop in ("off", "on"):
        kw = {} if loop == "on" else {"compiled_loop": False}
        arms = burst_arms(nt, torch, descs, frame, MODELIO_BURST, BURSTS,
                          runner_kw={arm: kw for arm in descs})
        for arm, a in arms.items():
            fps = float(np.median(a["fps"]))
            r = {"fps": a["fps"], "fps_median": fps,
                 "p50_ms": float(np.percentile(a["lat"], 50)),
                 "p99_ms": float(np.percentile(a["lat"], 99)),
                 "device_ms_per_frame": a["device_ms_per_frame"],
                 "kernels_per_frame": a["kernels_per_frame"],
                 "busy_share": a["device_ms_per_frame"] * fps / 1e3}
            res[arm][f"loop_{loop}"] = r
            print(f"phase 32: {arm} loop {loop}, bursts of {MODELIO_BURST} "
                  f"frames in "
                  f"turns: " + " / ".join(f"{f:.1f}" for f in a["fps"])
                  + f" frames/s; latency under the burst p50 "
                  f"{r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms; "
                  f"{r['kernels_per_frame']:.1f} CUDA kernels and "
                  f"{r['device_ms_per_frame']:.3f} ms of kernel time a "
                  f"frame, card busy {100 * r['busy_share']:.1f}% [{card}]")
    # windows bit for bit the per-frame path (raw outputs)
    for arm, model in (("F", f_model(files)), ("Q int8", q_model(files))):
        norm = f"{NORM_B} ! " if arm == "F" else ""
        desc = f"{APPSRC} ! {norm}{model} ! tensor_sink name=out"
        wframes = u8_frames((1, 224, 224, 3), MODELIO_WINDOW_FRAMES, 34)
        off = window_run(nt, torch, desc, wframes, "model",
                         compiled_loop=False)
        on = window_run(nt, torch, desc, wframes, "model")
        st = on["stats"]
        same = same_outputs(on["out"], off["out"])
        res[arm]["window"] = {"identical": same,
                              "loop_entries": st["loop_entries"],
                              "compiled_steps": st["compiled_steps"],
                              "loop_bails": st["loop_bails"],
                              "k_hist": on["khist"],
                              "captures": on["captures"],
                              "capture_s": on["capture_s"]}
        print(f"phase 32: {arm}, {len(wframes)} frames pushed at once: "
              f"loop-on bit for bit loop-off: {same}; {st['loop_entries']} "
              f"windows, {st['compiled_steps']} frames in windows, bails "
              f"{st['loop_bails']}, windows by K {on['khist']}, "
              f"{on['captures']} graphs captured")
        check(same and st["loop_entries"] > 0
              and not st["loop_bails"].get("error"),
              f"{arm}: windows differ from per-frame or none ran: "
              f"{st['loop_bails']}")
    record["modelio_timings"] = res


class _Warnings(logging.Handler):
    """Collects the port's warning records."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record.getMessage())


def while_phase(nt, torch, card, record, files) -> None:
    """Phase 33: the WHILE counter on the card: its window captures bail
    as "error" (one capture attempted a window size, remembered; one
    warning) and the frames run per frame, bit for bit the CPU's."""
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    rng = np.random.default_rng(33)
    xs = [rng.normal(0, 1, (1, 8)).astype(np.float32)
          for _ in range(WHILE_FRAMES)]
    desc = ("appsrc name=src dims=8:1 types=float32 ! tensor_filter "
            f"name=model framework=tensorflow-lite model={files['W']} "
            "custom=dtype=float32{} ! tensor_sink name=out")
    warn = _Warnings()
    logging.getLogger("nnstreamer_tpu_torch").addHandler(warn)
    try:
        pipe = nt.parse_launch(desc.format(""))
        runner = nt.PipelineRunner(pipe).start()
        try:
            for i, x in enumerate(xs):
                pipe.get("src").push(TensorBuffer.of(x, pts=i))
            pipe.get("src").end()
            runner.wait(300)
            # read before stop: closing the backend drops its graphs and
            # remembered failures
            be = pipe.get("model").backend
            failed = list(be._graphs.failed.values())
            captures = be.window_compile_count
        finally:
            runner.stop()
    finally:
        logging.getLogger("nnstreamer_tpu_torch").removeHandler(warn)
    card_out = pipe.get("out").results
    st = runner.stats()["model"]
    cpu_out = run_desc(nt, desc.format(" accelerator=cpu"), xs)
    same = len(card_out) == len(cpu_out) == len(xs) and all(
        all(np.asarray(u).tobytes() == np.asarray(v).tobytes()
            for u, v in zip(a.tensors, b.tensors))
        for a, b in zip(card_out, cpu_out))
    counters = sorted({int(np.asarray(r.tensors[1])) for r in card_out})
    window_warnings = [w for w in warn.records if "re-run per frame" in w]
    res = {"frames": len(card_out), "identical_to_cpu": same,
           "counters": counters, "loop_entries": st["loop_entries"],
           "loop_bails": st["loop_bails"], "captures": captures,
           "capture_failures": len(failed),
           "window_warnings": len(window_warnings)}
    print(f"phase 33: WHILE counter on the card, {len(xs)} frames pushed at "
          f"once: outputs bit for bit the CPU's: {same} (counters "
          f"{counters}); windows {st['loop_entries']}, bails "
          f"{st['loop_bails']}, graphs captured {captures}, "
          f"capture keys failed {len(failed)}, window warnings "
          f"{len(window_warnings)}: {window_warnings[:1]}; the capture's "
          f"error: {failed[:1]}")
    check(same and counters == [5], "WHILE: card differs from the CPU")
    # one capture attempt a window size (K in {2, 4, 8}: one graph key
    # each), each remembered: later windows of that K fail at once
    check(1 <= len(failed) <= 3
          and st["loop_bails"].get("error", 0) >= len(failed)
          and captures == 0 and len(window_warnings) == 1,
          f"WHILE: bails {st['loop_bails']}, {len(failed)} failed "
          f"captures, {captures} graphs, "
          f"{len(window_warnings)} warnings")
    record["while"] = res


# -- 34-35. model files, second group ----------------------------------------------

#: phase 34: frames of each card-vs-CPU check and of the windowed runs;
#: phase 35: closed-loop frames an arm (after warm-up)
MODELIO2_FRAMES, MODELIO2_WINDOW_FRAMES = 6, 64
SPEECH_IN = "appsrc name=src dims=1:16022 types=int16"


def write_model_files2(out_dir: Path) -> dict:
    """The second group's models (tools/model_fixtures.py) at full width,
    weights from seed 0: G config 1's MobileNetV2 (zoo://mobilenet_v2
    seed 0, BN folded) as a frozen GraphDef; S the speech-commands conv
    model (64 filters); M MobileNetV1 0.25 at 224² as .rtm; L Caffe's
    LeNet; R a CIFAR-10 ResNet-20 caffe2 pair; U LeNet-5 as .uff; the
    add2 .dlc pair. → {name: path}."""
    from nnstreamer_tpu_torch.tools import model_fixtures as mf

    t0 = time.perf_counter()
    files = mf.write_all(out_dir)
    print("phase 34: wrote " + ", ".join(
        f"{f.name} ({f.stat().st_size} B)" for f in files.values())
        + f" in {time.perf_counter() - t0:.2f} s")
    files = {k: str(v) for k, v in files.items()}
    files["R"] = f"{files['R_init']},{files['R_predict']}"
    return files


def speech_frames(n: int, seed: int) -> list:
    """n seeded one-second WAV files as the reference feeds them: the
    file's bytes as an int16 (16022, 1) tensor, header included."""
    from nnstreamer_tpu_torch.tools.model_fixtures import seeded_speech

    return [np.frombuffer(seeded_speech(seed + i), np.int16).reshape(-1, 1)
            for i in range(n)]


def modelio2_cells(files) -> dict:
    """name → (the filter after the head, the head (an appsrc named src,
    with G's and M's normalize_u8 filter), a decoder tail or "")."""
    norm = f"{APPSRC} ! {NORM_B}"
    return {
        "G": (f"tensor_filter name=model model={files['G']} inputname=input "
              f"outputname=logits", norm, LABEL),
        "M": (f"tensor_filter name=model framework=deepview-rt "
              f"model={files['M']}", norm, LABEL),
        "S": (f"tensor_filter name=model model={files['S']} "
              f"inputname=wav_data outputname=labels_softmax", SPEECH_IN,
              LABEL),
        "L": (f"tensor_filter name=model model={files['L']}",
              "appsrc name=src dims=28:28:1:1 types=float32", ""),
        "R": (f"tensor_filter name=model framework=caffe2 "
              f"model={files['R']}",
              "appsrc name=src dims=32:32:3:1 types=float32", ""),
        "U": (f"tensor_filter name=model framework=tensorrt "
              f"model={files['U']} inputname=in outputname=out",
              "appsrc name=src dims=1:28:28:1 types=float32", ""),
        "DLC f32": (f"tensor_filter name=model framework=snpe "
                    f"model={files['DLC_f']}",
                    "appsrc name=src dims=1 types=float32", ""),
        "DLC u8": (f"tensor_filter name=model framework=snpe "
                   f"model={files['DLC_u8']}",
                   "appsrc name=src dims=1 types=uint8", ""),
    }


def modelio2_frames(n: int, seed: int) -> dict:
    """Seeded input frames of each cell."""
    rng = np.random.default_rng(seed)
    img = u8_frames((1, 224, 224, 3), n, seed)
    return {"G": img, "M": img, "S": speech_frames(n, seed),
            "L": [rng.normal(0, 1, (1, 1, 28, 28)).astype(np.float32)
                  for _ in range(n)],
            "R": [rng.normal(0, 1, (1, 3, 32, 32)).astype(np.float32)
                  for _ in range(n)],
            "U": [rng.normal(0, 1, (1, 28, 28, 1)).astype(np.float32)
                  for _ in range(n)],
            "DLC f32": [np.asarray([v], np.float32)
                        for v in rng.uniform(-100, 100, n)],
            "DLC u8": [np.asarray([v], np.uint8)
                       for v in (0, 10, 1, 253, 254, 255)[:n]]}


def cell_desc(cell, accel: str = "", tail: bool = False) -> str:
    model, head, dec = cell
    if accel:
        head = head.replace(NORM_B, f"{NORM_B} accelerator={accel}")
        model = f"{model} accelerator={accel}"
    end = f"{dec} ! " if tail and dec else ""
    return f"{head} ! {model} ! {end}tensor_sink name=out"


class CountedDecodes:
    """Counts the GraphDef host stage's WAV decodes (the module function
    its host_pre calls) while it is entered."""

    def __enter__(self):
        from nnstreamer_tpu_torch.modelio import graphdef

        self.mod, self.real, self.n = graphdef, graphdef.decode_wav_bytes, 0

        def counted(*a, **k):
            self.n += 1
            return self.real(*a, **k)

        graphdef.decode_wav_bytes = counted
        return self

    def __exit__(self, *exc):
        self.mod.decode_wav_bytes = self.real


def modelio2_correctness(nt, torch, card, record, files) -> None:
    """Phase 34: every file f32 on the card (TF32 off) against its own
    CPU run, G against zoo://mobilenet_v2, the add2 pair bit for bit;
    normalize_u8 once a frame on G and M (wrapper = profiler); S's host
    stage once a frame; G, M and S under compiled windows bit for bit
    their per-frame outputs."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.backends import kernels

    cells = modelio2_cells(files)
    frames = modelio2_frames(MODELIO2_FRAMES, 34)
    res = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with CountedDecodes() as dec:
            card_out = {k: logits_of(run_desc(nt, cell_desc(c), frames[k]))
                        for k, c in cells.items()}
            s_decodes = dec.n
        cpu_out = {k: logits_of(run_desc(nt, cell_desc(c, "cpu"), frames[k]))
                   for k, c in cells.items()}
        zoo = logits_of(run_desc(
            nt, f"{APPSRC} ! {NORM_B} ! {MODEL}?dtype=float32 ! "
                f"tensor_sink name=out", frames["G"]))
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    for k, got in card_out.items():
        want = cpu_out[k]
        check(got.shape == want.shape and got.shape[0] == len(frames[k]),
              f"{k}: {got.shape} on the card, {want.shape} on the CPU")
        if k.startswith("DLC"):
            xs = np.stack(frames[k]).astype(np.float64)
            exact = np.clip(np.round(xs + 2), 0, 255) if k == "DLC u8" \
                else (xs.astype(np.float32) + np.float32(2)).astype(
                    np.float64)
            same = got.tobytes() == want.tobytes()
            res[k] = {"frames": len(got), "card_equals_cpu": same,
                      "x_plus_2_exact": bool(np.array_equal(got, exact)),
                      "dtype": str(got.dtype)}
            print(f"phase 34: {k} ({got.dtype}): card bit for bit the CPU: "
                  f"{same}; x + 2 exact: {res[k]['x_plus_2_exact']} "
                  f"(in {xs.ravel()[:3].tolist()} -> out "
                  f"{got.ravel()[:3].tolist()})")
            check(same and res[k]["x_plus_2_exact"], f"{k}: not x + 2")
            continue
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max()) / scale
        lab = [got.reshape(len(got), -1).argmax(-1),
               want.reshape(len(want), -1).argmax(-1)]
        res[k] = {"frames": len(got), "shape": list(got.shape[1:]),
                  "rel_err_cpu": err, "labels_equal": bool(
                      np.array_equal(*lab)), "max_abs": scale}
        extra = ""
        if k == "G":
            ez = float(np.abs(got - zoo).max()) / float(np.abs(zoo).max())
            zl = bool(np.array_equal(lab[0].ravel(),
                                     zoo.reshape(len(zoo), -1).argmax(-1)))
            res[k].update(rel_err_zoo=ez, labels_equal_zoo=zl)
            extra = (f"; {ez:.3e} of max |logit| from zoo://mobilenet_v2 "
                     f"(same params, BN unfolded) on the card, labels "
                     f"equal {zl}")
            check(ez <= CPU_TOLERANCE and zl, f"G vs zoo: {ez:.3e}")
        print(f"phase 34: {k} f32 (TF32 off) on the card, {len(got)} frames "
              f"{tuple(got.shape[1:])}: within {err:.3e} of max |y| "
              f"({scale:.4g}) of its CPU run, labels equal "
              f"{res[k]['labels_equal']}{extra} [{card}]")
        check(np.isfinite(got).all() and err <= CPU_TOLERANCE
              and res[k]["labels_equal"], f"{k}: card vs CPU {err:.3e}, "
                                          f"labels {lab}")
    res["S"]["host_decodes"] = s_decodes
    print(f"phase 34: S: the host stage decoded {s_decodes} WAV files for "
          f"{len(frames['S'])} frames")
    check(s_decodes == len(frames["S"]), f"S: {s_decodes} decodes")

    # normalize_u8 once a frame on G and M, by the wrapper and by name
    for k in ("G", "M"):
        desc = cell_desc(cells[k], tail=True)

        def attempt():
            kernels.normalize_u8.launches = 0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                open_capture(torch)
                out = run_desc(nt, desc, frames[k])
                torch.cuda.synchronize()
                close_capture(torch)
            named = sum("nns_normalize_kernel" in e.name
                        for e in kernel_events(prof))
            launched = kernels.normalize_u8.launches
            return ({"normalize_u8": launched}, {"normalize_u8": named},
                    (out, launched))

        (out, launched), tries = profiled_agreement(f"phase 34: {k}",
                                                    attempt)
        res[k].update(normalize_launches=launched, profiled_runs=tries)
        print(f"phase 34: {k}: normalize_u8 launched {launched} times for "
              f"{len(frames[k])} frames, by the wrapper and by name in the "
              f"profiler (profiled run {tries})")
        check(len(out) == len(frames[k]) and launched == len(frames[k]),
              f"{k}: normalize_u8 launched {launched} times")

    # compiled windows bit for bit the per-frame path; S's host stage runs
    # before each window's copy into the graph's inputs
    for k in ("G", "M", "S"):
        desc = cell_desc(cells[k])
        wframes = (speech_frames(MODELIO2_WINDOW_FRAMES, 340) if k == "S"
                   else u8_frames((1, 224, 224, 3), MODELIO2_WINDOW_FRAMES,
                                  340))
        off = window_run(nt, torch, desc, wframes, "model",
                         compiled_loop=False)
        with CountedDecodes() as dec:
            on = window_run(nt, torch, desc, wframes, "model")
        st = on["stats"]
        same = same_outputs(on["out"], off["out"])
        res[k]["window"] = {"identical": same,
                            "loop_entries": st["loop_entries"],
                            "compiled_steps": st["compiled_steps"],
                            "loop_bails": st["loop_bails"],
                            "k_hist": on["khist"],
                            "captures": on["captures"],
                            "capture_s": on["capture_s"],
                            "host_decodes": dec.n}
        print(f"phase 34: {k}, {len(wframes)} frames pushed at once: "
              f"loop-on bit for bit loop-off: {same}; {st['loop_entries']} "
              f"windows, {st['compiled_steps']} frames in windows, bails "
              f"{st['loop_bails']}, windows by K {on['khist']}, "
              f"{on['captures']} graphs captured"
              + (f", {dec.n} WAV decodes on the host" if k == "S" else ""))
        check(same and st["loop_entries"] > 0 and on["captures"] > 0
              and not st["loop_bails"].get("error"),
              f"{k}: windows differ from per-frame or none ran: "
              f"{st['loop_bails']}")
        if k == "S":
            check(dec.n == len(wframes), f"S windows: {dec.n} decodes for "
                                         f"{len(wframes)} frames")
    record["modelio2_correctness"] = res


def modelio2_timings(nt, torch, card, record, files) -> None:
    """Phase 35: every cell closed-loop (p50/p99, all live at once, frame
    by frame in turns); G, M and S also in bursts of 64 in turns a b b
    a, compiled windows off, then on (frames/s, latency under the burst,
    CUDA kernels and kernel ms a frame from a profiled burst, the card's
    busy share)."""
    cells = modelio2_cells(files)
    first = {k: v[0] for k, v in modelio2_frames(1, 35).items()}
    descs = {k: cell_desc(c, tail=True) for k, c in cells.items()}
    res = {k: {} for k in cells}
    lat = closed_loop_arms(nt, descs, first, MODELIO_LAT, MODELIO_WARMUP)
    for k, ms in lat.items():
        res[k]["closed_p50_ms"] = float(np.percentile(ms, 50))
        res[k]["closed_p99_ms"] = float(np.percentile(ms, 99))
        print(f"phase 35: {k}: closed-loop latency over {len(ms)} frames "
              f"(arms in turns, frame by frame) p50 "
              f"{res[k]['closed_p50_ms']:.3f} ms p99 "
              f"{res[k]['closed_p99_ms']:.3f} ms [{card}]")
    timed = {k: descs[k] for k in ("G", "M", "S")}
    for loop in ("off", "on"):
        kw = {} if loop == "on" else {"compiled_loop": False}
        arms = burst_arms(nt, torch, timed, first, MODELIO_BURST, BURSTS,
                          runner_kw={k: kw for k in timed})
        for k, a in arms.items():
            fps = float(np.median(a["fps"]))
            r = {"fps": a["fps"], "fps_median": fps,
                 "p50_ms": float(np.percentile(a["lat"], 50)),
                 "p99_ms": float(np.percentile(a["lat"], 99)),
                 "device_ms_per_frame": a["device_ms_per_frame"],
                 "kernels_per_frame": a["kernels_per_frame"],
                 "busy_share": a["device_ms_per_frame"] * fps / 1e3}
            res[k][f"loop_{loop}"] = r
            print(f"phase 35: {k} loop {loop}, bursts of {MODELIO_BURST} "
                  f"frames in "
                  f"turns: " + " / ".join(f"{f:.1f}" for f in a["fps"])
                  + f" frames/s; latency under the burst p50 "
                  f"{r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms; "
                  f"{r['kernels_per_frame']:.1f} CUDA kernels and "
                  f"{r['device_ms_per_frame']:.3f} ms of kernel time a "
                  f"frame, card busy {100 * r['busy_share']:.1f}% [{card}]")
    record["modelio2_timings"] = res


# -- 36-37. TorchScript model files and the last decoders ------------------------

#: phase 36: frames of each card-vs-CPU check and of SEG; frames pushed at
#: once in T's and TX's windowed runs; torch.jit.load comparisons a model
TS_FRAMES, TS_WINDOW_FRAMES, TX_WINDOW_FRAMES, TS_ORACLE = 6, 64, 24, 3
TX_IN = "appsrc name=src dims=1024:512:1 types=float32"
LT_IN = "appsrc name=src dims=1:28:28:1 types=uint8"
#: DeepLabV3-MobileNetV2's published output (deeplabv3_257_mv_gpu.tflite),
#: what the reference's image_segment decoder was written for
SEG_SHAPE = (1, 257, 257, 21)
SEG_IN = "appsrc name=src dims=21:257:257:1 types=float32"


def write_torchscript_files(out_dir: Path) -> dict:
    """The TorchScript cells' archives (tools/model_fixtures.py) at full
    width, weights from seed 0: T config 1's MobileNetV2 (zoo://mobilenet_v2,
    f32) traced; TX an nn.TransformerEncoder at the LLM cell's widths
    (d_model 1024, 8 heads, FFN 4096, 4 layers) scripted; LT LeNet-5 at
    lenet.prototxt's widths as a legacy archive. → {name: path}."""
    from nnstreamer_tpu_torch.tools import model_fixtures as mf

    t0 = time.perf_counter()
    files = mf.write_torchscript(out_dir)
    print("phase 36: wrote " + ", ".join(
        f"{f.name} ({f.stat().st_size} B)" for f in files.values())
        + f" in {time.perf_counter() - t0:.2f} s")
    return {k: str(v) for k, v in files.items()}


def ts_cells(files) -> dict:
    """name → (the filter after the head, the head, a decoder tail)."""
    norm = f"{APPSRC} ! {NORM_B}"
    t = f"tensor_filter name=model framework=pytorch model={files['T']}"
    return {
        "T": (t, norm, LABEL),
        "T-bf16": (f"{t} custom=dtype=bfloat16", norm, LABEL),
        "TX": (f"tensor_filter name=model framework=pytorch "
               f"model={files['TX']}", TX_IN, ""),
        "LT": (f"tensor_filter name=model model={files['LT']}", LT_IN, ""),
    }


def ts_frames(n: int, seed: int) -> dict:
    """Seeded input frames of each TorchScript cell."""
    rng = np.random.default_rng(seed)
    img = u8_frames((1, 224, 224, 3), n, seed)
    return {"T": img, "T-bf16": img,
            "TX": [rng.normal(0, 1, (1, 512, 1024)).astype(np.float32)
                   for _ in range(n)],
            "LT": u8_frames((1, 28, 28, 1), n, seed + 1)}


def jit_oracle(torch, files) -> dict:
    """T and TX through the port's lowering and through torch.jit.load on
    the card, TS_ORACLE seeded inputs each → {name: (largest |diff| / max
    |jit|, record calls)}. f32 with TF32 off for matmuls; convolutions in
    cuDNN's TF32, the card's default: the traced `_convolution` calls carry
    allow_tf32=True, which torch's executor obeys whatever the global flag
    says and the lowering (as the JAX package's) ignores, so both sides
    run them as the card's default does."""
    from nnstreamer_tpu_torch.backends.torch_backend import params_to
    from nnstreamer_tpu_torch.modelio import load_model_file

    rng = np.random.default_rng(361)
    out = {}
    for k, shape in (("T", (1, 224, 224, 3)), ("TX", (1, 512, 1024))):
        b = load_model_file(files[k])
        p = params_to(b.params, torch.device("cuda"))
        jit = torch.jit.load(files[k], map_location="cuda").eval()
        err = 0.0
        # torch's own executor, its graph optimizations (fusers) off: the
        # archive's ops one by one, as written
        with torch.inference_mode(), torch.jit.optimized_execution(False):
            for _ in range(TS_ORACLE):
                x = torch.from_numpy(
                    rng.normal(0, 1, shape).astype(np.float32)).cuda()
                got, want = b.fn(p, x)[0], jit(x)
                err = max(err, float((got - want).abs().max()
                                     / want.abs().max()))
        (tape,) = b.fn.tapes.values()
        out[k] = (err, tape.calls)
        del jit, p
    return out


def torchscript_correctness(nt, torch, card, record, files) -> None:
    """Phase 36: T, TX and LT on the card (f32, TF32 off) against their
    CPU runs (LT bit for bit), T and TX against torch.jit.load on the
    card, T against zoo://mobilenet_v2, T-bf16's labels, normalize_u8
    once a frame on T (wrapper = profiler), T's and TX's windows bit for
    bit per frame; SEG's device map = the host decoder's, direct_video
    = the converter's bytes, octet_stream = T's logits' bytes."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.backends import kernels

    cells = ts_cells(files)
    frames = ts_frames(TS_FRAMES, 36)
    res = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card_out = {k: logits_of(run_desc(nt, cell_desc(cells[k]), frames[k]))
                    for k in ("T", "TX", "LT")}
        cpu_out = {k: logits_of(run_desc(nt, cell_desc(cells[k], "cpu"),
                                         frames[k]))
                   for k in ("T", "TX", "LT")}
        zoo = logits_of(run_desc(
            nt, f"{APPSRC} ! {NORM_B} ! {MODEL}?dtype=float32 ! "
                f"tensor_sink name=out", frames["T"]))
        octet = run_desc(nt, cell_desc(cells["T"]).replace(
            "tensor_sink", "tensor_decoder mode=octet_stream ! tensor_sink"),
            frames["T"])
        torch.backends.cudnn.allow_tf32 = True
        oracle = jit_oracle(torch, files)
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    for k, got in card_out.items():
        want = cpu_out[k]
        check(got.shape == want.shape and got.shape[0] == len(frames[k]),
              f"{k}: {got.shape} on the card, {want.shape} on the CPU")
        if k == "LT":
            same = got.dtype == np.uint8 and got.tobytes() == want.tobytes()
            res[k] = {"frames": len(got), "card_equals_cpu": same,
                      "shape": list(got.shape[1:]), "dtype": str(got.dtype),
                      "first": got[0].ravel().tolist()}
            print(f"phase 36: LT (legacy lenet5.pt, uint8 softmax): card bit "
                  f"for bit the CPU over {len(got)} frames: {same}; frame 0 "
                  f"{got[0].ravel().tolist()}")
            check(same, "LT: card != CPU")
            continue
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max()) / scale
        lab = [got.reshape(len(got), -1, got.shape[-1]).argmax(-1)
               .reshape(len(got), -1),
               want.reshape(len(want), -1, want.shape[-1]).argmax(-1)
               .reshape(len(want), -1)]
        res[k] = {"frames": len(got), "shape": list(got.shape[1:]),
                  "rel_err_cpu": err, "labels_equal": bool(
                      np.array_equal(*lab)), "max_abs": scale,
                  "rel_err_jit": oracle[k][0], "record_calls": oracle[k][1]}
        extra = ""
        if k == "T":
            ez = float(np.abs(got - zoo).max()) / float(np.abs(zoo).max())
            zl = bool(np.array_equal(lab[0].ravel(),
                                     zoo.reshape(len(zoo), -1).argmax(-1)))
            res[k].update(rel_err_zoo=ez, labels_equal_zoo=zl)
            extra = (f"; {ez:.3e} of max |logit| from zoo://mobilenet_v2 "
                     f"(the module traced) on the card, labels equal {zl}")
            check(ez <= CPU_TOLERANCE and zl, f"T vs zoo: {ez:.3e}")
        print(f"phase 36: {k} f32 (TF32 off) on the card, {len(got)} frames "
              f"{tuple(got.shape[1:])}: within {err:.3e} of max |y| "
              f"({scale:.4g}) of its CPU run, labels equal "
              f"{res[k]['labels_equal']}; {oracle[k][0]:.3e} of max |y| from "
              f"torch.jit.load on the card ({TS_ORACLE} inputs, cuDNN's TF32 "
              f"convolutions in both); the record "
              f"replays {oracle[k][1]} calls{extra} [{card}]")
        check(np.isfinite(got).all() and err <= CPU_TOLERANCE
              and res[k]["labels_equal"] and oracle[k][0] <= CPU_TOLERANCE,
              f"{k}: card vs CPU {err:.3e}, vs jit {oracle[k][0]:.3e}, "
              f"labels {lab}")

    # T-bf16: params stored in bf16, the labels of the f32 run but at a
    # near tie (phase 27's rule: a flip where the f32 run's top-2 gap is no
    # larger than the two runs' largest logit difference on that frame)
    f32 = card_out["T"].reshape(len(frames["T"]), -1)
    bf = logits_of(run_desc(nt, cell_desc(cells["T-bf16"]), frames["T"]))
    bf = bf.reshape(len(f32), -1)
    flips = []
    for i in np.flatnonzero(bf.argmax(-1) != f32.argmax(-1)):
        top2 = np.sort(f32[i])[-2:]
        flips.append({"frame": int(i), "gap": float(top2[1] - top2[0]),
                      "diff": float(np.abs(bf[i] - f32[i]).max())})
    ebf = float(np.abs(bf - f32).max()) / float(np.abs(f32).max())
    res["T-bf16"] = {"label_agreement": len(f32) - len(flips),
                     "flips": flips, "rel_diff_f32": ebf}
    print(f"phase 36: T-bf16 (custom=dtype=bfloat16): labels equal the f32 "
          f"run's on {len(f32) - len(flips)} of {len(f32)} frames, flips "
          f"(top-2 gap of the f32 run, largest logit difference) {flips}; "
          f"logits {ebf:.3e} of max |logit| from it")
    check(all(f["gap"] <= f["diff"] for f in flips),
          f"T-bf16: a label flip off a near tie: {flips}")

    # octet_stream: T's logits' bytes
    same = len(octet) == len(frames["T"]) and all(
        np.asarray(o.tensors[0]).tobytes() == card_out["T"][i].tobytes()
        for i, o in enumerate(octet))
    res["octet_stream"] = {"identical": same}
    print(f"phase 36: octet_stream after T: {len(octet)} buffers, the "
          f"logits' bytes: {same}")
    check(same, "octet_stream bytes differ from T's logits")

    # normalize_u8 once a frame on T, by the wrapper and by name
    desc = cell_desc(cells["T"], tail=True)

    def attempt():
        kernels.normalize_u8.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_capture(torch)
            out = run_desc(nt, desc, frames["T"])
            torch.cuda.synchronize()
            close_capture(torch)
        named = sum("nns_normalize_kernel" in e.name
                    for e in kernel_events(prof))
        launched = kernels.normalize_u8.launches
        return ({"normalize_u8": launched}, {"normalize_u8": named},
                (out, launched))

    (out, launched), tries = profiled_agreement("phase 36: T", attempt)
    res["T"].update(normalize_launches=launched, profiled_runs=tries)
    print(f"phase 36: T: normalize_u8 launched {launched} times for "
          f"{len(frames['T'])} frames, by the wrapper and by name in the "
          f"profiler (profiled run {tries})")
    check(len(out) == len(frames["T"]) and launched == len(frames["T"]),
          f"T: normalize_u8 launched {launched} times")

    # compiled windows bit for bit the per-frame path
    for k, n in (("T", TS_WINDOW_FRAMES), ("TX", TX_WINDOW_FRAMES)):
        wframes = ts_frames(n, 360)[k]
        desc = cell_desc(cells[k])
        off = window_run(nt, torch, desc, wframes, "model",
                         compiled_loop=False)
        on = window_run(nt, torch, desc, wframes, "model")
        st = on["stats"]
        same = same_outputs(on["out"], off["out"])
        res[k]["window"] = {"identical": same,
                            "loop_entries": st["loop_entries"],
                            "compiled_steps": st["compiled_steps"],
                            "loop_bails": st["loop_bails"],
                            "k_hist": on["khist"],
                            "captures": on["captures"],
                            "capture_s": on["capture_s"]}
        print(f"phase 36: {k}, {len(wframes)} frames pushed at once: "
              f"loop-on bit for bit loop-off: {same}; {st['loop_entries']} "
              f"windows, {st['compiled_steps']} frames in windows, bails "
              f"{st['loop_bails']}, windows by K {on['khist']}, "
              f"{on['captures']} graphs captured")
        check(same and st["loop_entries"] > 0 and on["captures"] > 0
              and not st["loop_bails"].get("error"),
              f"{k}: windows differ from per-frame or none ran: "
              f"{st['loop_bails']}")

    # SEG: the device argmax map against the host decoder's class map
    rng = np.random.default_rng(362)
    scores = [rng.normal(0, 1, SEG_SHAPE).astype(np.float32)
              for _ in range(TS_FRAMES)]
    seg = "tensor_decoder mode=image_segment option1=tflite-deeplab"
    dev_maps = run_desc(nt, f"{SEG_IN} ! {seg} device=true ! "
                            f"tensor_sink name=out", scores)
    host = run_desc(nt, f"{SEG_IN} ! {seg} ! tensor_sink name=out", scores)
    same = len(dev_maps) == len(host) == len(scores) and all(
        np.asarray(d.tensors[0]).dtype == np.uint8
        and np.array_equal(np.asarray(d.tensors[0]), h.meta["class_map"])
        and np.array_equal(h.meta["class_map"], s[0].argmax(-1))
        for d, h, s in zip(dev_maps, host, scores))
    res["SEG"] = {"frames": len(scores), "device_equals_host": same,
                  "host_rgba_shape": list(np.asarray(host[0].tensors[0])
                                          .shape)}
    print(f"phase 36: SEG {SEG_SHAPE} f32 scores, {len(scores)} frames: the "
          f"device decode's uint8 class map (257, 257) equals the host "
          f"decoder's int32 argmax bit for bit: {same}; host RGBA overlay "
          f"{res['SEG']['host_rgba_shape']}")
    check(same, "SEG: device class map != host argmax")

    # direct_video: the converter's frame bytes back as video
    conv = run_pipeline(nt, f"{SRC} ! tensor_sink name=out")
    video = run_pipeline(nt, f"{SRC} ! tensor_decoder mode=direct_video ! "
                             f"tensor_sink name=out")
    same = len(conv) == len(video) == FRAMES and all(
        np.asarray(v.tensors[0]).tobytes() == np.asarray(c.tensors[0])
        .tobytes() for v, c in zip(video, conv))
    res["direct_video"] = {"frames": len(video), "identical": same,
                           "shape": list(np.asarray(video[0].tensors[0])
                                         .shape)}
    print(f"phase 36: direct_video on config 1's converter frames: "
          f"{len(video)} frames {res['direct_video']['shape']}, the "
          f"converter's bytes: {same}")
    check(same, "direct_video bytes differ from the converter's")
    record["torchscript_correctness"] = res


def interp_host_ms(torch, files, files2) -> dict:
    """Host ms a call, back to back, on the card: T's walk of its code,
    T's replay of the record, G's (the same network from a .pb) bound
    steps, on one normalized frame."""
    from nnstreamer_tpu_torch.backends.torch_backend import params_to
    from nnstreamer_tpu_torch.modelio import load_model_file

    dev = torch.device("cuda")
    x = torch.from_numpy(np.random.default_rng(370).uniform(
        -1, 1, (1, 224, 224, 3)).astype(np.float32)).to(dev)
    t = load_model_file(files["T"])
    tp = params_to(t.params, dev)
    g = load_model_file(files2["G"], input_names=["input"],
                        output_names=["logits"])
    gp = params_to(g.params, dev)
    with torch.inference_mode():
        t.fn(tp, x)
        out = {"T_walk": host_ms_per_call(torch, lambda: t.fn.walk(tp, x),
                                          50),
               "T_replay": host_ms_per_call(torch, lambda: t.fn(tp, x)),
               "G": host_ms_per_call(torch, lambda: g.fn(gp, x))}
    (tape,) = t.fn.tapes.values()
    out["T_record_calls"] = tape.calls
    return out


def torchscript_timings(nt, torch, card, record, files, files1,
                        files2) -> None:
    """Phase 37: T, G and F (the same network from a .pt, a .pb and a
    .tflite) with TX and LT closed-loop (p50/p99, all live at once, frame
    by frame in turns); T, G and F in bursts of 64 in turns a b b a,
    compiled windows off, then on (frames/s, latency under the burst,
    CUDA kernels and kernel ms a frame, the card's busy share); the
    interpreter's host ms per invoke, walk and replay, beside G's."""
    tail = f"{LABEL} name=dec ! tensor_sink name=out"
    cells = ts_cells(files)
    descs = {"T": cell_desc(cells["T"], tail=True),
             "G": cell_desc(modelio2_cells(files2)["G"], tail=True),
             "F": f"{APPSRC} ! {NORM_B} ! {f_model(files1)} ! {tail}",
             "TX": cell_desc(cells["TX"]), "LT": cell_desc(cells["LT"])}
    first = {k: v[0] for k, v in ts_frames(1, 37).items()}
    first.update(G=first["T"], F=first["T"])
    res = {k: {} for k in descs}
    lat = closed_loop_arms(nt, descs, first, MODELIO_LAT, MODELIO_WARMUP)
    for k, ms in lat.items():
        res[k]["closed_p50_ms"] = float(np.percentile(ms, 50))
        res[k]["closed_p99_ms"] = float(np.percentile(ms, 99))
        print(f"phase 37: {k}: closed-loop latency over {len(ms)} frames "
              f"(arms in turns, frame by frame) p50 "
              f"{res[k]['closed_p50_ms']:.3f} ms p99 "
              f"{res[k]['closed_p99_ms']:.3f} ms [{card}]")
    timed = {k: descs[k] for k in ("T", "G", "F")}
    for loop in ("off", "on"):
        kw = {} if loop == "on" else {"compiled_loop": False}
        arms = burst_arms(nt, torch, timed, first, MODELIO_BURST, BURSTS,
                          runner_kw={k: kw for k in timed})
        for k, a in arms.items():
            fps = float(np.median(a["fps"]))
            r = {"fps": a["fps"], "fps_median": fps,
                 "p50_ms": float(np.percentile(a["lat"], 50)),
                 "p99_ms": float(np.percentile(a["lat"], 99)),
                 "device_ms_per_frame": a["device_ms_per_frame"],
                 "kernels_per_frame": a["kernels_per_frame"],
                 "busy_share": a["device_ms_per_frame"] * fps / 1e3}
            res[k][f"loop_{loop}"] = r
            print(f"phase 37: {k} loop {loop}, bursts of {MODELIO_BURST} "
                  f"frames in "
                  f"turns: " + " / ".join(f"{f:.1f}" for f in a["fps"])
                  + f" frames/s; latency under the burst p50 "
                  f"{r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms; "
                  f"{r['kernels_per_frame']:.1f} CUDA kernels and "
                  f"{r['device_ms_per_frame']:.3f} ms of kernel time a "
                  f"frame, card busy {100 * r['busy_share']:.1f}% [{card}]")
    host = interp_host_ms(torch, files, files2)
    res["T"]["host_ms_per_invoke"] = host
    print(f"phase 37: host ms a call of the bare model, back to back: T's "
          f"walk of its code {host['T_walk']:.3f}, T's record "
          f"({host['T_record_calls']} calls) {host['T_replay']:.3f}, G's "
          f"bound steps {host['G']:.3f} [{card}]")
    record["torchscript_timings"] = res


# -- 38. item 2's CPU-only pieces on the card ---------------------------------

class NoTf32:
    """TF32 off for matmuls and convolutions inside the block, the
    previous settings back after."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        b = self.torch.backends
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        b = self.torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = self.saved


def single_outputs(model, xs, custom="", accel=""):
    """One SingleShot invoke of `model` (framework torch) on host arrays
    → its outputs as host arrays."""
    from nnstreamer_tpu_torch.runtime.sync import to_host
    from nnstreamer_tpu_torch.single import SingleShot

    with SingleShot(model=model, framework="torch", custom=custom,
                    accelerator=accel) as s:
        outs = s.invoke(*xs)
        if not accel:
            check(all(o.is_cuda for o in outs), f"{model}: not on the card")
        return [np.asarray(o) for o in to_host(outs)]


def rel_err(got, want) -> float:
    """max |got - want| / max |want| over output lists (float64)."""
    scale = max(float(np.abs(np.asarray(w, np.float64)).max()) for w in want)
    return max(float(np.abs(np.asarray(g, np.float64)
                            - np.asarray(w, np.float64)).max())
               for g, w in zip(got, want)) / max(scale, 1e-30)


def item2_card_phase(nt, torch, card, record) -> None:
    """Phase 38: the TorchScript recurrent/attention/MHA/decoder archives
    (tools/model_fixtures.write_torchscript_nn, written here) and the
    TFLite files only TensorFlow writes (committed in tools/data/:
    the breadth ops, the TFLite_Detection_PostProcess custom op, the
    keras LSTM's WHILE graph), and `custom=batch=4` on config 1's
    MobileNetV2 file (tools/tflite_fixture.py), each f32 on the card (TF32
    off) against its own CPU run, within CPU_TOLERANCE of max |y|;
    detections: the same count and classes."""
    import tempfile

    from nnstreamer_tpu_torch.models.mobilenet_v2 import build
    from nnstreamer_tpu_torch.tools import model_fixtures as mf
    from nnstreamer_tpu_torch.tools import tflite_fixture as fx
    from nnstreamer_tpu_torch.tools import tflite_tf_fixtures as tff

    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_item2_") as d, \
            NoTf32(torch):
        d = Path(d)
        for name in mf.TORCHSCRIPT_NN:
            path = str(d / f"{name}.pt")
            xs = mf.write_torchscript_nn(path, name)
            got = single_outputs(path, xs)
            want = single_outputs(path, xs, accel="cpu")
            err = rel_err(got, want)
            res[name] = {"outputs": len(got), "rel_err_cpu": err}
            print(f"phase 38: TorchScript {name} ({len(got)} outputs, "
                  f"inputs {[x.shape for x in xs]}) f32 on the card within "
                  f"{err:.3e} of max |y| of its CPU run [{card}]")
            check(len(got) == len(want) and all(
                np.isfinite(g).all() for g in got) and err <= CPU_TOLERANCE,
                f"{name}: card vs CPU {err:.3e}")
        files = {k: str(tff.DATA / v) for k, v in tff.FILES.items()}
        rng = np.random.default_rng(38)
        cases = {"elementwise": [[rng.normal(0, 1, (2, 8)).astype(np.float32)]
                                 for _ in range(2)],
                 "spatial": [[rng.normal(0, 1, (1, 4, 4, 8))
                              .astype(np.float32)] for _ in range(2)],
                 "lstm": [[rng.normal(0, 1, (1, 8, 6)).astype(np.float32)]
                          for _ in range(2)]}
        for name, inputs in cases.items():
            errs = [rel_err(single_outputs(files[name], xs, "dtype=float32"),
                            single_outputs(files[name], xs, "dtype=float32",
                                           "cpu")) for xs in inputs]
            res[name] = {"rel_err_cpu": max(errs)}
            print(f"phase 38: TFLite {name} ({Path(files[name]).name}) f32 "
                  f"on the card within {max(errs):.3e} of max |y| of its CPU "
                  f"run, {len(inputs)} inputs [{card}]")
            check(max(errs) <= CPU_TOLERANCE, f"{name}: {errs}")
        dets = []
        for seed in (10, 11, 12):
            r = np.random.default_rng(seed)
            N, C = tff.DETECT_N, tff.DETECT_C
            be = r.normal(0, 0.5, (1, N, 4)).astype(np.float32)
            sc = r.uniform(0, 0.25, (1, N, C + 1)).astype(np.float32)
            for i in r.choice(N, 6, replace=False):
                sc[0, i, r.integers(1, C + 1)] = r.uniform(0.6, 0.99)
            g = single_outputs(files["detect"], [be, sc], "dtype=float32")
            w = single_outputs(files["detect"], [be, sc], "dtype=float32",
                               "cpu")
            n = int(w[3][0])
            same = int(g[3][0]) == n and np.array_equal(g[1][0][:n],
                                                        w[1][0][:n])
            err = max(float(np.abs(g[k][0][:n] - w[k][0][:n]).max())
                      for k in (0, 2)) if n else 0.0
            dets.append({"count": n, "same_count_classes": bool(same),
                         "max_abs_err": err})
            check(same and n > 0 and err <= 1e-4,
                  f"detect seed {seed}: {dets[-1]}")
        res["detect"] = dets
        print(f"phase 38: TFLite detect (TFLite_Detection_PostProcess) on "
              f"the card vs its CPU run, 3 seeded cases: detections "
              f"{[x['count'] for x in dets]}, counts and classes equal, "
              f"boxes and scores within "
              f"{max(x['max_abs_err'] for x in dets):.3e} [{card}]")
        mb = d / "mbv2_float.tflite"
        fx.write_mobilenet_v2(build(dtype="float32", seed=0).params, mb)
        frames = [np.random.default_rng(380 + i).uniform(
            -1, 1, (1, 224, 224, 3)).astype(np.float32) for i in range(4)]
        x4 = np.concatenate(frames)
        b4 = single_outputs(str(mb), [x4], "batch=4,dtype=float32")[0]
        b4_cpu = single_outputs(str(mb), [x4], "batch=4,dtype=float32",
                                "cpu")[0]
        b1 = np.concatenate([single_outputs(str(mb), [f], "dtype=float32")[0]
                             for f in frames])
        e_cpu, e_b1 = rel_err([b4], [b4_cpu]), rel_err([b4], [b1])
        res["batch4"] = {"shape": list(b4.shape), "rel_err_cpu": e_cpu,
                         "rel_err_batch1": e_b1}
        print(f"phase 38: custom=batch=4 on mbv2_float.tflite (full width, "
              f"224²): output {b4.shape}, within {e_cpu:.3e} of max |logit| "
              f"of its CPU run and {e_b1:.3e} of four batch-1 invokes on the "
              f"card [{card}]")
        check(b4.shape == (4, 1001) and e_cpu <= CPU_TOLERANCE
              and e_b1 <= CPU_TOLERANCE, f"batch=4: {res['batch4']}")
    record["item2_on_card"] = res


# -- 39-40. the DSL's elements: tee, tensor_if, split/merge, repo -------------

#: phase 39's frames a check, E1's preview rate, phase 40's closed-loop
#: frames an arm (after warm-up)
ELEM_FRAMES, ELEM_LAT, ELEM_WARMUP = 12, 30, 5
#: phase 40's bursts: 64 frames (200 until phases 41-42 came, 160 until
#: phases 43-44 took the whole run past 760 s, 100 until phases 47-49 came)
ELEM_BURST = 64
V640 = "videotestsrc width=640 height=480 pattern=random"
NORM_CPU = NORM_B + " accelerator=cpu"


def e1_desc(n: int, dtype: str = "float32", accel: str = "",
            src: str = "", preview: str = "tensor_sink name=preview") -> str:
    """E1: a 640×480 source tee'd into the model branch (normalize_u8 →
    tensor_resize 224² bilinear on the card → MobileNetV2 → labels, the
    logits also kept) and the preview branch (tensor_rate 10/1, no
    throttle → tensor_resize 120×160 nearest → transpose to NCHW)."""
    acc = f" accelerator={accel}" if accel else ""
    src = src or f"{V640} num-buffers={n} ! tensor_converter"
    return (f"{src} ! tee name=t "
            f"t. ! queue ! {NORM_B}{acc} ! tensor_resize name=rs "
            f"size=224:224 method=bilinear ! tensor_filter name=model "
            f"model=zoo://mobilenet_v2?dtype={dtype}{acc} ! tee name=m "
            f"m. ! queue ! {LABEL} ! tensor_sink name=labels "
            f"m. ! queue ! tensor_sink name=logits "
            f"t. ! queue ! tensor_rate framerate=10/1 throttle=false ! "
            f"tensor_resize size=120:160 ! tensor_transform mode=transpose "
            f"option=1:2:0:3 ! {preview}")


def e3_desc(dtype: str = "float32", accel: str = "",
            tail: str = "tensor_sink name=out to-host=false") -> str:
    """E3: (1, 224, 448, 3) uint8 → normalize_u8 → tensor_split into two
    224² halves (strided views) → two MobileNetV2 filters sharing one
    model → tensor_merge on axis 0 → (the merged logits kept) →
    tensor_aggregator windows of 4 frames every 2."""
    acc = f" accelerator={accel}" if accel else ""
    model = (f"model=zoo://mobilenet_v2?dtype={dtype}{acc} "
             f"shared-tensor-filter-key=e3{accel}{dtype}")
    return (f"appsrc name=src dims=3:448:224:1 types=uint8 ! {NORM_B}{acc} ! "
            f"tensor_split name=sp tensorseg=224:224 axis=2 "
            f"sp.src_0 ! tensor_filter name=fa {model} ! mg.sink_0 "
            f"sp.src_1 ! tensor_filter name=fb {model} ! mg.sink_1 "
            f"tensor_merge name=mg option=0 sync-mode=nosync ! tee name=mt "
            f"mt. ! queue ! tensor_sink name=merged to-host=false "
            f"mt. ! queue ! tensor_aggregator frames-out=4 frames-flush=2 "
            f"frames-dim=0 ! {tail}")


def e2_desc(idx: int, thr: float, accel: str = "") -> str:
    """E2: MobileNetV2 logits → tensor_if on logit `idx` (> thr: pass,
    else zeros) → both branches through queue into join → labels."""
    acc = f" accelerator={accel}" if accel else ""
    return (f"{APPSRC} ! {NORM_B}{acc} ! tensor_filter name=model "
            f"model=zoo://mobilenet_v2?dtype=float32{acc} ! tensor_if "
            f"name=gate compared-value=a_value compared-value-option=0:{idx} "
            f"operator=gt supplied-value={thr!r} then=passthrough "
            f"else=fill_zero "
            f"gate.src_0 ! queue ! j.sink_0 gate.src_1 ! queue ! j.sink_1 "
            f"join name=j ! {LABEL} ! tensor_sink name=out")


def gate_desc(lo: int, hi: int, accel: str = "") -> str:
    """B's head behind an `average` / range_inclusive gate on the uint8
    frames."""
    acc = f" accelerator={accel}" if accel else ""
    return (f"{APPSRC} ! tensor_if compared-value=average "
            f"compared-value-option=0 operator=range_inclusive "
            f"supplied-value={lo}:{hi} ! {NORM_B}{acc} ! tensor_filter "
            f"name=model model=zoo://mobilenet_v2?dtype=float32{acc} ! "
            f"{LABEL} ! tensor_sink name=out")


def run_sinks(nt, desc, frames=None, sinks=("out",), **runner_kw):
    """`desc` run to EOS (frames pushed into "src" when given) → ({sink:
    results}, runner)."""
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    pipe = nt.parse_launch(desc)
    runner = nt.PipelineRunner(pipe, **runner_kw).start()
    try:
        if frames is not None:
            for i, f in enumerate(frames):
                pipe.get("src").push(TensorBuffer.of(f, pts=i))
            pipe.get("src").end()
        runner.wait(600)
    finally:
        runner.stop()
    return {s: pipe.get(s).results for s in sinks}, runner, pipe


def e1_phase(nt, torch, card, res) -> None:
    """E1: the resize on the card against the CPU; labels, f32 logits and
    the preview against the CPU run; normalize_u8 once a frame (wrapper
    and profiler); compiled windows on and off bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.backends import kernels

    n = ELEM_FRAMES
    sinks = ("labels", "logits", "preview")
    rs_tail = (f"{V640} num-buffers=4 ! tensor_converter ! {NORM_B}{{acc}} "
               f"! tensor_resize name=rs size=224:224 method=bilinear ! "
               f"tensor_sink name=out to-host=false")
    with NoTf32(torch):
        rs_card, _, pipe = run_sinks(nt, rs_tail.format(acc=""))
        on_card = sorted({str(k[3]) for k in pipe.get("rs")._consts})
        rs_cpu, _, _ = run_sinks(nt, rs_tail.format(acc=" accelerator=cpu"))
        card_out, _, pipe = run_sinks(nt, e1_desc(n), sinks=sinks)
        cpu_out, _, _ = run_sinks(nt, e1_desc(n, accel="cpu"), sinks=sinks)
    rs_card, rs_cpu = rs_card["out"], rs_cpu["out"]
    check(len(rs_card) == len(rs_cpu) == 4 and all(
        r.tensors[0].is_cuda for r in rs_card),
        f"E1 resize: {len(rs_card)} outputs, not all CUDA tensors")
    got = [r.tensors[0].cpu().numpy() for r in rs_card]
    want = [r.tensors[0].numpy() for r in rs_cpu]
    rs_err = rel_err(got, want)
    res["resize"] = {"devices": on_card, "rel_err_cpu": rs_err,
                     "shape": list(got[0].shape)}
    print(f"phase 39: E1 tensor_resize 640×480 → 224² bilinear ran on "
          f"{on_card}: its f32 output {got[0].shape} (CUDA tensors) within "
          f"{rs_err:.3e} of max |.| of the CPU run [{card}]")
    check(on_card == ["cuda:0"] and rs_err <= 1e-5, f"E1 resize: {res}")
    lab = [[b.meta["label_index"] for b in o["labels"]]
           for o in (card_out, cpu_out)]
    lg = [logits_of(o["logits"]) for o in (card_out, cpu_out)]
    err = rel_err([lg[0]], [lg[1]])
    prev_same = same_outputs(card_out["preview"], cpu_out["preview"])
    res["model_branch"] = {"frames": len(lab[0]), "labels_equal":
                           lab[0] == lab[1], "rel_err_cpu": err}
    res["preview"] = {"frames": len(card_out["preview"]),
                      "cpu_frames": len(cpu_out["preview"]),
                      "identical": prev_same,
                      "shape": list(np.asarray(
                          card_out["preview"][0].tensors[0]).shape)}
    print(f"phase 39: E1 f32 (TF32 off), {n} frames of 640×480: labels "
          f"equal the CPU run's: {lab[0] == lab[1]} ({lab[0][:4]}…); logits "
          f"within {err:.3e} of max |logit|; preview {res['preview']} bit "
          f"for bit the CPU run [{card}]")
    check(len(lab[0]) == n and lab[0] == lab[1] and err <= CPU_TOLERANCE,
          f"E1 model branch: {res['model_branch']}")
    check(prev_same and 0 < len(card_out["preview"]) < n
          and res["preview"]["shape"] == [1, 3, 120, 160],
          f"E1 preview: {res['preview']}")

    def attempt():
        kernels.normalize_u8.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_capture(torch)
            out, _, _ = run_sinks(nt, e1_desc(n, "bfloat16"), sinks=sinks)
            torch.cuda.synchronize()
            close_capture(torch)
        named = sum("nns_normalize_kernel" in e.name
                    for e in kernel_events(prof))
        launched = kernels.normalize_u8.launches
        return ({"normalize_u8": launched}, {"normalize_u8": named},
                (out, launched))

    (out, launched), tries = profiled_agreement("phase 39: E1", attempt)
    res["normalize_launches"] = launched
    print(f"phase 39: E1 bf16: normalize_u8 launched {launched} times for "
          f"{n} frames of 640×480, by the wrapper and by name in the "
          f"profiler (profiled run {tries})")
    check(launched == n and len(out["labels"]) == n,
          f"E1: normalize_u8 launched {launched} times for {n} frames")
    runs = {}
    for loop in (False, True):
        out, runner, _ = run_sinks(nt, e1_desc(3 * n, "bfloat16"),
                                   sinks=sinks, compiled_loop=loop)
        runs[loop] = (out, runner.stats()["model"])
    same = all(same_outputs(runs[True][0][s], runs[False][0][s])
               for s in sinks)
    st = runs[True][1]
    res["window"] = {"identical": same, "loop_entries": st["loop_entries"],
                     "compiled_steps": st["compiled_steps"],
                     "loop_bails": st["loop_bails"]}
    print(f"phase 39: E1 bf16, {3 * n} frames: compiled windows on bit for "
          f"bit off on every sink: {same}; {st['loop_entries']} windows, "
          f"{st['compiled_steps']} frames in windows, bails "
          f"{st['loop_bails']}")
    check(same, "E1: windows on and off differ")


def e2_phase(nt, torch, card, res) -> None:
    """E2: tensor_if on one device logit, threshold between two first-pass
    values so both branches fire; each frame's branch = the host
    decision on the same logits; one forced sync a frame under
    tensor_if. Then the average / range_inclusive gate: the model runs
    exactly on the frames that pass."""
    n = ELEM_FRAMES
    frames = u8_frames((1, 224, 224, 3), n, 39)
    with NoTf32(torch):
        first = logits_of(run_desc(
            nt, f"{APPSRC} ! {NORM_B} ! tensor_filter "
                f"model=zoo://mobilenet_v2?dtype=float32 ! tensor_sink "
                f"name=out", frames)).reshape(n, -1)
        idx = int(np.argmax(first.std(0)))
        vals = np.sort(first[:, idx])
        gaps = np.diff(vals)[n // 4: n - n // 4]
        k = n // 4 + int(np.argmax(gaps))
        thr = float((vals[k] + vals[k + 1]) / 2)
        out, runner, _ = run_sinks(nt, e2_desc(idx, thr), frames, trace=True)
    decided = first[:, idx] > thr
    got = {b.pts: b.meta["label_index"] for b in out["out"]}
    want = {i: int(first[i].argmax()) if decided[i] else 0
            for i in range(n)}
    syncs = runner.tracer.forced_syncs().get("gate", 0)
    res["E2"] = {"frames": len(got), "logit": idx, "threshold": thr,
                 "then": int(decided.sum()), "labels_match": got == want,
                 "then_labels_nonzero": bool(all(
                     want[i] != 0 for i in range(n) if decided[i])),
                 "forced_syncs_under_tensor_if": syncs}
    print(f"phase 39: E2 tensor_if on logit {idx} > {thr:.6g} (f32, TF32 "
          f"off): {int(decided.sum())} of {n} frames then (passthrough), the "
          f"rest else (fill_zero), joined: every frame's label matches the "
          f"host decision on the first pass's logits: {got == want}; forced "
          f"syncs under tensor_if {syncs} ({syncs / n:.3f} a frame) [{card}]")
    check(got == want and 0 < decided.sum() < n and syncs == n,
          f"E2: {res['E2']}, got {got}, want {want}")
    rng = np.random.default_rng(391)
    bright = rng.integers(20, 236, n)
    gframes = [np.clip(b + rng.integers(-20, 21, (1, 224, 224, 3)), 0, 255)
               .astype(np.uint8) for b in bright]
    lo, hi = 80, 170
    passes = [i for i, f in enumerate(gframes) if lo <= f.mean() <= hi]
    out, runner, _ = run_sinks(nt, gate_desc(lo, hi), gframes)
    ran = runner.stats()["model"]["buffers"]
    pts = [b.pts for b in out["out"]]
    res["gate"] = {"frames": n, "pass": passes, "model_buffers": ran,
                   "out_pts": pts}
    print(f"phase 39: average / range_inclusive {lo}:{hi} gate on uint8 "
          f"frames of brightness {bright.tolist()}: frames {passes} pass; "
          f"the model ran {ran} times, labels at pts {pts}")
    check(ran == len(passes) and pts == passes and 0 < len(passes) < n,
          f"gate: {res['gate']}")


def e3_phase(nt, torch, card, res) -> None:
    """E3: results stay CUDA tensors; merged logits = two single-filter
    runs on contiguous halves (f32, TF32 off); each window the stack of
    its frames; windows on = off; one model's memory; normalize_u8 once
    a frame (the wrapper's count)."""
    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.models.zoo import build_model

    n = 10
    frames = u8_frames((1, 224, 448, 3), n, 393)
    model = build_model("mobilenet_v2?dtype=float32").params
    one = sum(t.numel() * t.element_size()
              for t in (*model.parameters(), *model.buffers()))
    del model
    gc.collect()
    torch.cuda.synchronize()
    with NoTf32(torch):
        pipe = nt.parse_launch(e3_desc())
        before = torch.cuda.memory_allocated()
        runner = nt.PipelineRunner(pipe).start()
        opened = torch.cuda.memory_allocated() - before
        kernels.normalize_u8.launches = 0
        push_and_wait(pipe, runner, frames)
        launched = kernels.normalize_u8.launches
        wins, merged = pipe.get("out").results, pipe.get("merged").results
        halves = [logits_of(run_desc(
            nt, f"appsrc name=src dims=3:224:224:1 types=uint8 ! {NORM_B} ! "
                f"tensor_filter model=zoo://mobilenet_v2?dtype=float32 ! "
                f"tensor_sink name=out",
            [np.ascontiguousarray(f[:, :, h * 224:(h + 1) * 224])
             for f in frames])) for h in (0, 1)]
        off, _, _ = run_sinks(nt, e3_desc(), frames,
                              sinks=("out", "merged"), compiled_loop=False)
    cuda = all(r.tensors[0].is_cuda for r in wins + merged)
    m = [r.tensors[0].cpu().numpy() for r in merged]
    ref = [np.concatenate([halves[0][i], halves[1][i]]) for i in range(n)]
    err = rel_err(m, ref)
    stacked = all(
        np.array_equal(w.tensors[0].cpu().numpy(),
                       np.concatenate(m[2 * j:2 * j + 4]))
        and w.pts == merged[2 * j + 3].pts for j, w in enumerate(wins))
    same = (same_outputs(_host(wins), _host(off["out"]))
            and same_outputs(_host(merged), _host(off["merged"])))
    res["E3"] = {"frames": n, "windows": len(wins), "cuda": cuda,
                 "rel_err_halves": err, "windows_stack_frames": stacked,
                 "windows_on_equal_off": same, "opened_bytes": opened,
                 "model_bytes": one, "normalize_launches": launched}
    print(f"phase 39: E3, {n} frames (1, 224, 448, 3): {len(merged)} merged "
          f"(2, 1001) and {len(wins)} windows (8, 1001), CUDA tensors: "
          f"{cuda}; merged within {err:.3e} of max |logit| of two "
          f"single-filter runs on contiguous halves (f32, TF32 off); each "
          f"window the stack of its 4 frames bit for bit: {stacked}; "
          f"windows on = off: {same}; opening E3 took {opened} B, one "
          f"MobileNetV2 {one} B; normalize_u8 launched {launched} times "
          f"[{card}]")
    check(launched == n and cuda and len(merged) == n and len(wins) == (n - 4) // 2 + 1
          and err <= 1e-6 and stacked and same
          and 0.5 * one <= opened <= 1.5 * one, f"E3: {res['E3']}")


def _host(results):
    return [r.to_host() for r in results]


def push_and_wait(pipe, runner, frames):
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    try:
        for i, f in enumerate(frames):
            pipe.get("src").push(TensorBuffer.of(f, pts=i))
        pipe.get("src").end()
        runner.wait(600)
    finally:
        runner.stop()


def view_phase(nt, torch, card, res) -> None:
    """A transposed view into the model filter: `transpose 0:2:1:3`
    (H and W swapped, 224² stays 224²) fused into the filter (a permuted
    view reaches the model) and unfused (a view staged contiguous), each
    against the CPU run (f32, TF32 off)."""
    frames = u8_frames((1, 224, 224, 3), 6, 396)
    desc = (f"{APPSRC} ! {NORM_B}{{acc}} ! tensor_transform mode=transpose "
            f"option=0:2:1:3 ! tensor_filter "
            f"model=zoo://mobilenet_v2?dtype=float32{{acc}} ! tensor_sink "
            f"name=out")
    with NoTf32(torch):
        runs = {k: logits_of(run_sinks(nt, desc.format(acc=acc), frames,
                                       optimize=opt)[0]["out"])
                for k, acc, opt in (("fused", "", True),
                                    ("unfused", "", False),
                                    ("cpu", " accelerator=cpu", True))}
    errs = {k: rel_err([runs[k]], [runs["cpu"]]) for k in ("fused",
                                                           "unfused")}
    labels = {k: runs[k].reshape(len(frames), -1).argmax(-1).tolist()
              for k in runs}
    res["transposed_view"] = {"rel_err_cpu": errs, "labels": labels}
    print(f"phase 39: transpose 0:2:1:3 into MobileNetV2, {len(frames)} "
          f"frames f32: fused (a permuted view into the model) within "
          f"{errs['fused']:.3e} and unfused (staged contiguous) within "
          f"{errs['unfused']:.3e} of max |logit| of the CPU run; labels "
          f"equal: {labels['fused'] == labels['unfused'] == labels['cpu']} "
          f"[{card}]")
    check(max(errs.values()) <= CPU_TOLERANCE
          and labels["fused"] == labels["unfused"] == labels["cpu"],
          f"transposed view: {res['transposed_view']}")


def e4_phase(nt, torch, card, res) -> None:
    """E4: a repo loop s ← 0.9·s + 0.1·logits over the card's logits:
    the states equal the recurrence in torch, no forced sync in the loop,
    the runner stops with no thread left waiting."""
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.elements import REPO
    from nnstreamer_tpu_torch.runtime import sync

    n = ELEM_FRAMES
    frames = u8_frames((1, 224, 224, 3), n, 394)
    REPO.reset()
    desc = (f"tensor_repo_src name=state slot=39 dims=1001:1 types=float32 "
            f"count={n} ! mx.sink_0 "
            f"{APPSRC} ! {NORM_B} ! tensor_filter name=model "
            f"model=zoo://mobilenet_v2?dtype=float32 ! tee name=lt "
            f"lt. ! queue ! mx.sink_1 "
            f"lt. ! queue ! tensor_sink name=logits to-host=false "
            f"tensor_mux name=mx sync-mode=nosync ! tensor_filter name=rec ! "
            f"tee name=st st. ! queue ! tensor_repo_sink slot=39 "
            f"st. ! queue ! tensor_sink name=out to-host=false")
    with NoTf32(torch):
        pipe = nt.parse_launch(desc)
        pipe.get("rec").set_props(model=ModelBundle(
            fn=lambda p, s, x: (0.9 * s + 0.1 * x,), name="recurrence"))
        runner = nt.PipelineRunner(pipe, trace=True).start()
        syncs0 = sync.forced_sync_count()
        push_and_wait(pipe, runner, frames)
        syncs = sync.forced_sync_count() - syncs0
    states = [r.tensors[0] for r in pipe.get("out").results]
    logits = [r.tensors[0] for r in pipe.get("logits").results]
    s = torch.zeros(1, 1001, device="cuda")
    ref = []
    for x in logits:
        s = 0.9 * s + 0.1 * x
        ref.append(s)
    err = max(float((a - b).abs().max()) for a, b in zip(states, ref))
    cuda = all(t.is_cuda for t in states)
    waiting = [t.name for t in threading.enumerate()
               if t.is_alive() and ("state" in t.name or "repo" in t.name)]
    res["E4"] = {"frames": len(states), "max_abs_err": err, "cuda": cuda,
                 "forced_syncs": syncs, "threads_left": waiting,
                 "traced_syncs": runner.tracer.forced_syncs()}
    print(f"phase 39: E4 repo loop, {n} frames: states s ← 0.9·s + "
          f"0.1·logits as CUDA tensors ({cuda}) within {err:.3e} of the "
          f"recurrence in torch; forced syncs in the run {syncs}; threads "
          f"left {waiting} [{card}]")
    check(len(states) == n and cuda and err <= 1e-6 and syncs == 0
          and not waiting, f"E4: {res['E4']}")


def io_phase(nt, torch, card, res) -> None:
    """3b on the card: filesrc .npy → B → filesink = B's labels' bytes;
    tensor_sink to-host=false max-results=4 keeps the last 4 as CUDA
    tensors."""
    import tempfile

    n = ELEM_FRAMES
    frames = u8_frames((1, 224, 224, 3), n, 395)
    b = run_desc(nt, f"{APPSRC} ! {NORM_B} ! {MODEL} ! {LABEL} ! "
                     f"tensor_sink name=out", frames)
    want = b"".join(np.asarray(r.tensors[0]).tobytes() for r in b)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_io_") as d:
        npy, txt = Path(d) / "frames.npy", Path(d) / "labels.txt"
        np.save(npy, np.stack(frames))
        run_sinks(nt, f"filesrc location={npy} ! {NORM_B} ! {MODEL} ! "
                      f"{LABEL} ! filesink location={txt}", sinks=())
        got = txt.read_bytes()
    out, _, _ = run_sinks(nt, f"{APPSRC} ! {NORM_B} ! {MODEL} ! tensor_sink "
                              f"name=out to-host=false max-results=4", frames)
    kept = out["out"]
    res["io"] = {"filesink_bytes": len(got), "filesink_equal": got == want,
                 "kept": [r.pts for r in kept],
                 "kept_cuda": all(r.tensors[0].is_cuda for r in kept)}
    print(f"phase 39: filesrc frames.npy → B → filesink: {len(got)} bytes, "
          f"B's labels' bytes: {got == want}; tensor_sink to-host=false "
          f"max-results=4 kept pts {res['io']['kept']} as CUDA tensors: "
          f"{res['io']['kept_cuda']}")
    check(got == want and len(got) > 0
          and res["io"]["kept"] == list(range(n - 4, n))
          and res["io"]["kept_cuda"], f"3b: {res['io']}")


def elements_correctness(nt, torch, card, record) -> None:
    """Phase 39: E1-E4 and 3b on the card."""
    res = {}
    e1_phase(nt, torch, card, res)
    e2_phase(nt, torch, card, res)
    e3_phase(nt, torch, card, res)
    view_phase(nt, torch, card, res)
    e4_phase(nt, torch, card, res)
    io_phase(nt, torch, card, res)
    record["elements_correctness"] = res


def elements_timings(nt, torch, card, record) -> None:
    """Phase 40 (no claim): E1, E3 and B live at once: closed-loop
    p50/p99 frame by frame in turns; bursts of 64 in turns a b b a,
    compiled windows off, then on (frames/s, latency under the burst,
    kernels and kernel ms a frame, busy share); host and device ms a
    call of E1's resize on the card and host ms a frame of its preview
    branch; E2's forced syncs a frame (phase 39)."""
    from nnstreamer_tpu_torch.elements.transform import (
        TensorResize, TransformProgram)

    tail = f"{LABEL} ! tensor_sink name=out"
    descs = {
        "B": f"{APPSRC} ! {NORM_B} ! {MODEL} ! {tail}",
        "E1": e1_desc(0, "bfloat16",
                      src="appsrc name=src dims=3:640:480:1 types=uint8",
                      preview="fakesink").replace(
            "tensor_sink name=labels", "tensor_sink name=out").replace(
            "m. ! queue ! tensor_sink name=logits", "m. ! queue ! fakesink"),
        "E3": e3_desc("bfloat16", tail="fakesink").replace(
            "tensor_sink name=merged to-host=false", "tensor_sink name=out"),
    }
    rng = np.random.default_rng(40)
    first = {"B": rng.integers(0, 256, (1, 224, 224, 3), np.uint8),
             "E1": rng.integers(0, 256, (1, 480, 640, 3), np.uint8),
             "E3": rng.integers(0, 256, (1, 224, 448, 3), np.uint8)}
    res = {k: {} for k in descs}
    lat = closed_loop_arms(nt, descs, first, ELEM_LAT, ELEM_WARMUP)
    for k, ms in lat.items():
        res[k]["closed_p50_ms"] = float(np.percentile(ms, 50))
        res[k]["closed_p99_ms"] = float(np.percentile(ms, 99))
        print(f"phase 40: {k}: closed-loop latency over {len(ms)} frames "
              f"(arms in turns, frame by frame) p50 "
              f"{res[k]['closed_p50_ms']:.3f} ms p99 "
              f"{res[k]['closed_p99_ms']:.3f} ms [{card}]")
    for loop in ("off", "on"):
        kw = {} if loop == "on" else {"compiled_loop": False}
        arms = burst_arms(nt, torch, descs, first, ELEM_BURST, BURSTS,
                          runner_kw={k: kw for k in descs})
        for k, a in arms.items():
            fps = float(np.median(a["fps"]))
            r = {"fps": a["fps"], "fps_median": fps,
                 "p50_ms": float(np.percentile(a["lat"], 50)),
                 "p99_ms": float(np.percentile(a["lat"], 99)),
                 "device_ms_per_frame": a["device_ms_per_frame"],
                 "kernels_per_frame": a["kernels_per_frame"],
                 "busy_share": a["device_ms_per_frame"] * fps / 1e3}
            res[k][f"loop_{loop}"] = r
            print(f"phase 40: {k} loop {loop}, bursts of {ELEM_BURST} frames in "
                  f"turns: " + " / ".join(f"{f:.1f}" for f in a["fps"])
                  + f" frames/s; latency under the burst p50 "
                  f"{r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms; "
                  f"{r['kernels_per_frame']:.1f} CUDA kernels and "
                  f"{r['device_ms_per_frame']:.3f} ms of kernel time a "
                  f"frame, card busy {100 * r['busy_share']:.1f}% [{card}]")
    rs = TensorResize(name="rs", size="224:224", method="bilinear")
    x = torch.from_numpy(first["E1"]).cuda().float()
    resize = {"host_ms": host_ms_per_call(torch, lambda: rs._resize(x)),
              "device_ms": device_ms_per_call(torch, lambda: rs._resize(x),
                                              200)}
    pv = TensorResize(name="pv", size="120:160")
    tp = TransformProgram("transpose", "1:2:0:3")
    frame = first["E1"]
    t0 = time.perf_counter()
    for _ in range(200):
        tp.apply(pv._resize(frame))
    resize["preview_host_ms"] = (time.perf_counter() - t0) * 1e3 / 200
    res["E1"]["resize"] = resize
    syncs = record.get("elements_correctness", {}).get("E2", {}).get(
        "forced_syncs_under_tensor_if")
    res["E2_forced_syncs_per_frame"] = (syncs / ELEM_FRAMES
                                        if syncs is not None else None)
    print(f"phase 40: E1's tensor_resize 640×480 → 224² bilinear (f32, on "
          f"the card): host {resize['host_ms']:.4f} ms a call, device "
          f"{resize['device_ms']:.4f} ms; the preview branch (nearest "
          f"120×160 + transpose, host uint8) {resize['preview_host_ms']:.4f} "
          f"ms a frame; E2's forced syncs a frame "
          f"{res['E2_forced_syncs_per_frame']} [{card}]")
    record["elements_timings"] = res


def elements_phases(nt, torch, card, record, phases) -> None:
    """Phases 39-40."""
    elements_correctness(nt, torch, card, record)
    phases.done("39 (the DSL's elements: correctness)")
    elements_timings(nt, torch, card, record)
    phases.done("40 (the DSL's elements: timings)")


def modelio_phases(nt, torch, card, record, phases) -> None:
    """Phases 31-38, the model files in temporary directories."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_modelio_") as d:
        files = write_model_files(torch, Path(d))
        modelio_correctness(nt, torch, card, record, files)
        phases.done("31 (model files: correctness)")
        modelio_timings(nt, torch, card, record, files)
        phases.done("32 (model files: timings)")
        while_phase(nt, torch, card, record, files)
        phases.done("33 (WHILE)")
        files2 = write_model_files2(Path(d) / "second")
        modelio2_correctness(nt, torch, card, record, files2)
        phases.done("34 (model files, second group: correctness)")
        modelio2_timings(nt, torch, card, record, files2)
        phases.done("35 (model files, second group: timings)")
        files3 = write_torchscript_files(Path(d) / "torchscript")
        torchscript_correctness(nt, torch, card, record, files3)
        phases.done("36 (TorchScript and the last decoders: correctness)")
        torchscript_timings(nt, torch, card, record, files3, files, files2)
        phases.done("37 (TorchScript: timings)")
    item2_card_phase(nt, torch, card, record)
    phases.done("38 (item 2's CPU-only pieces on the card)")


# -- phases 41-42: Queue 1 items 3c-3d ---------------------------------------

#: E5: the zoo LSTM's widths (its defaults) and the loop's steps
LSTM_D_IN, LSTM_D_H, LSTM_STEPS = 32, 64, 64
#: E6: the keyword-spotting pipeline of tests/test_streaming_models.py
AUDIO_WINDOW, AUDIO_BUFFERS, AUDIO_SPB = 1024, 64, 256
AUDIO_WINDOWS = AUDIO_BUFFERS * AUDIO_SPB // AUDIO_WINDOW
AUDIO_HEAD = (f"audiotestsrc num-buffers={AUDIO_BUFFERS} "
              f"samples-per-buffer={AUDIO_SPB} wave=sine freq=880 ! "
              f"tensor_converter frames-per-tensor={AUDIO_WINDOW} ! ")
AUDIO_MODEL = ("tensor_filter name=model model=zoo://audio_classifier?"
               f"window={AUDIO_WINDOW}&num_classes=12")
AUDIO_TYPECAST = "tensor_transform mode=typecast option=float32"
#: E6's two arms agree within this share of max |logit| (the per-window
#: standardization absorbs normalize_u8's affine map; f32, TF32 off)
AUDIO_REL = 1e-4
#: E7 and phase 42: frames of B
STREAM_FRAMES = 16
IPC_FRAMES = 64
#: prefetch: batches a run, and the consumer's busy kernel a batch (cycles
#: of torch.cuda._sleep, ~2e9 a second)
PREFETCH_BATCHES, PREFETCH_DEPTH = 16, 2

#: E7's scripts, written to the reference's python3 contracts
#: (backends/python3_script.py, elements/script_codec.py)
PASSTHROUGH_PY = '''
import nnstreamer_python as nns


class CustomFilter(object):
    def setInputDim(self, input_dims):
        self.dims = input_dims
        return input_dims

    def invoke(self, input_array):
        return input_array
'''
DECODER_PY = '''
import numpy as np


class CustomDecoder(object):
    def decode(self, raw_data, in_info, rate_n, rate_d):
        out = [np.array([len(raw_data)], np.uint32).tobytes()]
        for raw, info in zip(raw_data, in_info):
            out += [np.array(info.getDims(), np.uint32).tobytes(),
                    np.array([raw.size], np.uint32).tobytes(), raw.tobytes()]
        return b"".join(out)
'''
CONVERTER_PY = '''
import numpy as np
import nnstreamer_python as nns


class CustomConverter(object):
    def convert(self, input_array):
        data = input_array[0].tobytes()
        n = int(np.frombuffer(data[:4], np.uint32)[0])
        off, infos, raws = 4, [], []
        for _ in range(n):
            dims = [int(d) for d in np.frombuffer(data[off:off + 16],
                                                   np.uint32)]
            size = int(np.frombuffer(data[off + 16:off + 20], np.uint32)[0])
            off += 20
            infos.append(nns.TensorShape(dims, np.float32))
            raws.append(data[off:off + size])
            off += size
        return infos, raws, 0, 0
'''


def lstm_loop_desc(slot: int, accel: str = "") -> str:
    """tests/test_streaming_models.py:36-73 as a string: the repo's (h, c)
    and an appsrc's x muxed into zoo://lstm, y to the sink and (h', c')
    back to the repo."""
    acc = f" accelerator={accel}" if accel else ""
    return (f"tensor_repo_src name=state slot={slot} dims={LSTM_D_H}:1,"
            f"{LSTM_D_H}:1 types=float32,float32 count={LSTM_STEPS + 1} ! "
            f"mx.sink_1 appsrc name=src dims={LSTM_D_IN}:1 types=float32 ! "
            f"mx.sink_0 tensor_mux name=mx sync-mode=nosync ! tensor_filter "
            f"name=model model=zoo://lstm?d_in={LSTM_D_IN}&d_hidden="
            f"{LSTM_D_H}{acc} ! tensor_demux name=dm tensorpick=0,1+2 "
            f"dm.src_0 ! tensor_sink name=out to-host=false dm.src_1 ! "
            f"tensor_repo_sink slot={slot}")


def e5_phase(nt, torch, card, res) -> None:
    """E5: the repo-looped LSTM at the zoo's widths, 64 steps: every y
    equal to a torch recurrence of the same weights on the card (bit for
    bit expected, held to 1e-6), within 1e-5 of max |y| of the CPU run
    (TF32 off), no forced sync (the state stays on the card after the
    priming zeros), compiled windows on = off bit for bit."""
    from nnstreamer_tpu_torch.elements import REPO
    from nnstreamer_tpu_torch.models import lstm
    from nnstreamer_tpu_torch.models.zoo import build_model
    from nnstreamer_tpu_torch.runtime import sync

    rng = np.random.default_rng(41)
    xs = [rng.normal(size=(1, LSTM_D_IN)).astype(np.float32)
          for _ in range(LSTM_STEPS)]
    runs = {}
    with NoTf32(torch):
        for key, accel, kw in (("card", "", {}), ("cpu", "cpu", {}),
                               ("off", "", {"compiled_loop": False})):
            REPO.reset()
            pipe = nt.parse_launch(lstm_loop_desc(41, accel))
            runner = nt.PipelineRunner(pipe, **kw).start()
            syncs0 = sync.forced_sync_count()
            push_and_wait(pipe, runner, xs)
            runs[key] = ([r.tensors[0] for r in pipe.get("out").results],
                         sync.forced_sync_count() - syncs0,
                         runner.stats()["model"])
        params = {k: v.cuda() for k, v in build_model(
            f"lstm?d_in={LSTM_D_IN}&d_hidden={LSTM_D_H}").params.items()}
        h = c = torch.zeros(1, LSTM_D_H, device="cuda")
        ref = []
        with torch.inference_mode():
            for x in xs:
                y, h, c = lstm.apply(params, torch.from_numpy(x).cuda(), h, c)
                ref.append(y)
    ys, syncs, st = runs["card"]
    cuda = all(isinstance(y, torch.Tensor) and y.is_cuda for y in ys)
    err = max(float((a - b).abs().max()) for a, b in zip(ys, ref))
    cpu = [np.asarray(y) for y in runs["cpu"][0]]
    cpu_err = rel_err([y.cpu().numpy() for y in ys], cpu)
    same = all(torch.equal(a, b) for a, b in zip(ys, runs["off"][0]))
    res["E5"] = {"steps": len(ys), "cuda": cuda, "max_abs_err_torch": err,
                 "rel_err_cpu": cpu_err, "forced_syncs": syncs,
                 "windows_on_equal_off": same,
                 "loop_entries": st["loop_entries"],
                 "compiled_steps": st["compiled_steps"]}
    print(f"phase 41: E5 repo-looped zoo://lstm (d_in {LSTM_D_IN}, d_hidden "
          f"{LSTM_D_H}), {len(ys)} steps: y as CUDA tensors ({cuda}) within "
          f"{err:.3e} of a torch recurrence of the same weights on the card; "
          f"within {cpu_err:.3e} of max |y| of the CPU run (TF32 off); "
          f"forced syncs {syncs}; windows on = off bit for bit: {same} "
          f"({st['loop_entries']} windows) [{card}]")
    check(len(ys) == LSTM_STEPS and cuda and err <= 1e-6
          and cpu_err <= 1e-5 and syncs == 0 and same, f"E5: {res['E5']}")


def e6_phase(nt, torch, card, res) -> dict:
    """E6: keyword spotting at window 1024, the typecast form against
    normalize_u8 (int16 → f32, once a window) before the model: logits
    within AUDIO_REL of max |logit|, labels equal; the kernel on each
    int16 (window, 1) frame of the path, through the wrapper and the
    pipeline's filter, = its plain version bit for bit (the logits alone
    cannot see a wrong scale or offset: the per-window standardization
    cancels any affine map); the wrapper's launches and the profiler's
    records both = the windows; the batch=4 bundle
    through SingleShot = four batch-1 calls. → #1's launches."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.single import SingleShot

    tail = f" ! {AUDIO_MODEL} ! tensor_sink name=out"
    with NoTf32(torch):
        typecast = run_sinks(nt, AUDIO_HEAD + AUDIO_TYPECAST + tail)[0]["out"]

        def attempt():
            kernels.normalize_u8.launches = 0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                open_capture(torch)
                out = run_sinks(nt, AUDIO_HEAD + NORM_B + tail)[0]["out"]
                torch.cuda.synchronize()
                close_capture(torch)
            named = sum("nns_normalize_kernel" in e.name
                        for e in kernel_events(prof))
            launched = kernels.normalize_u8.launches
            return ({"normalize_u8": launched}, {"normalize_u8": named},
                    (out, launched))

        (kernel_arm, launched), tries = profiled_agreement("phase 41: E6",
                                                           attempt)
        # the kernel on the path's own windows: the int16 (window, 1)
        # frames the converter makes, each through the wrapper and through
        # the pipeline's filter, against the plain version, bit for bit
        windows = [torch.from_numpy(np.asarray(r.tensors[0])).cuda()
                   for r in run_sinks(nt, AUDIO_HEAD + "tensor_sink "
                                      "name=raw", sinks=("raw",))[0]["raw"]]
        normed = run_sinks(nt, AUDIO_HEAD + NORM_B + " ! tensor_sink "
                           "name=norm to-host=false",
                           sinks=("norm",))[0]["norm"]
        plain = [kernels.normalize_u8_plain(w) for w in windows]
        direct = [kernels.normalize_u8(w) for w in windows]
        torch.cuda.synchronize()
        win_ok = (len(windows) == len(normed) == AUDIO_WINDOWS and all(
            w.dtype == torch.int16 and tuple(w.shape) == (AUDIO_WINDOW, 1)
            for w in windows))
        win_bits = win_ok and all(
            torch.equal(d.view(torch.int32), p.view(torch.int32))
            and torch.equal(r.tensors[0].view(torch.int32),
                            p.view(torch.int32))
            for d, r, p in zip(direct, normed, plain))
        win_err = max(float((d - p).abs().max())
                      for d, p in zip(direct, plain)) if plain else None
        lg = [logits_of(typecast), logits_of(kernel_arm)]
        err = rel_err([lg[1]], [lg[0]])
        labels = [list(map(int, a.argmax(-1))) for a in lg]
        x = np.random.default_rng(416).normal(
            0, 3000, (4, AUDIO_WINDOW, 1)).astype(np.float32)
        with SingleShot(model=f"zoo://audio_classifier?window={AUDIO_WINDOW}"
                              f"&batch=4", framework="torch") as s4:
            four = s4.invoke(x)[0]
        with SingleShot(model=f"zoo://audio_classifier?window={AUDIO_WINDOW}",
                        framework="torch") as s1:
            ones = torch.stack([s1.invoke(x[i])[0] for i in range(4)])
        b_err = rel_err([four.cpu().numpy()], [ones.cpu().numpy()])
    res["E6"] = {"windows": len(lg[0]), "rel_err": err,
                 "labels_equal": labels[0] == labels[1],
                 "int16_windows_bitwise": win_bits,
                 "int16_max_abs_err": win_err,
                 "normalize_launches": launched, "profiled_run": tries,
                 "batch4_on_card": four.is_cuda, "batch4_rel_err": b_err}
    print(f"phase 41: E6 keyword spotting, window {AUDIO_WINDOW}, "
          f"{len(lg[0])} windows: normalize_u8 (int16 → f32) against the "
          f"typecast: logits within {err:.3e} of max |logit|, labels equal "
          f"{labels[0] == labels[1]} ({labels[0][:4]}…); normalize_u8 on "
          f"the {len(windows)} int16 ({AUDIO_WINDOW}, 1) windows, through "
          f"the wrapper and the pipeline's filter, = the plain version bit "
          f"for bit: {win_bits} (max_abs_err {win_err}); normalize_u8 "
          f"launched {launched} times, by the wrapper and by name in the "
          f"profiler (profiled run {tries}); batch=4 through SingleShot on "
          f"the card within {b_err:.3e} of four batch-1 calls (TF32 off) "
          f"[{card}]")
    check(len(lg[0]) == len(lg[1]) == AUDIO_WINDOWS and err <= AUDIO_REL
          and labels[0] == labels[1] and launched == AUDIO_WINDOWS
          and win_bits and four.is_cuda and b_err <= 1e-5,
          f"E6: {res['E6']}")
    return {"E6": launched}


def e7_phase(nt, torch, card, res, scripts) -> dict:
    """E7: config 1's B with a framework=custom scaler (×0.5) between
    normalize_u8 and the model and a framework=python3 passthrough after
    it, beside B with `tensor_transform mode=arithmetic option=mul:0.5`
    and no script: logits bit for bit, labels equal; the scaler's output
    the plain computation; forced syncs 1.000 a frame, the script's; the
    python3 decoder and mode=custom-script: round-trip a frame of
    logits. → #1's launches."""
    from nnstreamer_tpu_torch.backends import custom, kernels
    from nnstreamer_tpu_torch.runtime import sync

    frames = u8_frames((1, 224, 224, 3), STREAM_FRAMES, 417)
    custom.register_custom_easy("chip_half", lambda ts: (ts[0] * 0.5,))
    tail = (f"{MODEL} ! tee name=t t. ! queue ! {LABEL} ! tensor_sink "
            f"name=labels t. ! queue ! tensor_sink name=logits")
    script = (f"{APPSRC} ! {NORM_B} ! tensor_filter framework=custom "
              f"model=chip_half ! {MODEL} ! tensor_filter framework=python3 "
              f"model={scripts['passthrough']} ! tee name=t t. ! queue ! "
              f"{LABEL} ! tensor_sink name=labels t. ! queue ! tensor_sink "
              f"name=logits")
    plain = (f"{APPSRC} ! {NORM_B} ! tensor_transform mode=arithmetic "
             f"option=mul:0.5 ! {tail}")
    sinks = ("labels", "logits")
    try:
        kernels.normalize_u8.launches = 0
        syncs0 = sync.forced_sync_count()
        got, _, _ = run_sinks(nt, script, frames, sinks=sinks)
        syncs = sync.forced_sync_count() - syncs0
        launched = kernels.normalize_u8.launches
        ref, _, _ = run_sinks(nt, plain, frames, sinks=sinks)
        scaled, _, _ = run_sinks(
            nt, f"{APPSRC} ! {NORM_B} ! tensor_filter framework=custom "
                f"model=chip_half ! tensor_sink name=out to-host=false",
            frames[:2])
    finally:
        custom.unregister_custom_easy("chip_half")
    same = same_outputs(got["logits"], ref["logits"])
    labels = [[b.meta["label_index"] for b in o["labels"]] for o in (got, ref)]
    host_logits = all(isinstance(r.tensors[0], np.ndarray)
                      for r in got["logits"])
    want = [kernels.normalize_u8_plain(torch.from_numpy(f).cuda()) * 0.5
            for f in frames[:2]]
    scaler = all(r.tensors[0].is_cuda and torch.equal(r.tensors[0], w)
                 for r, w in zip(scaled["out"], want))
    dec = run_sinks(
        nt, f"{APPSRC} ! {NORM_B} ! {MODEL} ! tee name=t t. ! queue ! "
            f"tensor_decoder mode=python3 option1={scripts['decoder']} ! "
            f"tensor_converter mode=custom-script:{scripts['converter']} ! "
            f"tensor_sink name=rt t. ! queue ! tensor_sink name=logits",
        frames[:1], sinks=("rt", "logits"))[0]
    rt = np.asarray(dec["rt"][0].tensors[0]).reshape(-1)
    lg = np.asarray(dec["logits"][0].tensors[0]).astype(np.float32).reshape(-1)
    roundtrip = rt.tobytes() == lg.tobytes()
    res["E7"] = {"frames": len(labels[0]), "logits_identical": same,
                 "labels_equal": labels[0] == labels[1],
                 "script_outputs_on_host": host_logits,
                 "forced_syncs_per_frame": syncs / STREAM_FRAMES,
                 "normalize_launches": launched, "scaler_plain": scaler,
                 "codec_roundtrip": roundtrip}
    print(f"phase 41: E7 B ({STREAM_FRAMES} frames, bf16) with a "
          f"framework=custom ×0.5 scaler before the model and a "
          f"framework=python3 passthrough after it: logits bit for bit those "
          f"of tensor_transform mul:0.5 without the script: {same}; labels "
          f"equal {labels[0] == labels[1]}; forced syncs "
          f"{syncs / STREAM_FRAMES:.3f} a frame (the script's; its outputs "
          f"host arrays: {host_logits}); the scaler's CUDA output = the "
          f"plain normalize ×0.5: {scaler}; normalize_u8 launched "
          f"{launched} times; python3 decoder → mode=custom-script: gives "
          f"back the logits' bytes: {roundtrip} [{card}]")
    check(same and labels[0] == labels[1] and len(labels[0]) == STREAM_FRAMES
          and syncs == STREAM_FRAMES and host_logits and scaler
          and launched == STREAM_FRAMES and roundtrip, f"E7: {res['E7']}")
    return {"E7": launched}


def streaming_correctness(nt, torch, card, record) -> dict:
    """Phase 41: E5-E7. → normalize_u8's launches by path."""
    import tempfile

    res = {}
    e5_phase(nt, torch, card, res)
    launches = e6_phase(nt, torch, card, res)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scripts_") as d:
        scripts = {}
        for name, text in (("passthrough", PASSTHROUGH_PY),
                           ("decoder", DECODER_PY),
                           ("converter", CONVERTER_PY)):
            scripts[name] = str(Path(d) / f"{name}.py")
            Path(scripts[name]).write_text(text)
        launches.update(e7_phase(nt, torch, card, res, scripts))
    record["streaming"] = res
    return launches


def wire_phase(nt, torch, card, res) -> None:
    """Wire frames of a buffer of CUDA tensors (every dtype): the bytes of
    the same buffer on the host, one counted sync a frame."""
    from nnstreamer_tpu_torch.edge import wire
    from nnstreamer_tpu_torch.runtime import sync
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    g = torch.Generator(device="cuda").manual_seed(42)
    dtypes = (torch.uint8, torch.int16, torch.int32, torch.int64,
              torch.float16, torch.bfloat16, torch.float32, torch.float64)
    frames = []
    for i in range(4):
        ts = [torch.randn(3, 5, 7, device="cuda", generator=g).mul(50)
              .to(dt) for dt in dtypes]
        frames.append(TensorBuffer.of(*ts, pts=i).with_meta(
            label="x", boxes=np.arange(6, dtype=np.float32).reshape(1, 6)))
    syncs0 = sync.forced_sync_count()
    enc = [wire.encode_buffer(b, client_id=7) for b in frames]
    syncs = sync.forced_sync_count() - syncs0
    host = [wire.encode_buffer(b.to_host(), client_id=7) for b in frames]
    same = enc == host
    back = [wire.decode_buffer(e)[0] for e in enc]
    values = all(np.asarray(t).tobytes() == np.asarray(u).tobytes()
                 for b, h in zip(back, frames)
                 for t, u in zip(b.tensors, h.to_host().tensors))
    res["wire"] = {"frames": len(enc), "bytes_equal_host": same,
                   "forced_syncs_per_frame": syncs / len(enc),
                   "decoded_equal": values, "bytes": len(enc[0])}
    print(f"phase 42: wire frames of {len(enc)} buffers of CUDA tensors "
          f"({len(dtypes)} dtypes, {len(enc[0])} bytes each): byte for byte "
          f"those of the same buffers on the host: {same}; forced syncs "
          f"{syncs / len(enc):.3f} a frame; decoded = the values: {values}")
    check(same and values and syncs == len(enc), f"wire: {res['wire']}")


def _ipc_child(ring, turns, n, created, go, done):
    """Phase 42's producer process (spawned): for each turn, appsrc →
    ipc_sink on its own ring; the frames are pushed when the parent says
    go, and the ring is kept until the parent has read it all."""
    sys.path.insert(0, str(ROOT))
    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    frames = u8_frames((1, 224, 224, 3), n, 42)
    for t in range(turns):
        pipe = nt.parse_launch(f"{APPSRC} ! ipc_sink ring={ring}-{t} "
                               f"capacity={1 << 24}")
        runner = nt.PipelineRunner(pipe).start()
        created[t].set()
        go[t].wait(300)
        for i, f in enumerate(frames):
            pipe.get("src").push(TensorBuffer.of(f, pts=i))
        pipe.get("src").end()
        runner.wait(300)
        done[t].wait(300)
        runner.stop()


def ipc_phase(nt, torch, card, res) -> None:
    """ipc_sink in a spawned child feeds ipc_src here, at B's frame, the
    native library built at first use; B's model after ipc_src gives B
    direct's labels; frames/s of both in turns B, ipc, ipc, B."""
    import multiprocessing
    import os

    from nnstreamer_tpu_torch import native

    t0 = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t0
    frames = u8_frames((1, 224, 224, 3), IPC_FRAMES, 42)
    tail = f"{NORM_B} ! {MODEL} ! {LABEL} ! tensor_sink name=out"
    ctx = multiprocessing.get_context("spawn")
    ring = f"/chip-smoke-{os.getpid()}"
    ev = {k: [ctx.Event() for _ in range(2)] for k in ("created", "go",
                                                      "done")}
    child = ctx.Process(target=_ipc_child, args=(
        ring, 2, IPC_FRAMES, ev["created"], ev["go"], ev["done"]))
    child.start()
    fps, labels = {"B": [], "ipc": []}, {}
    try:
        # warm the model once so no arm pays for a first build
        run_desc(nt, f"{APPSRC} ! {tail}", frames[:2])
        for arm, turn in (("B", None), ("ipc", 0), ("ipc", 1), ("B", None)):
            if arm == "B":
                pipe = nt.parse_launch(f"{APPSRC} ! {tail}")
                runner = nt.PipelineRunner(pipe).start()
                t = time.perf_counter()
                push_and_wait(pipe, runner, frames)
            else:
                check(ev["created"][turn].wait(300),
                      "ipc: the child never created its ring")
                pipe = nt.parse_launch(
                    f"ipc_src ring={ring}-{turn} dims=3:224:224:1 "
                    f"types=uint8 ! {tail}")
                runner = nt.PipelineRunner(pipe).start()
                t = time.perf_counter()
                ev["go"][turn].set()
                try:
                    runner.wait(300)
                finally:
                    runner.stop()
                    ev["done"][turn].set()
            fps[arm].append(IPC_FRAMES / (time.perf_counter() - t))
            labels.setdefault(arm, [b.meta["label_index"]
                                    for b in pipe.get("out").results])
        child.join(120)
    finally:
        for e in ev["go"] + ev["done"]:
            e.set()
        if child.is_alive():
            child.kill()
            child.join(10)
    res["ipc"] = {"frames": len(labels["ipc"]), "labels_equal":
                  labels["ipc"] == labels["B"], "fps": fps,
                  "child_exit": child.exitcode, "library": lib.name,
                  "build_s": build_s}
    print(f"phase 42: ipc_sink in a spawned process → ipc_src → B "
          f"({IPC_FRAMES} frames of 1×224×224×3 u8; {lib.name} built with "
          f"g++ in {build_s:.2f} s): labels equal B direct's: "
          f"{labels['ipc'] == labels['B']}; frames/s in turns B / ipc / ipc "
          f"/ B: {fps['B'][0]:.1f} / {fps['ipc'][0]:.1f} / "
          f"{fps['ipc'][1]:.1f} / {fps['B'][1]:.1f} [{card}]")
    check(len(labels["ipc"]) == IPC_FRAMES and labels["ipc"] == labels["B"]
          and child.exitcode == 0, f"ipc: {res['ipc']}")


def iio_phase(nt, torch, card, res) -> None:
    """tensor_src_iio from a fake sysfs tree (3 × s16 and a u64
    timestamp, scale and offset) into a filter on the card: CUDA tensors
    equal to the model on an independent numpy decode."""
    import struct
    import tempfile

    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle

    n, fpt = 64, 16
    rng = np.random.default_rng(42)
    raw = rng.integers(-2048, 2048, (n, 3)).astype(np.int16)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_iio_") as d:
        dev = Path(d) / "iio:device0"
        scan = dev / "scan_elements"
        scan.mkdir(parents=True)
        (dev / "name").write_text("chip_accel\n")
        (dev / "sampling_frequency").write_text("400\n")
        for i, ch in enumerate(("in_accel_x", "in_accel_y", "in_accel_z")):
            (scan / f"{ch}_en").write_text("1\n")
            (scan / f"{ch}_index").write_text(f"{i}\n")
            (scan / f"{ch}_type").write_text("le:s16/16>>0\n")
            (dev / f"{ch}_scale").write_text("0.5\n")
            (dev / f"{ch}_offset").write_text("3\n")
        (scan / "in_timestamp_en").write_text("1\n")
        (scan / "in_timestamp_index").write_text("3\n")
        (scan / "in_timestamp_type").write_text("le:u64/64>>0\n")
        data = Path(d) / "samples.bin"
        data.write_bytes(b"".join(struct.pack("<hhh2xQ", *map(int, r), 1000 + i)
                                  for i, r in enumerate(raw)))
        pipe = nt.parse_launch(
            f"tensor_src_iio device=chip_accel base_dir={d} data={data} "
            f"frames_per_tensor={fpt} ! tensor_filter name=f ! "
            f"tensor_sink name=out to-host=false")
        pipe.get("f").set_props(model=ModelBundle(
            fn=lambda p, x: (x[:, :3] * 2.0 + 1.0,), name="affine"))
        nt.run_pipeline(pipe, timeout=120)
    out = pipe.get("out").results
    want = ((raw.astype(np.float32) + 3.0) * 0.5) * 2.0 + 1.0
    cuda = all(r.tensors[0].is_cuda for r in out)
    got = np.concatenate([r.tensors[0].cpu().numpy() for r in out])
    same = got.shape == want.shape and bool(np.array_equal(got, want))
    res["iio"] = {"buffers": len(out), "cuda": cuda, "equal": same}
    print(f"phase 42: tensor_src_iio (fake sysfs: 3 × le:s16 + u64 "
          f"timestamp, scale 0.5, offset 3) → a filter on the card: "
          f"{len(out)} buffers of {fpt} samples as CUDA tensors ({cuda}), "
          f"equal to the model on a numpy decode: {same}")
    check(len(out) == n // fpt and cuda and same, f"iio: {res['iio']}")


def prefetch_run(torch, shape, busy_cycles: int):
    """prefetch_to_device at depth 2 through a CopyStager whose copies a
    `put=` wrapper pins and brackets with timing events on the copy
    stream, a
    consumer that reads each batch behind a busy kernel → (batches in
    order and equal to their sources, the copies' overlap with the
    consumer's busy kernels as a share of copy time, copy ms a batch)."""
    from nnstreamer_tpu_torch.runtime.input_pipeline import (
        CopyStager, prefetch_to_device)

    rng = np.random.default_rng(sum(shape))
    src = [rng.integers(0, 256, shape, np.uint8) for _ in
           range(PREFETCH_BATCHES)]
    for i, s in enumerate(src):
        s.reshape(-1)[0] = i
    stager = CopyStager("cuda")
    timed = []

    def put(x, device):
        # pinned here, so the stager's own pin_memory() is a no-op and
        # the bracket holds the copy alone
        pinned = torch.from_numpy(x).pin_memory()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stager.stream)
        staged = stager(pinned)
        end.record(stager.stream)
        timed.append((start, end))
        return staged

    base = torch.cuda.Event(enable_timing=True)
    base.record()
    busy, got = [], []
    for y in prefetch_to_device(iter(src), depth=PREFETCH_DEPTH, put=put):
        b0 = torch.cuda.Event(enable_timing=True)
        b1 = torch.cuda.Event(enable_timing=True)
        b0.record()
        torch.cuda._sleep(busy_cycles)
        total = y.sum(dtype=torch.int64)
        b1.record()
        busy.append((b0, b1))
        got.append((y, total))
    torch.cuda.synchronize()

    def span(a, b):
        return base.elapsed_time(a), base.elapsed_time(b)

    copies = [span(*c) for c in timed]
    busy = [span(*b) for b in busy]
    overlap = sum(max(0.0, min(c1, b1) - max(c0, b0))
                  for c0, c1 in copies for b0, b1 in busy)
    copy_ms = sum(c1 - c0 for c0, c1 in copies)
    ordered = [int(y.reshape(-1)[0]) for y, _ in got] == list(
        range(PREFETCH_BATCHES))
    equal = all(np.array_equal(y.cpu().numpy(), s) and int(tot) == int(
        s.sum(dtype=np.int64)) for (y, tot), s in zip(got, src))
    return ordered, equal, overlap / copy_ms, copy_ms / len(copies)


def prefetch_phase(nt, torch, card, res) -> None:
    """prefetch_to_device at depth 2 at B's frame and at a 16 MB frame: in
    order, each batch its host source, the copy stream overlapping a busy
    consumer (the overlap as a share of copy time, from CUDA events)."""
    out = {}
    for name, shape, cycles in (("B frame", (1, 224, 224, 3), 400_000),
                                ("16 MB", (16, 1024, 1024), 4_000_000)):
        prefetch_run(torch, shape, cycles)          # warm: streams, pinned
        ordered, equal, share, copy_ms = prefetch_run(torch, shape, cycles)
        out[name] = {"ordered": ordered, "equal": equal,
                     "overlap_share": share, "copy_ms": copy_ms,
                     "busy_ms": cycles / 2e6}
        print(f"phase 42: prefetch_to_device depth {PREFETCH_DEPTH}, "
              f"{PREFETCH_BATCHES} batches of {name} {shape} u8: in order "
              f"{ordered}, each its host source {equal}; copy "
              f"{copy_ms:.4f} ms a batch on the side stream, "
              f"{100 * share:.1f}% of copy time under the consumer's busy "
              f"kernels (~{cycles / 2e6:.1f} ms each) [{card}]")
        check(ordered and equal, f"prefetch {name}: {out[name]}")
    check(out["16 MB"]["overlap_share"] > 0,
          f"prefetch: the copies never overlapped the consumer: {out}")
    res["prefetch"] = out


def streaming_io(nt, torch, card, record) -> None:
    """Phase 42: the wire format, ipc, iio and the prefetching input."""
    res = {}
    wire_phase(nt, torch, card, res)
    ipc_phase(nt, torch, card, res)
    iio_phase(nt, torch, card, res)
    prefetch_phase(nt, torch, card, res)
    record["streaming_io"] = res


def streaming_phases(nt, torch, card, record, phases) -> dict:
    """Phases 41-42. → normalize_u8's launches by path."""
    launches = streaming_correctness(nt, torch, card, record)
    phases.done("41 (zoo LSTM and audio, the script backends)")
    streaming_io(nt, torch, card, record)
    phases.done("42 (wire, ipc, iio, prefetch)")
    return launches


# -- phases 43-44: the model store on the filter, the query edge ---------

#: phases 43-44 (Queue 1 items 4a-4b): Q1's frames, the two clients'
#: frames each, the canary's, the hot swap's burst, the overload burst,
#: Q2's clients and frames a client; timings: the burst, closed-loop
#: frames, warm-up frames, and Q2's frames a client in its timing arms
Q1_FRAMES, Q_TWO_FRAMES, Q3_FRAMES = 32, 16, 48
SWAP_FRAMES, OVERLOAD_FRAMES = 160, 64
#: the idle-filter swap's burst (half before the flip, half after)
SWAP_IDLE_FRAMES = 32
Q2_CLIENTS, Q2_FRAMES = 4, 16
Q_BURST, Q_LAT, Q_WARMUP, Q2_TIMED = 64, 64, 8, 32
Q_TIMEOUT = 120
#: served logits of Q2 (f32, TF32 off, cuDNN free to pick another
#: algorithm at batch 8) against B's per frame, relative to max |logit|
Q2_REL = 1e-3
CANARY = "store://mbv2@2:0.25 canary_seed=7"


def q_server(nt, sid, model, src_extra="", trace=False):
    """Q1's server pipeline → (pipe, runner, port): tensor_query_serversrc
    ! normalize_u8 ! tensor_filter model=`model` ! tensor_query_serversink."""
    pipe = nt.parse_launch(
        f"tensor_query_serversrc name=ssrc id={sid} port=0 "
        f"dims=3:224:224:1 types=uint8 {src_extra} ! {NORM_B} ! "
        f"tensor_filter name=f model={model} ! "
        f"tensor_query_serversink id={sid}")
    runner = nt.PipelineRunner(pipe, trace=trace).start()
    return pipe, runner, pipe.get("ssrc").port


def q_client_desc(port, extra=""):
    """Q1's client: frames to the server, labels and logits back."""
    return (f"{APPSRC} ! tensor_query_client name=qc port={port} "
            f"timeout={Q_TIMEOUT} {extra} ! tee name=t t. ! queue ! {LABEL} "
            f"! tensor_sink name=labels t. ! queue ! tensor_sink name=logits")


def q_ask(nt, port, frames, extra=""):
    """One client run → (logits by frame, labels by frame, pts)."""
    out, _, _ = run_sinks(nt, q_client_desc(port, extra), frames,
                          sinks=("labels", "logits"))
    return (logits_of(out["logits"]),
            [b.meta["label_index"] for b in out["labels"]],
            [b.pts for b in out["logits"]])


def b_logits(nt, model, frames):
    """B run directly on `model` (per frame, in this process) → (logits,
    labels)."""
    out, _, _ = run_sinks(
        nt, f"{APPSRC} ! {NORM_B} ! tensor_filter model={model} ! tee "
            f"name=t t. ! queue ! {LABEL} ! tensor_sink name=labels t. ! "
            f"queue ! tensor_sink name=logits", frames,
        sinks=("labels", "logits"))
    return (logits_of(out["logits"]),
            [b.meta["label_index"] for b in out["labels"]])


def rows_equal(a, b) -> list:
    """Per frame: are the two rows the same bytes."""
    return [x.tobytes() == y.tobytes() for x, y in zip(a, b)]


def wrap_calls(backend) -> list:
    """Record a torch backend's invokes (1) and windows (K) in order."""
    calls = []
    inv, win = backend.invoke, backend.invoke_window

    def invoke(t):
        calls.append(1)
        return inv(t)

    def invoke_window(frames):
        calls.append(len(frames))
        return win(frames)

    backend.invoke, backend.invoke_window = invoke, invoke_window
    return calls


def canary_cpu_versions(calls) -> list:
    """The port on the CPU, fed the card's split of invokes and windows:
    versions by frame of ``store://pq@2:0.25 canary_seed=7`` over
    probe_scale at 2 (v1) and 3 (v2) — the routing alone, whatever the
    model."""
    from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend
    from nnstreamer_tpu_torch.serving.store import get_store

    st = get_store()
    st.register("pq", "zoo://probe_scale?scale=2")
    st.register("pq", "zoo://probe_scale?scale=3")
    b = TorchBackend()
    b.open({"model": "store://pq@2:0.25", "accelerator": "cpu",
            "canary_seed": 7})
    x = np.ones((8, 1), np.float32)
    seq = []
    try:
        for k in calls:
            outs = [b.invoke((x,))] if k == 1 else b.invoke_window([(x,)] * k)
            seq += [1 if float(np.asarray(o[0])[0, 0]) == 2.0 else 2
                    for o in outs]
    finally:
        b.close()
    return seq


def q1_phase(nt, torch, card, res) -> int:
    """Q1 through the query edge against B direct; two clients at once.
    → normalize_u8's launches in Q1."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.runtime import sync

    frames = u8_frames((1, 224, 224, 3), Q1_FRAMES, 431)
    ref, ref_labels = b_logits(nt, "store://mbv2", frames)
    pipe, runner, port = q_server(nt, 4301, "store://mbv2")
    try:
        def attempt():
            kernels.normalize_u8.launches = 0
            syncs0 = sync.forced_sync_count()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                open_capture(torch)
                got = q_ask(nt, port, frames, "max_in_flight=4")
                torch.cuda.synchronize()
                close_capture(torch)
            syncs = sync.forced_sync_count() - syncs0
            named = sum("nns_normalize_kernel" in e.name
                        for e in kernel_events(prof))
            launched = kernels.normalize_u8.launches
            return ({"normalize_u8": launched}, {"normalize_u8": named},
                    (got, launched, syncs))

        ((logits, labels, pts), launched, syncs), tries = profiled_agreement(
            "phase 43: Q1", attempt)
        same = rows_equal(logits, ref)
        st = runner.stats()
        adm = st["ssrc"]
        res["Q1"] = {"frames": len(pts), "bit_for_bit": sum(same),
                     "labels_equal": labels == ref_labels,
                     "pts_in_order": pts == list(range(Q1_FRAMES)),
                     "normalize_launches": launched,
                     "forced_syncs_per_frame": syncs / Q1_FRAMES,
                     "admitted": adm["admitted"], "replied": adm["replied"],
                     "windows": st["f"].get("loop_entries", 0)}
        print(f"phase 43: Q1 (serversrc ! normalize_u8 ! store://mbv2 ! "
              f"serversink; client max_in_flight 4; bf16), {Q1_FRAMES} "
              f"frames: logits bit for bit B direct's on the same version: "
              f"{sum(same)}/{Q1_FRAMES}, labels equal {labels == ref_labels}, "
              f"pts in order {res['Q1']['pts_in_order']}; normalize_u8 "
              f"launched {launched} times, by the wrapper and by name "
              f"(profiled run {tries}); {syncs / Q1_FRAMES:.3f} forced syncs "
              f"a frame (the reply's); the model filter's windows "
              f"{res['Q1']['windows']} [{card}]")
        check(all(same) and len(same) == Q1_FRAMES and labels == ref_labels
              and res["Q1"]["pts_in_order"] and launched == Q1_FRAMES
              and syncs == Q1_FRAMES, f"Q1: {res['Q1']}")

        # two clients with frames in flight at once, each its own order
        two = {c: u8_frames((1, 224, 224, 3), Q_TWO_FRAMES, 432 + c)
               for c in (0, 1)}
        want = {c: b_logits(nt, "store://mbv2", two[c])[0] for c in two}
        with ThreadPoolExecutor(2) as ex:
            got = dict(zip(two, ex.map(
                lambda c: q_ask(nt, port, two[c], "max_in_flight=8"), two)))
        ok = {c: all(rows_equal(got[c][0], want[c]))
              and got[c][2] == list(range(Q_TWO_FRAMES)) for c in two}
        res["two_clients"] = ok
        print(f"phase 43: two clients at once ({Q_TWO_FRAMES} frames each, "
              f"max_in_flight 8): each in pts order with its own frames' "
              f"logits bit for bit: {ok}")
        check(all(ok.values()), f"two clients: {ok}")
    finally:
        runner.stop()
    return launched


def q3_canary(nt, torch, card, res) -> None:
    """Q3 canary: store://mbv2@2:0.25 canary_seed=7 behind the query edge,
    windows on: every frame one version's direct output bit for bit, the
    version sequence the port's on the CPU for the same split."""
    from nnstreamer_tpu_torch.serving.store import get_store

    frames = u8_frames((1, 224, 224, 3), Q3_FRAMES, 433)
    direct = {v: b_logits(nt, f"store://mbv2@{v}", frames)[0] for v in (1, 2)}
    entry = get_store().entry("mbv2")
    pipe, runner, port = q_server(nt, 4302, CANARY)
    try:
        calls = wrap_calls(pipe.get("f").backend)
        before = entry.stats_dict()
        logits, _, pts = q_ask(nt, port, frames, "max_in_flight=8")
        after = entry.stats_dict()
    finally:
        runner.stop()
    seq = []
    for i, row in enumerate(logits):
        hit = [v for v in (1, 2) if row.tobytes() == direct[v][i].tobytes()]
        seq.append(hit[0] if len(hit) == 1 else None)
    cpu = canary_cpu_versions(calls)
    # the entry's counters are process-wide: this run's share
    counts = {v: after.get(v, {}).get("invokes", 0)
              - before.get(v, {}).get("invokes", 0) for v in (1, 2)}
    res["Q3_canary"] = {"frames": len(seq), "versions": seq, "calls": calls,
                        "cpu_versions_equal": seq == cpu,
                        "invokes_by_version": counts,
                        "windows": sum(k > 1 for k in calls)}
    print(f"phase 43: Q3 canary ({CANARY}, v2 = seed-1 weights, windows "
          f"on), {Q3_FRAMES} frames: each one version's direct output bit "
          f"for bit: {None not in seq}; v2 on {seq.count(2)} frames; "
          f"{len(calls)} backend calls, {res['Q3_canary']['windows']} of "
          f"them windows; the version sequence equals the port's CPU "
          f"routing over the same split: {seq == cpu}; per-version invokes "
          f"{counts} [{card}]")
    check(None not in seq and seq == cpu and pts == list(range(Q3_FRAMES))
          and sum(counts.values()) == Q3_FRAMES and 0 < seq.count(2)
          and counts[2] == seq.count(2), f"Q3 canary: {res['Q3_canary']}")


def adoption_site(tracer, name: str, nth: int) -> str:
    """Where `name`'s nth store adoption was taken up, read from the
    order of its events on the tracer: "bail" (the compiled loop's swap
    bail just before it, then a per-frame invoke), "window" (a window's
    own version pick: its invoke_window span next), "frame" (a per-frame
    invoke with no bail: a frame left over from a window, or the loop
    not armed)."""
    keep = ("model_swap", "loop_bail_swap", "invoke_window", "process")
    own = [e[3] for e in tracer.events() if e[2] == name and e[3] in keep]
    at = [i for i, k in enumerate(own) if k == "model_swap"][nth]
    if at and own[at - 1] == "loop_bail_swap":
        return "bail"
    nxt = own[at + 1] if at + 1 < len(own) else None
    return {"invoke_window": "window", "process": "frame"}.get(nxt, str(nxt))


def window_versions(tracer, name: str) -> list:
    """The version of each of `name`'s invoke_window spans, with None for
    each of its adoptions, in the tracer's order."""
    return [None if e[3] == "model_swap" else (e[6] or {}).get("version")
            for e in tracer.events()
            if e[2] == name and e[3] in ("model_swap", "invoke_window")]


def swap_burst(cpipe, entry, frames) -> threading.Thread:
    """A started thread pushing `frames` from a running client pipeline;
    the second half only once `entry`'s epoch has moved on."""
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    epoch0 = entry.epoch
    half = len(frames) // 2

    def push():
        for i, f in enumerate(frames):
            if i == half:
                t_end = time.monotonic() + 120
                while entry.epoch == epoch0 and time.monotonic() < t_end:
                    time.sleep(0.001)
            cpipe.get("src").push(TensorBuffer.of(f, pts=i))
        cpipe.get("src").end()

    pusher = threading.Thread(target=push)
    pusher.start()
    return pusher


def version_seq(logits, direct, versions) -> list:
    """Each reply's version: the one whose direct logits it equals bit for
    bit (None: torn, or none of them)."""
    seq = []
    for i, row in enumerate(logits):
        hit = [v for v in versions if row.tobytes() == direct[v][i].tobytes()]
        seq.append(hit[0] if len(hit) == 1 else None)
    return seq


def q3_swap(nt, torch, card, res) -> None:
    """Q3 hot swap, windows on, twice on one server. In flight: store://
    mbv2s updated 1 → 2 once a quarter of a burst is back, with the
    frames up to its half in flight; the second half is pushed once the
    epoch has flipped, so frames flow under the barrier (the card
    otherwise drains the whole burst before the prewarm ends): no torn
    frame, versions never go back, every window before the adoption on 1
    and after it on 2, the barrier, a prewarmed flip, and the adoption
    taken up at an invoke boundary — after a "swap" bail, at a window's
    own version pick, or by a per-frame invoke (a frame left over from a
    window), as the tracer's order shows. Idle: 2 → 3 (v1's weights)
    once the filter has run the first half of a short burst and nothing
    is in flight; the armed loop's next frame meets the pending swap, so
    this adoption must follow a "swap" bail."""
    from nnstreamer_tpu_torch.serving.store import get_store

    store = get_store()
    e = store.entry("mbv2")
    for v in (1, 2, 1):
        store.register("mbv2s", e.bundle(v))
    frames = u8_frames((1, 224, 224, 3), SWAP_FRAMES, 434)
    idle = frames[:SWAP_IDLE_FRAMES]
    direct = {v: b_logits(nt, f"store://mbv2s@{v}", frames)[0]
              for v in (1, 2)}
    direct[3] = b_logits(nt, "store://mbv2s@3", idle)[0]
    entry = store.entry("mbv2s")
    pipe, runner, port = q_server(nt, 4303, "store://mbv2s", trace=True)
    rep = rep3 = {}
    try:
        # -- in flight: 1 → 2 -------------------------------------------
        cpipe = nt.parse_launch(q_client_desc(port, "max_in_flight=16"))
        crun = nt.PipelineRunner(cpipe).start()
        pusher = swap_burst(cpipe, entry, frames)
        sink = cpipe.get("logits")
        deadline = time.monotonic() + 120
        while len(sink.results) < SWAP_FRAMES // 4:
            check(time.monotonic() < deadline, "swap: no flow in 120 s")
            time.sleep(0.002)
        rep = store.update("mbv2s", 2, wait_s=60)
        pusher.join(120)
        crun.wait(300)
        crun.stop()
        st = runner.stats()["f"]
        site = adoption_site(runner.tracer, "f", 0)
        # -- idle: 2 → 3 ------------------------------------------------
        base = st["buffers"]
        cpipe3 = nt.parse_launch(q_client_desc(port, "max_in_flight=16"))
        crun3 = nt.PipelineRunner(cpipe3).start()
        pusher = swap_burst(cpipe3, entry, idle)
        deadline = time.monotonic() + 120
        while runner.stats()["f"]["buffers"] < base + SWAP_IDLE_FRAMES // 2:
            check(time.monotonic() < deadline, "idle swap: no flow in 120 s")
            time.sleep(0.002)
        rep3 = store.update("mbv2s", 3, wait_s=60)
        pusher.join(120)
        crun3.wait(300)
        crun3.stop()
        st3 = runner.stats()["f"]
        site3 = adoption_site(runner.tracer, "f", 1)
        wins = window_versions(runner.tracer, "f")
        swaps = runner.tracer.swap_events()
    finally:
        runner.stop()
    seq = version_seq(logits_of(sink.results), direct, (1, 2))
    flip = seq.index(2) if 2 in seq else len(seq)
    monotone = all(v == 1 for v in seq[:flip]) and all(
        v == 2 for v in seq[flip:])
    # windows: 1 until the first adoption, 2 until the second, then 3
    cuts = [i for i, v in enumerate(wins) if v is None]
    win_ok = len(cuts) == 2 and all(
        v == want for part, want in zip(
            (wins[:cuts[0]], wins[cuts[0] + 1:cuts[1]], wins[cuts[1] + 1:]),
            (1, 2, 3)) for v in part)
    bails = st.get("loop_bails", {})
    res["Q3_swap"] = {
        "frames": len(seq), "torn": seq.count(None), "monotone": monotone,
        "flip_at": flip, "barrier_ok": rep.get("barrier_ok"),
        "prewarmed_buckets": rep.get("prewarmed_buckets"),
        "prewarmed_flip": [bool(a.get("prewarmed")) for _, _, a in swaps],
        "loop_bails": bails, "windows": st.get("loop_entries", 0),
        "adopted_at": site, "window_versions_ok": win_ok}
    print(f"phase 43: Q3 hot swap in flight store://mbv2s 1 → 2 after "
          f"{SWAP_FRAMES // 4} of {SWAP_FRAMES} frames back (client in "
          f"flight 16, frames {SWAP_FRAMES // 2}+ pushed after the flip, "
          f"windows on): torn frames {seq.count(None)}, versions never "
          f"go back {monotone} (flip at frame {flip}), barrier_ok "
          f"{rep.get('barrier_ok')}, {rep.get('prewarmed_buckets')} buckets "
          f"prewarmed, adoptions prewarmed {res['Q3_swap']['prewarmed_flip']}"
          f", {res['Q3_swap']['windows']} windows, bails {bails}, adopted "
          f"at {site!r} (the tracer's order), every window on its "
          f"version {win_ok} [{card}]")
    check(len(seq) == SWAP_FRAMES and None not in seq and monotone
          and SWAP_FRAMES // 4 <= flip <= SWAP_FRAMES // 2
          and rep.get("barrier_ok") is True
          and rep.get("prewarmed_buckets", 0) >= 1
          and res["Q3_swap"]["prewarmed_flip"] == [True, True]
          and win_ok and site in ("bail", "window", "frame")
          and (site != "bail" or bails.get("swap", 0) >= 1),
          f"Q3 swap: {res['Q3_swap']}")
    seq3 = version_seq(logits_of(cpipe3.get("logits").results), direct,
                       (2, 3))
    half = SWAP_IDLE_FRAMES // 2
    bails3 = {k: n - bails.get(k, 0)
              for k, n in st3.get("loop_bails", {}).items()}
    res["Q3_swap_idle"] = {
        "frames": len(seq3), "versions": seq3,
        "barrier_ok": rep3.get("barrier_ok"), "loop_bails": bails3,
        "adopted_at": site3}
    print(f"phase 43: Q3 hot swap idle store://mbv2s 2 → 3 (v1's weights) "
          f"once the server ran {half} of {SWAP_IDLE_FRAMES} frames, the "
          f"rest pushed after the flip: versions {seq3[:half].count(2)} x 2 "
          f"then {seq3[half:].count(3)} x 3 of {half} each, barrier_ok "
          f"{rep3.get('barrier_ok')}, bails {bails3}, adopted at "
          f"{site3!r} [{card}]")
    check(seq3 == [2] * half + [3] * half
          and rep3.get("barrier_ok") is True
          and bails3.get("swap", 0) >= 1 and site3 == "bail",
          f"Q3 idle swap: {res['Q3_swap_idle']}")


def q_overload(nt, torch, card, res) -> None:
    """max_pending=2 and a burst from a raw client: every frame comes
    back as a RESULT or a typed BUSY, results in pts order."""
    import json as _json

    from nnstreamer_tpu_torch.edge import protocol as P
    from nnstreamer_tpu_torch.edge.wire import decode_buffer, encode_buffer
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    frames = u8_frames((1, 224, 224, 3), OVERLOAD_FRAMES, 435)
    pipe, runner, port = q_server(nt, 4304, "store://mbv2",
                                  src_extra="max_pending=2")
    results, busy, causes = [], [], Counter()
    done, hello = threading.Event(), threading.Event()

    def on_msg(mtype, payload):
        if mtype == P.T_HELLO_ACK:
            hello.set()
            return
        if mtype == P.T_RESULT:
            results.append(decode_buffer(payload)[0].pts)
        elif mtype == P.T_BUSY:
            info = _json.loads(payload.decode())
            busy.append(info["pts"])
            causes[info["cause"]] += 1
        if len(results) + len(busy) >= OVERLOAD_FRAMES:
            done.set()

    cli = P.MsgClient("127.0.0.1", port, on_message=on_msg)
    try:
        cli.send(P.T_HELLO, b'{"dims": "3:224:224:1", "types": "uint8"}')
        check(hello.wait(30), "overload: no HELLO_ACK")
        for i, f in enumerate(frames):
            cli.send(P.T_DATA, encode_buffer(TensorBuffer.of(f, pts=i)))
        check(done.wait(120), f"overload: {len(results)} results and "
                              f"{len(busy)} BUSY of {OVERLOAD_FRAMES}")
        adm = runner.stats()["ssrc"]
    finally:
        cli.close()
        runner.stop()
    res["overload"] = {"answered": len(results), "busy": len(busy),
                       "causes": dict(causes),
                       "results_in_order": results == sorted(results),
                       "admitted": adm["admitted"], "replied": adm["replied"]}
    print(f"phase 43: overload (max_pending=2, {OVERLOAD_FRAMES} frames at "
          f"once): {len(results)} answered + {len(busy)} typed BUSY "
          f"{dict(causes)} = {len(results) + len(busy)}, results in pts "
          f"order {res['overload']['results_in_order']}")
    check(sorted(results + busy) == list(range(OVERLOAD_FRAMES)) and busy
          and results == sorted(results)
          and adm["admitted"] == adm["replied"] == len(results),
          f"overload: {res['overload']}")


def q_hybrid(nt, torch, card, res) -> None:
    """connect_type=hybrid: the client finds the server through a broker
    by topic."""
    from nnstreamer_tpu_torch.edge import EdgeBroker

    frames = u8_frames((1, 224, 224, 3), 4, 436)
    ref, _ = b_logits(nt, "store://mbv2", frames)
    broker = EdgeBroker("127.0.0.1", 0)
    try:
        pipe, runner, _ = q_server(
            nt, 4305, "store://mbv2",
            src_extra=f"broker_port={broker.port} topic=infer/mbv2")
        try:
            logits, _, _ = q_ask(
                nt, broker.port, frames,
                "connect_type=hybrid topic=infer/mbv2")
        finally:
            runner.stop()
    finally:
        broker.close()
    same = rows_equal(logits, ref)
    res["hybrid"] = {"frames": len(same), "bit_for_bit": sum(same)}
    print(f"phase 43: hybrid (a broker, topic infer/mbv2): {sum(same)}/"
          f"{len(frames)} frames bit for bit B direct's")
    check(len(same) == len(frames) and all(same), f"hybrid: {res['hybrid']}")


def q2_clients(nt, port, frames_of, n_clients, in_flight=4):
    """n clients at once against a batched server → {client: (logits,
    pts, [ms a frame])}."""
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    def run(c):
        pipe = nt.parse_launch(
            f"{APPSRC} ! tensor_query_client port={port} timeout={Q_TIMEOUT} "
            f"max_in_flight={in_flight} ! tensor_sink name=out")
        seen = {}
        pipe.get("out").set_props(
            new_data=lambda b: seen.__setitem__(b.pts, time.perf_counter()))
        runner = nt.PipelineRunner(pipe).start()
        pushed = {}
        try:
            for i, f in enumerate(frames_of(c)):
                pushed[i] = time.perf_counter()
                pipe.get("src").push(TensorBuffer.of(f, pts=i))
            pipe.get("src").end()
            runner.wait(300)
        finally:
            runner.stop()
        res = pipe.get("out").results
        return c, (logits_of(res), [b.pts for b in res],
                   [(seen[p] - pushed[p]) * 1e3 for p in pushed if p in seen])

    with ThreadPoolExecutor(n_clients) as ex:
        return dict(ex.map(run, range(n_clients)))


def q2_phase(nt, torch, card, res) -> int:
    """Q2: BatchedQueryServer, bucket 8, pre = the normalize_u8 kernel, 4
    clients x 16 frames, f32 with TF32 off. → normalize_u8's launches."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.edge import BatchedQueryServer
    from nnstreamer_tpu_torch.tensor.dtypes import DType
    from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

    def frames_of(c):
        return u8_frames((1, 224, 224, 3), Q2_FRAMES, 440 + c)

    model = "zoo://mobilenet_v2?dtype=float32"
    seen = []

    def pre(x):
        y = kernels.normalize_u8(x)
        if len(seen) < 3:
            seen.append((x.clone(), y.clone()))
        return y

    with NoTf32(torch):
        ref = {c: b_logits(nt, model, frames_of(c))[0]
               for c in range(Q2_CLIENTS)}
        srv = BatchedQueryServer(
            model, sid=4306, bucket=BATCH_MAX, max_delay_ms=2.0, pre=pre,
            in_spec=TensorsSpec.of(TensorInfo((1, 224, 224, 3),
                                              DType.UINT8)))
        try:
            def attempt():
                kernels.normalize_u8.launches = 0
                b0 = srv.stats()["batches"]
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    open_capture(torch)
                    got = q2_clients(nt, srv.port, frames_of, Q2_CLIENTS)
                    torch.cuda.synchronize()
                    close_capture(torch)
                named = sum("nns_normalize_kernel" in e.name
                            for e in kernel_events(prof))
                launched = kernels.normalize_u8.launches
                batches = srv.stats()["batches"] - b0
                return ({"normalize_u8": launched}, {"normalize_u8": named},
                        (got, launched, batches))

            (got, launched, batches), tries = profiled_agreement(
                "phase 43: Q2", attempt)
            st = srv.stats()
        finally:
            srv.close()
    plain = all(torch.equal(y, kernels.normalize_u8_plain(x))
                for x, y in seen)
    err = max(float(np.abs(got[c][0] - ref[c]).max()
                    / np.abs(ref[c]).max()) for c in got)
    routed = all(got[c][1] == list(range(Q2_FRAMES)) for c in got)
    res["Q2"] = {"clients": Q2_CLIENTS, "frames": Q2_FRAMES * Q2_CLIENTS,
                 "batches": batches, "normalize_launches": launched,
                 "normalized_batch_bit_for_bit": plain,
                 "batch_shapes": [list(x.shape) for x, _ in seen],
                 "max_rel_err": err, "routed_in_order": routed,
                 "admitted": st["admitted"], "replied": st["replied"]}
    print(f"phase 43: Q2 BatchedQueryServer (bucket {BATCH_MAX}, pre = "
          f"normalize_u8 on the card batch, f32, TF32 off), {Q2_CLIENTS} "
          f"clients x {Q2_FRAMES} frames: {batches} batches, normalize_u8 "
          f"launched {launched} times by the wrapper and by name (profiled "
          f"run {tries}); the normalized batch bit for bit the plain "
          f"version's: {plain} (batches {res['Q2']['batch_shapes']}); each "
          f"client's logits within {err:.3e} of max |logit| of B's per "
          f"frame, routed in pts order {routed} [{card}]")
    check(plain and launched == batches and 0 < batches < Q2_CLIENTS
          * Q2_FRAMES and err <= Q2_REL and routed
          and st["admitted"] == st["replied"], f"Q2: {res['Q2']}")
    return launched


MANIFEST_CHILD = r"""
import hashlib, json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import nnstreamer_tpu_torch as nt
from nnstreamer_tpu_torch.serving.store import get_store
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
get_store().register("mbvm", "zoo://mobilenet_v2")
pipe = nt.parse_launch(sys.argv[2])
runner = nt.PipelineRunner(pipe).start()
warm = pipe.get("f").backend.warm_start_buckets
frame = np.random.default_rng(437).integers(0, 256, (1, 224, 224, 3),
                                            np.uint8)
pipe.get("src").push(TensorBuffer.of(frame, pts=0))
pipe.get("src").end()
runner.wait(300)
runner.stop()
row = np.asarray(pipe.get("out").results[0].tensors[0])
print(json.dumps({"warm": warm, "sha": hashlib.sha256(row.tobytes())
                  .hexdigest()}))
"""


def q_manifest(nt, torch, card, res) -> None:
    """The bucket manifest: this process serves store://mbvm with the
    manifest on; a spawned process reads it, replays its buckets at
    start, and its first frame equals this process's."""
    import hashlib
    import os
    import tempfile

    from nnstreamer_tpu_torch.serving import compile_cache
    from nnstreamer_tpu_torch.serving.store import get_store

    desc = (f"{APPSRC} ! {NORM_B} ! tensor_filter name=f model=store://mbvm "
            f"! tensor_sink name=out")
    frame = np.random.default_rng(437).integers(0, 256, (1, 224, 224, 3),
                                                np.uint8)
    keys = ("NNSTREAMER_TPU_TORCH_SERVING_COMPILE_CACHE",
            "NNSTREAMER_TPU_TORCH_SERVING_COMPILE_CACHE_DIR")
    saved = {k: os.environ.get(k) for k in keys}
    with tempfile.TemporaryDirectory() as d:
        os.environ[keys[0]], os.environ[keys[1]] = "1", d
        compile_cache.reset()
        try:
            get_store().register("mbvm", "zoo://mobilenet_v2")
            out, _, _ = run_sinks(nt, desc, [frame])
            row = np.asarray(out["out"][0].tensors[0])
            mine = hashlib.sha256(row.tobytes()).hexdigest()
            rows = json.loads((Path(d) / "manifest.json").read_text())
            t0 = time.perf_counter()
            child = json.loads(subprocess.run(
                [sys.executable, "-c", MANIFEST_CHILD, str(ROOT), desc],
                capture_output=True, text=True, check=True,
                env=dict(os.environ), timeout=600).stdout.splitlines()[-1])
            child_s = time.perf_counter() - t0
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            compile_cache.reset()
    res["manifest"] = {"rows": rows, "child_warm_buckets": child["warm"],
                       "first_frame_equal": child["sha"] == mine,
                       "child_seconds": child_s}
    print(f"phase 43: bucket manifest {rows}; a spawned process replayed "
          f"{child['warm']} bucket(s) at start and its first frame equals "
          f"this process's: {child['sha'] == mine} ({child_s:.2f} s for the "
          f"child)")
    check(child["warm"] >= 1 and child["sha"] == mine
          and rows.get("mbvm@1"), f"manifest: {res['manifest']}")


def serving_correctness(nt, torch, card, record) -> dict:
    """Phase 43. → normalize_u8's launches by cell."""
    from nnstreamer_tpu_torch.serving.store import get_store

    store = get_store()
    store.register("mbv2", "zoo://mobilenet_v2")
    store.register("mbv2", "zoo://mobilenet_v2?seed=1")
    res = {}
    try:
        q1 = q1_phase(nt, torch, card, res)
        q3_canary(nt, torch, card, res)
        q3_swap(nt, torch, card, res)
        q_overload(nt, torch, card, res)
        q_hybrid(nt, torch, card, res)
        q2 = q2_phase(nt, torch, card, res)
        q_manifest(nt, torch, card, res)
    finally:
        record["serving_correctness"] = res
    return {"Q1": q1, "Q2": q2}


def q2_timing(nt, torch, card, res) -> None:
    """Q2 (bf16) with 1, 4 and 8 clients, arms in turns 1 4 8 8 4 1:
    aggregate frames/s, mean batch occupancy, p50 latency."""
    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.edge import BatchedQueryServer
    from nnstreamer_tpu_torch.tensor.dtypes import DType
    from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

    frame = u8_frames((1, 224, 224, 3), 1, 445)[0]
    srv = BatchedQueryServer(
        "zoo://mobilenet_v2", sid=4307, bucket=BATCH_MAX, max_delay_ms=2.0,
        pre=kernels.normalize_u8,
        in_spec=TensorsSpec.of(TensorInfo((1, 224, 224, 3), DType.UINT8)))
    out = {n: [] for n in (1, 4, 8)}
    try:
        q2_clients(nt, srv.port, lambda c: [frame] * 8, 8, in_flight=8)
        for n in (1, 4, 8, 8, 4, 1):
            b0 = srv.stats()
            t0 = time.perf_counter()
            got = q2_clients(nt, srv.port, lambda c: [frame] * Q2_TIMED, n,
                             in_flight=8)
            wall = time.perf_counter() - t0
            b1 = srv.stats()
            lat = [ms for g in got.values() for ms in g[2]]
            out[n].append({"fps": n * Q2_TIMED / wall,
                           "occupancy": (b1["frames"] - b0["frames"])
                           / (b1["batches"] - b0["batches"]),
                           "p50_ms": float(np.percentile(lat, 50)),
                           "p99_ms": float(np.percentile(lat, 99))})
    finally:
        srv.close()
    res["Q2"] = out
    for n, runs in out.items():
        print(f"phase 44: Q2 {n} client(s) x {Q2_TIMED} frames (in flight "
              f"8 each, bf16): " + " / ".join(
                  f"{r['fps']:.1f} frames/s, occupancy {r['occupancy']:.2f}, "
                  f"p50 {r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms"
                  for r in runs) + f" [{card}]")


def q1_bursts(nt, torch, port, frame, card, res) -> None:
    """Q1 against B direct, bursts of Q_BURST frames in turns a b b a,
    windows on. B runs in one live pipeline, every window size warmed
    first (phase 27's burst_arms rule). A pipelined query client emits a
    reply only when its window fills or at EOS, so each Q1 burst is a
    fresh client, connected before the clock starts, that pushes the
    burst and EOS; the server (and its graphs) lives across bursts, and
    one untimed burst warms it. Then one profiled burst an arm: kernel
    time a frame and the card's busy share."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    tail = f"{LABEL} ! tensor_sink name=out collect=false"
    b_pipe = nt.parse_launch(f"{APPSRC} ! {NORM_B} ! {MODEL} ! {tail}")
    b_seen = {}
    b_pipe.get("out").set_props(
        new_data=lambda b: b_seen.__setitem__(b.pts, time.perf_counter()))
    b_run = nt.PipelineRunner(b_pipe).start()
    pts = [0]

    def burst(arm, k):
        if arm == "Q1":
            pipe = nt.parse_launch(
                f"{APPSRC} ! tensor_query_client port={port} "
                f"timeout={Q_TIMEOUT} max_in_flight=8 ! {tail}")
            seen = {}
            pipe.get("out").set_props(
                new_data=lambda b: seen.__setitem__(b.pts,
                                                    time.perf_counter()))
            runner = nt.PipelineRunner(pipe).start()
        else:
            pipe, seen, runner = b_pipe, b_seen, None
        pushed = {}
        t0 = time.perf_counter()
        for _ in range(k):
            pushed[pts[0]] = time.perf_counter()
            pipe.get("src").push(TensorBuffer.of(frame, pts=pts[0]))
            pts[0] += 1
        if runner is not None:
            pipe.get("src").end()
            runner.wait(300)
            runner.stop()
        deadline = time.monotonic() + 300
        while len([p for p in pushed if p in seen]) < k:
            check(time.monotonic() < deadline,
                  f"{arm}: burst of {k} not drained in 300 s")
            time.sleep(0.0005)
        last = max(seen[p] for p in pushed)
        return k / (last - t0), [(seen[p] - pushed[p]) * 1e3 for p in pushed]

    out = {arm: {"fps": [], "lat": []} for arm in ("Q1", "B")}
    try:
        for k in (1, 2, 4, BATCH_MAX, 3, Q_BURST):
            burst("B", k)
        burst("Q1", Q_BURST)
        for arm in ("Q1", "B", "B", "Q1"):
            fps, lat = burst(arm, Q_BURST)
            out[arm]["fps"].append(fps)
            out[arm]["lat"] += lat
        for arm in out:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                open_capture(torch)
                burst(arm, 48)
                torch.cuda.synchronize()
                close_capture(torch)
            out[arm]["device_ms_per_frame"] = sum(
                e.time_range.elapsed_us() for e in kernel_events(prof)) \
                / 1e3 / 48
        b_pipe.get("src").end()
        b_run.wait(60)
    finally:
        b_run.stop()
    for arm, a in out.items():
        fps = float(np.median(a["fps"]))
        r = res[arm]
        r.update({"burst_fps": a["fps"],
                  "burst_p50_ms": float(np.percentile(a["lat"], 50)),
                  "burst_p99_ms": float(np.percentile(a["lat"], 99)),
                  "device_ms_per_frame": a["device_ms_per_frame"],
                  "busy_share": a["device_ms_per_frame"] * fps / 1e3})
        print(f"phase 44: {arm}: closed loop p50 {r['closed_p50_ms']:.3f} "
              f"ms p99 {r['closed_p99_ms']:.3f} ms (arms in turns, frame "
              f"by frame); bursts of {Q_BURST} in turns: " + " / ".join(
                  f"{f:.1f}" for f in a["fps"]) + f" frames/s, latency "
              f"under the burst p50 {r['burst_p50_ms']:.3f} ms p99 "
              f"{r['burst_p99_ms']:.3f} ms, {r['device_ms_per_frame']:.3f} "
              f"ms of kernel time a frame, card busy "
              f"{100 * r['busy_share']:.1f}% [{card}]")


def serving_timings(nt, torch, card, record) -> None:
    """Phase 44 (no claim): Q1 beside B direct (closed loop frame by frame
    in turns; bursts of Q_BURST in turns a b b a with windows on, kernel
    time and busy share); Q2 with 1, 4 and 8 clients; store:// beside
    zoo:// on B closed loop."""
    from nnstreamer_tpu_torch.serving.store import get_store

    get_store().register("mbvt", "zoo://mobilenet_v2")
    frame = u8_frames((1, 224, 224, 3), 1, 444)[0]
    tail = f"{LABEL} ! tensor_sink name=out"
    pipe, runner, port = q_server(nt, 4308, "store://mbvt")
    try:
        # the closed loop's client waits for each reply (in flight 1)
        lat = closed_loop_arms(
            nt, {"Q1": f"{APPSRC} ! tensor_query_client port={port} "
                       f"timeout={Q_TIMEOUT} ! {tail}",
                 "B": f"{APPSRC} ! {NORM_B} ! {MODEL} ! {tail}"},
            frame, Q_LAT, Q_WARMUP)
        res = {k: {"closed_p50_ms": float(np.percentile(v, 50)),
                   "closed_p99_ms": float(np.percentile(v, 99))}
               for k, v in lat.items()}
        q1_bursts(nt, torch, port, frame, card, res)
    finally:
        runner.stop()
    q2_timing(nt, torch, card, res)
    route = closed_loop_arms(
        nt, {"store": f"{APPSRC} ! {NORM_B} ! tensor_filter "
                      f"model=store://mbvt ! {tail}",
             "zoo": f"{APPSRC} ! {NORM_B} ! {MODEL} ! {tail}"},
        frame, Q_LAT, Q_WARMUP)
    p50 = {k: float(np.percentile(v, 50)) for k, v in route.items()}
    res["routing"] = {k: {"p50_ms": p50[k],
                          "p99_ms": float(np.percentile(v, 99))}
                      for k, v in route.items()}
    res["routing"]["store_minus_zoo_p50_ms"] = p50["store"] - p50["zoo"]
    print(f"phase 44: B closed loop, store://mbvt beside zoo://mobilenet_v2 "
          f"(frame by frame in turns): p50 {p50['store']:.3f} ms vs "
          f"{p50['zoo']:.3f} ms, the routing's cost "
          f"{p50['store'] - p50['zoo']:+.3f} ms a frame [{card}]")
    record["serving_timings"] = res


def serving_phases(nt, torch, card, record, phases) -> dict:
    """Phases 43-44. → normalize_u8's launches by cell."""
    launches = serving_correctness(nt, torch, card, record)
    phases.done("43 (store:// on the filter, the query edge: correctness)")
    serving_timings(nt, torch, card, record)
    phases.done("44 (the query edge: timings)")
    return launches


# -- phases 45-46: the supervised worker pool and the metrics plane ----------

POOL_FRAMES, POOL_KILL_FRAMES, POOL_SWAP_FRAMES = 16, 48, 48
POOL_TUNE_FRAMES, POOL_LAT, POOL_WARMUP, POOL_BURST = 48, 40, 4, 32
#: pooled logits against B direct in this process, relative to max
#: |logit|: the same weights and kernels, another process's cuDNN choice
POOL_REL = 1e-5
POOL_NORM = "tensor_filter name=norm framework=pallas model=normalize_u8"
#: the served model: the store's zoo seed (@0, MobileNetV2 1.0 at 224²,
#: bf16, seed 0) and a version 2 (seed 1) that every child preloads
POOL_STORE, POOL_V1 = "mobilenet_v2", 0
POOL_V2_REF = "zoo://mobilenet_v2?seed=1"
POOL_SHAPE, POOL_DIMS = (1, 224, 224, 3), "3:224:224:1"
#: where every child must serve (each picks it through pick_device)
POOL_DEVICE = "cuda:0"
#: a child's start is an import of torch and a CUDA context: seconds
POOL_KW = dict(ready_timeout_s=0, spawn_grace_s=180.0, hb_timeout_s=20.0,
               frame_deadline_s=120.0, drain_timeout_s=30.0,
               restart_backoff_s=0.05)


class PoolClient:
    """A raw query-wire client: every RESULT and typed BUSY by pts, with
    how many times each pts came back (a duplicate is a fault)."""

    def __init__(self, port):
        import json as _json

        from nnstreamer_tpu_torch.edge import protocol as P
        from nnstreamer_tpu_torch.edge.wire import decode_buffer

        self.P, self._json, self._decode = P, _json, decode_buffer
        self.results, self.busy, self.seen = {}, {}, Counter()
        self.t_back = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._hello = threading.Event()
        self.c = P.MsgClient("127.0.0.1", port, on_message=self._on)
        self.c.send(P.T_HELLO, _json.dumps(
            {"dims": POOL_DIMS, "types": "uint8"}).encode())
        check(self._hello.wait(60), "pool client: no HELLO_ACK")

    def _on(self, mtype, payload):
        P = self.P
        if mtype == P.T_HELLO_ACK:
            self._hello.set()
            return
        with self._cv:
            if mtype == P.T_RESULT:
                buf, _ = self._decode(payload)
                self.results[buf.pts] = np.asarray(buf.tensors[0]).astype(
                    np.float32)
                self.seen[buf.pts] += 1
                self.t_back[buf.pts] = time.perf_counter()
            elif mtype == P.T_BUSY:
                info = self._json.loads(payload.decode())
                self.busy[info["pts"]] = info["cause"]
                self.seen[info["pts"]] += 1
            self._cv.notify_all()

    def send(self, pts, frame):
        from nnstreamer_tpu_torch.edge.wire import encode_buffer
        from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

        self.c.send(self.P.T_DATA,
                    encode_buffer(TensorBuffer.of(frame, pts=pts)))

    def wait(self, pts_set, timeout=300.0):
        deadline = time.monotonic() + timeout
        with self._cv:
            while not all(p in self.seen for p in pts_set):
                left = deadline - time.monotonic()
                check(left > 0, f"pool client: {len(pts_set)} frames not "
                                f"answered within {timeout} s")
                self._cv.wait(min(left, 1.0))

    def close(self):
        self.c.close()


def pool_conserved(c) -> bool:
    return (c["offered"] == c["admitted"] + sum(c["rejected"].values())
            and c["admitted"] == c["replied"] + sum(c["shed"].values())
            + c["depth"] + c["inflight"])


def pool_launches(tracer) -> int:
    """normalize_u8's launches in the pool's children, as the wrapper's
    counter counted them there: each child's tracer hears of every
    counted launch (`cuda_graphs.observe_launches`) and ships the count
    in its trace deltas."""
    return sum(n for k, n in tracer.kernel_launches().items()
               if k.startswith("w") and k.endswith("/normalize_u8"))


def pool_spans(tracer) -> int:
    """The norm filter's process spans in the children's shipped traces:
    one a frame the filter handled, whatever ran inside it."""
    return sum(h["count"] for n, h in tracer.hists().items()
               if n.startswith("w") and n.endswith("/norm"))


def rel_to(got, ref) -> float:
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def pool_preload() -> tuple:
    """(name, version, ref) recipes of the served versions beyond the
    store's zoo seed, for the children and this process alike."""
    return ((POOL_STORE, 2, POOL_V2_REF),)


def pool_start(nt, workers, sid, tracer=None, **kw):
    """A PooledQueryServer of pipeline B's two filters (every version
    preloaded in each child), not waited for."""
    from nnstreamer_tpu_torch.serving.pool import PooledQueryServer
    from nnstreamer_tpu_torch.serving.worker import WorkerSpec

    spec = WorkerSpec(
        kind="pipeline", dims=POOL_DIMS, types="uint8",
        pipeline=f"{POOL_NORM} ! tensor_filter name=mbv2 "
                 f"model=store://{POOL_STORE}", preload=pool_preload())
    return PooledQueryServer(spec, workers=workers, sid=sid, tracer=tracer,
                             max_pending=256, **dict(POOL_KW, **kw))


def child_starts(tracer, pool_name) -> list:
    """Seconds from each spawn to its ready handshake (restarts too), as
    the pool's lifecycle events on the tracer record them."""
    spawned, out = {}, []
    for name, wid, kind, t, _ in tracer.worker_events():
        if name != pool_name:
            continue
        if kind == "spawn":
            spawned[wid] = t
        elif kind == "ready" and wid in spawned:
            out.append(t - spawned.pop(wid))
    return out


def pool_correctness(nt, torch, card, record, ctx) -> None:
    """Phase 45."""
    from nnstreamer_tpu_torch.runtime.tracing import Tracer
    from nnstreamer_tpu_torch.serving.autotune import AutoTuner, SLOSpec
    from nnstreamer_tpu_torch.serving.metrics import (
        MetricsServer, metrics_snapshot, parse_prometheus, scrape)

    from nnstreamer_tpu_torch.serving.worker import _register_preloads

    res = {}
    record["pool_correctness"] = res
    frames = u8_frames(POOL_SHAPE, POOL_FRAMES, 451)
    tr2, tr1 = Tracer(), Tracer()
    # two workers with the shm lane, one without: both start at once
    pqs2 = pool_start(nt, 2, 4501, tracer=tr2)
    pqs1 = pool_start(nt, 1, 4502, tracer=tr1, shm_transport=False)
    ctx.update(pqs2=pqs2, pqs1=pqs1, tr2=tr2, tr1=tr1)
    # B directly in this process on the same versions, pinned, while the
    # children start
    _register_preloads(pool_preload())
    refs = {}
    for v in (POOL_V1, 2):
        out = run_sinks(nt, f"{APPSRC} ! {NORM_B} ! tensor_filter "
                            f"model=store://{POOL_STORE}@{v} ! tensor_sink "
                            f"name=out", frames)[0]["out"]
        refs[v] = logits_of(out).astype(np.float32)
    ref1, ref2 = refs[POOL_V1], refs[2]
    check(pqs2.pool.wait_ready(240) and pqs1.pool.wait_ready(240),
          f"pool: workers not ready: {pqs2.stats()['workers']} "
          f"{pqs1.stats()['workers']}")
    devs = [w["device"] for p in (pqs2, pqs1) for w in p.stats()["workers"]]
    res["devices"] = devs
    check(all(d == POOL_DEVICE for d in devs), f"pool devices: {devs}")

    # -- logits, shm lane on (2 workers) and off (1 worker) --------------
    got = {}
    for key, pqs in (("shm", pqs2), ("pipe", pqs1)):
        cli = PoolClient(pqs.port)
        try:
            for i, f in enumerate(frames):
                cli.send(i, f)
            cli.wait(range(POOL_FRAMES))
        finally:
            cli.close()
        check(not cli.busy, f"pool {key}: BUSY {cli.busy}")
        got[key] = np.stack([cli.results[i] for i in range(POOL_FRAMES)])
    errs = {k: rel_to(v, ref1) for k, v in got.items()}
    bits = {k: sum(a.tobytes() == b.tobytes() for a, b in zip(v, ref1))
            for k, v in got.items()}
    lanes_equal = sum(a.tobytes() == b.tobytes()
                      for a, b in zip(got["shm"], got["pipe"]))
    p2 = pqs2.stats()["pool"]
    res["logits"] = {"max_rel": errs, "bit_for_bit": bits,
                     "shm_vs_pipe_bit_for_bit": lanes_equal,
                     "shm_frames": p2["shm_frames"],
                     "pipe_shm_frames": pqs1.stats()["pool"]["shm_frames"]}
    print(f"phase 45: pooled B (appsrc ! normalize_u8 ! store://{POOL_STORE} "
          f"! tensor_sink in each child; bf16, {POOL_SHAPE} uint8), "
          f"{POOL_FRAMES} frames: 2 workers with the shm lane max |diff| / "
          f"max|logit| {errs['shm']:.3e} ({bits['shm']}/{POOL_FRAMES} bit "
          f"for bit B direct's), 1 worker on the pipe {errs['pipe']:.3e} "
          f"({bits['pipe']}/{POOL_FRAMES}); the two lanes bit for bit "
          f"{lanes_equal}/{POOL_FRAMES}; shm records {p2['shm_frames']}, "
          f"children on {sorted(set(devs))} [{card}]")
    check(max(errs.values()) <= POOL_REL and p2["shm_frames"] >= 2 *
          POOL_FRAMES and res["logits"]["pipe_shm_frames"] == 0,
          f"pool logits: {res['logits']}")
    # the kernel ran in the children: each child's wrapper counts its
    # launches, and its trace deltas carry them beside the norm filter's
    # spans (the heartbeat lane ships every 0.1 s)
    def seen():
        return {k: {"launches": pool_launches(t), "spans": pool_spans(t)}
                for k, t in (("2 workers", tr2), ("1 worker", tr1))}

    deadline = time.monotonic() + 30
    while min(min(c.values()) for c in seen().values()) < POOL_FRAMES \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    counts = seen()
    res["launches_logits"] = counts
    print(f"phase 45: normalize_u8 in the children, launches as their "
          f"wrappers counted them / the norm filter's spans, both from the "
          f"shipped trace deltas: " + ", ".join(
              f"{k} {c['launches']} / {c['spans']}"
              for k, c in counts.items())
          + f" for {POOL_FRAMES} frames each")
    check(all(c == {"launches": POOL_FRAMES, "spans": POOL_FRAMES}
              for c in counts.values()), f"pool launches: {counts}")

    # -- SIGKILL of one worker mid-flood ---------------------------------
    old_pids = pqs2.pool.pids()
    cli = PoolClient(pqs2.port)
    killed = []
    try:
        for i in range(POOL_KILL_FRAMES):
            cli.send(100 + i, frames[i % POOL_FRAMES])
            if i == POOL_KILL_FRAMES // 3:
                deadline = time.monotonic() + 60
                while not pqs2.pool.stats()["workers"][0]["inflight"]:
                    check(time.monotonic() < deadline, "kill: worker 0 idle")
                    time.sleep(0.001)
                killed.append(pqs2.pool.kill_worker(0))
        cli.wait([100 + i for i in range(POOL_KILL_FRAMES)])
    finally:
        cli.close()
    dup = [p for p, n in cli.seen.items() if n != 1]
    bad = [p for p, v in cli.results.items()
           if rel_to(v, ref1[(p - 100) % POOL_FRAMES]) > POOL_REL]
    check(pqs2.pool.wait_ready(240), "kill: no replacement worker")
    c = pqs2.admission_counters()
    st = pqs2.stats()
    new_pid = pqs2.pool.pids()[0]
    res["kill"] = {"killed": killed[0], "replaced_by": new_pid,
                   "answered": len(cli.results), "busy": dict(cli.busy),
                   "duplicates": dup, "wrong": bad,
                   "reoffered": st["pool"]["reoffered"],
                   "restarts": st["pool"]["restarts"],
                   "conserved": pool_conserved(c),
                   "device": st["workers"][0]["device"]}
    print(f"phase 45: SIGKILL of worker 0 (pid {killed[0]}) with frames in "
          f"flight, {POOL_KILL_FRAMES} frames: {len(cli.results)} answered, "
          f"BUSY {dict(cli.busy)}, duplicates {dup}, off B direct {bad}, "
          f"re-offered {st['pool']['reoffered']}, restarts "
          f"{st['pool']['restarts']}; the replacement (pid {new_pid}) came "
          f"up on {st['workers'][0]['device']}; offered == admitted + "
          f"rejected and admitted == replied + shed + depth + inflight: "
          f"{pool_conserved(c)}")
    check(killed[0] == old_pids[0] and len(cli.results) == POOL_KILL_FRAMES
          and not cli.busy and not dup and not bad
          and st["pool"]["restarts"] == 1 and pool_conserved(c)
          and new_pid != killed[0]
          and st["workers"][0]["device"] == POOL_DEVICE,
          f"kill: {res['kill']}")

    # -- two-phase swap to the preloaded version 2 under traffic ---------
    cli = PoolClient(pqs2.port)
    epoch0 = pqs2.pool.epoch
    try:
        half = POOL_SWAP_FRAMES // 2
        for i in range(half):
            cli.send(200 + i, frames[i % POOL_FRAMES])
        rep = pqs2.swap(POOL_STORE, 2, timeout_s=180.0)
        for i in range(half, POOL_SWAP_FRAMES):
            cli.send(200 + i, frames[i % POOL_FRAMES])
        cli.wait([200 + i for i in range(POOL_SWAP_FRAMES)])
    finally:
        cli.close()
    version, torn = {}, []
    for p, v in cli.results.items():
        k = (p - 200) % POOL_FRAMES
        e1, e2 = rel_to(v, ref1[k]), rel_to(v, ref2[k])
        version[p] = 1 if e1 <= POOL_REL else 2 if e2 <= POOL_REL else 0
        if not version[p]:
            torn.append((p, e1, e2))
    after = [version.get(200 + i) for i in range(half, POOL_SWAP_FRAMES)]
    res["swap"] = {"ok": rep["ok"], "epoch": [epoch0, pqs2.pool.epoch],
                   "workers": {str(w): r for w, r in rep["workers"].items()},
                   "v1": sum(v == 1 for v in version.values()),
                   "v2": sum(v == 2 for v in version.values()),
                   "torn": torn, "after_all_v2": all(v == 2 for v in after)}
    print(f"phase 45: two-phase swap store://{POOL_STORE} → @2 (preloaded) "
          f"with {half} frames in flight, {half} more after: ok "
          f"{rep['ok']}, epoch {epoch0} → {pqs2.pool.epoch}, commit on "
          f"{sum(r.get('commit_ok', False) for r in rep['workers'].values())}"
          f"/2 workers; {res['swap']['v1']} frames v1, {res['swap']['v2']} "
          f"v2, torn {torn}, every frame sent after the flip v2 "
          f"{res['swap']['after_all_v2']}")
    check(rep["ok"] and pqs2.pool.epoch == epoch0 + 1
          and len(rep["workers"]) == 2 and not torn
          and res["swap"]["after_all_v2"] and not cli.busy,
          f"swap: {res['swap']}")

    # -- the autotuner on the live admission queue: dry run, then applied
    tuned = {}
    for dry in (True, False):
        applied_ok = []

        def on_apply(rec, pqs=pqs2, ok=applied_ok):
            ok.append(pool_conserved(pqs.admission_counters()))

        def victims(vs, pqs=pqs2):
            for v in vs:
                pqs.qs.send_busy(v.meta.get("client_id"), v.pts,
                                 "bound_shrink")

        mp0 = pqs2.admission_counters()["max_pending"]
        tuner = AutoTuner(SLOSpec(p99_budget_ms=40.0), admission=pqs2.qs.frames,
                          tracer=tr2, dry_run=dry, interval_s=0.02,
                          cooldown_s=0.05, on_apply=on_apply,
                          on_victims=victims).start()
        cli = PoolClient(pqs2.port)
        base = 400 if dry else 500
        try:
            for i in range(POOL_TUNE_FRAMES):
                cli.send(base + i, frames[i % POOL_FRAMES])
            cli.wait([base + i for i in range(POOL_TUNE_FRAMES)])
        finally:
            cli.close()
            tuner.stop()
        st = tuner.stats()
        audit = tuner.audit()
        mp1 = pqs2.admission_counters()["max_pending"]
        tuned["dry_run" if dry else "applied"] = {
            "ticks": st["ticks"], "decisions": st["decisions"],
            "applied_total": st["applied_total"],
            "dry_run_total": st["dry_run_total"],
            "audit_applied": sum(a["outcome"] == "applied" for a in audit),
            "audit_dropped": st["audit_dropped"],
            "max_pending": [mp0, mp1],
            "conserved_after_each_apply": all(applied_ok),
            "answered": len(cli.results), "busy": len(cli.busy),
            "conserved": pool_conserved(pqs2.admission_counters())}
        if dry:
            check(st["applied_total"] == 0 and st["dry_run_total"] >= 1
                  and mp1 == mp0, f"autotune dry run: {tuned}")
    a = tuned["applied"]
    res["autotune"] = tuned
    print(f"phase 45: autotuner on the live admission queue (p99 budget "
          f"40 ms), {POOL_TUNE_FRAMES} frames each: dry run "
          f"{tuned['dry_run']['dry_run_total']} decisions, max_pending "
          f"{tuned['dry_run']['max_pending']}; applied "
          f"{a['applied_total']} (all {a['audit_applied']} in the audit "
          f"ring), max_pending {a['max_pending']}, invariants after each "
          f"{a['conserved_after_each_apply']}; answered {a['answered']} + "
          f"BUSY {a['busy']}")
    check(a["applied_total"] >= 1 and a["audit_applied"] ==
          a["applied_total"] and a["audit_dropped"] == 0
          and a["conserved_after_each_apply"] and a["conserved"]
          and a["answered"] + a["busy"] == POOL_TUNE_FRAMES,
          f"autotune: {tuned}")
    pqs2.qs.frames.configure(max_pending=256)

    # -- a /metrics scrape against pqs.stats() ---------------------------
    def collect():
        s = pqs2.stats()
        return metrics_snapshot(tracer=tr2, admission=s.pop("admission"),
                                pool=s, devprof=None)

    msrv = MetricsServer(collect)
    try:
        time.sleep(0.3)                  # the children's last deltas
        fams = parse_prometheus(scrape(
            f"http://127.0.0.1:{msrv.port}/metrics"))
        s = pqs2.stats()
    finally:
        msrv.close()

    def val(fam, key=None):
        return fams[fam]["samples"][key or fam]

    adm, pool = s["admission"], s["pool"]
    pairs = {"offered": (val("nns_admission_offered_total"),
                         adm["offered"]),
             "admitted": (val("nns_admission_admitted_total"),
                          adm["admitted"]),
             "replied": (val("nns_admission_replied_total"),
                         adm["replied"]),
             "rejected": (sum(fams["nns_admission_rejected_total"]
                              ["samples"].values()),
                          sum(adm["rejected"].values())),
             "restarts": (val("nns_pool_restarts_total"), pool["restarts"]),
             "reoffered": (val("nns_pool_reoffered_total"),
                           pool["reoffered"]),
             "shm_frames": (val("nns_shm_frames_total"),
                            pool["shm_frames"]),
             "epoch": (val("nns_pool_epoch"), pool["epoch"]),
             "ready": (val("nns_pool_ready"), pool["ready"])}
    res["metrics"] = {k: list(v) for k, v in pairs.items()}
    print(f"phase 45: /metrics scrape against pqs.stats(): "
          + ", ".join(f"{k} {int(a)}={b}" for k, (a, b) in pairs.items()))
    check(all(a == b for a, b in pairs.values()), f"metrics: {pairs}")


def pool_drain(ctx, res, strict=True) -> None:
    """close() both pools: no orphan pid, no shm segment left."""
    from nnstreamer_tpu_torch.serving.pool import proc_alive

    out = {}
    for key in ("pqs2", "pqs1"):
        pqs = ctx.pop(key, None)
        if pqs is None:
            continue
        pids = pqs.pool.all_pids_ever()
        replied = pqs.admission_counters()["replied"]
        reoffered = pqs.stats()["pool"]["reoffered"]
        pqs.close()
        out[key] = {"pids": pids, "replied": replied, "reoffered": reoffered,
                    "alive": [p for p in pids if proc_alive(p)],
                    "segments": pqs.pool.shm_segments()}
    res["drain"] = out
    print(f"phase 45: drain: " + "; ".join(
        f"{k}: {len(v['pids'])} pids ever, alive {v['alive']}, shm "
        f"segments {v['segments']}" for k, v in out.items()))
    if strict:
        check(all(not v["alive"] and not v["segments"]
                  for v in out.values()), f"drain: {out}")


def pool_timings(nt, torch, card, record, ctx) -> None:
    """Phase 46 (no claim): closed-loop p50 of pooled B with 1 and 2
    workers beside B direct, frame by frame in turns; bursts from 1, 2
    and 4 clients against the 2-worker pool in turns 1 2 4 4 2 1; each
    child's start; the shm lane against the pipe per hop."""
    from nnstreamer_tpu_torch.edge.wire import encode_buffer
    from nnstreamer_tpu_torch.serving.shm import hop_latency_ab
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    res = {}
    record["pool_timings"] = res
    pqs2, pqs1 = ctx["pqs2"], ctx["pqs1"]
    frame = u8_frames(POOL_SHAPE, 1, 461)[0]
    tail = "tensor_sink name=out"
    lat = closed_loop_arms(
        nt, {"pool1": f"{APPSRC} ! tensor_query_client port={pqs1.port} "
                      f"timeout={Q_TIMEOUT} ! {tail}",
             "pool2": f"{APPSRC} ! tensor_query_client port={pqs2.port} "
                      f"timeout={Q_TIMEOUT} ! {tail}",
             "B": f"{APPSRC} ! {NORM_B} ! tensor_filter "
                  f"model=store://{POOL_STORE}@2 ! {tail}"},
        frame, POOL_LAT, POOL_WARMUP)
    res["closed"] = {k: {"p50_ms": float(np.percentile(v, 50)),
                         "p99_ms": float(np.percentile(v, 99))}
                     for k, v in lat.items()}
    print(f"phase 46: closed loop (frame by frame in turns, {POOL_LAT} "
          f"frames an arm): " + ", ".join(
              f"{k} p50 {v['p50_ms']:.3f} ms p99 {v['p99_ms']:.3f} ms"
              for k, v in res["closed"].items()) + f" [{card}]")
    # a pool answers a client's frames in the order its workers finish
    # them: the bursts use raw clients (a pipelined tensor_query_client
    # holds replies to its send order), connected before the clock starts
    bursts = {n: [] for n in (1, 2, 4)}
    for n in (1, 2, 4, 4, 2, 1):
        clients = [PoolClient(pqs2.port) for _ in range(n)]
        try:
            t0 = time.perf_counter()
            for i in range(POOL_BURST):
                for cli in clients:
                    cli.send(i, frame)
            for cli in clients:
                cli.wait(range(POOL_BURST))
            wall = time.perf_counter() - t0
        finally:
            for cli in clients:
                cli.close()
        check(all(len(c.results) == POOL_BURST for c in clients),
              f"burst of {n} clients: {[len(c.busy) for c in clients]} BUSY")
        bursts[n].append(n * POOL_BURST / wall)
    res["bursts_fps"] = bursts
    print(f"phase 46: bursts of {POOL_BURST} frames a client (all sent at "
          f"once) against the 2-worker pool, in turns 1 2 4 4 2 1: " + ", ".join(
              f"{n} client(s) " + " / ".join(f"{f:.1f}" for f in v)
              + " frames/s" for n, v in bursts.items()) + f" [{card}]")
    starts = {"pool2": child_starts(ctx["tr2"], pqs2.pool.name),
              "pool1": child_starts(ctx["tr1"], pqs1.pool.name)}
    res["child_start_s"] = starts
    print(f"phase 46: each child's start (spawn to ready: torch, the CUDA "
          f"context, the pipeline and its model): " + ", ".join(
              f"{k} " + " / ".join(f"{s:.2f}" for s in v) + " s"
              for k, v in starts.items()) + " (the 2-worker pool's third is "
          f"the replacement after the SIGKILL)")
    nbytes = len(encode_buffer(TensorBuffer.of(frame, pts=0)))
    hop = hop_latency_ab(payload_bytes=nbytes, n=200)
    res["hop"] = hop
    print(f"phase 46: one hop parent → child → parent of a {nbytes}-byte "
          f"frame, 200 round trips a lane: pipe p50 {hop['pipe_p50_ms']:.3f}"
          f" ms p99 {hop['pipe_p99_ms']:.3f} ms, shm p50 "
          f"{hop['shm_p50_ms']:.3f} ms p99 {hop['shm_p99_ms']:.3f} ms "
          f"({hop['hop_speedup']:.2f}x) [{card}]")


def pool_launch_tally(ctx, res) -> int:
    """After the drain, when every child that stopped on its own has
    shipped its last deltas: normalize_u8's launches counted in each
    pool's children against the norm filter's spans and the pool's
    replies. → the launches of both pools."""
    out = {}
    for key in ("2", "1"):
        drained = res["drain"][f"pqs{key}"]
        out[key] = {"launches": pool_launches(ctx[f"tr{key}"]),
                    "spans": pool_spans(ctx[f"tr{key}"]),
                    "replied": drained["replied"],
                    "reoffered": drained["reoffered"]}
    res["launches_in_children"] = out
    print(f"phase 46: normalize_u8 in the children over phases 45-46, "
          f"launches as their wrappers counted them / norm spans / replies "
          f"(re-offered): " + ", ".join(
              f"{k}-worker pool {c['launches']} / {c['spans']} / "
              f"{c['replied']} ({c['reoffered']})" for k, c in out.items())
          + " (the SIGKILLed child's launches since its last ship are "
          f"lost with it)")
    one, two = out["1"], out["2"]
    # the 1-worker pool lost no child: every count closes; a frame the
    # killed child had launched for is re-offered and launched again
    check(one["launches"] == one["spans"] == one["replied"]
          and two["spans"] <= two["launches"]
          <= two["replied"] + two["reoffered"],
          f"launches in the children: {out}")
    return one["launches"] + two["launches"]


def pool_phases(nt, torch, card, record, phases) -> dict:
    """Phases 45-46. → normalize_u8's launches in the children."""
    ctx = {}
    try:
        pool_correctness(nt, torch, card, record, ctx)
        phases.done("45 (the worker pool, the metrics plane, the "
                    "autotuner: correctness)")
        pool_timings(nt, torch, card, record, ctx)
    except BaseException:
        pool_drain(ctx, record.setdefault("pool_correctness", {}),
                   strict=False)
        raise
    # drain last: the timings run on the same two pools
    pool_drain(ctx, record["pool_correctness"])
    launched = pool_launch_tally(ctx, record["pool_correctness"])
    phases.done("46 (the worker pool: timings; drain)")
    return {"pool": launched}


# -- phases 47-49: placement, device segments, the device profiler ------------

#: logical devices of phases 47-48 (all on cuda:0 with one card)
PLC_DEVICES = 4
PLC_FRAMES, PLC_LAT, PLC_WARMUP = 32, 30, 4
SEG_BURST, SEG_PROF_FRAMES = 64, 32
#: SEG's logits against B's, relative to max |logit| (the bound held;
#: the cut's two typecasts are exact, so SEG is expected bit for bit)
SEG_REL = 1e-3
FLIGHT_COOLDOWN_S = 1.5
#: note_dispatch + note_launched pairs timed on the host
HOOK_ITERS = 10000
#: config 1's model and frame (a CPU rehearsal swaps in a small one)
PLC_ZOO, PLC_SHAPE = "zoo://mobilenet_v2", (1, 224, 224, 3)


def plc_in() -> str:
    h, w, c = PLC_SHAPE[1:]
    return f"appsrc name=src dims={c}:{w}:{h}:1 types=uint8"


def plc_desc(extra: str = "", model: str = "") -> str:
    """B with `extra` on its model filter: appsrc ! normalize_u8 ! model
    ! tensor_sink (the logits)."""
    model = model or f"tensor_filter name=model model={PLC_ZOO}"
    return f"{plc_in()} ! {NORM_B} ! {model} {extra} ! tensor_sink name=out"


def counted_run(nt, desc, frames, **runner_kw):
    """`desc` over `frames`, normalize_u8's count set to 0 just before and
    read just after → (logits, launches, model filter, runner)."""
    from nnstreamer_tpu_torch.backends import kernels

    kernels.normalize_u8.launches = 0
    out, runner, pipe = run_sinks(nt, desc, frames, **runner_kw)
    return (logits_of(out["out"]), kernels.normalize_u8.launches,
            pipe.get("model") if "model" in pipe.elements else None, runner)


def seed1(ref: str) -> str:
    """The zoo reference with seed 1 (a second version's weights)."""
    return ref + ("&" if "?" in ref else "?") + "seed=1"


def fence_run(nt, desc, frames, fence):
    """`desc` over `frames`, `fence(filter)` called once half of them are
    back → (logits by pts, replies, the filter's stats)."""
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    pipe = nt.parse_launch(desc)
    runner = nt.PipelineRunner(pipe).start()
    src, sink, f = pipe.get("src"), pipe.get("out"), pipe.get("model")
    half = len(frames) // 2
    try:
        for i, fr in enumerate(frames):
            if i == half:
                deadline = time.monotonic() + 120
                while len(sink.results) < half:
                    check(time.monotonic() < deadline, "fence run stalled")
                    time.sleep(0.001)
                fence(f)
            src.push(TensorBuffer.of(fr, pts=i))
        src.end()
        runner.wait(600)
    finally:
        runner.stop()
    res = sink.results
    return ({int(b.pts): np.asarray(b.tensors[0]) for b in res}, len(res),
            f.extra_stats())


def swap_run(nt, torch, frames, ref1, ref2, card, res) -> None:
    """R2 on a store:// model swapped 1 → 2 under traffic: no torn frame
    (each frame's logits one version's bits), versions never go back,
    both replicas in one epoch."""
    from nnstreamer_tpu_torch.serving.store import get_store
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    store = get_store()
    store.register("plc_mbv2", PLC_ZOO)
    store.register("plc_mbv2", seed1(PLC_ZOO))
    pipe = nt.parse_launch(plc_desc(
        "devices=2", "tensor_filter name=model model=store://plc_mbv2"))
    runner = nt.PipelineRunner(pipe).start()
    src, sink, f = pipe.get("src"), pipe.get("out"), pipe.get("model")
    n = len(frames)
    try:
        for i in range(n // 2):
            src.push(TensorBuffer.of(frames[i], pts=i))
        deadline = time.monotonic() + 120
        while len(sink.results) < n // 4:
            check(time.monotonic() < deadline, "swap run stalled")
            time.sleep(0.001)
        rep = store.update("plc_mbv2", 2)        # frames in flight
        for i in range(n // 2, n):
            src.push(TensorBuffer.of(frames[i], pts=i))
        src.end()
        runner.wait(600)
        epochs = f.replicas.adopted_epochs()
    finally:
        runner.stop()
    got = {int(b.pts): np.asarray(b.tensors[0]) for b in sink.results}
    vers = [1 if got[i].tobytes() == ref1[i].tobytes() else
            2 if got[i].tobytes() == ref2[i].tobytes() else 0
            for i in range(n)]
    torn = vers.count(0)
    monotone = all(a <= b for a, b in zip(vers, vers[1:]))
    res["R2_swap"] = {"versions": vers, "torn": torn, "epochs": epochs,
                      "prewarmed_buckets": rep["prewarmed_buckets"]}
    print(f"phase 47: R2 swap 1 -> 2 under traffic ({n} frames, the flip "
          f"with frames in flight): versions by frame {vers}; torn frames "
          f"{torn}; adopted epochs {epochs}; prewarmed buckets "
          f"{rep['prewarmed_buckets']} [{card}]")
    check(torn == 0 and monotone and vers[-1] == 2
          and len(set(epochs)) == 1 and epochs[0] == rep["epoch"],
          f"R2 swap: {res['R2_swap']}")


def placement_phase(nt, torch, card, record) -> int:
    """Phase 47: R2, SH2, SH2x2 on PLC_DEVICES logical devices. →
    normalize_u8's launches on the new paths."""
    frames = u8_frames(PLC_SHAPE, PLC_FRAMES, 471)
    res, launched = {}, 0
    ref, _, _, _ = counted_run(nt, plc_desc(), frames, compiled_loop=False)
    arms = {"R2": "devices=2", "SH1": "shards=1", "SH2": "shards=2",
            "SH2x2": "devices=4 shards=2"}
    mem = {}
    for arm, extra in arms.items():
        logits, n, f, runner = counted_run(nt, plc_desc(extra), frames)
        st = runner.stats()["model"]
        same = rows_equal(logits, ref)
        launched += n
        res[arm] = {"bit_for_bit_B": sum(same), "launches": n,
                    "replica_invokes": st.get("replica_invokes"),
                    "replied": len(logits)}
        res[arm]["logits"] = logits
        print(f"phase 47: {arm} (B's model filter with {extra}, "
              f"virtual_devices={PLC_DEVICES}), {PLC_FRAMES} frames: logits "
              f"bit for bit B's {sum(same)}/{PLC_FRAMES}; replica invokes "
              f"{st.get('replica_invokes')} = replied {len(logits)}; "
              f"normalize_u8 launched {n} times [{card}]")
        check(n == PLC_FRAMES and st.get("replica_invokes") == PLC_FRAMES
              == len(logits), f"{arm}: {res[arm]}")
    check(all(rows_equal(res["R2"]["logits"], ref)),
          "R2's logits differ from B's")
    check(all(rows_equal(res["SH2"]["logits"], res["SH1"]["logits"])),
          "SH2's logits differ from SH1's")
    for arm in arms:
        res[arm].pop("logits")
    # memory_allocated by arm: each opened alone, the delta over its start;
    # SH2's param bytes on each logical device of its group
    for arm, extra in (("B", ""), ("R2", "devices=2"), ("SH2", "shards=2")):
        gc.collect()
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        pipe = nt.parse_launch(plc_desc(extra))
        runner = nt.PipelineRunner(pipe).start()
        torch.cuda.synchronize()
        mem[arm] = torch.cuda.memory_allocated() - m0
        if arm == "SH2":
            res["SH2"]["shard_bytes"] = [
                r.backend.shard_bytes()
                for r in pipe.get("model").replicas._replicas]
        pipe.get("src").end()
        runner.wait(60)
        runner.stop()
    res["memory_allocated_opened"] = mem
    print(f"phase 47: memory_allocated when opened (the filter's backends "
          f"and params, one card): B {mem['B']} B, R2 {mem['R2']} B (head "
          f"+ 2 replicas), SH2 {mem['SH2']} B (head + the group's slices); "
          f"SH2's params per logical device {res['SH2']['shard_bytes']} "
          f"[{card}]")

    # fences: every frame answered once, Σ replica invokes = replied
    for arm, extra, fence in (
            ("R2 fence", "devices=2",
             lambda f: f.replicas.fence(0, "drill")),
            ("SH2x2 fence", "devices=4 shards=2",
             lambda f: f.replicas.fence_device(1, "drill"))):
        got, replied, st = fence_run(nt, plc_desc(extra), frames, fence)
        same = all(got[i].tobytes() == ref[i].tobytes()
                   for i in range(PLC_FRAMES))
        res[arm] = {"replied": replied, "bit_for_bit_B": same,
                    "replica_invokes": st["replica_invokes"],
                    "live": st["replica_live"],
                    "fences": st["replica_fences"],
                    "leases": st.get("leases")}
        print(f"phase 47: {arm} mid-stream: {replied} of {PLC_FRAMES} "
              f"frames answered, each once, bit for bit B's {same}; replica "
              f"invokes {st['replica_invokes']}, live {st['replica_live']}, "
              f"fences {st['replica_fences']}, leases {st.get('leases')}")
        check(replied == PLC_FRAMES == st["replica_invokes"]
              and sorted(got) == list(range(PLC_FRAMES)) and same
              and st["replica_fences"] == 1, f"{arm}: {res[arm]}")
        if "SH" in arm:
            check(st["leases"]["fenced"] == 2, f"{arm}: the group's two "
                  f"devices are not both fenced: {st['leases']}")
    ref2, _, _, _ = counted_run(
        nt, plc_desc("", f"tensor_filter name=model model={seed1(PLC_ZOO)}"),
        frames, compiled_loop=False)
    swap_run(nt, torch, frames, ref, ref2, card, res)

    lat = closed_loop_arms(
        nt, {"B": plc_desc(), "R2": plc_desc("devices=2"),
             "SH2": plc_desc("shards=2")}, frames[0], PLC_LAT, PLC_WARMUP)
    res["closed_loop"] = {a: {"p50_ms": float(np.percentile(v, 50)),
                              "p99_ms": float(np.percentile(v, 99))}
                          for a, v in lat.items()}
    print(f"phase 47: closed loop frame by frame in turns ({PLC_LAT} frames "
          f"an arm): " + ", ".join(
              f"{a} p50 {r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms"
              for a, r in res["closed_loop"].items()) + f" [{card}]")
    record["placement"] = res
    return launched


def seg_register(torch) -> None:
    """SEG's two store models from one zoo MobileNetV2 (1.0, bf16, seed 0)
    module and its parameters: the backbone to the pooled features (f32),
    the classifier from them; together the zoo model's forward."""
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.models import layers as L
    from nnstreamer_tpu_torch.models.zoo import build_model
    from nnstreamer_tpu_torch.serving.store import get_store

    m = build_model(PLC_ZOO[len("zoo://"):]).params

    def backbone(mod, x):
        h = x.to(mod.dtype).permute(0, 3, 1, 2)
        h = mod.stem(h)
        for block in mod.blocks:
            h = block(h)
        return L.global_avg_pool(mod.head(h)).to(torch.float32)

    def classifier(dense, h):
        return dense(h).to(torch.float32)

    store = get_store()
    store.register("seg_bb", ModelBundle(fn=backbone, params=m,
                                         name="mbv2_backbone"))
    store.register("seg_cl", ModelBundle(fn=classifier, params=m.classifier,
                                         name="mbv2_classifier"))


SEG_MID = ("tensor_filter name=bb model=store://seg_bb ! tensor_transform "
           "mode=typecast option=bfloat16 ! tensor_filter name=cl "
           "model=store://seg_cl")


def seg_desc() -> str:
    return f"{plc_in()} ! {NORM_B} ! {SEG_MID} ! tensor_sink name=out"


def seg_windows(nt, torch, frames, card, res) -> None:
    """SEG with windows on: a warmed burst under the profiler, its
    cudaGraphLaunch calls against the head's replays (one window, one
    replay) and its outputs against the per-frame run's."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    pipe = nt.parse_launch(seg_desc())
    runner = nt.PipelineRunner(pipe).start()
    src, sink = pipe.get("src"), pipe.get("out")
    be = pipe.get("bb").backend
    pts = 0
    try:
        for k in (1, 2, 4, 8, 3, len(frames)):        # capture every K
            for j in range(k):
                src.push(TensorBuffer.of(frames[j % len(frames)], pts=pts))
                pts += 1
            deadline = time.monotonic() + 120
            while len(sink.results) < pts:
                check(time.monotonic() < deadline, "SEG warm-up stalled")
                time.sleep(0.001)
        sink.results.clear()
        torch.cuda.synchronize()
        w0, c0 = be.window_invokes, be.window_compile_count
        f0 = be.window_frames
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_capture(torch)
            for j, fr in enumerate(frames):
                src.push(TensorBuffer.of(fr, pts=pts + j))
            deadline = time.monotonic() + 120
            while len(sink.results) < len(frames):
                check(time.monotonic() < deadline, "SEG burst stalled")
                time.sleep(0.001)
            torch.cuda.synchronize()
            close_capture(torch)
        windows = be.window_invokes - w0
        captured = be.window_compile_count - c0
        in_windows = be.window_frames - f0
        src.end()
        runner.wait(60)
    finally:
        runner.stop()
    graphs = sum(a.count for a in prof.key_averages()
                 if a.key == "cudaGraphLaunch")
    kernel_launches = sum(a.count for a in prof.key_averages()
                          if a.key == "cudaLaunchKernel")
    st = runner.stats()["bb"]
    res["windows"] = {"frames": len(frames), "windows": windows,
                      "frames_in_windows": in_windows,
                      "captured": captured, "cudaGraphLaunch": graphs,
                      "cudaLaunchKernel": kernel_launches,
                      "compiled_steps": st.get("compiled_steps"),
                      "out": logits_of(sink.results)}
    print(f"phase 48: SEG windows on, {len(frames)} frames pushed at once "
          f"(graphs warmed first): {windows} windows of the head holding "
          f"{in_windows} frames (the rest per frame while the loop arms), "
          f"{captured} captured in the burst, {graphs} cudaGraphLaunch and "
          f"{kernel_launches} cudaLaunchKernel calls in its profile "
          f"(normalize_u8 and the per-frame frames launch outside a graph) "
          f"[{card}]")
    check(windows > 0 and graphs == windows - captured,
          f"SEG: one window, one replay: {res['windows']}")


def segment_phase(nt, torch, card, record) -> int:
    """Phase 48: SEG composed, windowed, planned on two logical devices,
    timed beside B. → normalize_u8's launches on SEG's runs."""
    from nnstreamer_tpu_torch.serving.placement import (
        apply_plan, plan_from_tracer)
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    seg_register(torch)
    frames = u8_frames(PLC_SHAPE, PLC_FRAMES, 481)
    res = {}
    b, _, _, _ = counted_run(nt, plc_desc(), frames, compiled_loop=False)
    on, n_on, _, r_on = counted_run(nt, seg_desc(), frames,
                                    compiled_loop=False)
    off, n_off, _, r_off = counted_run(nt, seg_desc(), frames,
                                       compiled_loop=False,
                                       device_segments=False, trace=True)
    segs = r_on.device_segments()
    rel = float(np.abs(on - b).max() / np.abs(b).max())
    same = rows_equal(on, off)
    res.update(segments=segs, bit_for_bit_off=sum(same), rel_to_B=rel,
               bit_for_bit_B=sum(rows_equal(on, b)), launches=n_on)
    print(f"phase 48: SEG (B's model cut at the pooled features: "
          f"store://seg_bb ! typecast bfloat16 ! store://seg_cl, one zoo "
          f"module's params), {PLC_FRAMES} frames: segments {segs}; logits "
          f"bit for bit device_segments=False's {sum(same)}/{PLC_FRAMES}, "
          f"B's {res['bit_for_bit_B']}/{PLC_FRAMES}, max |SEG - B| / max "
          f"|B| {rel:.3e}; normalize_u8 launched {n_on} (on) and {n_off} "
          f"(off) times [{card}]")
    check(segs == [{"head": "bb", "segment": "bb+cl", "size": 2,
                    "composed": True}] and all(same) and rel <= SEG_REL
          and n_on == n_off == PLC_FRAMES, f"SEG: {res}")

    seg_windows(nt, torch, frames, card, res)
    check(all(rows_equal(res["windows"].pop("out"), on)),
          "SEG's windowed logits differ from its per-frame logits")

    # a 2-stage plan from the traced segments-off run, on ordinals 0 and 1
    plan = plan_from_tracer(r_off.tracer, ["bb", "cl"], 2)
    pipe = nt.parse_launch(seg_desc())
    pinned = apply_plan(pipe, plan)
    from nnstreamer_tpu_torch.backends import kernels

    kernels.normalize_u8.launches = 0
    runner = nt.PipelineRunner(pipe, compiled_loop=False).start()
    try:
        for i, fr in enumerate(frames):
            pipe.get("src").push(TensorBuffer.of(fr, pts=i))
        pipe.get("src").end()
        runner.wait(600)
    finally:
        runner.stop()
    n_plan = kernels.normalize_u8.launches
    planned = logits_of(pipe.get("out").results)
    st = runner.stats()
    ords = [pipe.get(g[0]).backend.device_ordinal for g in plan.stages]
    res["plan"] = {"report": plan.report(), "pinned": pinned,
                   "ordinals": ords,
                   "bit_for_bit_off": sum(rows_equal(planned, off)),
                   "staging_transfers": {
                       g[0]: st[g[0]]["backend_staging_transfers"]
                       for g in plan.stages},
                   "segments": runner.device_segments()}
    print(f"phase 48: plan_from_tracer on the traced segments-off run: "
          f"stages {plan.stages} on ordinals {ords} (planned "
          f"{plan.devices}), stage seconds "
          + ", ".join(f"{t * 1e3:.3f} ms" for t in plan.stage_times_s)
          + f", bubble {plan.bubble_fraction:.3f}; applied: logits bit for "
          f"bit the segments-off run's {res['plan']['bit_for_bit_off']}/"
          f"{PLC_FRAMES}, staging transfers {res['plan']['staging_transfers']}"
          f" (the cut's handoff, one a frame) [{card}]")
    check(len(plan.stages) == 2 and ords == [0, 1]
          and res["plan"]["bit_for_bit_off"] == PLC_FRAMES
          and st["cl"]["backend_staging_transfers"] == PLC_FRAMES
          and n_plan == PLC_FRAMES and not runner.device_segments(),
          f"SEG plan: {res['plan']}")

    # per-frame and windowed frames/s beside B, in turns
    descs = {"B": plc_desc(), "SEG": seg_desc()}
    frame = frames[0]
    for loop in ("off", "on"):
        kw = {} if loop == "on" else {"compiled_loop": False}
        arms = burst_arms(nt, torch, descs, frame, SEG_BURST, 1,
                          prof_frames=SEG_PROF_FRAMES,
                          runner_kw={a: kw for a in descs})
        for arm, a in arms.items():
            fps = float(np.median(a["fps"]))
            res.setdefault("timings", {})[f"{arm} loop {loop}"] = {
                "fps": a["fps"], "p50_ms": float(np.percentile(a["lat"], 50)),
                "device_ms_per_frame": a["device_ms_per_frame"],
                "kernels_per_frame": a["kernels_per_frame"]}
            print(f"phase 48: {arm} loop {loop}, bursts of {SEG_BURST} in "
                  f"turns: " + " / ".join(f"{f:.1f}" for f in a["fps"])
                  + f" frames/s; latency under the burst p50 "
                  f"{np.percentile(a['lat'], 50):.3f} ms; "
                  f"{a['kernels_per_frame']:.1f} kernels and "
                  f"{a['device_ms_per_frame']:.3f} ms of kernel time a "
                  f"frame [{card}]")
    record["segments"] = res
    return n_on + n_off + n_plan


def mbv2_flops(model, size: int, batch: int = 1) -> int:
    """2 × the multiply-adds of MobileNetV2's convolutions and dense layer
    at `size`², from the module's weight shapes (a SAME conv of stride s
    maps H to ceil(H / s))."""
    flops, h = 0, size

    def conv(unit, h):
        cout, cin_g, kh, kw = unit.weight.shape
        ho = math.ceil(h / unit.stride)
        return 2 * batch * cout * cin_g * kh * kw * ho * ho, ho

    units = [model.stem] + [u for blk in model.blocks for u in
                            (blk.expand, blk.depthwise, blk.project)
                            if u is not None] + [model.head]
    for unit in units:
        f, h = conv(unit, h)
        flops += f
    cout, cin = model.classifier.weight.shape
    return flops + 2 * batch * cout * cin


def profiler_phase(nt, torch, card, record) -> int:
    """Phase 49: the device profiler on B, /metrics, the flight recorder
    on Q1, the profiler's cost. → normalize_u8's launches on B's
    profiled run."""
    import contextlib
    import io
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.__main__ import main as cli
    from nnstreamer_tpu_torch.models.zoo import build_model
    from nnstreamer_tpu_torch.runtime import devprof
    from nnstreamer_tpu_torch.runtime.flightrec import (
        FlightRecorder, list_bundles)
    from nnstreamer_tpu_torch.serving.autotune import AutoTuner, SLOSpec
    from nnstreamer_tpu_torch.serving.metrics import (
        MetricsServer, metrics_snapshot, parse_prometheus, render_prometheus,
        scrape)

    frames = u8_frames(PLC_SHAPE, PLC_FRAMES, 491)
    res = {}
    prof = devprof.get()
    prof.reset()
    prof.enable(True)
    try:
        _, launched, _, _ = counted_run(nt, plc_desc(), frames,
                                        compiled_loop=False)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(0)
        st = prof.stats()
        after = torch.cuda.memory_allocated(0)
        want = mbv2_flops(build_model(PLC_ZOO[len("zoo://"):]).params,
                          PLC_SHAPE[1])
        jit = next(r for r in st["jit"] if r["filter"] == "model")
        inv = next(r for r in st["invoke"] if r["filter"] == "model")
        hbm = next((r["bytes"] for r in st["hbm"]
                    if r["device"] == "cuda:0"
                    and r["kind"] == "bytes_in_use"), None)
        # the profiler's kernel time a frame: the card's kernel records of
        # a profiled per-frame run
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as tp:
            open_capture(torch)
            run_sinks(nt, plc_desc(), frames[:SEG_PROF_FRAMES],
                      compiled_loop=False)
            torch.cuda.synchronize()
            close_capture(torch)
        evs = kernel_events(tp)
        kern_ms = sum(e.time_range.elapsed_us() for e in evs) / 1e3 \
            / SEG_PROF_FRAMES
        model_ms = sum(e.time_range.elapsed_us() for e in evs
                       if "nns_normalize_kernel" not in e.name) / 1e3 \
            / SEG_PROF_FRAMES
        res["B"] = {"flops": jit["flops"], "analytic_flops": want,
                    "bytes_lower_bound": jit["bytes_accessed"],
                    "compile_s": jit["compile_s"],
                    "invoke_p50_ms": inv["p50_ms"],
                    "samples": inv["samples_total"],
                    "achieved_tflops": inv["achieved_tflops"],
                    "mfu": inv["mfu"], "roofline": jit["roofline"],
                    "peak_tflops": st["peak_tflops"],
                    "peak_hbm_gbps": st["peak_hbm_gbps"],
                    "kernel_ms_per_frame": kern_ms,
                    "model_kernel_ms_per_frame": model_ms,
                    "hbm_bytes_in_use": hbm,
                    "memory_allocated": (before, after)}
        print(f"phase 49: the device profiler on B (per frame, {PLC_FRAMES} "
              f"frames): the model bucket {jit['bucket']}: "
              f"{jit['flops']:.0f} FLOPs a frame by FlopCounterMode, the "
              f"analytic count of its convs and dense layer {want} "
              f"(ratio {jit['flops'] / want:.6f}); bytes (lower bound) "
              f"{jit['bytes_accessed']:.0f}; first run "
              f"{jit['compile_s'] * 1e3:.1f} ms; device ms an invoke "
              f"(CUDA events, p50 of {inv['samples_total']}) "
              f"{inv['p50_ms']:.4f} against the profiler's kernel time a "
              f"frame {kern_ms:.4f} ms ({model_ms:.4f} ms without "
              f"normalize_u8); achieved {inv['achieved_tflops']:.4f} TFLOP/s, "
              f"MFU {inv['achieved_tflops'] / st['peak_tflops']:.3e} (the "
              f"row's, rounded as JAX rounds it: {inv['mfu']}) of the "
              f"{st['peak_tflops']} TFLOP/s "
              f"spec-sheet peak ({st['device_kind']}), roofline "
              f"{jit['roofline']}; memory ledger bytes_in_use {hbm} "
              f"against torch.cuda.memory_allocated {before}..{after} "
              f"[{card}]")
        check(abs(jit["flops"] - want) <= 0.01 * want
              and inv["samples_total"] > 0 and hbm is not None
              and before <= hbm <= after
              and launched == PLC_FRAMES,
              f"profiler on B: {res['B']}")

        # /metrics carries the device families, the values of stats()
        srv = MetricsServer(lambda: metrics_snapshot(devprof=prof.stats()),
                            port=0)
        try:
            st = prof.stats()
            fams = parse_prometheus(scrape(
                f"http://127.0.0.1:{srv.port}/metrics"))
        finally:
            srv.close()
        flops_row = fams["nns_jit_flops"]["samples"]
        got = {k: v for k, v in flops_row.items() if 'filter="model"' in k}
        samples = {k: v for k, v in
                   fams["nns_invoke_samples_total"]["samples"].items()
                   if 'filter="model"' in k}
        inv = next(r for r in st["invoke"] if r["filter"] == "model")
        present = sorted(f for f in fams if f.startswith(
            ("nns_jit_", "nns_invoke_", "nns_device_hbm_")))
        res["metrics"] = {"families": present, "jit_flops": got,
                          "samples": samples}
        print(f"phase 49: /metrics: {len(present)} device families "
              f"{present}; the model's jit flops {got}, invoke samples "
              f"{samples} (stats(): {jit['flops']:.0f}, "
              f"{inv['samples_total']})")
        check(list(got.values()) == [jit["flops"]]
              and list(samples.values()) == [float(inv["samples_total"])]
              and {"nns_jit_flops", "nns_invoke_mfu",
                   "nns_device_hbm_bytes"} <= set(present),
              f"/metrics: {res['metrics']}")
    finally:
        prof.enable(False)

    # the flight recorder on Q1: a p99 budget it must breach
    flight_dir = tempfile.mkdtemp(prefix="chip_flight_")
    pipe, runner, port = q_server(nt, 4901, PLC_ZOO, trace=True)
    try:
        tuner = AutoTuner(SLOSpec(p99_budget_ms=0.001),
                          tracer=runner.tracer, dry_run=True)
        rec = FlightRecorder(flight_dir, cooldown_s=FLIGHT_COOLDOWN_S).attach(
            tracer=runner.tracer, autotune=tuner,
            prom=lambda: render_prometheus(metrics_snapshot(
                tracer=runner.tracer)))
        t_dump = None
        for rnd in range(3):
            if rnd == 2:     # the third round after the window closed
                time.sleep(max(0.0, FLIGHT_COOLDOWN_S
                               - (time.monotonic() - t_dump)) + 0.2)
            q_ask(nt, port, frames[:8])
            tuner.tick()
            if t_dump is None:
                t_dump = time.monotonic()
        fst = rec.stats()
    finally:
        runner.stop()
    bundles = list_bundles(flight_dir)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc_list = cli(["flight", flight_dir, "--json"])
    listed = json.loads(out.getvalue())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc_inspect = cli(["flight", flight_dir, "--inspect",
                          bundles[0]["name"]])
    inspected = json.loads(out.getvalue())
    res["flight"] = {"dumps": fst["dumps"], "suppressed": fst["suppressed"],
                     "bundles": [b["name"] for b in bundles],
                     "files": bundles[0]["files"], "rc": (rc_list,
                                                          rc_inspect)}
    print(f"phase 49: the flight recorder on Q1 (p99 budget 0.001 ms, "
          f"cooldown {FLIGHT_COOLDOWN_S} s, 3 rounds of 8 frames, the third "
          f"after the window): dumps {fst['dumps']}, suppressed "
          f"{fst['suppressed']}, bundles {res['flight']['bundles']} with "
          f"{bundles[0]['files']}; flight list rc {rc_list} "
          f"({len(listed)} rows), flight --inspect rc {rc_inspect} (cause "
          f"{inspected['cause']['kind']})")
    check(fst["dumps"] == {"slo_breach": 2}
          and fst["suppressed"] == {"slo_breach": 1} and len(bundles) == 2
          and rc_list == 0 and len(listed) == 2 and rc_inspect == 0
          and inspected["cause"]["kind"] == "slo_breach"
          and "trace.json" in bundles[0]["files"],
          f"flight recorder: {res['flight']}")

    # the profiler's cost on the hot path: its two hooks a frame on the
    # host, then B closed loop, off on on off off on on off
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    # the hot loop's pattern: 8 invokes in flight, then the sync that
    # drains their samples (the scheduler's max_inflight)
    dev = torch.device("cuda", 0)
    probe = devprof.DeviceProfiler().enable()
    hook_s = drain_s = 0.0
    for _ in range(HOOK_ITERS // 8):
        t0 = time.perf_counter()
        for _ in range(8):
            probe.note_dispatch("f", "b", dev)
            probe.note_launched()
        hook_s += time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probe.sample_sync()
        drain_s += time.perf_counter() - t0
    hook_us = hook_s / HOOK_ITERS * 1e6
    drain_us = drain_s / HOOK_ITERS * 1e6
    got = threading.Event()
    pipe = nt.parse_launch(plc_desc())
    pipe.get("out").set_props(new_data=lambda b: got.set(), collect=False)
    runner = nt.PipelineRunner(pipe).start()
    lat = {"off": [], "on": []}
    try:
        pts = 0
        for arm in ("off", "on", "on", "off") * 2:
            prof.enable(arm == "on")
            for i in range(PLC_WARMUP + PLC_LAT):
                got.clear()
                t0 = time.perf_counter()
                pipe.get("src").push(TensorBuffer.of(frames[0], pts=pts))
                pts += 1
                check(got.wait(60), "no frame back within 60 s")
                if i >= PLC_WARMUP:
                    lat[arm].append((time.perf_counter() - t0) * 1e3)
        pipe.get("src").end()
        runner.wait(60)
    finally:
        prof.enable(False)
        runner.stop()
    res["cost"] = {a: {"p50_ms": float(np.percentile(v, 50)),
                       "p99_ms": float(np.percentile(v, 99))}
                   for a, v in lat.items()}
    res["cost"]["hooks_us_per_frame"] = hook_us
    res["cost"]["drain_us_per_sample"] = drain_us
    print(f"phase 49: the profiler's host time a frame over {HOOK_ITERS} "
          f"frames in flights of 8: note_dispatch + note_launched (two "
          f"CUDA events recorded) {hook_us:.2f} µs, the sample's read at "
          f"the sync {drain_us:.2f} µs [{card}]")
    print(f"phase 49: B closed loop with the profiler off and on, in turns "
          f"off on on off, twice ({4 * PLC_LAT} frames an arm): p50 off "
          f"{res['cost']['off']['p50_ms']:.3f} ms, on "
          f"{res['cost']['on']['p50_ms']:.3f} ms; p99 off "
          f"{res['cost']['off']['p99_ms']:.3f} ms, on "
          f"{res['cost']['on']['p99_ms']:.3f} ms [{card}]")
    record["profiler"] = res
    return launched


def new_paths_agreement(nt, torch, card, record) -> None:
    """normalize_u8 on R2, SH2 and SEG, counted by its wrapper and by name
    in one profile (profiled_agreement)."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.backends import kernels

    frames = u8_frames(PLC_SHAPE, 8, 499)

    def attempt():
        kernels.normalize_u8.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_capture(torch)
            for desc in (plc_desc("devices=2"), plc_desc("shards=2"),
                         seg_desc()):
                run_sinks(nt, desc, frames)
            torch.cuda.synchronize()
            close_capture(torch)
        named = sum("nns_normalize_kernel" in e.name
                    for e in kernel_events(prof))
        launched = kernels.normalize_u8.launches
        return {"normalize_u8": launched}, {"normalize_u8": named}, launched

    launched, tries = profiled_agreement("phase 49: new paths", attempt)
    record["new_paths_agreement"] = {"launches": launched, "tries": tries}
    print(f"phase 49: normalize_u8 on R2, SH2 and SEG ({len(frames)} frames "
          f"each): {launched} launches by the wrapper and by name in one "
          f"profile (profiled run {tries}) [{card}]")
    check(launched == 3 * len(frames), f"new paths: {launched} launches")


#: phase 49: frames of the plain run's --profile check
PROF_CLI_FRAMES = 4


def profile_cli_check(torch, card, record) -> int:
    """Phase 49: `main(['--profile', DIR, B over PROF_CLI_FRAMES frames])`
    in this process: exit 0, the Chrome trace it names on stderr parses
    and holds at least one of the card's kernels (the profiler drops
    records now and then, so no exact count). → normalize_u8's launches
    in the run."""
    import contextlib
    import io
    import os
    import tempfile

    from nnstreamer_tpu_torch.__main__ import main as cli
    from nnstreamer_tpu_torch.backends import kernels

    out_dir = tempfile.mkdtemp(prefix="chip_profile_")
    err = io.StringIO()
    kernels.normalize_u8.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli(["--profile", out_dir, b_desc(PROF_CLI_FRAMES)])
    wall = time.perf_counter() - t0
    launched = kernels.normalize_u8.launches
    path = os.path.join(out_dir, "trace.json")
    events = json.loads(Path(path).read_text())["traceEvents"] \
        if os.path.exists(path) else []
    kern = Counter(e["name"] for e in events if e.get("cat") == "kernel")
    norm = sum(n for k, n in kern.items() if "nns_normalize_kernel" in k)
    record["profile_cli"] = {
        "rc": rc, "seconds": wall, "events": len(events),
        "kernel_events": sum(kern.values()), "kernel_names": len(kern),
        "normalize_records": norm, "launches": launched}
    print(f"phase 49: main(['--profile', DIR, B over {PROF_CLI_FRAMES} "
          f"frames]): exit {rc} in {wall:.2f} s; {path}: {len(events)} "
          f"events, {sum(kern.values())} kernel records of {len(kern)} "
          f"kernels ({norm} nns_normalize_kernel), normalize_u8 launched "
          f"{launched} times by its wrapper [{card}]")
    check(rc == 0 and path in err.getvalue() and sum(kern.values()) > 0
          and launched == PROF_CLI_FRAMES,
          f"--profile: {record['profile_cli']}, stderr "
          f"{err.getvalue()[-500:]!r}")
    return launched


def placement_phases(nt, torch, card, record, phases) -> dict:
    """Phases 47-49 on PLC_DEVICES logical devices. → normalize_u8's
    launches on the new paths."""
    import os

    old = os.environ.get(VIRTUAL_ENV)
    os.environ[VIRTUAL_ENV] = str(PLC_DEVICES)
    try:
        launched = placement_phase(nt, torch, card, record)
        phases.done("47 (placement: replicas, dense shards, fences, swap)")
        launched += segment_phase(nt, torch, card, record)
        phases.done("48 (device segments: SEG, its windows, the plan)")
        launched += profiler_phase(nt, torch, card, record)
        new_paths_agreement(nt, torch, card, record)
        launched += profile_cli_check(torch, card, record)
        phases.done("49 (the device profiler, /metrics, the flight "
                    "recorder)")
    finally:
        if old is None:
            os.environ.pop(VIRTUAL_ENV, None)
        else:
            os.environ[VIRTUAL_ENV] = old
    return {"placement": launched}


# -- phases 50-51: the serving mesh, the llm subcommand -----------------------

#: phase 50: frames of the partition flood (open loop) and after the swap
MESH_FRAMES, MESH_SWAP_FRAMES = 96, 16
#: frames a pool takes alone before the flood: one at a time, then at once
#: (its capacity, which sets the offered rate)
MESH_WARM, MESH_CAP_FRAMES = 4, 16
MESH_LOAD_X, MESH_LEASE_S, MESH_HEAL_AFTER_S = 1.5, 1.0, 2.5
#: phase 51: requests of the llm subcommand
LLM_CLI_REQUESTS = 4
#: phase 51: tensor_llm under the device profiler: the llm subcommand's
#: model and pool, 2 of its prompts, prewarmed to their buckets
LLM_PROF_PROPS = dict(model="store://transformer", n_heads=4,
                      paged_kernel="pallas", prefill_chunk=0,
                      block_size=16, max_len=128,
                      num_blocks=64, max_batch=2, prewarm=16)
LLM_PROF_REQUESTS, LLM_PROF_TOKENS = 2, 8


def mesh_flood(router_port, frames, arrivals, trace):
    """run_open_loop against the router: frame i is frames[i % len]; every
    RESULT's logits by pts, and how many times each pts came back."""
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
    from nnstreamer_tpu_torch.traffic.loadgen import run_open_loop

    got, seen = {}, Counter()

    def on_result(pts, buf):
        got[pts] = np.asarray(buf.tensors[0]).astype(np.float32)
        seen[pts] += 1

    report = run_open_loop(
        "127.0.0.1", router_port, dims=POOL_DIMS, types="uint8",
        arrivals=arrivals, trace=trace, drain_timeout_s=120.0,
        make_frame=lambda i: TensorBuffer.of(frames[i % len(frames)],
                                             pts=i),
        on_result=on_result)
    return report, got, seen


def mesh_versions(got, refs, n_frames) -> dict:
    """Each reply's version: the one whose B-direct logits it is within
    POOL_REL of (0 = neither), with its bit-for-bit count."""
    out = {"version": {}, "bit_for_bit": 0}
    for pts, v in got.items():
        k = pts % n_frames
        errs = {ver: rel_to(v, ref[k]) for ver, ref in refs.items()}
        ver = min(errs, key=errs.get)
        out["version"][pts] = ver if errs[ver] <= POOL_REL else 0
        out["bit_for_bit"] += v.tobytes() == refs[ver][k].tobytes()
    return out


def mesh_phase(nt, torch, card, record) -> int:
    """Phase 50: pipeline B from a two-host serving mesh through a
    partition and a swap. → normalize_u8's launches in the hosts'
    children."""
    from nnstreamer_tpu_torch.runtime.tracing import Tracer
    from nnstreamer_tpu_torch.serving.mesh import MeshRouter, pool_join
    from nnstreamer_tpu_torch.serving.pool import proc_alive
    from nnstreamer_tpu_torch.serving.worker import _register_preloads
    from nnstreamer_tpu_torch.traffic.loadgen import (
        conservation_ok, poisson_arrivals)
    from nnstreamer_tpu_torch.traffic.netchaos import ChaosProxy

    res = {}
    record["mesh"] = res
    frames = u8_frames(POOL_SHAPE, POOL_FRAMES, 501)
    tracers = [Tracer(), Tracer()]
    # two one-worker pools of B's two filters, starting at once
    pools = [pool_start(nt, 1, 5001 + k, tracer=tracers[k])
             for k in range(2)]
    router = proxy = None
    agents = []
    try:
        _register_preloads(pool_preload())
        refs = {}
        for v in (POOL_V1, 2):
            out = run_sinks(nt, f"{APPSRC} ! {NORM_B} ! tensor_filter "
                                f"model=store://{POOL_STORE}@{v} ! "
                                f"tensor_sink name=out", frames)[0]["out"]
            refs[v] = logits_of(out).astype(np.float32)
        check(all(p.pool.wait_ready(240) for p in pools),
              f"mesh: pools not ready: {[p.stats()['workers'] for p in pools]}")
        # each pool alone: warm, then its capacity from a burst
        caps = []
        for pqs in pools:
            cli = PoolClient(pqs.port)
            try:
                for i in range(MESH_WARM):
                    cli.send(i, frames[i])
                    cli.wait([i])
                t0 = time.perf_counter()
                for i in range(MESH_CAP_FRAMES):
                    cli.send(100 + i, frames[i % POOL_FRAMES])
                cli.wait([100 + i for i in range(MESH_CAP_FRAMES)])
                caps.append(MESH_CAP_FRAMES / (time.perf_counter() - t0))
            finally:
                cli.close()
            check(not cli.busy, f"mesh: a pool refused {cli.busy}")
        router = MeshRouter(sid=5003, dims=POOL_DIMS, types="uint8",
                            max_pending=4 * MESH_FRAMES,
                            lease_s=MESH_LEASE_S, max_redeliver=2)
        proxy = ChaosProxy("127.0.0.1", router.port, seed=50)
        for k, pqs in enumerate(pools):
            host, port = ((proxy.host, proxy.port) if k == 0
                          else ("127.0.0.1", router.port))
            agents.append(pool_join(pqs, host, port, name=f"h{k}",
                                    connect_timeout_s=10.0))
        check(router.wait_hosts(2, 30), "mesh: hosts did not register")

        # -- the partition: h0 blackholed mid-flood, healed, rejoined --
        rate = MESH_LOAD_X * sum(caps)
        arrivals = poisson_arrivals(rate, MESH_FRAMES,
                                    np.random.default_rng(50))
        t_bh = float(arrivals[MESH_FRAMES // 2])
        proxy.program([(t_bh, "blackhole"),
                       (t_bh + MESH_HEAL_AFTER_S, "heal")])
        report, got, seen = mesh_flood(router.port, frames, arrivals, True)
        check(proxy.wait_program(60), "mesh: the heal never applied")
        rejoined = _wait_for(lambda: router.ready_hosts() == 2, 60)
        c = router.admission_counters()
        st = router.stats()
        applied = proxy.applied("blackhole")
        fences = [(round(t - applied, 4), h, cause)
                  for t, h, k, cause in router.events
                  if k == "fence" and t >= applied]
        per_host = {h["host"]: h["replied"] for h in st["hosts"]}
        ver = mesh_versions(got, {POOL_V1: refs[POOL_V1]}, POOL_FRAMES)
        ex = report.get("redelivered_examples") or []
        lat = report.get("latency_ms", {})
        res["partition"] = {
            "capacity_rps": caps, "offered_rps": rate,
            "blackhole_at_s": t_bh, "report": {
                k: report.get(k) for k in (
                    "offered", "completed", "rejected", "lost",
                    "busy_causes", "duration_s", "offered_rate_rps",
                    "throughput_rps", "latency_ms", "redelivered",
                    "redelivered_examples", "traced_replies")},
            "fences": fences, "reoffered": st["mesh"]["reoffered"],
            "per_host_replied": per_host, "admission": c,
            "conserved": conservation_ok(c), "rejoined": rejoined,
            "duplicates": [p for p, n in seen.items() if n != 1],
            "off_B": [p for p, v in ver["version"].items() if v != POOL_V1],
            "bit_for_bit": ver["bit_for_bit"]}
        r = res["partition"]
        print(f"phase 50: a port MeshRouter (lease {MESH_LEASE_S} s, "
              f"max_redeliver 2) over two 1-worker pools of B's two "
              f"filters (bf16, {POOL_SHAPE} uint8), h0 through a "
              f"ChaosProxy (seed 50); capacities measured "
              + " / ".join(f"{x:.1f}" for x in caps) + " frames/s (a "
              f"burst of {MESH_CAP_FRAMES} to each pool alone) [{card}]")
        print(f"phase 50: {MESH_FRAMES} frames open loop (Poisson at "
              f"{rate:.1f} frames/s = {MESH_LOAD_X} x the measured sum), "
              f"h0 blackholed at {t_bh:.3f} s and healed "
              f"{MESH_HEAL_AFTER_S} s later: completed {report['completed']}"
              f", rejected {report['rejected']} {report['busy_causes']}, "
              f"lost {report['lost']}; fences after the blackhole (s after "
              f"it, host, cause) {fences}; re-offered {r['reoffered']}; "
              f"redelivered {report.get('redelivered')}, e.g. "
              f"{ex[:1]}; rejoined {rejoined}; replied per host {per_host},"
              f" router {c['replied']}; offered == admitted + rejected and "
              f"admitted == replied + shed + depth + inflight: "
              f"{r['conserved']}; replies within {POOL_REL} of B direct's "
              f"v{POOL_V1} {len(got) - len(r['off_B'])}/{len(got)}, bit for "
              f"bit {ver['bit_for_bit']}/{len(got)}, duplicated "
              f"{r['duplicates']} [{card}]")
        print(f"phase 50: the flood: latency p50 {lat.get('p50')} ms p99 "
              f"{lat.get('p99')} ms, fence detection "
              f"{fences[0][0] if fences else None} s after the blackhole "
              f"(lease {MESH_LEASE_S} s), {report['throughput_rps']} "
              f"frames/s completed over {report['duration_s']} s "
              f"(offered {report['offered_rate_rps']} frames/s) [{card}]")
        check(report["lost"] == 0 and report["completed"] == MESH_FRAMES
              and r["conserved"] and sum(per_host.values()) == c["replied"]
              and c["replied"] == MESH_FRAMES and not r["duplicates"]
              and not r["off_B"] and rejoined and bool(fences)
              and fences[0][1:] == ("h0", "lease_expired")
              and any(e["hosts"] == ["h0", "h1"] for e in ex),
              f"mesh partition: {r}")

        # -- a two-phase swap to version 2 across both hosts ------------
        epoch0 = router.epoch
        rep = router.swap(POOL_STORE, 2, timeout_s=180.0)
        before = dict(per_host)
        report2, got2, seen2 = mesh_flood(
            router.port, frames, poisson_arrivals(
                rate, MESH_SWAP_FRAMES, np.random.default_rng(51)), False)
        ver2 = mesh_versions(got2, refs, POOL_FRAMES)
        st = router.stats()
        after = {h["host"]: h["replied"] - before.get(h["host"], 0)
                 for h in st["hosts"]}
        res["swap"] = {"ok": rep["ok"], "epoch": [epoch0, router.epoch],
                       "hosts": rep["hosts"],
                       "versions": dict(Counter(ver2["version"].values())),
                       "bit_for_bit": ver2["bit_for_bit"],
                       "completed": report2["completed"],
                       "lost": report2["lost"], "per_host": after,
                       "conserved": conservation_ok(
                           router.admission_counters())}
        w = res["swap"]
        print(f"phase 50: mesh swap store://{POOL_STORE} @{POOL_V1} -> @2 "
              f"on both hosts: ok {rep['ok']}, epoch {epoch0} -> "
              f"{router.epoch}, hosts {rep['hosts']}; then "
              f"{MESH_SWAP_FRAMES} frames: replies by version "
              f"{w['versions']} (bit for bit {ver2['bit_for_bit']}/"
              f"{len(got2)}), per host {after}, lost {report2['lost']}, "
              f"conserved {w['conserved']} [{card}]")
        check(rep["ok"] and router.epoch == epoch0 + 1
              and all(h.get("commit_ok") for h in rep["hosts"].values())
              and len(rep["hosts"]) == 2
              and report2["completed"] == MESH_SWAP_FRAMES
              and w["versions"] == {2: MESH_SWAP_FRAMES} and w["conserved"],
              f"mesh swap: {w}")

        # -- normalize_u8 in the children: every frame they processed ---
        def tally():
            return [(pool_launches(t), p.admission_counters()["replied"])
                    for t, p in zip(tracers, pools)]

        _wait_for(lambda: all(n == m for n, m in tally()), 30)
        counts = tally()
        res["launches"] = counts
        processed = sum(m for _, m in counts)
        warm = 2 * (MESH_WARM + MESH_CAP_FRAMES)
        print(f"phase 50: normalize_u8 in the hosts' children, launches as "
              f"their wrappers counted them / their pools' replies: "
              + ", ".join(f"h{k} {n} / {m}" for k, (n, m) in
                          enumerate(counts))
              + f"; {processed - warm} frames processed for the router's "
              f"{router.admission_counters()['replied']} replies (the rest "
              f"of {processed}: {warm} frames sent to the pools alone)")
        check(all(n == m for n, m in counts) and processed - warm
              >= router.admission_counters()["replied"],
              f"mesh launches: {counts}")
    finally:
        for a in agents:
            a.stop()
        if proxy is not None:
            proxy.close()
        if router is not None:
            router.close()
        pids = [p for pqs in pools for p in pqs.pool.all_pids_ever()]
        for pqs in pools:
            pqs.close()
    alive = [p for p in pids if proc_alive(p)]
    segments = [s for pqs in pools for s in pqs.pool.shm_segments()]
    res["drain"] = {"pids": pids, "alive": alive, "segments": segments}
    print(f"phase 50: drain: {len(pids)} pids ever, alive {alive}, shm "
          f"segments {segments}")
    check(not alive and not segments, f"mesh drain: {res['drain']}")
    return sum(n for n, _ in counts)


def _wait_for(cond, timeout_s) -> bool:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


def llm_cli_cases(torch, dev):
    """(name, kernel fn, plain fn, args) at the `llm` subcommand's
    attention shape: the zoo transformer's 4 heads of 16 on 4 kv heads,
    block 16, 64 blocks, 8 a row (max_len 128), q f32; decode rows at
    staggered depths (the table's last slot among them), prefill chunks
    at the prompts' two buckets (8 and 16)."""
    from nnstreamer_tpu_torch.backends import paged_attn as pa

    rng = np.random.default_rng(3)
    nb, bs, n_kv, hd, mb, heads = 64, 16, 4, 16, 8, 4
    pools = [torch.from_numpy(rng.standard_normal(
        (nb, bs, n_kv, hd)).astype(np.float32)).to(dev) for _ in range(2)]
    perm = rng.permutation(np.arange(1, nb))
    tab, ps = decode_rows(rng, perm, (40, 16, 5, mb * bs - 1), bs, mb)
    q = torch.from_numpy(rng.standard_normal(
        (len(ps), heads, hd)).astype(np.float32)).to(dev)
    cases = [("decode llm-cli kv4 hd16 B4", pa.paged_decode_attn,
              pa.paged_decode_attn_plain,
              (q, *pools, torch.from_numpy(tab).to(dev),
               torch.from_numpy(ps).to(dev)))]
    seq = torch.from_numpy(tab[0]).to(dev)
    for s_c in (8, 16):
        qp = torch.from_numpy(rng.standard_normal(
            (heads, s_c, hd)).astype(np.float32)).to(dev)
        cases.append((f"prefill llm-cli kv4 hd16 S{s_c} pos0=0",
                      pa.paged_prefill_attn, pa.paged_prefill_attn_plain,
                      (qp, *pools, seq, 0)))
    return cases


def llm_cli_run(kernel: str) -> dict:
    """main(["llm", "--requests", N]) in this process with
    NNS_PAGED_KERNEL=`kernel` → its exit code, its lines, the tokens and
    the done line of each request, and its seconds."""
    import contextlib
    import io
    import os

    from nnstreamer_tpu_torch.__main__ import main as cli

    out = io.StringIO()
    old = os.environ.get("NNS_PAGED_KERNEL")
    os.environ["NNS_PAGED_KERNEL"] = kernel
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli(["llm", "--requests", str(LLM_CLI_REQUESTS)])
    finally:
        if old is None:
            os.environ.pop("NNS_PAGED_KERNEL")
        else:
            os.environ["NNS_PAGED_KERNEL"] = old
    wall = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    tokens, done = {}, {}
    for line in lines:
        rid, _, rest = line.strip().partition("  ")
        toks, _, tail = rest.partition("   [")
        tokens.setdefault(rid, []).extend(int(t) for t in toks.split())
        if tail.startswith("done"):
            done[rid] = line.strip()
    return {"rc": rc, "lines": lines, "tokens": tokens, "done": done,
            "seconds": wall}


def llm_cli_prompts() -> list:
    """The prompts `llm --requests N` makes at its default seed (0)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(LLM_CLI_REQUESTS):
        plen = int(rng.integers(1, 17))
        out.append(rng.integers(0, 256, size=plen).astype(np.int32))
    return out


def llm_cli_phase(nt, torch, card, record) -> dict:
    """Phase 51: the `llm` subcommand in this process, on the card, with
    the paged kernels (NNS_PAGED_KERNEL=pallas), then again on the torch
    reference (xla): every request done in both, the paged wrappers
    launched in the first, the tokens equal but for near-ties, and each
    kernel within PAGED_REL/PAGED_ABS of its plain version at the
    subcommand's shapes. → each paged wrapper's launches in the first
    run."""
    from nnstreamer_tpu_torch.backends import paged_attn as pa
    from nnstreamer_tpu_torch.models import transformer
    from nnstreamer_tpu_torch.serving.store import get_store

    wrappers = {"paged_decode_attn": pa.paged_decode_attn,
                "paged_prefill_attn": pa.paged_prefill_attn}
    for w in wrappers.values():
        w.launches = 0
    run = llm_cli_run("pallas")
    launches = {k: w.launches for k, w in wrappers.items()}
    ref = llm_cli_run("xla")
    want = [f"req{i}" for i in range(LLM_CLI_REQUESTS)]
    print(f"phase 51: main(['llm', '--requests', '{LLM_CLI_REQUESTS}']) "
          f"with NNS_PAGED_KERNEL=pallas on the card: exit {run['rc']}, "
          f"{len(run['lines'])} lines, done {sorted(run['done'])} (e.g. "
          f"{run['done'].get('req0')!r}); the paged wrappers' launches "
          f"{launches}; {run['seconds']:.2f} s; again with xla (the torch "
          f"reference): exit {ref['rc']}, done {sorted(ref['done'])}, "
          f"{ref['seconds']:.2f} s [{card}]")
    check(run["rc"] == 0 and sorted(run["done"]) == want
          and ref["rc"] == 0 and sorted(ref["done"]) == want
          and all(n > 0 for n in launches.values()),
          f"llm subcommand: {run['rc']} {sorted(run['done'])}, "
          f"{ref['rc']} {sorted(ref['done'])}, {launches}")
    # the tokens: the kernel arm against the reference arm (f32 both)
    dev = torch.device("cuda")
    entry = get_store().entry("transformer")
    params = on_device(entry.bundle(entry.state[0]).params, dev)

    def last_logits(seq):
        return transformer.apply_seq(params, seq.to(dev), n_heads=4,
                                     attn="xla")[0, -1]

    prompts = llm_cli_prompts()
    got = {f"r{i}": run["tokens"][f"req{i}"] for i in range(len(prompts))}
    exp = {f"r{i}": ref["tokens"][f"req{i}"] for i in range(len(prompts))}
    flips = check_f32_parity(torch, last_logits, prompts, got, exp, "51")
    same = sum(got[k] == exp[k] for k in got)
    # each kernel at the subcommand's shapes, against its plain version
    # in f32 (TF32 off: phase 14 leaves it on, and the plain prefill's
    # products would then carry TF32's 1e-3)
    errs = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for case in llm_cli_cases(torch, dev):
            key = case[0].split()[0]
            errs[key] = max(errs.get(key, 0.0),
                            check_paged_case(torch, "51", *case, record))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    record["llm_cli"] = {
        "rc": [run["rc"], ref["rc"]], "done": sorted(run["done"]),
        "launches": launches, "lines": len(run["lines"]),
        "seconds": [run["seconds"], ref["seconds"]],
        "token_identical": same, "near_tie_flips": flips,
        "kernel_errs": errs}
    print(f"phase 51: the pallas run's tokens against the xla run's: "
          f"{same}/{len(got)} requests token-identical, {flips} near-tie "
          f"flips (limit {LLM_TIE} of max|logit|); the paged kernels at "
          f"the subcommand's shapes (4 heads of 16, block 16, q f32) "
          f"against their plain versions (TF32 off): max_abs_err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" [{card}]")
    return launches


def llm_profiler_check(nt, torch, card, record) -> dict:
    """Phase 51: tensor_llm with the device profiler on, in profiled runs
    until the paged wrappers' launches equal the profiler's records by
    name (profiled_agreement): the model:<element> row against the placed
    params plus the pool's k and v, counted here from the tensors on the
    card; an invoke row for every (kind, bucket) the executor ran, one
    sample a dispatch (warm runs included); a first-run row for each but
    the decode windows'. → the paged wrappers' launches in the agreeing
    run."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.runtime import devprof

    prompts = llm_cli_prompts()[:LLM_PROF_REQUESTS]
    dp = devprof.get()

    def attempt():
        dp.reset()
        dp.enable(True)
        try:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            _, llm, wall, launches = serve(
                nt, torch, prompts, prof=prof, new_tokens=LLM_PROF_TOKENS,
                **LLM_PROF_PROPS)
            st = dp.stats()
        finally:
            dp.enable(False)
        paged = {k: launches[k] for k in ("paged_decode_attn",
                                          "paged_prefill_attn")}
        return paged, named_launches(prof, paged), (llm, wall, st, paged)

    (llm, wall, st, paged), tries = profiled_agreement("phase 51: profiled "
                                                       "tensor_llm", attempt)
    ex = llm.engine.executor
    tensors = [t for t in _leaves(ex.params) + [ex.cache.k, ex.cache.v]]
    want = sum(t.numel() * t.element_size() for t in tensors)
    on_card = all(t.is_cuda for t in tensors)
    rows = {r["kind"]: r["bytes"] for r in st["hbm"] if r["device"] == "-"}
    ran = {f"{k[0]}:{k[1]}x{k[2]}" if k[0] == "decmulti"
           else f"{k[0]}:{k[1]}" for k in ex._seen}
    inv = {r["bucket"]: r["samples_total"] for r in st["invoke"]
           if r["filter"] == llm.name}
    jit = {r["bucket"] for r in st["jit"] if r["filter"] == llm.name}
    dispatches = (ex.prefills + ex.chunk_prefills + ex.decode_steps
                  - ex.window_steps + ex.decode_windows + llm.warm_compiles)
    res = {"model_row": rows.get(f"model:{llm.name}"), "want_bytes": want,
           "on_card": on_card, "buckets": sorted(inv), "ran": sorted(ran),
           "samples": sum(inv.values()), "dispatches": dispatches,
           "jit": sorted(jit), "launches": paged, "tries": tries,
           "seconds": wall,
           "p50_ms": {r["bucket"]: r["p50_ms"] for r in st["invoke"]
                      if r["filter"] == llm.name}}
    record["llm_profiler"] = res
    print(f"phase 51: tensor_llm ({LLM_PROF_REQUESTS} requests, "
          f"{LLM_PROF_TOKENS} tokens each, paged kernels) with the device "
          f"profiler on: model:{llm.name} {res['model_row']} bytes against "
          f"the placed params + k + v {want} (on the card: {on_card}); "
          f"invoke rows {res['buckets']} against the buckets run "
          f"{res['ran']}, {res['samples']} samples for {dispatches} "
          f"dispatches; first-run rows {res['jit']}; device ms an invoke "
          f"(p50) {res['p50_ms']}; the paged wrappers' launches {paged} = "
          f"the profiler's by name (profiled run {tries}); {wall:.2f} s "
          f"[{card}]")
    check(res["model_row"] == float(want) and on_card
          and set(inv) == ran and res["samples"] == dispatches
          and jit == {b for b in ran if not b.startswith("decmulti")}
          and all(n > 0 for n in paged.values()),
          f"tensor_llm under the profiler: {res}")
    return paged


def _leaves(tree) -> list:
    """The tensors of a params tree (dicts and lists)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def mesh_phases(nt, torch, card, record, phases) -> tuple:
    """Phases 50-51. → (normalize_u8's launches in the mesh's children,
    the paged wrappers' launches in the llm subcommand)."""
    launched = mesh_phase(nt, torch, card, record)
    phases.done("50 (pipeline B from a two-host mesh through a partition "
                "and a swap)")
    paged = llm_cli_phase(nt, torch, card, record)
    for k, n in llm_profiler_check(nt, torch, card, record).items():
        paged[k] += n
    phases.done("51 (the llm subcommand, tensor_llm under the profiler)")
    return {"mesh": launched}, paged


# -- phases 52-53: load generation, MQTT (Queue 1 items 4h, 5a) ---------------

#: phase 52: the open-loop flood's size and offered load (× the pool's
#: capacity, measured by a burst of TRAFFIC_CAP_FRAMES), then the frames
#: whose logits are held to B direct's at TRAFFIC_CHECK_X × capacity
TRAFFIC_FRAMES, TRAFFIC_CAP_FRAMES, TRAFFIC_CHECK_FRAMES = 96, 16, 16
TRAFFIC_LOAD_X, TRAFFIC_CHECK_X = 1.5, 0.5
#: phase 53: frames of B carried across the broker on each transport
MQTT_FRAMES = 64
MQTT_TOPIC = "b/logits"


def test_images(nt, n: int) -> list:
    """Phase 4's test images: `n` videotestsrc frames of POOL_SHAPE
    (224², uint8)."""
    _, h, w, _ = POOL_SHAPE
    out = run_sinks(nt, f"videotestsrc num-buffers={n} width={w} "
                        f"height={h} ! tensor_converter ! tensor_sink "
                        f"name=out")[0]["out"]
    return [np.asarray(b.tensors[0]) for b in out]


def traffic_cli(argv) -> tuple:
    """main(["traffic", *argv]) in this process → (exit code, the report
    its --json line printed)."""
    import contextlib
    import io

    from nnstreamer_tpu_torch.__main__ import main as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(["traffic", *argv])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else {})


def traffic_phase(nt, torch, card, record) -> int:
    """Phase 52: pipeline B in a 1-worker pool, flooded open loop by the
    port's own `traffic` subcommand at 1.5x its measured capacity, then
    held to B direct at 0.5x. → normalize_u8's launches in the child."""
    from nnstreamer_tpu_torch.runtime.tracing import Tracer
    from nnstreamer_tpu_torch.serving.pool import proc_alive
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
    from nnstreamer_tpu_torch.traffic.loadgen import (
        conservation_ok, poisson_arrivals, run_open_loop)

    res = {}
    record["traffic"] = res
    frames = test_images(nt, TRAFFIC_CHECK_FRAMES)
    tracer = Tracer()
    pqs = pool_start(nt, 1, 5201, tracer=tracer)
    try:
        ref = logits_of(run_sinks(
            nt, f"{APPSRC} ! {NORM_B} ! tensor_filter model=store://"
                f"{POOL_STORE}@{POOL_V1} ! tensor_sink name=out",
            frames)[0]["out"]).astype(np.float32)
        check(pqs.pool.wait_ready(240),
              f"traffic: pool not ready: {pqs.stats()['workers']}")
        cli = PoolClient(pqs.port)
        try:
            for i in range(MESH_WARM):
                cli.send(i, frames[i])
                cli.wait([i])
            t0 = time.perf_counter()
            for i in range(TRAFFIC_CAP_FRAMES):
                cli.send(100 + i, frames[i % len(frames)])
            cli.wait([100 + i for i in range(TRAFFIC_CAP_FRAMES)])
            cap = TRAFFIC_CAP_FRAMES / (time.perf_counter() - t0)
        finally:
            cli.close()
        check(not cli.busy, f"traffic: the pool refused {cli.busy}")
        rate = TRAFFIC_LOAD_X * cap
        argv = ["--host", "127.0.0.1", "--port", str(pqs.port), "--dims",
                POOL_DIMS, "--types", "uint8", "--rate", f"{rate:.3f}",
                "--requests", str(TRAFFIC_FRAMES), "--seed", "0", "--json"]
        t0 = time.perf_counter()
        rc, rep = traffic_cli(argv)
        wall = time.perf_counter() - t0
        c = pqs.admission_counters()
        lat = rep.get("latency_ms", {})
        res["flood"] = {"capacity_rps": cap, "rate": rate, "argv": argv,
                        "rc": rc, "seconds": wall, "admission": c,
                        "conserved": conservation_ok(c), "report": {
                            k: rep.get(k) for k in (
                                "offered", "completed", "rejected", "lost",
                                "busy_causes", "duration_s",
                                "offered_rate_rps", "throughput_rps",
                                "goodput_rps", "within_budget",
                                "p99_budget_ms", "latency_ms",
                                "queue_depth_peak", "seed")}}
        print(f"phase 52: pipeline B (normalize_u8 ! store://{POOL_STORE}"
              f"@{POOL_V1}, bf16, {POOL_SHAPE} uint8) in a 1-worker pool, "
              f"capacity {cap:.1f} frames/s (a burst of "
              f"{TRAFFIC_CAP_FRAMES} after {MESH_WARM} warm-up frames); "
              f"main(['traffic', {', '.join(repr(a) for a in argv)}]): exit "
              f"{rc}, offered {rep.get('offered')}, completed "
              f"{rep.get('completed')}, rejected {rep.get('rejected')} "
              f"{rep.get('busy_causes')}, lost {rep.get('lost')}, the pool's "
              f"queue depth peak {c.get('depth_peak')}; its "
              f"counters {c} conserved {conservation_ok(c)} [{card}]")
        print(f"phase 52: the flood: latency p50 {lat.get('p50')} ms p99 "
              f"{lat.get('p99')} ms, goodput {rep.get('goodput_rps')} "
              f"frames/s (budget {rep.get('p99_budget_ms')} ms), "
              f"{rep.get('throughput_rps')} frames/s completed over "
              f"{rep.get('duration_s')} s (offered "
              f"{rep.get('offered_rate_rps')} frames/s); {wall:.2f} s in "
              f"the subcommand [{card}]")
        check(rc == 0 and rep.get("lost") == 0
              and rep.get("offered") == TRAFFIC_FRAMES
              and rep["completed"] + rep["rejected"] == TRAFFIC_FRAMES
              and rep["completed"] >= 1 and conservation_ok(c),
              f"traffic flood: {res['flood']}")

        # -- B's logits through run_open_loop at half the capacity -------
        got = {}

        def on_result(pts, buf):
            got[pts] = np.asarray(buf.tensors[0]).astype(np.float32)

        rep2 = run_open_loop(
            "127.0.0.1", pqs.port, dims=POOL_DIMS, types="uint8",
            arrivals=poisson_arrivals(TRAFFIC_CHECK_X * cap,
                                      TRAFFIC_CHECK_FRAMES,
                                      np.random.default_rng(52)),
            make_frame=lambda i: TensorBuffer.of(frames[i], pts=i),
            drain_timeout_s=120.0, on_result=on_result)
        errs = {p: rel_to(v, ref[p]) for p, v in got.items()}
        same = sum(v.tobytes() == ref[p].tobytes() for p, v in got.items())
        res["check"] = {"completed": rep2["completed"],
                        "lost": rep2["lost"], "max_rel": max(
                            errs.values(), default=None),
                        "bit_for_bit": same}
        print(f"phase 52: {TRAFFIC_CHECK_FRAMES} test images open loop at "
              f"{TRAFFIC_CHECK_X} x capacity through run_open_loop("
              f"on_result=...): completed {rep2['completed']}, lost "
              f"{rep2['lost']}; logits against B direct's: max "
              f"|diff|/max|logit| {res['check']['max_rel']}, bit for bit "
              f"{same}/{len(got)} [{card}]")
        check(rep2["completed"] == TRAFFIC_CHECK_FRAMES and len(got) ==
              TRAFFIC_CHECK_FRAMES and all(e <= POOL_REL
                                           for e in errs.values()),
              f"traffic check: {res['check']}")

        # -- normalize_u8 in the child: every frame the pool answered ----
        def tally():
            return (pool_launches(tracer),
                    pqs.admission_counters()["replied"])

        _wait_for(lambda: tally()[0] == tally()[1], 30)
        launched, replied = tally()
        res["launches"] = [launched, replied]
        print(f"phase 52: normalize_u8 in the child, launches as its "
              f"wrapper counted them / the pool's replies: {launched} / "
              f"{replied} ({MESH_WARM} warm-up + {TRAFFIC_CAP_FRAMES} burst"
              f" + {rep['completed']} flood + {rep2['completed']} check)")
        check(launched == replied == MESH_WARM + TRAFFIC_CAP_FRAMES
              + rep["completed"] + rep2["completed"],
              f"traffic launches: {launched} / {replied}")
    finally:
        pids = pqs.pool.all_pids_ever()
        pqs.close()
    alive = [p for p in pids if proc_alive(p)]
    res["drain"] = {"pids": pids, "alive": alive,
                    "segments": pqs.pool.shm_segments()}
    check(not alive and not res["drain"]["segments"],
          f"traffic drain: {res['drain']}")
    return launched


def subscribed(broker, topic, n: int = 1) -> bool:
    """The broker holds `n` subscribers of `topic` at least: edge-protocol
    SUBSCRIBEs and MQTT connections with a topic filter that matches."""
    from nnstreamer_tpu_torch.edge import mqtt_wire

    with broker._lock:
        subs = len(broker._subs.get(topic, ()))
    mq = broker._mqtt
    with mq._lock:
        subs += sum(any(mqtt_wire.topic_matches(f, topic) for f in c.filters)
                    for c in mq._conns.values())
    return subs >= n


def carried(nt, kernels, frames, recv_desc, send_desc, ready) -> dict:
    """Start the receiving pipeline, wait for `ready(recv_pipe)`, push
    `frames` through the sending one to EOS, and wait for every frame at
    the receiver. → its results, the sender's normalize_u8 launches and
    the seconds from the first push to the last arrival."""
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    recv = nt.parse_launch(recv_desc)
    rr = nt.PipelineRunner(recv).start()
    sink = recv.get("out")
    try:
        check(_wait_for(lambda: ready(recv), 30),
              f"carried: the receiver never subscribed ({recv_desc})")
        send = nt.parse_launch(send_desc)
        sr = nt.PipelineRunner(send).start()
        try:
            n0 = kernels.normalize_u8.launches
            t0 = time.perf_counter()
            for i, f in enumerate(frames):
                send.get("src").push(TensorBuffer.of(f, pts=i))
            send.get("src").end()
            sr.wait(600)
            launched = kernels.normalize_u8.launches - n0
            ok = _wait_for(lambda: len(sink.results) >= len(frames), 60)
            wall = time.perf_counter() - t0
        finally:
            sr.stop()
        check(ok, f"carried: {len(sink.results)}/{len(frames)} frames "
                  f"arrived ({send_desc})")
    finally:
        src = recv.get("src")
        if hasattr(src, "interrupt"):
            src.interrupt()
        rr.stop()
    return {"results": list(sink.results), "launches": launched,
            "seconds": wall}


def mqtt_phase(nt, torch, card, record) -> int:
    """Phase 53: B's logits across the EdgeBroker over real MQTT, over
    its edge protocol with broker-time pts, and edgesink → edgesrc; a raw
    MqttClient counts the MQTT run's PUBLISH packets. → normalize_u8's
    launches in the three sending pipelines."""
    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.edge.broker import EdgeBroker
    from nnstreamer_tpu_torch.edge.mqtt_wire import MqttClient
    from nnstreamer_tpu_torch.edge.wire import decode_buffer
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    res = {}
    record["mqtt"] = res
    frames = u8_frames(POOL_SHAPE, MQTT_FRAMES, 530)
    head = f"{APPSRC} ! {NORM_B} ! {MODEL}"
    # B direct, twice: the first warms the model, the second is the
    # reference, timed as the transports are (first push to last result)
    run_desc(nt, f"{head} ! tensor_sink name=out", frames[:8])
    pipe = nt.parse_launch(f"{head} ! tensor_sink name=out")
    runner = nt.PipelineRunner(pipe).start()
    try:
        t0 = time.perf_counter()
        for i, f in enumerate(frames):
            pipe.get("src").push(TensorBuffer.of(f, pts=i))
        pipe.get("src").end()
        runner.wait(600)
        b_fps = MQTT_FRAMES / (time.perf_counter() - t0)
    finally:
        runner.stop()
    direct = pipe.get("out").results
    check(len(direct) == MQTT_FRAMES, f"B direct: {len(direct)} frames")
    ref = logits_of(direct)
    dims, types, _ = direct[0].spec().to_strings()
    broker = EdgeBroker("127.0.0.1", 0)
    raw = None
    runs = {}
    try:
        check(broker.mqtt_port is not None, "mqtt: no MQTT listener")
        raw_got = []
        raw = MqttClient("127.0.0.1", broker.mqtt_port,
                         client_id="chip-smoke-raw")
        raw.subscribe(MQTT_TOPIC, lambda t, p: raw_got.append(p))
        tail = f"dims={dims} types={types} queue_size=128 ! tensor_sink name=out"
        runs["mqtt"] = carried(
            nt, kernels, frames,
            f"mqttsrc name=src protocol=mqtt port={broker.mqtt_port} "
            f"topic={MQTT_TOPIC} {tail}",
            f"{head} ! mqttsink protocol=mqtt qos=1 topic={MQTT_TOPIC} "
            f"port={broker.mqtt_port}",
            lambda p: subscribed(broker, MQTT_TOPIC, 2))
        check(_wait_for(lambda: len(raw_got) >= MQTT_FRAMES, 30),
              f"mqtt: the raw client saw {len(raw_got)} PUBLISH packets")
        runs["edge"] = carried(
            nt, kernels, frames,
            f"mqttsrc name=src protocol=edge sync=broker port={broker.port}"
            f" topic=b/edge {tail}",
            f"{head} ! mqttsink protocol=edge topic=b/edge "
            f"port={broker.port}",
            lambda p: subscribed(broker, "b/edge"))
        # edgesink port=0: the publisher starts first (its port, its caps)
        pub = nt.parse_launch(f"{head} ! edgesink name=pub port=0")
        pr = nt.PipelineRunner(pub).start()
        try:
            port = pub.get("pub").port
            recv = nt.parse_launch(f"edgesrc name=src port={port} timeout=30"
                                   f" ! tensor_sink name=out")
            rr = nt.PipelineRunner(recv).start()
            try:
                check(_wait_for(lambda: len(
                    pub.get("pub")._server.connections()) == 1, 30),
                    "edgesink: no subscriber")
                n0 = kernels.normalize_u8.launches
                t0 = time.perf_counter()
                for i, f in enumerate(frames):
                    pub.get("src").push(TensorBuffer.of(f, pts=i))
                pub.get("src").end()
                pr.wait(600)
                launched = kernels.normalize_u8.launches - n0
                sink = recv.get("out")
                ok = _wait_for(lambda: len(sink.results) >= MQTT_FRAMES, 60)
                wall = time.perf_counter() - t0
                pr.stop()              # the publisher's close is EOS
                rr.wait(60)
            finally:
                rr.stop()
        finally:
            pr.stop()
        check(ok, f"edgesink: {len(sink.results)}/{MQTT_FRAMES} arrived")
        runs["edgesink"] = {"results": list(sink.results),
                            "launches": launched, "seconds": wall}
    finally:
        if raw is not None:
            raw.close()
        broker.close()

    out = {}
    for name, run in runs.items():
        got = run["results"]
        pts = [b.pts for b in got]
        logits = logits_of(got)
        same = [bool(logits[i].tobytes() == ref[i].tobytes())
                for i in range(min(len(got), MQTT_FRAMES))]
        out[name] = {"arrived": len(got), "launches": run["launches"],
                     "bit_for_bit": sum(same), "seconds": run["seconds"],
                     "fps": MQTT_FRAMES / run["seconds"],
                     "pts_head": pts[:3], "pts_tail": pts[-2:]}
        if name == "edge":
            out[name]["pts_ok"] = bool(pts and pts[0] == 0 and all(
                b >= a for a, b in zip(pts, pts[1:])))
        else:
            out[name]["pts_ok"] = pts == list(range(MQTT_FRAMES))
    raw_frames = [decode_buffer(p)[0] for p in raw_got]
    raw_same = sum(
        b.pts == i and np.asarray(b.tensors[0]).tobytes() == ref[i].tobytes()
        for i, b in enumerate(raw_frames))
    res.update({"runs": out, "raw_publish": len(raw_got),
                "raw_bit_for_bit": raw_same, "B_fps": b_fps})
    for name, o in out.items():
        print(f"phase 53: {name}: {o['arrived']}/{MQTT_FRAMES} frames, pts "
              f"{o['pts_head']}...{o['pts_tail']} ok {o['pts_ok']}, logits "
              f"bit for bit B direct's {o['bit_for_bit']}/{MQTT_FRAMES}, "
              f"normalize_u8 launches {o['launches']}, {o['fps']:.1f} "
              f"frames/s from the first push to the last arrival (B "
              f"direct {b_fps:.1f}) [{card}]")
    print(f"phase 53: a raw MqttClient on {MQTT_TOPIC!r}: {len(raw_got)} "
          f"PUBLISH packets, {raw_same} decode to B's frames (pts and "
          f"logits bit for bit)")
    check(all(o["arrived"] == MQTT_FRAMES and o["pts_ok"]
              and o["bit_for_bit"] == MQTT_FRAMES
              and o["launches"] == MQTT_FRAMES for o in out.values())
          and len(raw_got) == MQTT_FRAMES and raw_same == MQTT_FRAMES,
          f"mqtt phase: {res}")
    return sum(o["launches"] for o in out.values())


def traffic_phases(nt, torch, card, record, phases) -> dict:
    """Phases 52-53. → normalize_u8's launches on each path."""
    flooded = traffic_phase(nt, torch, card, record)
    phases.done("52 (pipeline B flooded open loop by the traffic "
                "subcommand)")
    carried_over = mqtt_phase(nt, torch, card, record)
    phases.done("53 (B's logits over the broker: MQTT, edge, edgesink)")
    return {"traffic": flooded, "mqtt": carried_over}


#: phase 54: frames of B through each interop codec and over gRPC
INTEROP_FRAMES = 64
#: phase 54: frames of the protobuf leg run under the profiler
INTEROP_PROFILED = 16
INTEROP_CODECS = ("protobuf", "flatbuf", "flexbuf")
#: phase 55: MobileNetV2 1.0's training batch and steps; the steps held
#: to the CPU (batch TRAIN_CPU_BATCH, TF32 off); the closed-loop timing
#: steps after TRAIN_WARM warm-up steps
TRAIN_BATCH, TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 8, 4
TRAIN_CPU_BATCH, TRAIN_CPU_STEPS = 2, 2
TRAIN_TIMED, TRAIN_WARM = 10, 2
TRAIN_LR = 1e-3
#: the card-vs-CPU arm trains with sgd: its update is lr·grad, so the
#: parameters after a step hold the backward (Adam's lr-sized update of
#: an element whose gradient is rounding noise takes either sign)
TRAIN_CPU_OPT = "sgd:0.01"
#: the two arms of the card-vs-CPU comparison
TRAIN_ARMS = ("cuda", "cpu")
TRAIN_WIDTH, TRAIN_CLASSES = 1.0, 1001
TRAIN_MODEL = (f"zoo://mobilenet_v2?width={TRAIN_WIDTH}&"
               f"num_classes={TRAIN_CLASSES}")
#: card vs CPU, relative: a loss taken at the same params (the forward:
#: step 1, and step 2 teacher-forced) and the free-running step 2's
#: (after each arm's own step 1). Float32 against float64 on one CPU at
#: width 0.35 (nnstreamer_tpu_torch/tools/train_spread.py --width 0.35):
#: 1.3e-7 and 3.9e-7 at the same params, 6.5e-5 free-running
TRAIN_SAME_LOSS_REL, TRAIN_FREE_LOSS_REL = 1e-5, 1e-3
#: card vs CPU, one sgd step from the same params: per leaf, |card − CPU|
#: over the leaf's largest movement in the CPU's step (the floor of the
#: movement 1e-2 of the largest leaf's; two f32 ulps of the leaf's start
#: value allowed besides), the median over the leaves that moved more and
#: the largest over all. The same tool read, for float32 against float64,
#: a median of 2.6e-3 and 4.7e-5 and a largest of 3.2e-2 and 3.8e-2
#: (steps 1 and 2), and for BN with its batch statistics detached from
#: the graph a median of 1.4 both. Two free-running steps are not held
#: so: there float32's rounding in step 1 moves step 2's parameters by a
#: median of 0.29 of their movement
TRAIN_CPU_MEDIAN, TRAIN_CPU_MAX = 5e-2, 3e-1
#: codec host cost: encode + decode of B's (1, 1001) f32 logits, calls
CODEC_HOST_CALLS = 2000


def interop_tools() -> dict:
    """Which of the packages JAX's interop and trainer import are found
    on this machine (found by import spec; none is imported here — optax
    would import JAX)."""
    import importlib.util

    out = {}
    for name in ("grpc", "google.protobuf", "flatbuffers", "optax"):
        try:
            out[name] = importlib.util.find_spec(name) is not None
        except (ImportError, ValueError):
            out[name] = False
    return out


def timed_run(nt, desc, frames):
    """`desc` started, `frames` pushed into "src" at once, run to EOS →
    (results, seconds from the first push to the last result)."""
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    pipe = nt.parse_launch(desc)
    runner = nt.PipelineRunner(pipe).start()
    try:
        t0 = time.perf_counter()
        for i, f in enumerate(frames):
            pipe.get("src").push(TensorBuffer.of(f, pts=i))
        pipe.get("src").end()
        runner.wait(600)
        wall = time.perf_counter() - t0
    finally:
        runner.stop()
    return pipe.get("out").results, wall


def flexible_leg(nt, torch, codec_tail: str):
    """Phase 28's crop → invoke-dynamic MobileNetV2 (a FLEXIBLE frame of
    one (1, 1001) logits tensor a region) into `codec_tail` → the
    frames."""
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    regions = [np.array([[0, 0, 100, 80], [10, 10, 57, 57]], np.uint32),
               np.array([[0, 0, 224, 224]], np.uint32),
               np.array([[5, 5, 33, 120], [50, 50, 100, 80],
                         [60, 60, 100, 80]], np.uint32)]
    img = u8_frames((1, 224, 224, 3), len(regions), 540)
    pipe = nt.parse_launch(
        f"appsrc name=raw dims=3:224:224:1 types=uint8 ! {NORM_B} ! "
        f"crop.sink_0 appsrc name=info dims=4:1 types=uint32 ! crop.sink_1 "
        f"tensor_crop name=crop ! tensor_filter model=zoo://mobilenet_v2 "
        f"invoke_dynamic=true custom=dynamic_spatial=true ! {codec_tail}")
    runner = nt.PipelineRunner(pipe).start()
    try:
        for i, (f, reg) in enumerate(zip(img, regions)):
            pipe.get("raw").push(TensorBuffer.of(f, pts=i))
            pipe.get("info").push(TensorBuffer.of(reg, pts=i))
        pipe.get("raw").end()
        pipe.get("info").end()
        runner.wait(600)
    finally:
        runner.stop()
    return pipe.get("out").results


def grpc_leg(nt, kernels, frames, res) -> int:
    """B's logits from `tensor_sink_grpc server=true` to `tensor_src_grpc
    server=false` in a second pipeline, or, where grpc is not installed,
    the refusal that names the package. → normalize_u8's launches."""
    from nnstreamer_tpu_torch.core.errors import PipelineError
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    try:
        import grpc  # noqa: F401
    except ImportError:
        print("phase 54: grpc: not installed on this machine; the gRPC "
              "leg is held to JAX on the CPU only")
        el = nt.parse_launch("appsrc name=src dims=1001:1 types=float32 ! "
                             "tensor_sink_grpc name=g port=0").get("g")
        try:
            el.start()
            raised = ""
        except PipelineError as e:
            raised = str(e)
        print(f"phase 54: starting tensor_sink_grpc raises: {raised}")
        res["grpc"] = {"installed": False, "refusal": raised}
        check("grpcio" in raised and "tensor_sink_grpc" in raised,
              f"grpc refusal: {raised!r}")
        return 0
    send = nt.parse_launch(
        f"{APPSRC} ! {NORM_B} ! {MODEL} ! tensor_sink_grpc name=g port=0 "
        f"server=true queue_size={2 * INTEROP_FRAMES}")
    sr = nt.PipelineRunner(send).start()
    rr = None
    try:
        port = send.get("g").bound_port
        recv = nt.parse_launch(
            f"tensor_src_grpc name=in port={port} server=false dims=1001:1 "
            f"types=float32 queue_size={2 * INTEROP_FRAMES} ! tensor_sink "
            f"name=out")
        rr = nt.PipelineRunner(recv).start()
        check(_wait_for(lambda: send.get("g").client_count == 1, 30),
              "grpc: the client never subscribed")
        n0 = kernels.normalize_u8.launches
        t0 = time.perf_counter()
        for i, f in enumerate(frames):
            send.get("src").push(TensorBuffer.of(f, pts=i))
        send.get("src").end()
        sr.wait(600)
        launched = kernels.normalize_u8.launches - n0
        sink = recv.get("out")
        ok = _wait_for(lambda: len(sink.results) >= len(frames), 60)
        wall = time.perf_counter() - t0
        sr.stop()                   # ends the client's stream: its EOS
        rr.wait(60)
    finally:
        sr.stop()
        if rr is not None:
            rr.stop()
    check(ok, f"grpc: {len(sink.results)}/{len(frames)} frames arrived")
    res["grpc"] = {"installed": True, "results": list(sink.results),
                   "launches": launched, "seconds": wall}
    return launched


def interop_phase(nt, torch, card, record) -> int:
    """Phase 54: B's logits through each interop codec (decoder, then
    converter, in one pipeline), a FLEXIBLE frame through each, and over
    gRPC between two pipelines. → normalize_u8's launches on the path."""
    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.runtime import sync
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    res = {"packages": interop_tools()}
    record["interop"] = res
    frames = u8_frames(POOL_SHAPE, INTEROP_FRAMES, 540)
    head = f"{APPSRC} ! {NORM_B} ! {MODEL}"
    run_desc(nt, f"{head} ! tensor_sink name=out", frames[:8])   # warm
    direct, b_wall = timed_run(nt, f"{head} ! tensor_sink name=out", frames)
    check(len(direct) == INTEROP_FRAMES, f"B direct: {len(direct)} frames")
    ref = logits_of(direct)
    b_fps = INTEROP_FRAMES / b_wall
    flex_direct = flexible_leg(nt, torch, "tensor_sink name=out")
    launched = 0
    codecs = {}
    for codec in INTEROP_CODECS:
        desc = (f"{head} ! tensor_decoder name=dec mode={codec} ! "
                f"tensor_converter mode=custom:{codec} ! tensor_sink name=out")
        # traced: the decoder's read-back is the only forced sync a frame
        pipe = nt.parse_launch(desc)
        runner = nt.PipelineRunner(pipe, trace=True)
        n0, f0 = kernels.normalize_u8.launches, sync.forced_sync_count()
        runner.start()
        try:
            t0 = time.perf_counter()
            for i, f in enumerate(frames):
                pipe.get("src").push(TensorBuffer.of(f, pts=i))
            pipe.get("src").end()
            runner.wait(600)
            wall = time.perf_counter() - t0
        finally:
            runner.stop()
        n = kernels.normalize_u8.launches - n0
        forced = sync.forced_sync_count() - f0
        traced = runner.tracer.forced_syncs()
        got = pipe.get("out").results
        # a static stream's rank is not on the wire: (1, 1001) comes back
        # as (1001,), the reference's canonical form (FLEXIBLE keeps it)
        same = sum(
            i < len(got) and got[i].pts == i
            and np.asarray(got[i].tensors[0]).tobytes() == ref[i].tobytes()
            and np.asarray(got[i].tensors[0]).shape == ref[i].shape[1:]
            for i in range(INTEROP_FRAMES))
        flex = flexible_leg(
            nt, torch, f"tensor_decoder mode={codec} ! tensor_converter "
                       f"mode=custom:{codec} ! tensor_sink name=out")
        flex_ok = len(flex) == len(flex_direct) == 3 and all(
            int(a.format) == int(b.format) == 1
            and len(a.tensors) == len(b.tensors)
            and all(np.asarray(p).shape == np.asarray(q).shape == (1, 1001)
                    and np.asarray(p).tobytes() == np.asarray(q).tobytes()
                    for p, q in zip(a.tensors, b.tensors))
            for a, b in zip(flex, flex_direct))
        enc_us, dec_us, frame_bytes = codec_host_us(codec)
        codecs[codec] = {
            "encode_us": enc_us, "decode_us": dec_us,
            "frame_bytes": frame_bytes,
            "arrived": len(got), "bit_for_bit": same, "launches": n,
            "forced_syncs": forced, "traced_syncs": traced,
            "seconds": wall,
            "fps": INTEROP_FRAMES / wall, "flexible_ok": flex_ok,
            "flexible_regions": [len(b.tensors) for b in flex]}
        launched += n
        print(f"phase 54: {codec}: {len(got)}/{INTEROP_FRAMES} frames, "
              f"logits and pts bit for bit B direct's {same}/"
              f"{INTEROP_FRAMES}; normalize_u8 "
              f"+{n}; forced syncs {forced} (traced {traced}); "
              f"{INTEROP_FRAMES / wall:.1f} frames/s first push to last "
              f"result, traced (B direct {b_fps:.1f}); FLEXIBLE crop → "
              f"invoke-dynamic frames through the GstTensorMetaInfo header: "
              f"{[len(b.tensors) for b in flex]} (1, 1001) tensors, bit for "
              f"bit {flex_ok}; host µs a frame: encode {enc_us:.1f}, decode "
              f"{dec_us:.1f} ({frame_bytes} bytes) [{card}]")
        check(len(got) == INTEROP_FRAMES and same == INTEROP_FRAMES
              and n == INTEROP_FRAMES
              and forced == INTEROP_FRAMES
              and traced == {"dec": INTEROP_FRAMES} and flex_ok,
              f"interop {codec}: {codecs[codec]}")
    def attempt():
        from torch.profiler import ProfilerActivity, profile

        n0 = kernels.normalize_u8.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_capture(torch)
            got = run_desc(nt, f"{head} ! tensor_decoder mode=protobuf ! "
                               f"tensor_converter mode=custom:protobuf ! "
                               f"tensor_sink name=out",
                           frames[:INTEROP_PROFILED])
            torch.cuda.synchronize()
            close_capture(torch)
        named = sum("nns_normalize_kernel" in e.name
                    for e in kernel_events(prof))
        n = kernels.normalize_u8.launches - n0
        return {"normalize_u8": n}, {"normalize_u8": named}, (got, n)

    (prof_got, prof_n), tries = profiled_agreement("phase 54", attempt)
    launched += prof_n
    res["profiled"] = {"frames": len(prof_got), "launches": prof_n,
                       "profiled_run": tries}
    print(f"phase 54: protobuf, {INTEROP_PROFILED} frames profiled: "
          f"normalize_u8 {prof_n} launches by the wrapper and by name in "
          f"the profiler (profiled run {tries}) [{card}]")
    check(len(prof_got) == prof_n == INTEROP_PROFILED,
          f"phase 54 profiled: {res['profiled']}")
    # B direct again: the spread of a 64-frame run beside the codecs'
    _, wall = timed_run(nt, f"{head} ! tensor_sink name=out", frames)
    res["codecs"] = codecs
    res["B_fps"] = [b_fps, INTEROP_FRAMES / wall]
    print(f"phase 54: B direct before and after the codecs: "
          f"{b_fps:.1f} / {INTEROP_FRAMES / wall:.1f} frames/s [{card}]")
    n = grpc_leg(nt, kernels, frames, res)
    g = res["grpc"]
    if g["installed"]:
        got = g.pop("results")
        same = sum(np.asarray(b.tensors[0]).tobytes() == ref[i].tobytes()
                   for i, b in enumerate(got[:INTEROP_FRAMES]))
        g.update({"arrived": len(got), "in_order_bit_for_bit": same,
                  "fps": INTEROP_FRAMES / g["seconds"]})
        print(f"phase 54: gRPC tensor_sink_grpc server=true → "
              f"tensor_src_grpc server=false: {len(got)}/{INTEROP_FRAMES} "
              f"frames, in order and bit for bit {same}/{INTEROP_FRAMES}, "
              f"normalize_u8 +{n}, {g['fps']:.1f} frames/s first push to "
              f"last arrival (B direct {b_fps:.1f}) [{card}]")
        check(len(got) == INTEROP_FRAMES and same == INTEROP_FRAMES
              and n == INTEROP_FRAMES, f"grpc leg: {g}")
    print(f"phase 54: packages found: {res['packages']}")
    return launched + n


def train_pipe(nt, model, opt, x_desc, y_dims, accel="", extra=""):
    """x (through the normalize_u8 filter) and labels paired by tensor_mux
    into tensor_trainer → the pipeline (appsrc "x", "y"; sink "out")."""
    acc = f" accelerator={accel}" if accel else ""
    return nt.parse_launch(
        f"appsrc name=x {x_desc} ! {NORM_B}{acc} ! mux.sink_0 "
        f"appsrc name=y dims={y_dims} types=int32 ! mux.sink_1 "
        f"tensor_mux name=mux ! tensor_trainer name=tr model={model} "
        f"optimizer={opt}{acc} {extra} ! tensor_sink name=out")


def train_run(nt, pipe, xs, ys, closed=False, trace=False):
    """Push (x, y) step by step (closed: each step's loss awaited before
    the next push) → (losses, per-step seconds, runner)."""
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    runner = nt.PipelineRunner(pipe, trace=trace).start()
    out = pipe.get("out")
    steps = []
    try:
        for i, (x, y) in enumerate(zip(xs, ys)):
            t0 = time.perf_counter()
            pipe.get("x").push(TensorBuffer.of(x, pts=i))
            pipe.get("y").push(TensorBuffer.of(y, pts=i))
            if closed:
                check(_wait_for(lambda: len(out.results) > i, 120),
                      f"train step {i} never finished")
                steps.append(time.perf_counter() - t0)
        pipe.get("x").end()
        pipe.get("y").end()
        runner.wait(900)
    finally:
        runner.stop()
    return [float(np.asarray(b.tensors[0])[0]) for b in out.results], \
        steps, runner


#: closed-loop steps under torch.profiler
TRAIN_PROFILED = 3


def train_profile(nt, torch, xdesc, x, y) -> dict:
    """TRAIN_PROFILED closed-loop steps of phase 55's pipeline after a
    warm-up step, under torch.profiler → kernels and kernel ms a step,
    wall ms a step, the busy share, the top kernel names, and
    normalize_u8's launches by its wrapper and by name (a capture of
    ~7,000 kernels loses a record now and then, so these two are
    reported, and the audio leg's smaller captures are held to agree)."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    from nnstreamer_tpu_torch.backends import kernels

    pipe = train_pipe(nt, TRAIN_MODEL, f"adam:{TRAIN_LR}", xdesc, len(y))
    runner = nt.PipelineRunner(pipe).start()
    out = pipe.get("out")

    def step(i):
        pipe.get("x").push(TensorBuffer.of(x, pts=i))
        pipe.get("y").push(TensorBuffer.of(y, pts=i))
        check(_wait_for(lambda: len(out.results) > i, 120),
              f"profiled train step {i} never finished")

    try:
        step(0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_capture(torch)
            n0 = kernels.normalize_u8.launches
            t0 = time.perf_counter()
            for i in range(1, 1 + TRAIN_PROFILED):
                step(i)
            wall = time.perf_counter() - t0
            launched = kernels.normalize_u8.launches - n0
            torch.cuda.synchronize()
            close_capture(torch)
        pipe.get("x").end()
        pipe.get("y").end()
        runner.wait(120)
    finally:
        runner.stop()
    evs = kernel_events(prof)
    by = Counter()
    for e in evs:
        by[e.name.split("<")[0].split("(")[0][:48]] += \
            e.time_range.elapsed_us() / 1e3
    kern = sum(by.values())
    named = sum("nns_normalize_kernel" in e.name for e in evs)
    return {"launches": launched, "named": named,
            "kernels_per_step": len(evs) / TRAIN_PROFILED,
            "kernel_ms_per_step": kern / TRAIN_PROFILED,
            "wall_ms_per_step": 1e3 * wall / TRAIN_PROFILED,
            "busy": kern / (1e3 * wall),
            "top": [(k, round(v / TRAIN_PROFILED, 3))
                    for k, v in by.most_common(5)]}


def codec_host_us(codec) -> tuple:
    """Host µs a call of one codec's encode and decode on B's (1, 1001)
    f32 logits (the decoder's and the converter's own work)."""
    import importlib

    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    mod = importlib.import_module(
        f"nnstreamer_tpu_torch.interop.{codec}_codec")
    enc, dec = getattr(mod, f"encode_{codec}"), getattr(mod, f"decode_{codec}")
    buf = TensorBuffer.of(np.random.default_rng(541).standard_normal(
        (1, 1001)).astype(np.float32))
    frame = enc(buf)
    t0 = time.perf_counter()
    for _ in range(CODEC_HOST_CALLS):
        enc(buf)
    t1 = time.perf_counter()
    for _ in range(CODEC_HOST_CALLS):
        dec(frame)
    t2 = time.perf_counter()
    return (1e6 * (t1 - t0) / CODEC_HOST_CALLS,
            1e6 * (t2 - t1) / CODEC_HOST_CALLS, len(frame))


def param_list(trainer):
    from nnstreamer_tpu_torch.parallel.train import leaves

    return [t.detach().float().cpu() for t in leaves(trainer.params)]


def step_agreement(got, want, prev) -> tuple:
    """One sgd step's parameters on the card (`got`) against the CPU's
    (`want`), both from `prev` (state dicts) → (the median over the leaves
    that moved over 1e-2 of the largest movement, and the largest over
    all, of |card − CPU| over the leaf's movement; the worst leaf)."""
    moved = {k: float((want[k] - prev[k]).abs().max()) for k in want}
    floor = 1e-2 * max(moved.values())
    ratio = {k: max(0.0, float((got[k] - want[k]).abs().max())
                    - 2 * float(prev[k].abs().max()) * 2.0 ** -23)
             / max(moved[k], floor) for k in want}
    worst = max(ratio, key=ratio.get)
    return (float(np.median([ratio[k] for k in want if moved[k] > floor])),
            ratio[worst], worst)


def train_card_vs_cpu(nt, torch, card, x8, y8) -> tuple:
    """Phase 55's batch-2 `sgd` arm, TF32 off: TRAIN_CPU_STEPS steps on
    the card and on the CPU from the zoo's params, each writing a
    checkpoint a step; then step 2 on the card from the CPU's step-1
    checkpoint (teacher-forced). Holds the losses at the same params,
    the free-running step 2's loss, and each step's parameters
    (step_agreement) → (#1's launches on the card, the record)."""
    import tempfile

    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
    from nnstreamer_tpu_torch.trainer.element import CHECKPOINT_FILE

    x2, y2 = x8[:TRAIN_CPU_BATCH], y8[:TRAIN_CPU_BATCH]
    xdesc2 = f"dims=3:224:224:{TRAIN_CPU_BATCH} types=uint8"
    launched = 0

    def arm(accel, ck, steps, resume=""):
        nonlocal launched
        extra = f"checkpoint_dir={ck} checkpoint_every=1"
        if resume:
            extra += f" resume_from={resume}"
        pipe = train_pipe(nt, TRAIN_MODEL, TRAIN_CPU_OPT, xdesc2,
                          TRAIN_CPU_BATCH, accel=accel, extra=extra)
        n0 = kernels.normalize_u8.launches
        ls, _, _ = train_run(nt, pipe, [x2] * steps, [y2] * steps)
        if accel != "cpu":
            launched += kernels.normalize_u8.launches - n0
        return ls

    def saved(ck, n):
        blob = torch.load(Path(ck) / f"step_{n}" / CHECKPOINT_FILE,
                          map_location="cpu", weights_only=True)
        return {k: v.float() for k, v in blob["params"].items()}

    card_arm, cpu_arm = TRAIN_ARMS
    with NoTf32(torch), tempfile.TemporaryDirectory() as ck:
        lh = arm(cpu_arm, f"{ck}/cpu", TRAIN_CPU_STEPS)
        lc = arm(card_arm, f"{ck}/card", TRAIN_CPU_STEPS)
        lt = arm(card_arm, f"{ck}/forced", 1, resume=f"{ck}/cpu/step_1")
        start = {k: v.float() for k, v in tm.init_params(
            width=TRAIN_WIDTH, num_classes=TRAIN_CLASSES).state_dict().items()}
        steps = [step_agreement(saved(f"{ck}/card", 1), saved(f"{ck}/cpu", 1),
                                start),
                 step_agreement(saved(f"{ck}/forced", 2),
                                saved(f"{ck}/cpu", 2), saved(f"{ck}/cpu", 1))]
    same = [abs(lc[0] - lh[0]) / abs(lh[0]), abs(lt[0] - lh[1]) / abs(lh[1])]
    free = abs(lc[1] - lh[1]) / abs(lh[1])
    rec = {"optimizer": TRAIN_CPU_OPT, "card_losses": lc, "cpu_losses": lh,
           "forced_step_2_loss": lt, "same_params_loss_rel": same,
           "free_step_2_loss_rel": free,
           "params": [{"median": m, "max": x, "worst_leaf": w}
                      for m, x, w in steps]}
    print(f"phase 55: batch {TRAIN_CPU_BATCH}, {TRAIN_CPU_OPT}, card vs CPU "
          f"from the same params (TF32 off): losses {lc} vs {lh}, step 2 "
          f"from the CPU's step 1 {lt}; rel at the same params "
          f"{[f'{r:.3e}' for r in same]} (limit {TRAIN_SAME_LOSS_REL}), "
          f"free-running step 2 {free:.3e} (limit {TRAIN_FREE_LOSS_REL}); "
          f"parameters, |card − CPU| over each leaf's movement, step 1 and "
          f"step 2 (teacher-forced): median "
          f"{[f'{m:.3e}' for m, _, _ in steps]} (limit {TRAIN_CPU_MEDIAN}), "
          f"largest {[f'{x:.3e}' for _, x, _ in steps]} at "
          f"{[w for _, _, w in steps]} (limit {TRAIN_CPU_MAX}) [{card}]")
    check(len(lc) == len(lh) == TRAIN_CPU_STEPS and len(lt) == 1
          and max(same) <= TRAIN_SAME_LOSS_REL
          and free <= TRAIN_FREE_LOSS_REL
          and all(m <= TRAIN_CPU_MEDIAN and x <= TRAIN_CPU_MAX
                  for m, x, _ in steps),
          f"card vs CPU training: {rec}")
    return launched, rec


def train_phase(nt, torch, card, record) -> int:
    """Phase 55: MobileNetV2 1.0 trained on the card behind normalize_u8
    (x and labels paired by tensor_mux): 8 steps on one seeded batch, the
    loss falls, #1 once a step, one forced sync a step at the trainer,
    checkpoints at 4 and 8; steps 5-8 again from the step-4 checkpoint,
    bit for bit (cuDNN deterministic); batch 2 on the card and on the CPU
    from the same params, TF32 off; the closed-loop step time; then the
    audio classifier with sgd on int16 windows. → #1's launches."""
    import tempfile

    from nnstreamer_tpu_torch.backends import kernels

    res = {}
    record["train"] = res
    rng = np.random.default_rng(550)
    x8 = rng.integers(0, 256, (TRAIN_BATCH, 224, 224, 3), np.uint8)
    y8 = rng.integers(0, 1001, (TRAIN_BATCH,)).astype(np.int32)
    xdesc = f"dims=3:224:224:{TRAIN_BATCH} types=uint8"
    launched = 0
    cudnn = torch.backends.cudnn
    prev = (cudnn.deterministic, cudnn.benchmark)
    with tempfile.TemporaryDirectory() as ck:
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            pipe = train_pipe(nt, TRAIN_MODEL, f"adam:{TRAIN_LR}", xdesc,
                              TRAIN_BATCH, extra=f"checkpoint_dir={ck} "
                              f"checkpoint_every={TRAIN_CKPT_EVERY}")
            n0 = kernels.normalize_u8.launches
            losses, _, runner = train_run(nt, pipe, [x8] * TRAIN_STEPS,
                                          [y8] * TRAIN_STEPS, trace=True)
            n = kernels.normalize_u8.launches - n0
            launched += n
            tr = pipe.get("tr")
            syncs = runner.tracer.forced_syncs()
            full_params = param_list(tr)
            saved = sorted(p.name for p in Path(ck).iterdir())
            resumed = train_pipe(
                nt, TRAIN_MODEL, f"adam:{TRAIN_LR}", xdesc, TRAIN_BATCH,
                extra=f"resume_from={ck}/step_{TRAIN_CKPT_EVERY}")
            n0 = kernels.normalize_u8.launches
            tail, _, _ = train_run(nt, resumed,
                                   [x8] * (TRAIN_STEPS - TRAIN_CKPT_EVERY),
                                   [y8] * (TRAIN_STEPS - TRAIN_CKPT_EVERY))
            launched += kernels.normalize_u8.launches - n0
            rtr = resumed.get("tr")
            res_params = param_list(rtr)
            resume_same = (tail == losses[TRAIN_CKPT_EVERY:] and all(
                torch.equal(a, b) for a, b in zip(full_params, res_params)))
            resume_err = max(float((a - b).abs().max())
                             for a, b in zip(full_params, res_params))
        finally:
            cudnn.deterministic, cudnn.benchmark = prev
    res.update({"losses": losses, "launches": n, "forced_syncs": syncs,
                "checkpoints": saved, "resumed_losses": tail,
                "resumed_steps": rtr.steps, "resume_bitwise": resume_same,
                "resume_max_abs_param_diff": resume_err})
    print(f"phase 55: {TRAIN_MODEL} adam:{TRAIN_LR}, f32, batch "
          f"{TRAIN_BATCH} × 224² uint8 behind normalize_u8, {TRAIN_STEPS} "
          f"steps on one seeded batch: losses "
          f"{[round(l, 4) for l in losses]}; normalize_u8 launches {n}; "
          f"forced syncs {syncs}; checkpoints {saved} [{card}]")
    print(f"phase 55: resume_from step_{TRAIN_CKPT_EVERY}: steps "
          f"{TRAIN_CKPT_EVERY + 1}-{TRAIN_STEPS} losses "
          f"{[round(l, 4) for l in tail]}, = the uninterrupted run's and "
          f"every parameter bit for bit: {resume_same} (max |diff| "
          f"{resume_err}; cudnn.deterministic) [{card}]")
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses))
          and losses[-1] < losses[0] and n == TRAIN_STEPS
          and syncs == {"tr": TRAIN_STEPS} and tr.steps == TRAIN_STEPS
          and saved == [f"step_{TRAIN_CKPT_EVERY}", f"step_{TRAIN_STEPS}"],
          f"training: {res}")
    check(resume_same and rtr.steps == TRAIN_STEPS, f"resume: {res}")

    # batch 2 on the card and on the CPU, from the same params, with sgd
    n, res["cpu"] = train_card_vs_cpu(nt, torch, card, x8, y8)
    launched += n

    # closed loop: step ms and images/s
    pipe = train_pipe(nt, TRAIN_MODEL, f"adam:{TRAIN_LR}", xdesc, TRAIN_BATCH)
    n0 = kernels.normalize_u8.launches
    _, steps, _ = train_run(nt, pipe, [x8] * TRAIN_TIMED,
                            [y8] * TRAIN_TIMED, closed=True)
    launched += kernels.normalize_u8.launches - n0
    ms = sorted(1e3 * s for s in steps[TRAIN_WARM:])
    p50 = float(np.percentile(ms, 50))
    ips = TRAIN_BATCH * len(ms) / (sum(ms) / 1e3)
    res["timing"] = {"step_ms": ms, "step_ms_p50": p50, "images_per_s": ips,
                     "tf32_matmul": bool(torch.backends.cuda.matmul.allow_tf32),
                     "tf32_cudnn": bool(cudnn.allow_tf32)}
    print(f"phase 55: closed loop, {len(ms)} steps after {TRAIN_WARM} "
          f"warm-up (push x and labels → loss on the host): step ms p50 "
          f"{p50:.3f}, {ips:.1f} images/s (TF32 matmul "
          f"{res['timing']['tf32_matmul']}, cuDNN "
          f"{res['timing']['tf32_cudnn']}) [{card}]")
    pr = res["profile"] = train_profile(nt, torch, xdesc, x8, y8)
    launched += pr["launches"]
    print(f"phase 55: {TRAIN_PROFILED} steps profiled (closed loop): "
          f"{pr['kernels_per_step']:.0f} kernels a step, kernel ms a step "
          f"{pr['kernel_ms_per_step']:.3f} of {pr['wall_ms_per_step']:.3f} "
          f"wall (busy {pr['busy']:.3f}); by name: {pr['top']}; "
          f"normalize_u8 launches by the wrapper {pr['launches']}, by name "
          f"{pr['named']} [{card}]")
    check(pr["launches"] == TRAIN_PROFILED, f"profiled steps: {pr}")

    # the audio leg: int16 windows behind normalize_u8, sgd
    xa = rng.normal(0, 3000, (TRAIN_BATCH, AUDIO_WINDOW, 1)).clip(
        -32768, 32767).astype(np.int16)
    ya = rng.integers(0, 12, (TRAIN_BATCH,)).astype(np.int32)
    def attempt():
        from torch.profiler import ProfilerActivity, profile

        pipe = train_pipe(nt, "zoo://audio_classifier?num_classes=12",
                          "sgd:0.05", f"dims=1:{AUDIO_WINDOW}:"
                          f"{TRAIN_BATCH} types=int16", TRAIN_BATCH)
        n0 = kernels.normalize_u8.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            open_capture(torch)
            losses, _, _ = train_run(nt, pipe, [xa] * TRAIN_STEPS,
                                     [ya] * TRAIN_STEPS)
            torch.cuda.synchronize()
            close_capture(torch)
        n = kernels.normalize_u8.launches - n0
        named = sum("nns_normalize_kernel" in e.name
                    for e in kernel_events(prof))
        return {"normalize_u8": n}, {"normalize_u8": named}, (losses, n)

    (al, an), tries = profiled_agreement("phase 55: audio", attempt)
    launched += an
    res["audio"] = {"losses": al, "launches": an, "profiled_run": tries}
    print(f"phase 55: zoo://audio_classifier?num_classes=12 sgd:0.05 on "
          f"({TRAIN_BATCH}, {AUDIO_WINDOW}, 1) int16 windows behind "
          f"normalize_u8: losses {[round(l, 4) for l in al]}, normalize_u8 "
          f"launches {an} by the wrapper and by name in the profiler "
          f"(profiled run {tries}) [{card}]")
    check(len(al) == TRAIN_STEPS and all(np.isfinite(al)) and al[-1] < al[0]
          and an == TRAIN_STEPS, f"audio training: {res['audio']}")
    return launched


def interop_train_phases(nt, torch, card, record, phases,
                         which=("interop", "train")) -> dict:
    """Phases 54-55. → normalize_u8's launches on each path."""
    out = {}
    if "interop" in which:
        out["interop"] = interop_phase(nt, torch, card, record)
        phases.done("54 (B's logits through protobuf, flatbuf, flexbuf and "
                    "gRPC)")
    if "train" in which:
        out["train"] = train_phase(nt, torch, card, record)
        phases.done("55 (MobileNetV2 1.0 and the audio classifier trained "
                    "behind normalize_u8)")
    return out


# -- phases 56-57: the rest of parallel/ (Queue 1 item 6) ---------------------

#: phases 56-57 run on this many logical devices of the card
PAR_DEVICES = 4
#: MD2 (BASELINE row 5's form): the batched server's bucket and dp, its
#: clients and frames a client; its one-card reference serves batches of
#: the per-shard size. Where the two are not bit for bit (cuDNN may take
#: another algorithm at another batch: a shard of a 2-row flush runs 1
#: row where the one-card server pads to 4), each reply is held within
#: MD2_REL of max |logit|; MD2_TIMED frames a client in each timing arm
MD2_BUCKET, MD2_DP, MD2_CLIENTS, MD2_FRAMES = 8, 2, 4, 16
MD2_REL, MD2_TIMED = 1e-5, 16
#: frames a client of MD2's profiled run (#1's launches by the wrapper
#: against the profiler's records; reading a trace takes seconds)
MD2_PROF_FRAMES = 4
#: TRS: tensor_trainer's mesh, batch and optimizer (TF32 off), and the
#: closed-loop steps timed after one warm-up step, in each arm
TRS_MESH, TRS_BATCH, TRS_OPT, TRS_TIMED = "dp=2,tp=2", 8, "sgd:0.01", 3
#: PP: stages (one a logical device), microbatches and their shape, the
#: MLP's width (bench.py:1154: d_model 1024, d_ff 4096); the pipeline
#: against the serial fold where not bit for bit
PP_STAGES, PP_MICRO, PP_SHAPE, PP_FF, PP_REL = 4, 8, (2, 2048, 1024), 4096, \
    1e-5
#: MOE: d_model, hidden, experts over ep devices, tokens; against
#: reference_moe
MOE_D, MOE_H, MOE_E, MOE_EP, MOE_T, MOE_REL = 1024, 4096, 8, 4, 16384, 1e-5
#: DRY: the ring's local block in dryrun_multichip (a multiple of 128,
#: so each ring step runs flash_block_update's kernel)
DRY_BLOCK = 128
#: MH2: logical devices of each of the two processes
MH2_DEVICES = 2
#: the names of both flash_block_update kernels (bf16 and f32)
FLASH_BLOCK_SYMBOL = "nns_flash_block_"


def md2_servers(nt, torch, model, sid):
    """(MD2's server: dp MD2_DP over the first logical devices, bucket
    MD2_BUCKET; the one-card server of the per-shard bucket), each with
    normalize_u8 as `pre` on uint8 224² frames."""
    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.edge import BatchedQueryServer
    from nnstreamer_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from nnstreamer_tpu_torch.serving.placement import accelerator_for
    from nnstreamer_tpu_torch.tensor.dtypes import DType
    from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

    u8 = TensorsSpec.of(TensorInfo((1, 224, 224, 3), DType.UINT8))
    md2 = BatchedQueryServer(model, sid=sid, bucket=MD2_BUCKET,
                             max_delay_ms=2.0, pre=kernels.normalize_u8,
                             in_spec=u8, mesh=make_mesh(MeshSpec(dp=MD2_DP)))
    one = BatchedQueryServer(model, sid=sid + 1,
                             bucket=MD2_BUCKET // MD2_DP, max_delay_ms=2.0,
                             pre=kernels.normalize_u8, in_spec=u8,
                             accelerator=accelerator_for(0))
    return md2, one


def md2_phase(nt, torch, card, res) -> int:
    """MD2: BatchedQueryServer over dp 2 of the card's logical devices
    against the one-card server of bucket 4, f32 with TF32 off, 4 clients
    x 16 frames; then both in bf16 in turns a b b a. → #1's launches."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.backends import kernels

    def frames_of(c):
        return u8_frames((1, 224, 224, 3), MD2_FRAMES, 560 + c)

    t0 = time.perf_counter()
    with NoTf32(torch):
        md2, one = md2_servers(nt, torch, "zoo://mobilenet_v2?dtype=float32",
                               4560)
        try:
            ref = q2_clients(nt, one.port, frames_of, MD2_CLIENTS)
            n0, s0 = kernels.normalize_u8.launches, md2.stats()
            got = q2_clients(nt, md2.port, frames_of, MD2_CLIENTS)
            launched = kernels.normalize_u8.launches - n0
            s1 = md2.stats()
            shard = [b - a for a, b in zip(s0["shard_batches"],
                                           s1["shard_batches"])]
            batches = s1["batches"] - s0["batches"]
            moved = s1["transfers"] - s0["transfers"]

            def attempt():
                n0 = kernels.normalize_u8.launches
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    open_capture(torch)
                    q2_clients(nt, md2.port,
                               lambda c: frames_of(c)[:MD2_PROF_FRAMES],
                               MD2_CLIENTS)
                    torch.cuda.synchronize()
                    close_capture(torch)
                named = sum("nns_normalize_kernel" in e.name
                            for e in kernel_events(prof))
                n = kernels.normalize_u8.launches - n0
                return {"normalize_u8": n}, {"normalize_u8": named}, n

            profiled, tries = profiled_agreement("phase 56: MD2", attempt)
            st = md2.stats()
        finally:
            md2.close()
            one.close()
    same = sum(int(np.array_equal(a, b)) for c in got
               for a, b in zip(got[c][0], ref[c][0]))
    err = max(float(np.abs(got[c][0] - ref[c][0]).max()
                    / np.abs(ref[c][0]).max()) for c in got)
    routed = all(got[c][1] == list(range(MD2_FRAMES)) for c in got)
    frames = MD2_CLIENTS * MD2_FRAMES
    res["MD2"] = {"clients": MD2_CLIENTS, "frames": frames,
                  "batches": batches, "shard_batches": shard,
                  "normalize_launches": launched, "profiled_run": tries,
                  "profiled_launches": profiled,
                  "transfers": moved, "bit_for_bit_frames": same,
                  "max_rel_err": err, "routed_in_order": routed,
                  "admitted": st["admitted"], "replied": st["replied"]}
    print(f"phase 56: MD2 BatchedQueryServer(bucket {MD2_BUCKET}, mesh dp "
          f"{MD2_DP} of {PAR_DEVICES} logical devices, pre = normalize_u8 "
          f"on each shard's rows), f32, TF32 off, {MD2_CLIENTS} clients x "
          f"{MD2_FRAMES} frames: {batches} batches, per device {shard}, "
          f"normalize_u8 launched {launched} times, {moved} copies between "
          f"logical devices; {MD2_CLIENTS} x {MD2_PROF_FRAMES} frames "
          f"profiled: {profiled} launches by the wrapper and by name "
          f"(profiled run {tries}); against the one-card server of bucket "
          f"{MD2_BUCKET // MD2_DP}: {same}/{frames} replies bit for bit, the "
          f"largest difference {err:.3e} of max |logit| (limit {MD2_REL}); "
          f"routed in pts order {routed} [{card}]")
    check(launched == sum(shard) == batches * MD2_DP
          and shard == [batches] * MD2_DP and 0 < batches < frames
          and err <= MD2_REL and routed
          and st["admitted"] == st["replied"], f"MD2: {res['MD2']}")

    # bf16: MD2 and the one-card Q2 (bucket 8) in turns a b b a
    from nnstreamer_tpu_torch.edge import BatchedQueryServer
    from nnstreamer_tpu_torch.serving.placement import accelerator_for
    from nnstreamer_tpu_torch.tensor.dtypes import DType
    from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

    t1 = time.perf_counter()
    frame = u8_frames((1, 224, 224, 3), 1, 561)[0]
    md2, spare = md2_servers(nt, torch, "zoo://mobilenet_v2", 4562)
    spare.close()
    q2 = BatchedQueryServer(
        "zoo://mobilenet_v2", sid=4564, bucket=MD2_BUCKET, max_delay_ms=2.0,
        pre=kernels.normalize_u8, accelerator=accelerator_for(0),
        in_spec=TensorsSpec.of(TensorInfo((1, 224, 224, 3), DType.UINT8)))
    arms = {"MD2": md2, "Q2": q2}
    out = {k: [] for k in arms}
    n0 = kernels.normalize_u8.launches
    try:
        for srv in arms.values():
            q2_clients(nt, srv.port, lambda c: [frame] * 8, MD2_CLIENTS,
                       in_flight=8)
        for name in ("MD2", "Q2", "Q2", "MD2"):
            start = time.perf_counter()
            g = q2_clients(nt, arms[name].port,
                           lambda c: [frame] * MD2_TIMED, MD2_CLIENTS,
                           in_flight=8)
            wall = time.perf_counter() - start
            lat = [ms for v in g.values() for ms in v[2]]
            out[name].append({"fps": MD2_CLIENTS * MD2_TIMED / wall,
                              "p50_ms": float(np.percentile(lat, 50))})
        shard = md2.stats()["shard_batches"]
    finally:
        md2.close()
        q2.close()
    timed = kernels.normalize_u8.launches - n0
    res["MD2_timing"] = out
    for name, runs in out.items():
        print(f"phase 56: {name} bf16, {MD2_CLIENTS} clients x {MD2_TIMED} "
              f"frames (in flight 8 each): " + " / ".join(
                  f"{r['fps']:.1f} frames/s, p50 {r['p50_ms']:.3f} ms"
                  for r in runs) + f" [{card}]")
    print(f"phase 56: MD2 bf16 batches per device {shard}; "
          f"{t1 - t0:.2f} s for the f32 arms, "
          f"{time.perf_counter() - t1:.2f} s for the bf16 ones")
    return launched + profiled + timed


def placed_bytes(torch, state) -> dict:
    """Bytes of a sharded train state's master leaves and their optimizer
    state on each logical device (by the tp devices' ordinals)."""
    sp = state.params
    out = {o: 0 for o in sp.ordinals}
    for leaf in sp.placed.values():
        for i, p in enumerate(leaf["parts"]):
            o = sp.ordinals[i if leaf["dim"] is not None else 0]
            out[o] += sum(t.numel() * t.element_size() for t in
                          [p, *state.opt_state.state.get(p, {}).values()]
                          if isinstance(t, torch.Tensor))
    return out


def trs_phase(nt, torch, card, res) -> int:
    """TRS: x behind normalize_u8 and the labels, paired by tensor_mux,
    into tensor_trainer over a dp 2 x tp 2 mesh (MobileNetV2 1.0, f32,
    TF32 off, batch 8, sgd 0.01), against the one-device trainer on the
    card: step 1 from the zoo's params, step 2 from the mesh's step-1
    checkpoint (teacher-forced); a control with per-shard BN statistics;
    step ms of both arms; placed bytes per logical device. → #1's
    launches."""
    import contextlib
    import tempfile

    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.models import layers
    from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
    from nnstreamer_tpu_torch.trainer.element import CHECKPOINT_FILE

    rng = np.random.default_rng(565)
    x8 = rng.integers(0, 256, (TRS_BATCH, 224, 224, 3), np.uint8)
    y8 = rng.integers(0, 1001, (TRS_BATCH,)).astype(np.int32)
    xdesc = f"dims=3:224:224:{TRS_BATCH} types=uint8"
    n0 = kernels.normalize_u8.launches

    def arm(ck, steps, mesh="", resume="", closed=False):
        extra = f"checkpoint_dir={ck} checkpoint_every=1" if ck else ""
        if mesh:
            extra += f" mesh={mesh}"
        if resume:
            extra += f" resume_from={resume}"
        pipe = train_pipe(nt, TRAIN_MODEL, TRS_OPT, xdesc, TRS_BATCH,
                          extra=extra)
        losses, secs, _ = train_run(nt, pipe, [x8] * steps, [y8] * steps,
                                    closed=closed)
        return losses, secs, pipe.get("tr")

    def saved(ck, n):
        blob = torch.load(Path(ck) / f"step_{n}" / CHECKPOINT_FILE,
                          map_location="cpu", weights_only=True)
        return {k: v.float() for k, v in blob["params"].items()}

    t0 = time.perf_counter()
    with NoTf32(torch), tempfile.TemporaryDirectory() as ck:
        torch.cuda.reset_peak_memory_stats()
        lm, _, tr = arm(f"{ck}/mesh", 2, mesh=TRS_MESH)
        peak = torch.cuda.max_memory_allocated()
        placed = placed_bytes(torch, tr._state)
        lo, _, _ = arm(f"{ck}/one", 2)
        lf, _, _ = arm(f"{ck}/forced", 1, resume=f"{ck}/mesh/step_1")
        saved_bn = layers.batch_stats
        layers.batch_stats = lambda reduce: contextlib.nullcontext()
        try:
            lc, _, _ = arm(f"{ck}/ctrl", 1, mesh=TRS_MESH)
        finally:
            layers.batch_stats = saved_bn
        start = {k: v.float() for k, v in tm.init_params(
            width=TRAIN_WIDTH, num_classes=TRAIN_CLASSES).state_dict().items()}
        steps = [step_agreement(saved(f"{ck}/mesh", 1), saved(f"{ck}/one", 1),
                                start),
                 step_agreement(saved(f"{ck}/mesh", 2),
                                saved(f"{ck}/forced", 2),
                                saved(f"{ck}/mesh", 1))]
        ctrl = step_agreement(saved(f"{ck}/ctrl", 1), saved(f"{ck}/one", 1),
                              start)
        t1 = time.perf_counter()
        timing = {}
        for name, mesh in (("mesh", TRS_MESH), ("one", ""), ("one", ""),
                           ("mesh", TRS_MESH)):
            _, secs, _ = arm("", TRS_TIMED + 1, mesh=mesh, closed=True)
            timing.setdefault(name, []).extend(1e3 * s for s in secs[1:])
    t2 = time.perf_counter()
    launched = kernels.normalize_u8.launches - n0
    same = [abs(lm[0] - lo[0]) / abs(lo[0]), abs(lm[1] - lf[0]) / abs(lf[0])]
    p50 = {k: float(np.percentile(v, 50)) for k, v in timing.items()}
    res["TRS"] = {"mesh": TRS_MESH, "optimizer": TRS_OPT, "mesh_losses": lm,
                  "one_device_losses": lo, "forced_step_2_loss": lf,
                  "same_params_loss_rel": same, "control_loss": lc,
                  "params": [{"median": m, "max": x, "worst_leaf": w}
                             for m, x, w in steps],
                  "control": {"median": ctrl[0], "max": ctrl[1]},
                  "placed_bytes_by_logical_device": placed,
                  "peak_memory_allocated": peak, "step_ms": timing,
                  "step_ms_p50": p50, "normalize_launches": launched,
                  "seconds": {"arms": t1 - t0, "timing": t2 - t1}}
    print(f"phase 56: TRS tensor_trainer mesh={TRS_MESH} ({TRAIN_MODEL}, "
          f"f32, TF32 off, batch {TRS_BATCH}, {TRS_OPT}) against the "
          f"one-device trainer on the card: losses {lm} vs {lo}, step 2 from "
          f"the mesh's step 1 {lf}; rel at the same params "
          f"{[f'{r:.3e}' for r in same]} (limit {TRAIN_SAME_LOSS_REL}); "
          f"parameters over each leaf's movement, step 1 and step 2: median "
          f"{[f'{m:.3e}' for m, _, _ in steps]} (limit {TRAIN_CPU_MEDIAN}), "
          f"largest {[f'{x:.3e}' for _, x, _ in steps]} at "
          f"{[w for _, _, w in steps]} (limit {TRAIN_CPU_MAX}); control "
          f"(per-shard BN statistics): loss {lc}, median {ctrl[0]:.3e}, "
          f"largest {ctrl[1]:.3e} [{card}]")
    print(f"phase 56: TRS placed bytes (params and moments) by logical "
          f"device {placed}; the card's peak memory_allocated in the mesh "
          f"arm {peak / 2**20:.1f} MiB; closed-loop step ms p50: mesh "
          f"{p50['mesh']:.3f}, one device {p50['one']:.3f} (turns a b b a, "
          f"{TRS_TIMED} timed steps a turn); normalize_u8 launches "
          f"{launched}; {t1 - t0:.2f} s for the five arms, {t2 - t1:.2f} s "
          f"for the timing [{card}]")
    check(len(lm) == len(lo) == 2 and len(lf) == 1
          and max(same) <= TRAIN_SAME_LOSS_REL
          and all(m <= TRAIN_CPU_MEDIAN and x <= TRAIN_CPU_MAX
                  for m, x, _ in steps)
          and ctrl[0] > TRAIN_CPU_MEDIAN
          and launched == 2 + 2 + 1 + 1 + 4 * (TRS_TIMED + 1),
          f"TRS: {res['TRS']}")
    return launched


def pp_phase(torch, dev, card, res) -> None:
    """PP: PP_STAGES residual MLP stages (the transformer's rmsnorm and
    _mlp at d_model 1024, d_ff 4096) on as many logical devices, f32 with
    TF32 off, PP_MICRO microbatches: against reference_pipeline; ms per
    forward, pipelined and serial."""
    from nnstreamer_tpu_torch.models.transformer import _mlp, rmsnorm
    from nnstreamer_tpu_torch.parallel import (
        pipeline_apply, stack_stage_params)
    from nnstreamer_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from nnstreamer_tpu_torch.parallel.pipeline import (
        PIPELINE_MOVES, reference_pipeline)

    gen = torch.Generator().manual_seed(570)
    d = PP_SHAPE[-1]
    stages = [{"ln": (1 + 0.1 * torch.randn(d, generator=gen)).to(dev),
               "wi": (torch.randn(d, 2 * PP_FF, generator=gen)
                      * d ** -0.5).to(dev),
               "wd": (torch.randn(PP_FF, d, generator=gen)
                      * PP_FF ** -0.5).to(dev)}
              for _ in range(PP_STAGES)]

    def stage(p, a):
        return a + _mlp(p, rmsnorm(a, p["ln"]), a.dtype)

    x = torch.randn((PP_MICRO,) + PP_SHAPE, generator=gen).to(dev)
    mesh = make_mesh(MeshSpec(dp=1, pp=PP_STAGES))
    stacked = stack_stage_params(stages)
    with NoTf32(torch):
        m0 = PIPELINE_MOVES.count
        out = pipeline_apply(stage, stacked, x, mesh=mesh)
        moved = PIPELINE_MOVES.count - m0
        ref = reference_pipeline(stage, stages, x)
        same = torch.equal(out, ref)
        err = float((out - ref).abs().max() / ref.abs().max())
        ms = event_ms_per_call(
            torch, lambda: pipeline_apply(stage, stacked, x, mesh=mesh), 3)
        ms_serial = event_ms_per_call(
            torch, lambda: reference_pipeline(stage, stages, x), 3)
    res["PP"] = {"stages": PP_STAGES, "micro": PP_MICRO,
                 "shape": list(PP_SHAPE), "bit_for_bit": same,
                 "max_rel_err": err, "copies": moved, "ms": ms,
                 "serial_ms": ms_serial}
    print(f"phase 57: PP {PP_STAGES} stages on {PP_STAGES} logical devices, "
          f"{PP_MICRO} microbatches of {PP_SHAPE} f32 (TF32 off), residual "
          f"rmsnorm + MLP (d_ff {PP_FF}): bit for bit reference_pipeline "
          f"{same} (max rel {err:.3e}), {moved} copies between stages; "
          f"{ms:.3f} ms a forward pipelined, {ms_serial:.3f} ms serial "
          f"[{card}]")
    check(same or err <= PP_REL, f"PP: {res['PP']}")


def moe_phase(torch, dev, card, res) -> None:
    """MOE: E 8 over ep 4, T 16,384 tokens of d 1024 (hidden 4096): f32
    with ample capacity against reference_moe; at capacity factor 1.25
    the dropped tokens are `_route`'s per shard, their rows exactly zero,
    the kept rows against reference_moe; bf16 ms a layer."""
    from nnstreamer_tpu_torch.parallel import init_moe_params, moe_apply
    from nnstreamer_tpu_torch.parallel import moe as pm
    from nnstreamer_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(dp=1, ep=MOE_EP))
    params = init_moe_params(torch.Generator().manual_seed(571), MOE_D,
                             MOE_H, MOE_E, device=dev)
    # tokens share a direction (as a layer's inputs do), so the router
    # favours some experts and capacity 1.25 drops tokens
    gen = torch.Generator().manual_seed(572)
    x = (torch.randn(MOE_T, MOE_D, generator=gen)
         + torch.randn(MOE_D, generator=gen)).to(dev)
    t_local = MOE_T // MOE_EP
    cap = max(1, int(np.ceil(1.25 * t_local / MOE_E)))
    with NoTf32(torch):
        ref = pm.reference_moe(params, x)
        scale = float(ref.abs().max())
        ample = moe_apply(params, x, mesh=mesh, capacity_factor=float(MOE_E))
        err_ample = float((ample - ref).abs().max()) / scale
        tight = moe_apply(params, x, mesh=mesh, capacity_factor=1.25)
        keep = torch.cat([pm._route(x[i * t_local:(i + 1) * t_local],
                                    params["gate"], MOE_E, cap)[2]
                          for i in range(MOE_EP)])
        dropped = int((~keep).sum())
        zero = bool((tight[~keep] == 0).all())
        live = bool((tight[keep] != 0).any(dim=1).all())
        err_tight = float((tight[keep] - ref[keep]).abs().max()) / scale
        del ref, ample, tight
    pb = {k: v.to(torch.bfloat16) for k, v in params.items()}
    xb = x.to(torch.bfloat16)
    ms = event_ms_per_call(
        torch, lambda: moe_apply(pb, xb, mesh=mesh, capacity_factor=1.25), 5)
    res["MOE"] = {"tokens": MOE_T, "experts": MOE_E, "ep": MOE_EP,
                  "capacity": cap, "ample_max_rel_err": err_ample,
                  "dropped": dropped, "dropped_rows_zero": zero,
                  "kept_rows_nonzero": live, "kept_max_rel_err": err_tight,
                  "bf16_ms": ms}
    print(f"phase 57: MOE E {MOE_E} on ep {MOE_EP}, T {MOE_T} x d {MOE_D} "
          f"(hidden {MOE_H}), f32, TF32 off: ample capacity within "
          f"{err_ample:.3e} of max |reference_moe| (limit {MOE_REL}); "
          f"capacity factor 1.25 (C {cap}): {dropped} tokens dropped, the "
          f"ones _route drops per shard, their rows exactly zero {zero}, "
          f"every kept row live {live} and within {err_tight:.3e}; bf16 "
          f"{ms:.3f} ms a layer [{card}]")
    check(err_ample <= MOE_REL and err_tight <= MOE_REL and zero and live
          and 0 < dropped < MOE_T, f"MOE: {res['MOE']}")


def dry_phase(nt, torch, card, res) -> int:
    """DRY: dryrun_multichip(PAR_DEVICES) on the card, the ring's block
    DRY_BLOCK, so every ring step (the sp ring and the composed forward's)
    launches flash_block_update: wrapper = profiler. → #6's launches."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.parallel.dryrun import dryrun_multichip

    fb = kernels.flash_block_update

    def attempt():
        n0 = fb.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_capture(torch)
            out = dryrun_multichip(PAR_DEVICES, block=DRY_BLOCK)
            torch.cuda.synchronize()
            close_capture(torch)
        named = sum(FLASH_BLOCK_SYMBOL in e.name for e in kernel_events(prof))
        n = fb.launches - n0
        return ({"flash_block_update": n}, {"flash_block_update": named},
                (out, n))

    (out, n), tries = profiled_agreement("phase 57: DRY", attempt)
    c = out["composed"]
    res["DRY"] = {"train": out["train"], "ring": out["ring"],
                  "pipeline": out["pipeline"], "moe": out["moe"],
                  "composed": {"shape": c["shape"],
                               "max_abs_err": c["max_abs_err"]},
                  "flash_block_launches": n, "profiled_run": tries}
    ring = out["ring"]
    print(f"phase 57: DRY dryrun_multichip({PAR_DEVICES}) on the card (ring "
          f"block {DRY_BLOCK}): train dp {out['train']['dp']} x tp "
          f"{out['train']['tp']} loss {out['train']['loss']:.5f}; sp ring "
          f"{ring['shape']} max_abs_err {ring['max_abs_err']:.3e} (limit "
          f"{ring['limit']:.3e}); pipeline bit for bit "
          f"{out['pipeline']['bit_for_bit']}; composed {c['shape']} "
          f"max_abs_err {c['max_abs_err']:.3e} (limit 5e-4); "
          f"flash_block_update launched {n} times by the wrapper and by name "
          f"(profiled run {tries}) [{card}]")
    check(n > 0 and ring["max_abs_err"] <= ring["limit"]
          and c["max_abs_err"] < 5e-4, f"DRY: {res['DRY']}")
    return n


def mh2_start():
    """MH2's two processes (multihost_check.py, gloo, MH2_DEVICES logical
    devices each on the card), started → the processes."""
    import os

    port = free_tcp_port()
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    script = ROOT / "nnstreamer_tpu_torch" / "tools" / "multihost_check.py"
    return [subprocess.Popen(
        [sys.executable, str(script), str(pid),
         f"127.0.0.1:{port}", "--backend", "gloo", "--devices",
         str(MH2_DEVICES)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]


def free_tcp_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def mh2_finish(procs, card, res) -> None:
    """MH2: both processes' results: the cross-process sum exact, the
    train step within 1e-5 of the serial numpy step, one loss."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            check(p.returncode == 0, f"MH2 process failed:\n{err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res["MH2"] = outs
    print(f"phase 57: MH2 two processes, gloo, {MH2_DEVICES} logical devices "
          f"each on the card, a dp {2 * MH2_DEVICES} global mesh: sums "
          f"{[o['sum'] for o in outs]} (exact: {3.0 * MH2_DEVICES}), one "
          f"train step against the serial numpy step: max |err| "
          f"{[o['err'] for o in outs]} (limit 1e-5), losses "
          f"{[o['loss'] for o in outs]}, copies between logical devices "
          f"{[o['transfers'] for o in outs]}, devices {outs[0]['devices']}, "
          f"jax-free {[o['jax_free'] for o in outs]} [{card}]")
    check(len(outs) == 2 and all(o["sum"] == 3.0 * MH2_DEVICES
                                 and o["err"] < 1e-5 and o["jax_free"]
                                 for o in outs)
          and outs[0]["loss"] == outs[1]["loss"], f"MH2: {outs}")


def parallel_phases(nt, torch, card, record, phases) -> tuple:
    """Phases 56-57 on PAR_DEVICES logical devices of the card ([parallel]
    virtual_devices, restored after). → (#1's launches by cell, #6's)."""
    import os

    res = {}
    record["parallel"] = res
    dev = torch.device("cuda", 0)
    old = os.environ.get(VIRTUAL_ENV)
    os.environ[VIRTUAL_ENV] = str(PAR_DEVICES)
    try:
        md2 = md2_phase(nt, torch, card, res)
        trs = trs_phase(nt, torch, card, res)
        phases.done("56 (mesh dispatch MD2 and sharded training TRS)")
        # MH2's processes start first: their start-up overlaps the rest
        procs = mh2_start()
        try:
            dry = dry_phase(nt, torch, card, res)
            pp_phase(torch, dev, card, res)
            moe_phase(torch, dev, card, res)
        finally:
            mh2_finish(procs, card, res)
        phases.done("57 (pipeline, MoE, dryrun, multi-host)")
    finally:
        if old is None:
            os.environ.pop(VIRTUAL_ENV)
        else:
            os.environ[VIRTUAL_ENV] = old
    return {"MD2": md2, "TRS": trs}, dry


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="On-card smoke test of the PyTorch/CUDA port (phases "
                    "in the module docstring).")
    ap.add_argument(
        "--slice6", action="store_true",
        help="run phases 1, 2 and 24-26 only (the traced, fault-tolerant "
             "runtime over A/B and LLM serving)")
    ap.add_argument(
        "--batching", action="store_true",
        help="run phases 1, 2, 27 and 28 only (B micro-batched, the filter "
             "properties and FLEXIBLE invokes)")
    ap.add_argument(
        "--window", action="store_true",
        help="run phases 1, 2, 29 and 30 only (compiled windows: vision "
             "pipelines and the LLM decode window)")
    ap.add_argument(
        "--modelio", action="store_true",
        help="run phases 1, 2 and 31-38 only (model-file ingestion: "
             "TFLite float, int8-native and WHILE, .npz; GraphDef with the "
             "audio front end, Caffe, Caffe2, UFF, DLC, RTM; TorchScript "
             "legacy and modern; the image_segment, direct_video and "
             "octet_stream decoders; item 2's CPU-only files on the card)")
    ap.add_argument(
        "--elements", action="store_true",
        help="run phases 1, 2, 39 and 40 only (tee, queue, tensor_resize, "
             "tensor_rate, tensor_if, join, split/merge, the aggregator, "
             "the repo loop, filesrc/filesink, tensor_sink to-host=false)")
    ap.add_argument(
        "--streaming", action="store_true",
        help="run phases 1, 2, 41 and 42 only (zoo://lstm in a repo loop, "
             "zoo://audio_classifier, the custom and python3 backends, the "
             "script codecs; the wire format, ipc, tensor_src_iio and the "
             "prefetching input)")
    ap.add_argument(
        "--serving", action="store_true",
        help="run phases 1, 2, 43 and 44 only (store:// on the vision "
             "filter: canary, hot swap, the bucket manifest; the query "
             "edge: tensor_query_*, BUSY, hybrid discovery, the batched "
             "query server)")
    ap.add_argument(
        "--pool", action="store_true",
        help="run phases 1, 2, 45 and 46 only (pipeline B in supervised "
             "pool workers: the shm lane, SIGKILL, swap, drain; the "
             "autotuner and /metrics on the live pool; timings)")
    ap.add_argument(
        "--placement", action="store_true",
        help="run phases 1, 2 and 47-49 only (B's model filter as replicas "
             "and dense shards on logical devices, B's model as a two-filter "
             "device segment and its plan, the device profiler and the "
             "flight recorder)")
    ap.add_argument(
        "--mesh", action="store_true",
        help="run phases 1, 2, 50 and 51 only (pipeline B from a two-host "
             "serving mesh through a partition and a swap; the llm "
             "subcommand)")
    ap.add_argument(
        "--traffic", action="store_true",
        help="run phases 1, 2, 52 and 53 only (pipeline B flooded open "
             "loop by the traffic subcommand; B's logits over the broker: "
             "MQTT, the edge protocol, edgesink/edgesrc)")
    ap.add_argument(
        "--interop", action="store_true",
        help="run phases 1, 2 and 54 only (B's logits through the "
             "protobuf, flatbuf and flexbuf codecs and over gRPC)")
    ap.add_argument(
        "--train", action="store_true",
        help="run phases 1, 2 and 55 only (MobileNetV2 1.0 and the audio "
             "classifier trained behind normalize_u8)")
    ap.add_argument(
        "--parallel", action="store_true",
        help="run phases 1, 2, 56 and 57 only (the rest of parallel/ on "
             "logical devices of the card: the mesh dispatcher, sharded "
             "training, the pipeline, MoE, the dryrun, two processes)")
    ap.add_argument(
        "--slice4", action="store_true",
        help="run phases 1, 2 and 20-23 only (the ring step, ring "
             "attention and sharded serving), e.g. on a four-card machine, "
             "where virtual_devices=4 puts one shard on each card")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the card and has nothing to "
              "do without one", file=sys.stderr)
        return 2
    if not (ROOT / "nnstreamer_tpu_torch").is_dir():
        print(f"chip_smoke: no nnstreamer_tpu_torch package beside "
              f"{__file__}; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.backends import cuda_build

    record = {}
    phases = Phases()
    # -- 1. environment ---------------------------------------------------
    card = sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader").splitlines()[0]
    nvcc = cuda_build.find_nvcc()
    print(f"phase 1: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, torch CUDA {torch.version.cuda}, "
          f"{sh(nvcc, '--version').splitlines()[-1]}, device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"phase 1: card: {card}")
    print(f"phase 1: packages JAX's interop and trainer import, found "
          f"here: {interop_tools()}")
    record["card"] = card
    phases.done("1 (environment)")

    # -- 2. build -----------------------------------------------------------
    # one nvcc per source, all started together
    t0 = time.perf_counter()
    sources = ("normalize.cu", "paged_attn.cu", "quantize_rows.cu",
               "flash_attn.cu", "flash_attn_tc.cu", "clamp_scale.cu")
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(cuda_build.build, sources))
    build_s = time.perf_counter() - t0
    for lib in libs:
        ptxas = [l.strip() for l in lib.with_suffix(".log").read_text()
                 .splitlines() if "registers" in l or "spill" in l]
        print(f"phase 2: built {lib.name}")
        for line in ptxas:
            print(f"phase 2: ptxas: {line}")
    print(f"phase 2: built {len(libs)} kernel libraries in {build_s:.2f} s "
          f"(in parallel)")
    record["build_s"] = build_s
    phases.done("2 (build)")

    if args.slice4:
        ctx = {}
        llm_model(ctx)
        entries = slice4_phases(nt, torch, card, record, phases, ctx)
    elif args.slice6:
        ctx = {}
        llm_model(ctx)
        slice6_phases(nt, torch, card, record, phases, ctx)
        entries = []
    elif args.batching:
        batching_phases(nt, torch, card, record, phases)
        entries = []
    elif args.window:
        window_phases(nt, torch, card, record, phases, {})
        entries = []
    elif args.modelio:
        modelio_phases(nt, torch, card, record, phases)
        entries = []
    elif args.elements:
        elements_phases(nt, torch, card, record, phases)
        entries = []
    elif args.streaming:
        streaming_phases(nt, torch, card, record, phases)
        entries = []
    elif args.serving:
        serving_phases(nt, torch, card, record, phases)
        entries = []
    elif args.pool:
        pool_phases(nt, torch, card, record, phases)
        entries = []
    elif args.placement:
        placement_phases(nt, torch, card, record, phases)
        entries = []
    elif args.mesh:
        mesh_phases(nt, torch, card, record, phases)
        entries = []
    elif args.traffic:
        traffic_phases(nt, torch, card, record, phases)
        entries = []
    elif args.parallel:
        parallel_phases(nt, torch, card, record, phases)
        entries = []
    elif args.interop or args.train:
        interop_train_phases(
            nt, torch, card, record, phases,
            which=("interop",) * args.interop + ("train",) * args.train)
        entries = []
    else:
        # -- 3-6. normalize_u8, pipelines A and B ------------------------
        entries = slice1_phases(nt, torch, card, record, phases)
        # -- 7-10. paged attention and LLM serving -------------------------
        ctx = {}
        entries += llm_phases(nt, torch, card, record, phases, ctx)
        # -- 11-15. W8A8 serving and the full-sequence forward -----------
        entries += slice3_phases(nt, torch, card, record, phases, ctx)
        # -- 16-19. clamp_scale, detection, pose, composite ---------------
        entries += slice5_phases(nt, torch, card, record, phases)
        # -- 20-23. the ring step, ring attention, sharded serving -------
        entries += slice4_phases(nt, torch, card, record, phases, ctx)
        # -- 24-26. the traced, fault-tolerant host runtime -------------
        slice6_phases(nt, torch, card, record, phases, ctx)
        # -- 27-28. micro-batching, filter properties, FLEXIBLE --------
        batching_phases(nt, torch, card, record, phases)
        # -- 29-30. compiled windows, the LLM decode window --------------
        window_phases(nt, torch, card, record, phases, ctx)
        # -- 31-38. model files: TFLite, WHILE, .npz; the second group;
        # TorchScript and the last decoders; item 2's CPU-only files ------
        modelio_phases(nt, torch, card, record, phases)
        # -- 39-40. the DSL's elements -----------------------------------
        elements_phases(nt, torch, card, record, phases)
        # -- 41-42. items 3c-3d: E6 and E7 launch #1 too ----------------
        extra = streaming_phases(nt, torch, card, record, phases)
        # -- 43-44. items 4a-4b: Q1 once a frame, Q2 once a batch -------
        extra.update(serving_phases(nt, torch, card, record, phases))
        # -- 45-46. items 4c-4d: #1 once a frame in every pool child ----
        extra.update(pool_phases(nt, torch, card, record, phases))
        # -- 47-49. items 4e-4f: #1 once a frame on R2, SH2, SEG -------
        extra.update(placement_phases(nt, torch, card, record, phases))
        # -- 50-51. item 4g: #1 in the mesh's hosts; #7-#8 in `llm` -----
        mesh, paged = mesh_phases(nt, torch, card, record, phases)
        extra.update(mesh)
        # -- 52-53. items 4h, 5a: #1 in the flooded pool's child; B's
        # senders across the broker --------------------------------------
        extra.update(traffic_phases(nt, torch, card, record, phases))
        # -- 54-55. items 5b-5c: B into each codec and over gRPC; x into
        # the trainer -----------------------------------------------------
        extra.update(interop_train_phases(nt, torch, card, record, phases))
        # -- 56-57. item 6: #1 in MD2's shards and TRS's batches; #6 in
        # the dryrun's rings --------------------------------------------
        par, dry = parallel_phases(nt, torch, card, record, phases)
        extra.update(par)
        ring = next(e for e in entries if e["name"] == "flash_block_update")
        ring["launches_by_path"] = {"SHARD": ring["launches"], "DRY": dry}
        ring["launches"] += dry
        norm = next(e for e in entries if e["name"] == "normalize_u8")
        norm["launches_by_path"] = {"B": norm["launches"], **extra}
        norm["launches"] += sum(extra.values())
        for e in entries:
            if e["name"] in paged:
                e["launches_by_path"] = {"LLM": e["launches"],
                                         "llm_cli": paged[e["name"]]}
                e["launches"] += paged[e["name"]]
    record["phase_seconds"] = phases.seconds

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = ("chip_smoke_slice4.json" if args.slice4 else
            "chip_smoke_slice6.json" if args.slice6 else
            "chip_smoke_batching.json" if args.batching else
            "chip_smoke_window.json" if args.window else
            "chip_smoke_modelio.json" if args.modelio else
            "chip_smoke_elements.json" if args.elements else
            "chip_smoke_streaming.json" if args.streaming else
            "chip_smoke_serving.json" if args.serving else
            "chip_smoke_pool.json" if args.pool else
            "chip_smoke_placement.json" if args.placement else
            "chip_smoke_mesh.json" if args.mesh else
            "chip_smoke_traffic.json" if args.traffic else
            "chip_smoke_interop.json" if args.interop and not args.train else
            "chip_smoke_train.json" if args.train and not args.interop else
            "chip_smoke_parallel.json" if args.parallel else
            "chip_smoke_interop_train.json" if args.interop else
            "chip_smoke.json")
    (out_dir / name).write_text(json.dumps(record, indent=1))
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
