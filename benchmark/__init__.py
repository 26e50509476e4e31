"""The benchmark of the PyTorch/CUDA port (`nnstreamer_tpu_torch`).

`python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` on one card and prints
the result as its last line. See README.md in this folder.
"""
