"""Continuous-batching LLM serving (counterpart of the JAX package's
llm/).

- `paged_cache`  — fixed-size-block KV pool + free-list allocator.
- `paged_model`  — prefill/decode math over the paged pool, the torch
  reference that equals `transformer.generate` token for token.
- `engine`       — the continuous-batching loop: admit, prefill
  (pow2-bucketed, optionally chunked), merge into the in-flight decode
  batch, retire; plus the static-batching A/B mode.

`elements/llm.py` exposes the engine as the `tensor_llm` element;
`backends/llm_exec.py` owns the bucketed device calls underneath it and
`backends/paged_attn.py` the CUDA paged-attention kernels.
"""

from nnstreamer_tpu_torch.llm.engine import LLMEngine, LLMRequest  # noqa: F401
from nnstreamer_tpu_torch.llm.paged_cache import (  # noqa: F401
    BlockAllocator, PagedKVCache)

__all__ = ["BlockAllocator", "LLMEngine", "LLMRequest", "PagedKVCache"]
