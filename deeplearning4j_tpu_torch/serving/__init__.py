"""Serving: paged KV cache, cached decode, sampling, continuous batching,
speculative decoding and int8 quantization."""
from deeplearning4j_tpu_torch.serving.decode import (
    StackDecoder, decode_attention, decode_attention_paged,
    decode_attention_spec_paged, one_hot_embedder)
from deeplearning4j_tpu_torch.serving.engine import (GenerationResult,
                                                     Request, ServingEngine)
from deeplearning4j_tpu_torch.serving.kv_cache import KVCache
from deeplearning4j_tpu_torch.serving.sampler import (Sampler, sample_tokens,
                                                      spec_accept_tokens)
from deeplearning4j_tpu_torch.serving.spec import (NgramDraftIndex,
                                                   resolve_spec_decode,
                                                   resolve_spec_draft)

__all__ = ["StackDecoder", "decode_attention", "decode_attention_paged",
           "decode_attention_spec_paged", "one_hot_embedder",
           "GenerationResult", "Request", "ServingEngine", "KVCache",
           "Sampler", "sample_tokens", "spec_accept_tokens",
           "NgramDraftIndex", "resolve_spec_decode", "resolve_spec_draft"]
