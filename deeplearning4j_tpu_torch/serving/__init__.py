"""Serving: paged KV cache, cached decode, sampling, continuous batching."""
from deeplearning4j_tpu_torch.serving.decode import (StackDecoder,
                                                     one_hot_embedder)
from deeplearning4j_tpu_torch.serving.engine import (GenerationResult,
                                                     Request, ServingEngine)
from deeplearning4j_tpu_torch.serving.kv_cache import KVCache
from deeplearning4j_tpu_torch.serving.sampler import Sampler, sample_tokens

__all__ = ["StackDecoder", "one_hot_embedder", "GenerationResult", "Request",
           "ServingEngine", "KVCache", "Sampler", "sample_tokens"]
