"""Serving: paged KV cache, cached decode, sampling, continuous batching,
speculative decoding, int8 quantization, and serving under KV pressure
(preemption, the host and disk swap tiers, the radix prefix tree and the
persistent prefix store)."""
from deeplearning4j_tpu_torch.serving.block_table import (BlockAllocator,
                                                          PrefixRegistry)
from deeplearning4j_tpu_torch.serving.decode import (
    StackDecoder, decode_attention, decode_attention_paged,
    decode_attention_spec_paged, one_hot_embedder)
from deeplearning4j_tpu_torch.serving.engine import (GenerationResult,
                                                     Request, ServingEngine)
from deeplearning4j_tpu_torch.serving.kv_cache import KVCache
from deeplearning4j_tpu_torch.serving.kv_disk import (DiskBlockPool,
                                                      resolve_disk_pool)
from deeplearning4j_tpu_torch.serving.lifecycle import (HostBlockPool,
                                                        KVLifecycleManager,
                                                        PersistentPrefixStore,
                                                        resolve_lifecycle,
                                                        resolve_prefix_store)
from deeplearning4j_tpu_torch.serving.radix_tree import (RadixPrefixTree,
                                                         resolve_prefix_radix)
from deeplearning4j_tpu_torch.serving.sampler import (Sampler, sample_tokens,
                                                      spec_accept_tokens)
from deeplearning4j_tpu_torch.serving.spec import (NgramDraftIndex,
                                                   resolve_spec_decode,
                                                   resolve_spec_draft)

__all__ = ["KVCache", "BlockAllocator", "PrefixRegistry", "RadixPrefixTree",
           "resolve_prefix_radix", "HostBlockPool", "KVLifecycleManager",
           "PersistentPrefixStore", "DiskBlockPool", "resolve_lifecycle",
           "resolve_prefix_store", "resolve_disk_pool",
           "StackDecoder", "decode_attention", "decode_attention_paged",
           "decode_attention_spec_paged", "one_hot_embedder",
           "GenerationResult", "Request", "ServingEngine",
           "Sampler", "sample_tokens", "spec_accept_tokens",
           "NgramDraftIndex", "resolve_spec_decode", "resolve_spec_draft"]
