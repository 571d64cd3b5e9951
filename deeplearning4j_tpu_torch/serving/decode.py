"""Incremental (KV-cached) decode for causal SelfAttentionLayer stacks
(counterpart of serving/decode.py).

`StackDecoder` re-derives each attention layer's q/k/v from the layer's own
parameters with the exact math of SelfAttentionLayer.forward, so cached
decode matches the full-recompute forward position for position. Its three
steps mutate the paged cache in place (serving/kv_cache.py):

- `_prefill_fn`: a whole (bucket-padded) prompt, dense causal attention;
- `_prefill_shared_fn`: a prompt suffix whose prefix is already resident
  (prefix sharing), also one chunk of a chunked prefill with the chunk's
  (start, end) in the (shared_len, plen) seats;
- `_decode_fn`: one token for every slot, attending through
  `paged_attention` (default `decode_attention_paged`: the CUDA kernel on
  the card, the plain version on the CPU);
- `_spec_decode_fn`: speculative verification, Q consecutive positions
  per slot (the last committed token plus the drafts) appended and
  attended in ONE multi-query call per layer through
  `paged_spec_attention` (default `decode_attention_spec_paged`, K2).

With `kv_quant` the pool is int8 (serving/kv_cache.py) and every attention
call gets the layer's per-(block, head) scales; with `quant_weights` the
attention projections run as int8 products with per-channel scales
(`quantize_attention_weights`). The output head stays float.

Prompt buckets are the JAX package's (`prefill_bucket`, `shared_buckets`),
so writes are block-granular the same way and the engine's first-use
counters mean the same thing.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.common.enums import Activation
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.layers.attention import \
    SelfAttentionLayer
from deeplearning4j_tpu_torch.nn.conf.layers.feedforward import (
    ActivationLayer, DropoutLayer, LossLayer)
from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import RnnOutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                    torch_dtype)
from deeplearning4j_tpu_torch.ops.decode_attention import (
    decode_attention_dense, decode_attention_dense_paged,
    decode_attention_dense_spec_paged)
from deeplearning4j_tpu_torch.ops.helpers import helper_for
from deeplearning4j_tpu_torch.serving import kv_cache, quant

NEG_INF = -1e30

# Non-attention layers a decode step may apply one position at a time.
_POSITIONWISE = (RnnOutputLayer, ActivationLayer, DropoutLayer, LossLayer)


def decode_attention(q, kc, vc, visible, scale, window: int = 0):
    """Single-query attention against a contiguous (S, L, Hk, D) cache
    (current position already appended; visible = position index + 1),
    resolved through the kernel seam: K6 (`flash_decode_attention`) for
    CUDA tensors, the plain version for CPU tensors. Returns (S, H, D)."""
    fn = helper_for("decode_attention", decode_attention_dense, q)
    return fn(q, kc, vc, visible, scale, window)


def decode_attention_paged(q, kp, vp, block_tables, visible, scale,
                           window: int = 0, k_scale=None, v_scale=None):
    """Single-query attention against the PAGED cache, resolved through the
    kernel seam: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = helper_for("decode_attention_paged", decode_attention_dense_paged,
                    q)
    return fn(q, kp, vp, block_tables, visible, scale, window,
              k_scale=k_scale, v_scale=v_scale)


def decode_attention_spec_paged(q, kp, vp, block_tables, visible, scale,
                                window: int = 0, k_scale=None, v_scale=None):
    """Multi-query (speculative verification) attention against the PAGED
    cache: q (S, Q, H, D), query i of slot s at position visible[s] - 1 + i
    sees j < visible + i. Resolved through the kernel seam: K2 for CUDA
    tensors, the plain version (Q single-query calls) for CPU tensors."""
    fn = helper_for("decode_attention_spec_paged",
                    decode_attention_dense_spec_paged, q)
    return fn(q, kp, vp, block_tables, visible, scale, window,
              k_scale=k_scale, v_scale=v_scale)


def _attn_heads(layer: SelfAttentionLayer, params, xt):
    """(.., n_in) -> q (.., H, Dh), k/v (.., Hk, Dh). A `w_*_scale` entry
    beside a weight (weight-only int8) makes that projection
    (x @ w_int8) * scale."""
    H, Hk = layer.n_heads, layer.kv_heads
    Dh = layer.n_out // H
    lead = xt.shape[:-1]

    def proj(name, heads):
        sc = params.get(name + "_scale")
        y = xt @ params[name] if sc is None \
            else quant.int8_matmul(xt, params[name], sc)
        return y.reshape(lead + (heads, Dh))

    return proj("w_q", H), proj("w_k", Hk), proj("w_v", Hk)


def _out_proj(params, out):
    """out @ w_o + b, int8-aware as `_attn_heads`."""
    sc = params.get("w_o_scale")
    y = out @ params["w_o"] if sc is None \
        else quant.int8_matmul(out, params["w_o"], sc)
    return y + params["b"]


def quantize_attention_weights(params, layers):
    """Weight-only int8 for every SelfAttentionLayer's q/k/v/o projections
    (per-output-channel scales, serving/quant.py): each weight is replaced
    by its int8 payload plus a `<name>_scale` sibling. The output head
    stays float (logits are the accuracy-critical surface). Returns a new
    list; the layer dicts are copied, never mutated."""
    out = list(params)
    for i, layer in enumerate(layers):
        if not isinstance(layer, SelfAttentionLayer):
            continue
        p = dict(out[i])
        for name in ("w_q", "w_k", "w_v", "w_o"):
            p[name], p[name + "_scale"] = quant.quantize_weight(p[name])
        out[i] = p
    return out


def _dense_causal_attention(layer, q, k, v):
    """Prefill attention over the padded prompt (B=1): q (T, H, Dh),
    k/v (T, Hk, Dh). Padded tail keys are masked by causality alone."""
    T, H, Dh = q.shape
    G = H // k.shape[1]
    if G > 1:
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("qhd,khd->hqk", q.to(acc), k.to(acc)) / math.sqrt(Dh)
    qi = torch.arange(T, device=q.device)[:, None]
    kj = torch.arange(T, device=q.device)[None, :]
    valid = qi >= kj
    if layer.attention_window:
        valid = valid & (qi - kj < layer.attention_window)
    s = s.masked_fill(~valid[None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v.to(acc)).to(q.dtype)


class StackDecoder:
    """Prefill-then-decode wrapper for a causal SelfAttentionLayer stack
    built as a MultiLayerNetwork. Owns the KVCache; the serving engine
    composes its steps with token embedding and sampling."""

    def __init__(self, net, max_seqs: int, max_len: int, dtype=None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefix_share: Optional[bool] = None,
                 paged_attention=None,
                 paged_spec_attention=None, kv_quant: Optional[bool] = None,
                 quant_weights: Optional[bool] = None,
                 prefix_radix: Optional[bool] = None, device="cuda"):
        layers, params = _extract_stack(net)
        self.layers = layers
        self.device = resolve_device(device)
        if self.device != net.device:
            raise ValueError(f"decoder device {self.device} differs from the "
                             f"network's {net.device}")
        self.dtype = torch_dtype(dtype) if dtype is not None else net.dtype
        self.params = [{k: v.to(self.dtype) if v.is_floating_point() else v
                        for k, v in p.items()} for p in params]
        self.quant_weights = quant.resolve_quant_weights(quant_weights)
        if self.quant_weights:
            self.params = quantize_attention_weights(self.params, layers)
        self.attn_idx = [i for i, l in enumerate(layers)
                         if isinstance(l, SelfAttentionLayer)]
        if not self.attn_idx:
            raise ValueError("StackDecoder needs at least one "
                             "SelfAttentionLayer in the stack")
        shapes = set()
        for i in self.attn_idx:
            l = layers[i]
            if not l.causal:
                raise ValueError(
                    f"layer {i} ({type(l).__name__}) is not causal — "
                    "autoregressive decode needs causal attention")
            shapes.add((l.kv_heads, l.n_out // l.n_heads))
        if len(shapes) != 1:
            raise ValueError(f"attention layers disagree on (n_kv_heads, "
                             f"head_dim): {sorted(shapes)}")
        for i, l in enumerate(layers[:-1]):
            if not isinstance(l, (SelfAttentionLayer,) + _POSITIONWISE):
                raise NotImplementedError(
                    f"layer {i} ({type(l).__name__}) has no incremental "
                    "decode path (not position-wise)")
        (self.n_kv_heads, self.head_dim), = shapes
        self.n_in = getattr(layers[0], "n_in", None)
        self.cache = kv_cache.KVCache(
            len(self.attn_idx), max_seqs, max_len, self.n_kv_heads,
            self.head_dim, self.dtype, block_size=block_size,
            num_blocks=num_blocks, prefix_share=prefix_share,
            kv_quant=kv_quant,
            prefix_radix=prefix_radix, device=self.device)
        self._paged_attention = (paged_attention if paged_attention
                                 is not None else decode_attention_paged)
        self._paged_spec_attention = (
            paged_spec_attention if paged_spec_attention is not None
            else decode_attention_spec_paged)

    # ------------------------------------------------------------ steps
    def _positionwise(self, layer, params, x):
        """A non-attention layer per position: x (..., n_feat) fed as a
        1-timestep recurrent activation."""
        out, _, _ = layer.forward(params, {}, x[..., None], train=False,
                                  mask=None)
        return out[..., 0]

    def _head_logprobs(self, h):
        """Log-probabilities from the output layer given its input h
        (S, n_feat)."""
        out_layer = self.layers[-1]
        p = self.params[-1]
        if isinstance(out_layer, RnnOutputLayer):
            z = h @ p["W"]
            if out_layer.has_bias:
                z = z + p["b"]
        elif hasattr(out_layer, "preout"):
            z = out_layer.preout(p, h)
        else:
            z = self._positionwise(out_layer, p, h)
            if out_layer.activation == Activation.SOFTMAX:
                return torch.log(torch.clamp(z, min=1e-30))
            return torch.log_softmax(z, dim=-1)
        if out_layer.activation != Activation.SOFTMAX:
            z = out_layer._act(z)
        return torch.log_softmax(z, dim=-1)

    def _prefill_fn(self, x, slot: int, plen: int):
        """Prompt pass: x (n_in, T_pad) features of ONE request; writes
        every attention layer's k/v into `slot`, sets lengths[slot] = plen,
        returns the (vocab,) logprobs at position plen-1."""
        st = self.cache.state
        xt = x.transpose(0, 1).to(self.dtype)              # (T_pad, n_in)
        li = 0
        for i, layer in enumerate(self.layers[:-1]):
            p = self.params[i]
            if isinstance(layer, SelfAttentionLayer):
                q, k, v = _attn_heads(layer, p, xt)
                kv_cache.write_prefill(st, li, slot, k, v)
                li += 1
                out = _dense_causal_attention(layer, q, k, v)
                xt = layer._act(_out_proj(
                    p, out.reshape(xt.shape[0], layer.n_out)))
            else:
                xt = self._positionwise(layer, p, xt)
        kv_cache.set_length(st, slot, plen)
        return self._head_logprobs(xt[plen - 1][None])[0]

    def _prefill_shared_fn(self, x, slot: int, plen: int, shared_len: int,
                           kv_blocks: int):
        """Suffix pass: x (n_in, Ts_pad) features of logical positions
        [shared_len, plen); scatters the suffix k/v through the block
        table, then attends each suffix query against the slot's first
        `kv_blocks` gathered blocks. Padding rows trash-route."""
        st = self.cache.state
        xt = x.transpose(0, 1).to(self.dtype)              # (Ts_pad, n_in)
        Ts = xt.shape[0]
        bs = self.cache.block_size
        qpos = shared_len + torch.arange(Ts, dtype=torch.int64,
                                         device=self.device)
        valid = qpos < plen
        L = kv_blocks * bs
        j = torch.arange(L, device=self.device)[None, :]
        causal = j <= qpos[:, None]                         # (Ts, L)
        li = 0
        for i, layer in enumerate(self.layers[:-1]):
            p = self.params[i]
            if isinstance(layer, SelfAttentionLayer):
                q, k, v = _attn_heads(layer, p, xt)
                kv_cache.write_positions(st, li, slot, qpos, valid, k, v)
                row = st.block_tables[slot, :kv_blocks].long()
                kb, vb = st.k[li][row], st.v[li][row]    # (kvb, bs, Hk, D)
                if st.quantized:
                    # dequantize per gathered block (the slot's view, never
                    # the pool), the paged plain version's math
                    kb = quant.kv_dequantize(kb, st.k_scale[li][row])
                    vb = quant.kv_dequantize(vb, st.v_scale[li][row])
                kl = kb.reshape(L, self.n_kv_heads, self.head_dim)
                vl = vb.reshape(L, self.n_kv_heads, self.head_dim)
                li += 1
                H, Dh = layer.n_heads, self.head_dim
                G = H // self.n_kv_heads
                acc = torch.promote_types(q.dtype, torch.float32)
                q4 = q.reshape(Ts, self.n_kv_heads, G, Dh)
                s = torch.einsum("thgd,lhd->thgl", q4.to(acc),
                                 kl.to(acc)) / math.sqrt(Dh)
                mask = causal
                if layer.attention_window:
                    mask = mask & (qpos[:, None] - j
                                   < layer.attention_window)
                s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
                pattn = torch.softmax(s, dim=-1)
                out = torch.einsum("thgl,lhd->thgd", pattn, vl.to(acc))
                out = out.reshape(Ts, layer.n_out).to(self.dtype)
                xt = layer._act(_out_proj(p, out))
            else:
                xt = self._positionwise(layer, p, xt)
        kv_cache.set_length(st, slot, plen)
        return self._head_logprobs(xt[plen - 1 - shared_len][None])[0]

    def _decode_fn(self, x, active):
        """One decode iteration for ALL slots: x (S, n_in) current-token
        features, active (S,) bool. Appends each attention layer's k/v at
        the slot's current position, attends through the paged cache,
        advances lengths on active slots; returns (S, vocab) logprobs."""
        st = self.cache.state
        h = x.to(self.dtype)
        visible = st.lengths + 1                            # pre-advance + 1
        scale = 1.0 / math.sqrt(self.head_dim)
        li = 0
        for i, layer in enumerate(self.layers[:-1]):
            p = self.params[i]
            if isinstance(layer, SelfAttentionLayer):
                q, k_t, v_t = _attn_heads(layer, p, h)
                kv_cache.append_token(st, li, k_t, v_t, active)
                out = self._paged_attention(
                    q, st.k[li], st.v[li], st.block_tables, visible, scale,
                    layer.attention_window, **st.scales(li))
                li += 1
                h = layer._act(_out_proj(p, out.reshape(h.shape[0],
                                                        layer.n_out)))
            else:
                h = self._positionwise(layer, p, h)
        kv_cache.advance_lengths(st, active)
        return self._head_logprobs(h)

    def _spec_decode_fn(self, x, active, draft_len):
        """One SPECULATIVE decode iteration for all slots: x (S, Q, n_in)
        features of [last committed token, draft 0, ..., draft Q-2], active
        (S,) bool, draft_len (S,) int in [0, Q-1]. Row i's k/v land at
        position lengths + i (trash-routed for inactive slots and rows past
        the slot's draft length), and all Q queries are verified in ONE
        multi-query attention call per layer. Returns (S, Q, vocab)
        logprobs; row i is the distribution of the token after position
        lengths + i - 1. Does NOT move `lengths`: the engine commits the
        accepted count afterwards, and rejected rows stay invisible."""
        st = self.cache.state
        S, Q = x.shape[0], x.shape[1]
        h = x.to(self.dtype)                                # (S, Q, n_in)
        pos = st.lengths.long()                             # pre-commit
        i = torch.arange(Q, device=self.device)[None, :]
        positions = pos[:, None] + i                        # (S, Q)
        valid = active[:, None] & (i <= draft_len[:, None])
        visible = pos + 1
        scale = 1.0 / math.sqrt(self.head_dim)
        li = 0
        for idx, layer in enumerate(self.layers[:-1]):
            p = self.params[idx]
            if isinstance(layer, SelfAttentionLayer):
                q, k_t, v_t = _attn_heads(layer, p, h)      # (S, Q, ., Dh)
                kv_cache.append_tokens(st, li, k_t, v_t, positions, valid)
                out = self._paged_spec_attention(
                    q, st.k[li], st.v[li], st.block_tables, visible, scale,
                    layer.attention_window, **st.scales(li))
                li += 1
                h = layer._act(_out_proj(p, out.reshape(S, Q, layer.n_out)))
            else:
                h = self._positionwise(
                    layer, p, h.reshape(S * Q, -1)).reshape(S, Q, -1)
        return self._head_logprobs(h.reshape(S * Q, -1)).reshape(S, Q, -1)

    # ------------------------------------------------------- stateful API
    def _features(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, self.dtype)

    @torch.no_grad()
    def prefill(self, slot: int, x) -> torch.Tensor:
        """Write a prompt (n_in, T) into `slot`; returns the (vocab,)
        next-token logprobs."""
        x = self._features(x)
        T = x.shape[1]
        if T < 1 or T >= self.cache.max_len:
            raise ValueError(f"prompt length {T} outside [1, max_len)")
        Tp = self.prefill_bucket(T)
        if Tp != T:
            x = torch.nn.functional.pad(x, (0, Tp - T))
        return self._prefill_fn(x, slot, T)

    def prefill_bucket(self, plen: int) -> int:
        """Padded prompt length: next power of two, rounded up to whole KV
        blocks, capped at max_len."""
        Tp = min(self.cache.max_len, 1 << max(0, (plen - 1)).bit_length())
        bs = self.cache.block_size
        return min(self.cache.max_len, -(-Tp // bs) * bs)

    def shared_buckets(self, plen: int, shared_len: int):
        """(suffix bucket Ts_pad, gathered-block count) for a shared-prefix
        or chunk prefill, both bucketed to powers of two."""
        Ts = plen - shared_len
        Tsp = min(self.cache.max_len, 1 << max(0, (Ts - 1)).bit_length())
        nb = -(-plen // self.cache.block_size)
        kvb = min(self.cache.blocks_per_seq,
                  1 << max(0, (nb - 1)).bit_length())
        return Tsp, kvb

    @torch.no_grad()
    def prefill_shared(self, slot: int, x, plen: int,
                       shared_len: int) -> torch.Tensor:
        """Prefill a prompt whose first `shared_len` positions are already
        resident; x (n_in, plen - shared_len) suffix features."""
        x = self._features(x)
        Ts = x.shape[1]
        if Ts != plen - shared_len or Ts < 1 or shared_len < 1:
            raise ValueError(f"bad shared prefill: plen={plen}, "
                             f"shared_len={shared_len}, suffix={Ts}")
        Tsp, kvb = self.shared_buckets(plen, shared_len)
        if Tsp != Ts:
            x = torch.nn.functional.pad(x, (0, Tsp - Ts))
        return self._prefill_shared_fn(x, slot, plen, shared_len, kvb)

    @torch.no_grad()
    def prefill_chunk(self, slot: int, x, start: int,
                      end: int) -> torch.Tensor:
        """One chunk [start, end) of an incremental prefill; returns the
        logprobs at position end-1 (meaningful on the final chunk)."""
        x = self._features(x)
        Tc = x.shape[1]
        if Tc != end - start or Tc < 1 or start < 0 \
                or end > self.cache.max_len:
            raise ValueError(f"bad prefill chunk: start={start}, "
                             f"end={end}, chunk={Tc}")
        Tsp, kvb = self.shared_buckets(end, start)
        if Tsp != Tc:
            x = torch.nn.functional.pad(x, (0, Tsp - Tc))
        return self._prefill_shared_fn(x, slot, end, start, kvb)


def _extract_stack(net) -> Tuple[List, List]:
    """(layers, params_tree) of an initialized MultiLayerNetwork."""
    if not isinstance(net, MultiLayerNetwork):
        raise TypeError(f"unsupported model type {type(net).__name__} "
                        "(ComputationGraph is not ported yet)")
    if not net._initialized:
        raise RuntimeError("Call net.init() before building a decoder")
    return net.layers, net.params_tree


def one_hot_embedder(n_in: int, dtype=torch.float32) -> Callable:
    """Default token->features map: one-hot into the stack's n_in, as a
    comparison against an arange (no device-side range check, so no host
    sync)."""
    def embed(tokens):
        classes = torch.arange(n_in, device=tokens.device)
        return (tokens.long()[..., None] == classes).to(dtype)
    return embed
