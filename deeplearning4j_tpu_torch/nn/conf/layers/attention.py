"""Multi-head self-attention over recurrent streams (counterpart of
nn/conf/layers/attention.py).

Ported: the dense path with causal masking, the sliding window, the (batch,
time) key-padding mask and the GQA head repeat, and the long-context branch
(T > block_size > 0), which runs `ops/flash_attention.flash_attention`
(the K3 forward, K4 or K5 backward on the card; their plain versions on
the CPU) once k/v are repeated to full heads, so the (B, H, T, T) score
tensor never exists there. The JAX package's ring and GSPMD branches
belong to the sharding slice: the port has no sequence-parallel context,
so they are never taken.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (
    FeedForwardLayerConf, register_layer)
from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention

NEG_INF = -1e30


@register_layer
@dataclass
class SelfAttentionLayer(FeedForwardLayerConf):
    """(batch, n_in, time) -> (batch, n_out, time); n_out % n_heads == 0.
    `n_kv_heads` > 0 gives grouped-query attention: query head h reads kv
    head h // (n_heads // n_kv_heads)."""
    n_heads: int = 4
    causal: bool = False
    block_size: int = 128
    attention_window: int = 0
    n_kv_heads: int = 0

    def set_n_in(self, input_type, override=False):
        if self.n_in == 0 or override:
            self.n_in = input_type.size
        if self.n_out == 0:
            self.n_out = self.n_in

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out,
                                   getattr(input_type, "timeseries_length", -1))

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    def init_params(self, generator, input_type, dtype=torch.float32,
                    device="cpu"):
        if self.n_out % self.n_heads != 0:
            raise ValueError(f"n_out {self.n_out} % n_heads {self.n_heads} "
                             "!= 0")
        if self.n_heads % self.kv_heads != 0:
            raise ValueError(f"n_heads {self.n_heads} % n_kv_heads "
                             f"{self.kv_heads} != 0")
        kv_out = self.kv_heads * (self.n_out // self.n_heads)

        def w(o):
            return self._winit(generator, (self.n_in, o), self.n_in, o,
                               dtype, device)
        return {"w_q": w(self.n_out), "w_k": w(kv_out), "w_v": w(kv_out),
                "w_o": self._winit(generator, (self.n_out, self.n_out),
                                   self.n_out, self.n_out, dtype, device),
                "b": torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                device=device)}

    def forward(self, params, state, x, *, train=False, mask=None):
        if x.ndim != 3:
            raise ValueError("SelfAttentionLayer expects (batch, size, time)")
        B, _, T = x.shape
        H, Hk = self.n_heads, self.kv_heads
        Dh = self.n_out // H
        xt = x.transpose(1, 2)                           # (B, T, n_in)

        def heads(w, h):
            return (xt @ w).reshape(B, T, h, Dh).transpose(1, 2)

        q = heads(params["w_q"], H)
        k, v = heads(params["w_k"], Hk), heads(params["w_v"], Hk)
        if Hk != H:       # broadcast kv groups to full heads
            k = k.repeat_interleave(H // Hk, dim=1)
            v = v.repeat_interleave(H // Hk, dim=1)
        if self.block_size and T > self.block_size:
            out = flash_attention(q, k, v, mask, self.causal, None,
                                  self.attention_window)
        else:
            out = self._dense(q, k, v, mask, T, Dh)
        out = out.transpose(1, 2).reshape(B, T, self.n_out)
        out = self._act(out @ params["w_o"] + params["b"])
        if mask is not None:  # zero padded query positions
            out = out * mask[:, :, None].to(out.dtype)
        return out.transpose(1, 2), state, mask

    def _dense(self, q, k, v, mask, T, Dh):
        """Dense softmax attention over the (B, H, T, T) scores."""
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(Dh)
        qi = torch.arange(T, device=q.device)[:, None]
        kj = torch.arange(T, device=q.device)[None, :]
        if self.causal:
            scores = scores.masked_fill(~(qi >= kj), NEG_INF)
        if self.attention_window:
            wm = qi - kj < self.attention_window
            if not self.causal:
                wm = wm & (kj - qi < self.attention_window)
            scores = scores.masked_fill(~wm, NEG_INF)
        if mask is not None:  # (B, T) padding mask: padded keys drop
            scores = scores.masked_fill(~(mask[:, None, None, :] > 0),
                                        NEG_INF)
        attn = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bhkv->bhqv", attn, v)  # (B, H, T, Dh)
