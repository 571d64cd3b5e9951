// What the flash-attention sources share: the masking geometry and the
// tile ranges a (query tile, key tile) walk visits. Included by
// flash_attention.cu (the fp32 kernels) and flash_attention_sm90.cu (the
// bf16 wgmma kernels of K3, K4 and K5). The tile helpers take the tile
// sizes as template arguments: TQ query rows by TK key rows.
#pragma once

#define DL4J_NEG_INF (-1e30f)

struct Geometry {
  int T, causal, window;
};

// Does this (q tile, key tile) pair hold any pair that is not visible?
// Only such tiles evaluate validity per element.
template <int TQ, int TK>
__device__ __forceinline__ bool tile_masked(const Geometry& g, int q_lo,
                                            int k_lo, bool has_km) {
  const int q_hi = q_lo + TQ - 1, k_hi = k_lo + TK - 1;
  if (has_km || k_hi >= g.T || q_hi >= g.T) return true;
  if (g.causal && k_hi > q_lo) return true;
  if (g.window > 0) {
    if (q_hi - k_lo >= g.window) return true;
    if (!g.causal && k_hi - q_lo >= g.window) return true;
  }
  return false;
}

// visibility of (qi, kj); key_ok = kj < T and the key mask allows kj
__device__ __forceinline__ bool visible(const Geometry& g, int qi, int kj,
                                        bool key_ok) {
  if (!key_ok || qi >= g.T) return false;
  if (g.causal && kj > qi) return false;
  if (g.window > 0) {
    if (qi - kj >= g.window) return false;
    if (!g.causal && kj - qi >= g.window) return false;
  }
  return true;
}

// key tiles [j0, j1) of TK keys that the q tile of TQ rows at q_lo can see
template <int TQ, int TK>
__device__ __forceinline__ void key_tiles(const Geometry& g, int q_lo,
                                          int* j0, int* j1) {
  const int q_hi = min(q_lo + TQ, g.T) - 1;
  const int k_begin = g.window > 0 ? max(0, q_lo - g.window + 1) : 0;
  int k_end = g.T;
  if (g.causal) k_end = min(k_end, q_hi + 1);
  else if (g.window > 0) k_end = min(k_end, q_hi + g.window);
  *j0 = k_begin / TK;
  *j1 = k_end > k_begin ? (k_end + TK - 1) / TK : *j0;
}

// q tiles [i0, i1) of TQ rows that can see the key tile of TK keys at k_lo
template <int TQ, int TK>
__device__ __forceinline__ void query_tiles(const Geometry& g, int k_lo,
                                            int* i0, int* i1) {
  const int k_hi = min(k_lo + TK, g.T) - 1;
  int q_begin = 0, q_end = g.T;
  if (g.causal) q_begin = k_lo;
  else if (g.window > 0) q_begin = max(0, k_lo - g.window + 1);
  if (g.window > 0) q_end = min(q_end, k_hi + g.window);
  *i0 = q_begin / TQ;
  *i1 = q_end > q_begin ? (q_end + TQ - 1) / TQ : *i0;
}
