"""The port's speculative decoding and int8 serving against the JAX package's,
in float64 on the CPU.

- Quantization: `kv_quantize` and `quantize_weight` give int8 payloads and
  float32 scales bit-identical to the JAX package's for the same input;
  `int8_matmul` agrees to 1e-12.
- Cache writes: `append_tokens` (float and int8, inactive slots and padded
  draft rows routed to trash, a draft crossing a block edge), and the int8
  read-modify-write of `append_token`, `write_positions`, `write_prefill`,
  leave the whole pool (payload and scales) bit-identical to the JAX
  package's.
- Kernels' plain versions: the plain K2 (`decode_attention_dense_spec_paged`)
  equals JAX's Pallas `flash_decode_attention_spec_paged` (interpret mode on
  the CPU) and its dense oracle to 1e-10, and its row i equals the port's
  plain K1 at visible + i exactly; the plain K6 (`decode_attention_dense`,
  what `flash_decode_attention` runs on a CPU tensor) equals JAX's
  `flash_decode_attention` and `decode_attention_dense` to 1e-10,
  including cache lengths whose partition falls below 8.
- The n-gram draft index proposes what the JAX package's proposes.
- Engine: spec-on greedy tokens, counted host syncs and accepted/rejected
  drafts equal the JAX engine's on the same schedules (repetitive prompts,
  EOS, max-gen, mid-stream admission, prefix sharing); spec-on equals
  spec-off inside the port (greedy, and sampled for a single request);
  the int8 KV pool, int8 weights, both, and both with spec give the JAX
  engine's tokens and syncs (int8 is held against JAX's int8, never against
  float: the two streams differ on these models).
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops.decode_attention import (
    _resolve_bkv as jax_resolve_bkv,
    decode_attention_dense as jax_dense,
    decode_attention_dense_spec_paged as jax_dense_spec,
    flash_decode_attention as jax_flash,
    flash_decode_attention_spec_paged as jax_flash_spec)
from deeplearning4j_tpu.serving import Request as JaxRequest
from deeplearning4j_tpu.serving import ServingEngine as JaxEngine
from deeplearning4j_tpu.serving import kv_cache as jkv
from deeplearning4j_tpu.serving import quant as jquant
from deeplearning4j_tpu.serving import spec as jspec
from deeplearning4j_tpu.serving.sampler import \
    spec_accept_tokens as jax_spec_accept
from deeplearning4j_tpu_torch.ops import decode_attention as tda
from deeplearning4j_tpu_torch.ops import helpers
from deeplearning4j_tpu_torch.serving import (NgramDraftIndex, Request,
                                              Sampler, ServingEngine,
                                              spec_accept_tokens)
from deeplearning4j_tpu_torch.serving import kv_cache as tkv
from deeplearning4j_tpu_torch.serving import quant as tquant
from deeplearning4j_tpu_torch.serving import spec as tspec

from tests.test_torch_serving import P1, P2, _nets, _oracle_logprobs

ATOL = 1e-10
REPETITIVE = [1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3, 4, 1, 2]
PROMPTS = [REPETITIVE, [5, 4, 3], [2, 2, 7, 1, 2, 2, 7, 1, 2, 2]]


@pytest.fixture(scope="module")
def nets():
    return _nets()


# ------------------------------------------------------------ quantization
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kv_quantize_bit_identical_to_jax(dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 4, 8, 2, 16) * rng.uniform(0.01, 5.0, (3, 4, 1, 2, 1))
         ).astype(dtype)
    x[1, 2, :, 1] = 0.0                 # an all-zero slice gets scale 1.0
    x[0, 0, 0, 0, :4] = [0.5, -0.5, 1.5, 2.5]   # halves: round to even
    tq, ts = tquant.kv_quantize(torch.from_numpy(x))
    jq, js = jquant.kv_quantize(jnp.asarray(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[1, 2, 1].item() == 1.0
    np.testing.assert_array_equal(
        tquant.kv_dequantize(tq, ts).numpy(),
        np.asarray(jquant.kv_dequantize(jq, js)))


def test_quantize_weight_and_int8_matmul_match_jax():
    rng = np.random.RandomState(1)
    w = rng.randn(24, 16) * rng.uniform(0.1, 3.0, (1, 16))
    w[:, 5] = 0.0
    x = rng.randn(5, 3, 24)
    tq, ts = tquant.quantize_weight(torch.from_numpy(w))
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    y = tquant.int8_matmul(torch.from_numpy(x), tq, ts)
    assert y.dtype == torch.float64
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jquant.int8_matmul(jnp.asarray(x), jq, js)),
        atol=1e-12, rtol=0)


@pytest.mark.parametrize("value", [None, "", "0", "1", "off", "yes"])
def test_quant_and_spec_resolvers_match_jax(value, monkeypatch):
    for env in ("DL4J_TPU_KV_QUANT", "DL4J_TPU_W8", "DL4J_TPU_SPEC_DECODE",
                "DL4J_TPU_SPEC_DRAFT"):
        monkeypatch.delenv(env, raising=False)
        if value is not None and (env != "DL4J_TPU_SPEC_DRAFT"
                                  or value.isdigit()):
            monkeypatch.setenv(env, value)
    assert tquant.resolve_kv_quant(None) == jquant.resolve_kv_quant(None)
    assert tquant.resolve_quant_weights(None) == \
        jquant.resolve_quant_weights(None)
    assert tspec.resolve_spec_decode(None) == jspec.resolve_spec_decode(None)
    assert tspec.resolve_spec_draft(None) == jspec.resolve_spec_draft(None)
    for explicit in (True, False):
        assert tquant.resolve_kv_quant(explicit) is explicit
        assert tspec.resolve_spec_decode(explicit) is explicit


# ------------------------------------------------------------- cache writes
S_, NL, HK, DH, BS, MAXLEN = 4, 2, 2, 4, 4, 16
NB = S_ * (MAXLEN // BS)


def _pools(quant, seed):
    """The same random pool and block tables in both packages: slot 1 holds
    no reservation (its row is all trash), the others map shuffled blocks."""
    rng = np.random.RandomState(seed)
    bps = MAXLEN // BS
    jst = jkv.init_cache_state(NL, S_, MAXLEN, HK, DH, jnp.float64,
                               block_size=BS, kv_quant=quant)
    tst = tkv.CacheState(NL, S_, MAXLEN, HK, DH, torch.float64, BS, NB,
                         torch.device("cpu"), kv_quant=quant)
    perm = rng.permutation(NB)
    bt = np.full((S_, bps), NB, np.int32)
    for s in (0, 2, 3):
        bt[s] = perm[s * bps:(s + 1) * bps]
    lengths = np.asarray([3, 0, 7, 14], np.int32)
    kf = rng.randn(NL, NB + 1, BS, HK, DH)
    vf = rng.randn(NL, NB + 1, BS, HK, DH)
    jst = {**jst, "block_tables": jnp.asarray(bt),
           "lengths": jnp.asarray(lengths)}
    tst.block_tables.copy_(torch.from_numpy(bt))
    tst.lengths.copy_(torch.from_numpy(lengths))
    if quant:
        kq, ks = jquant.kv_quantize(jnp.asarray(kf))
        vq, vs = jquant.kv_quantize(jnp.asarray(vf))
        jst = {**jst, "k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        for name, arr in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            getattr(tst, name).copy_(torch.from_numpy(np.array(arr)))
    else:
        jst = {**jst, "k": jnp.asarray(kf), "v": jnp.asarray(vf)}
        tst.k.copy_(torch.from_numpy(kf))
        tst.v.copy_(torch.from_numpy(vf))
    return jst, tst, rng


def _assert_pools_equal(jst, tst):
    names = ("k", "v", "k_scale", "v_scale") if tst.quantized else ("k", "v")
    for name in names:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(jst[name]), err_msg=name)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("Q", [2, 3, 5])
def test_append_tokens_matches_jax_bit_exact(quant, Q):
    jst, tst, rng = _pools(quant, seed=Q)
    # slot 1 inactive; slot 3 (length 14) drafts across the block edge at 16
    # only as far as its table reaches; slot 2's draft crosses 8
    active = np.asarray([True, False, True, True])
    draft_len = np.asarray([0, Q - 1, Q - 1, min(1, Q - 1)], np.int32)
    i = np.arange(Q)[None, :]
    positions = np.asarray(jst["lengths"])[:, None] + i
    valid = active[:, None] & (i <= draft_len[:, None])
    k_t = rng.randn(S_, Q, HK, DH)
    v_t = rng.randn(S_, Q, HK, DH)
    for layer in range(NL):
        jst = jkv.append_tokens(jst, layer, jnp.asarray(k_t), jnp.asarray(v_t),
                                jnp.asarray(positions), jnp.asarray(valid))
        tkv.append_tokens(tst, layer, torch.from_numpy(k_t),
                          torch.from_numpy(v_t), torch.from_numpy(positions),
                          torch.from_numpy(valid))
    _assert_pools_equal(jst, tst)
    # the written rows read back at their logical positions (float pool)
    if not quant:
        bt = tst.block_tables.numpy()
        for s in np.flatnonzero(active):
            for r in range(draft_len[s] + 1):
                p = positions[s, r]
                np.testing.assert_array_equal(
                    tst.k[1, bt[s, p // BS], p % BS].numpy(), k_t[s, r])


def test_int8_append_token_write_positions_and_prefill_match_jax():
    jst, tst, rng = _pools(True, seed=11)
    active = np.asarray([True, False, True, True])
    k_t, v_t = rng.randn(S_, HK, DH), rng.randn(S_, HK, DH)
    jst = jkv.append_token(jst, 0, jnp.asarray(k_t), jnp.asarray(v_t),
                           jnp.asarray(active))
    tkv.append_token(tst, 0, torch.from_numpy(k_t), torch.from_numpy(v_t),
                     torch.from_numpy(active))
    _assert_pools_equal(jst, tst)
    # a suffix scatter into slot 2 with a padded (invalid) tail
    positions = np.arange(5, 13)
    valid = positions < 11
    k_s, v_s = rng.randn(8, HK, DH), rng.randn(8, HK, DH)
    jst = jkv.write_positions(jst, 1, 2, jnp.asarray(positions),
                              jnp.asarray(valid), jnp.asarray(k_s),
                              jnp.asarray(v_s))
    tkv.write_positions(tst, 1, 2, torch.from_numpy(positions),
                        torch.from_numpy(valid), torch.from_numpy(k_s),
                        torch.from_numpy(v_s))
    _assert_pools_equal(jst, tst)
    k_b, v_b = rng.randn(8, HK, DH), rng.randn(8, HK, DH)
    jst = jkv.write_prefill(jst, 0, 3, jnp.asarray(k_b), jnp.asarray(v_b))
    tkv.write_prefill(tst, 0, 3, torch.from_numpy(k_b), torch.from_numpy(v_b))
    _assert_pools_equal(jst, tst)


def test_int8_cache_bytes_match_jax():
    from deeplearning4j_tpu.serving import KVCache as JaxKVCache
    for quant in (False, True):
        j = JaxKVCache(2, 3, 32, 2, 8, jnp.float64, block_size=4,
                       kv_quant=quant)
        t = tkv.KVCache(2, 3, 32, 2, 8, torch.float64, block_size=4,
                        kv_quant=quant, device="cpu")
        for attr in ("bytes_per_position", "block_overhead_bytes",
                     "block_bytes"):
            assert getattr(t, attr) == getattr(j, attr), (quant, attr)
        assert t.bytes() == j.bytes()
        assert t.state.quantized == quant
    assert t.bytes_per_position * 8 == JaxKVCache(
        2, 3, 32, 2, 8, jnp.float64, block_size=4).bytes_per_position


def test_int8_cow_copy_carries_scales():
    c = tkv.KVCache(1, 2, 16, 1, 2, torch.float64, block_size=4,
                    kv_quant=True, device="cpu")
    c.state.k_scale[0, 3] = 0.25
    c.state.k[0, 3] = 7
    tkv.copy_block(c.state, 3, 5)
    assert torch.equal(c.state.k[:, 5], c.state.k[:, 3])
    assert c.state.k_scale[0, 5, 0].item() == 0.25


# --------------------------------------------------- K2 / K6 plain versions
def _spec_case(Q, G, window, bs, quant, seed, S=3, Hk=2, D=8, bps=4):
    rng = np.random.RandomState(seed)
    H, L = Hk * G, bps * bs
    nb = S * bps + 2
    visible = np.asarray([1, L - Q + 1] + list(rng.randint(1, L - Q + 2,
                                                           S - 2)), np.int32)
    perm = rng.permutation(nb)
    bt = np.full((S, bps), nb, np.int32)
    used = 0
    for s in range(S):
        n = -(-(int(visible[s]) + Q - 1) // bs)
        bt[s, :n] = perm[used:used + n]
        used += n
    q = rng.randn(S, Q, H, D)
    shape = (nb + 1, bs, Hk, D)
    if quant:
        kp = rng.randint(-127, 128, shape).astype(np.int8)
        vp = rng.randint(-127, 128, shape).astype(np.int8)
        scales = {"k_scale": rng.uniform(1e-3, 2e-2, (nb + 1, Hk)),
                  "v_scale": rng.uniform(1e-3, 2e-2, (nb + 1, Hk))}
    else:
        kp, vp, scales = rng.randn(*shape), rng.randn(*shape), {}
    return (q, kp, vp, bt, visible, 1.0 / np.sqrt(D), window), scales


def _as_torch(args, scales):
    arrays = [torch.from_numpy(np.ascontiguousarray(a)) for a in args[:5]]
    return (*arrays, *args[5:]), {k: torch.from_numpy(v)
                                  for k, v in scales.items()}


def _as_jax(args, scales):
    return ((*[jnp.asarray(a) for a in args[:5]], *args[5:]),
            {k: jnp.asarray(v) for k, v in scales.items()})


SPEC_CASES = [(Q, G, w, bs, False) for Q in (2, 5) for G in (1, 2, 4)
              for w in (0, 5) for bs in (4, 8)] \
    + [(3, G, 5, 8, True) for G in (1, 2)] + [(9, 2, 0, 4, True)]


@pytest.mark.parametrize("Q,G,window,bs,quant", SPEC_CASES)
def test_plain_spec_paged_matches_jax_kernel_and_oracle(Q, G, window, bs,
                                                        quant):
    args, scales = _spec_case(Q, G, window, bs, quant, seed=Q * 7 + G + bs)
    targs, tsc = _as_torch(args, scales)
    out = tda.decode_attention_dense_spec_paged(*targs, **tsc)
    assert out.dtype == torch.float64 and out.shape == targs[0].shape
    jargs, jsc = _as_jax(args, scales)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jax_flash_spec(*jargs, **jsc)),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jax_dense_spec(*jargs, **jsc)),
                               atol=ATOL, rtol=0)
    # row i is the port's plain K1 at visible + i, exactly
    q, kp, vp, bt, vis, scale, w = targs
    for i in range(Q):
        row = tda.decode_attention_dense_paged(q[:, i], kp, vp, bt, vis + i,
                                               scale, w, **tsc)
        assert torch.equal(out[:, i], row)
    # the wrapper on CPU tensors IS the plain version and launches nothing
    before = tda.flash_decode_attention_spec_paged.launches
    assert torch.equal(tda.flash_decode_attention_spec_paged(*targs, **tsc),
                       out)
    assert tda.flash_decode_attention_spec_paged.launches == before


def test_merge_of_exact_spec_partials_equals_dense():
    """The logaddexp merge the CUDA wrapper applies to K2's per-block
    partials (with the query axis riding along), fed partials computed in
    float64 from the plain math, reproduces the plain K2: the merge algebra
    is exact."""
    args, _ = _spec_case(3, 2, 5, 4, False, seed=4)
    q, kp, vp, bt, vis, scale, window = _as_torch(args, {})[0]
    S, Q, H, D = q.shape
    Hk, bs, bps = kp.shape[2], kp.shape[1], bt.shape[1]
    G = H // Hk
    o_p = torch.zeros(S, Hk, bps, Q, G, D, dtype=torch.float64)
    l_p = torch.full((S, Hk, bps, Q, G), tda.NEG_INF, dtype=torch.float64)
    q5 = q.reshape(S, Q, Hk, G, D)
    for s in range(S):
        for i in range(Q):
            v = int(vis[s]) + i
            for j in range(bps):
                pos = j * bs + torch.arange(bs)
                ok = (pos < v) & (v - 1 - pos < window)
                if not bool(ok.any()):
                    continue
                k, vv = kp[bt[s, j]], vp[bt[s, j]]
                sc = torch.einsum("hgd,thd->hgt", q5[s, i], k) * scale
                sc = sc.masked_fill(~ok, tda.NEG_INF)
                m = sc.amax(-1)
                p = torch.exp(sc - m[..., None]) * ok
                l = p.sum(-1)
                o_p[s, :, j, i] = torch.einsum("hgt,thd->hgd", p,
                                               vv) / l[..., None]
                l_p[s, :, j, i] = m + torch.log(l)
    out = tda.merge_partials(o_p, l_p, torch.float64)
    ref = tda.decode_attention_dense_spec_paged(q, kp, vp, bt, vis, scale,
                                                window)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("L,G,window", [(32, 2, 0), (32, 1, 5), (24, 4, 0),
                                        (12, 2, 3), (6, 2, 0), (20, 2, 0)])
def test_plain_contiguous_decode_matches_jax_flash_and_dense(L, G, window):
    """K6's contract on a contiguous cache; L = 6 and 20 give partitions
    below 8 (the JAX kernel takes its dense path there, the CUDA kernel
    runs them)."""
    rng = np.random.RandomState(L + G + window)
    S, Hk, D = 3, 2, 8
    q = rng.randn(S, Hk * G, D)
    kc, vc = rng.randn(S, L, Hk, D), rng.randn(S, L, Hk, D)
    vis = np.asarray([1, L, rng.randint(1, L + 1)], np.int32)
    targs = [torch.from_numpy(a) for a in (q, kc, vc, vis)]
    out = tda.flash_decode_attention(*targs, 0.3, window)
    jargs = [jnp.asarray(a) for a in (q, kc, vc, vis)]
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jax_flash(*jargs, 0.3, window)),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jax_dense(*jargs, 0.3, window)),
                               atol=ATOL, rtol=0)
    assert torch.equal(out, tda.decode_attention_dense(*targs, 0.3, window))
    assert tda.kernel_bkv(L, G, D) == jax_resolve_bkv(0, L) \
        == {32: 32, 24: 24, 12: 12, 6: 6, 20: 20}[L]


@pytest.mark.parametrize("L,G,D", [(1024, 2, 64), (1024, 2, 128),
                                   (1000, 4, 64), (300, 1, 32),
                                   (4096, 1, 256)])
def test_k6_partition_fits_shared_memory_and_divides_l(L, G, D):
    """The CUDA launch plan of K6: the JAX partition where its CTA fits the
    H100's shared memory, else the largest divisor of L that does."""
    bkv = tda.kernel_bkv(L, G, D)
    assert L % bkv == 0 and bkv <= jax_resolve_bkv(0, L)
    assert tda.smem_bytes(G, D, bkv) <= tda.SMEM_LIMIT
    if tda.smem_bytes(G, D, jax_resolve_bkv(0, L)) <= tda.SMEM_LIMIT:
        assert bkv == jax_resolve_bkv(0, L)
    assert tda.kernel_bkv(1024, 2, 64) == 256
    assert tda.kernel_bkv(1024, 2, 128) == 128


def test_spec_and_contiguous_seams_route_by_device():
    x = torch.zeros(1)
    assert helpers.helper_for("decode_attention_spec_paged",
                              tda.decode_attention_dense_spec_paged, x) \
        is tda.decode_attention_dense_spec_paged
    reg = helpers.registered_helpers()
    assert reg["decode_attention_spec_paged"] \
        is tda.flash_decode_attention_spec_paged
    assert reg["decode_attention"] is tda.flash_decode_attention
    targs = _as_torch(*_spec_case(2, 1, 0, 8, False, 0))[0]
    with pytest.raises(ValueError, match="CUDA"):
        tda.flash_decode_spec_partials(*targs)


# ------------------------------------------------------------ draft index
def test_ngram_proposals_identical_to_jax():
    rng = np.random.RandomState(3)
    for trial in range(6):
        motif = list(rng.randint(0, 6, rng.randint(2, 7)))
        hist = (motif * 8)[:rng.randint(5, 40)]
        hist = [int(t) if rng.rand() > 0.15 else int(rng.randint(0, 6))
                for t in hist]
        kw = dict(max_ngram=int(rng.randint(1, 5)),
                  positions_per_gram=int(rng.randint(1, 5)))
        ti, ji = NgramDraftIndex(**kw), jspec.NgramDraftIndex(**kw)
        ti.reset(0, hist[:3])
        ji.reset(0, hist[:3])
        for t in hist[3:]:
            for k in (1, 4, 8):
                assert ti.propose(0, k) == ji.propose(0, k)
            ti.extend(0, [t])
            ji.extend(0, [t])
        assert ti._grams == ji._grams and ti.history_len(0) == len(hist)
        ti.drop(0)
        assert ti.propose(0, 4) == []


def test_spec_accept_greedy_matches_jax():
    rng = np.random.RandomState(5)
    S, Q, V = 4, 5, 7
    lp = np.log(rng.dirichlet(np.ones(V), (S, Q)))
    greedy = lp.argmax(-1).astype(np.int32)
    draft = greedy[:, :-1].copy()
    draft[1, 2] = (draft[1, 2] + 1) % V          # reject at row 2
    draft[2, 0] = (draft[2, 0] + 1) % V          # reject at once
    draft_len = np.asarray([4, 4, 3, 0], np.int32)
    temps = np.zeros((S,), np.float32)
    t_toks, t_acc, t_com = spec_accept_tokens(
        Sampler(0, device="cpu"), list(range(Q)), torch.from_numpy(lp),
        torch.from_numpy(draft), torch.from_numpy(draft_len),
        torch.from_numpy(temps), any_sampled=False)
    from deeplearning4j_tpu.serving.sampler import Sampler as JaxSampler
    j_toks, j_acc, j_com = jax_spec_accept(
        JaxSampler(0).peek_keys(Q), jnp.asarray(lp), jnp.asarray(draft),
        jnp.asarray(draft_len), jnp.asarray(temps))
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))
    np.testing.assert_array_equal(t_com.numpy(), np.asarray(j_com))
    assert t_acc.tolist() == [4, 2, 0, 0]


def test_sampler_defaults_to_the_card(monkeypatch):
    """Built alone, a Sampler keeps its generator on the card unless the
    caller asks for the CPU: without CUDA the default raises."""
    assert Sampler(0, device="cpu").generator(3).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Sampler(0)


# ------------------------------------------------------------ engine parity
def _schedule(name, eng, req_cls):
    if name in ("spec", "spec_share"):
        return [r.tokens for r in eng.generate(
            [req_cls(list(p), max_new_tokens=12) for p in PROMPTS])]
    if name == "spec_eos_maxgen":
        return [r.tokens for r in eng.generate(
            [req_cls(REPETITIVE, max_new_tokens=10, eos_id=4),
             req_cls(PROMPTS[2], max_new_tokens=2),
             req_cls(P2, max_new_tokens=1)])]
    if name == "spec_midstream":
        f1 = eng.submit(req_cls(REPETITIVE, max_new_tokens=14))
        for _ in range(2):
            eng.step()
        f2 = eng.submit(req_cls(PROMPTS[2], max_new_tokens=9, eos_id=3))
        f3 = eng.submit(req_cls(P1, max_new_tokens=6))
        eng.drain()
        return [f.get(timeout=0).tokens for f in (f1, f2, f3)]
    raise ValueError(name)


ENGINE_CASES = {
    "spec": dict(spec_decode=True, prefix_share=False),
    "spec_share": dict(spec_decode=True, kv_block=4, prefix_share=True),
    "spec_eos_maxgen": dict(spec_decode=True, spec_draft=2),
    "spec_midstream": dict(spec_decode=True, kv_block=4),
    "kv_quant": dict(kv_quant=True, decode_chunk=8, overlap=True),
    "quant_weights": dict(quant_weights=True, decode_chunk=8, overlap=False),
    "int8_both": dict(kv_quant=True, quant_weights=True, kv_block=4,
                      prefill_chunk=8),
    "int8_both_spec": dict(kv_quant=True, quant_weights=True,
                           spec_decode=True),
}


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engine_tokens_and_host_syncs_match_jax(nets, name):
    net, tnet = nets
    kw = dict(max_seqs=3, max_len=48, seed=3, decode_chunk=1, overlap=False)
    kw.update(ENGINE_CASES[name])
    sched = name if name.startswith("spec_") and name != "spec_share" \
        else "spec"
    jeng = JaxEngine(net, **kw)
    teng = ServingEngine(tnet, device="cpu", **kw)
    ref = _schedule(sched, jeng, JaxRequest)
    out = _schedule(sched, teng, Request)
    assert out == ref
    js, ts = jeng.stats(), teng.stats()
    for key in ("host_syncs", "tokens_out", "spec_decode",
                "spec_tokens_accepted", "spec_tokens_rejected",
                "prefix_hits", "prefill_chunks"):
        assert ts[key] == js[key], key
    assert ts["jit_compiles"] == \
        jeng.metrics.get("serving.jit_compiles").value
    assert teng.decoder.cache.bytes() == jeng.decoder.cache.bytes()
    assert teng.decoder.cache.kv_quant == kw.get("kv_quant", False)
    assert teng.decoder.quant_weights == kw.get("quant_weights", False)
    if kw.get("spec_decode") and sched in ("spec", "spec_midstream"):
        assert ts["spec_tokens_accepted"] > 0


@pytest.mark.parametrize("temp", [0.0, 0.9])
def test_spec_on_equals_spec_off_in_the_port(nets, temp):
    """Greedy over three concurrent requests, and sampled for a single
    request (each committed token samples at its sequential chain
    position, so the stream is the spec-off stream). The sampled run also
    goes once with drafts that are the spec-off stream itself, so that
    sampled drafts are accepted too."""
    _, tnet = nets
    prompts = PROMPTS if temp == 0.0 else [REPETITIVE]

    def run(spec, oracle=None):
        eng = ServingEngine(tnet, max_seqs=3, max_len=48, seed=11,
                            decode_chunk=1, overlap=False, spec_decode=spec,
                            device="cpu")
        if oracle is not None:
            idx = eng._spec_index
            idx.propose = lambda slot, k: oracle[
                idx.history_len(slot) - len(REPETITIVE):][:k]
        toks = [r.tokens for r in eng.generate(
            [Request(list(p), max_new_tokens=16, temperature=temp)
             for p in prompts])]
        return toks, eng.stats()

    ref, off = run(False)
    got, on = run(True)
    assert got == ref and on["tokens_out"] == off["tokens_out"]
    assert on["spec_tokens_accepted"] + on["spec_tokens_rejected"] > 0
    if temp == 0.0:
        assert on["spec_tokens_accepted"] > 0
        assert on["host_syncs"] < off["host_syncs"]
    else:
        got, on = run(True, oracle=ref[0])
        assert got == ref
        assert on["spec_tokens_accepted"] > 0
        assert on["spec_tokens_rejected"] == 0
        assert on["host_syncs"] < off["host_syncs"]


def test_spec_without_matches_is_k1_sync_for_sync(nets):
    _, tnet = nets
    kw = dict(max_seqs=3, max_len=48, seed=3, decode_chunk=1, overlap=False,
              device="cpu")
    off = ServingEngine(tnet, **kw)
    ref = off.generate([Request(list(p), max_new_tokens=12)
                        for p in PROMPTS])
    eng = ServingEngine(tnet, spec_decode=True, **kw)
    eng._spec_index.propose = lambda slot, k: []
    got = eng.generate([Request(list(p), max_new_tokens=12)
                        for p in PROMPTS])
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    s_off, s_on = off.stats(), eng.stats()
    assert s_on["host_syncs"] == s_off["host_syncs"]
    assert s_on["spec_tokens_accepted"] == s_on["spec_tokens_rejected"] == 0


@pytest.mark.parametrize("opts", [dict(spec_decode=True),
                                  dict(spec_decode=True, kv_block=4,
                                       prefix_share=True)])
def test_spec_captured_rows_match_full_recompute(nets, opts):
    _, tnet = nets
    eng = ServingEngine(tnet, max_seqs=3, max_len=48, seed=3,
                        capture_logprobs=True, device="cpu", **opts)
    results = eng.generate([Request(list(p), max_new_tokens=12)
                            for p in PROMPTS])
    assert eng.stats()["spec_tokens_accepted"] > 0
    for prompt, res in zip(PROMPTS, results):
        ref = _oracle_logprobs(tnet, list(prompt) + res.tokens)
        assert len(res.logprobs) == len(res.tokens)
        for i, lp in enumerate(res.logprobs):
            np.testing.assert_allclose(lp, ref[:, len(prompt) - 1 + i],
                                       atol=1e-9, rtol=0)


def test_spec_env_knob_turns_it_on(nets, monkeypatch):
    _, tnet = nets
    monkeypatch.setenv("DL4J_TPU_SPEC_DECODE", "1")
    monkeypatch.setenv("DL4J_TPU_KV_QUANT", "1")
    eng = ServingEngine(tnet, max_seqs=2, max_len=32, device="cpu")
    assert eng.stats()["spec_decode"] == 1 and eng.decoder.cache.kv_quant
    assert eng.decoder.cache.state.k.dtype == torch.int8
