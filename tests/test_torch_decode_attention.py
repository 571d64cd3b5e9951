"""The port's paged decode attention against the JAX package's.

The plain PyTorch version `decode_attention_dense_paged` (what the CPU path
runs, and what chip_smoke.py holds the CUDA kernel against on the card)
must equal the JAX package's Pallas kernel `flash_decode_attention_paged`
(interpret mode on the CPU, as tests/test_decode_attention.py runs it) and
its dense paged oracle, in float64, to 1e-10. Inputs are numpy draws handed
to both packages: GQA groups 1/2/4, windows 0/5, block sizes 4/8 (4 takes
the JAX dense fallback), ragged visible lengths including 1 and the full
table, shuffled block tables whose unused entries point at the trash block,
and an int8 pool with per-(block, head) scales. The CUDA kernel itself is held
against the same plain version on the card by chip_smoke.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops.decode_attention import (
    decode_attention_dense_paged as jax_dense_paged,
    flash_decode_attention_paged as jax_flash_paged)
from deeplearning4j_tpu_torch.ops import build, helpers
from deeplearning4j_tpu_torch.ops import decode_attention as tda

ATOL = 1e-10


def _case(G, window, bs, quant, seed, S=3, Hk=2, D=8, bps=4):
    rng = np.random.RandomState(seed)
    H, L = Hk * G, bps * bs
    nb = S * bps + 2                       # physical blocks; index nb = trash
    visible = np.asarray([1, L] + list(rng.randint(1, L + 1, S - 2)),
                         np.int32)
    perm = rng.permutation(nb)
    bt = np.full((S, bps), nb, np.int32)
    used = 0
    for s in range(S):
        n = -(-int(visible[s]) // bs)
        bt[s, :n] = perm[used:used + n]
        used += n
    q = rng.randn(S, H, D)
    shape = (nb + 1, bs, Hk, D)
    if quant:
        kp = rng.randint(-127, 128, shape).astype(np.int8)
        vp = rng.randint(-127, 128, shape).astype(np.int8)
        scales = {"k_scale": rng.uniform(1e-3, 2e-2, (nb + 1, Hk)),
                  "v_scale": rng.uniform(1e-3, 2e-2, (nb + 1, Hk))}
    else:
        kp, vp, scales = rng.randn(*shape), rng.randn(*shape), {}
    return (q, kp, vp, bt, visible, 1.0 / np.sqrt(D), window), scales


def _torch(args, scales):
    q, kp, vp, bt, vis, scale, window = args
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, kp, vp, bt,
                                                            vis)]
    return (*t, scale, window), {k: torch.from_numpy(v)
                                 for k, v in scales.items()}


def _jax(args, scales):
    q, kp, vp, bt, vis, scale, window = args
    return ((jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
             jnp.asarray(bt), jnp.asarray(vis), scale, window),
            {k: jnp.asarray(v) for k, v in scales.items()})


CASES = [(G, w, bs, False) for G in (1, 2, 4) for w in (0, 5)
         for bs in (4, 8)] + [(G, 5, 8, True) for G in (1, 2, 4)] \
    + [(2, 0, 4, True)]


@pytest.mark.parametrize("G,window,bs,quant", CASES)
def test_plain_paged_matches_jax_kernel_and_oracle(G, window, bs, quant):
    args, scales = _case(G, window, bs, quant, seed=G * 10 + window + bs)
    targs, tsc = _torch(args, scales)
    out = tda.decode_attention_dense_paged(*targs, **tsc).numpy()
    jargs, jsc = _jax(args, scales)
    ref_kernel = np.asarray(jax_flash_paged(*jargs, **jsc))
    ref_dense = np.asarray(jax_dense_paged(*jargs, **jsc))
    assert out.dtype == np.float64
    np.testing.assert_allclose(out, ref_kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, ref_dense, atol=ATOL, rtol=0)
    # the wrapper on CPU tensors IS the plain version, and launches nothing
    before = tda.flash_decode_attention_paged.launches
    wrapped = tda.flash_decode_attention_paged(*targs, **tsc).numpy()
    assert np.array_equal(wrapped, out)
    assert tda.flash_decode_attention_paged.launches == before


def test_merge_of_exact_partials_equals_dense():
    """The logaddexp merge the CUDA wrapper applies to the kernel's
    per-block partials, fed partials computed in float64 from the plain
    math, reproduces the dense result: the merge algebra is exact."""
    args, _ = _case(2, 5, 8, False, seed=3)
    q, kp, vp, bt, vis, scale, window = _torch(args, {})[0]
    S, H, D = q.shape
    Hk, bs, bps = kp.shape[2], kp.shape[1], bt.shape[1]
    G = H // Hk
    o_p = torch.zeros(S, Hk, bps, 1, G, D, dtype=torch.float64)
    l_p = torch.full((S, Hk, bps, 1, G), tda.NEG_INF, dtype=torch.float64)
    q4 = q.reshape(S, Hk, G, D)
    for s in range(S):
        v = int(vis[s])
        for j in range(bps):
            pos = j * bs + torch.arange(bs)
            ok = (pos < v) & (v - 1 - pos < window)
            if not bool(ok.any()):
                continue
            k, vv = kp[bt[s, j]], vp[bt[s, j]]          # (bs, Hk, D)
            sc = torch.einsum("hgd,thd->hgt", q4[s], k) * scale
            sc = sc.masked_fill(~ok, tda.NEG_INF)
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None]) * ok
            l = p.sum(-1)
            o_p[s, :, j, 0] = torch.einsum("hgt,thd->hgd", p,
                                           vv) / l[..., None]
            l_p[s, :, j, 0] = m + torch.log(l)
    out = tda.merge_partials(o_p, l_p, torch.float64)[:, 0]
    ref = tda.decode_attention_dense_paged(q, kp, vp, bt, vis, scale, window)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=0)


def test_seam_routes_by_device():
    """CPU tensors get the plain version; the kernel is registered for CUDA
    tensors and no switch turns it off there."""
    x = torch.zeros(1)
    plain = tda.decode_attention_dense_paged
    assert helpers.helper_for("decode_attention_paged", plain, x) is plain
    assert helpers.registered_helpers()["decode_attention_paged"] \
        is tda.flash_decode_attention_paged
    with pytest.raises(ValueError):
        tda.flash_decode_partials(*_torch(*_case(1, 0, 8, False, 0))[0])


def test_kernel_build_raises_without_nvcc(monkeypatch):
    """A missing compiler is an error, never a silent fallback."""
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc()

