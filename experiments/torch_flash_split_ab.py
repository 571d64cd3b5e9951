#!/usr/bin/env python3
"""The bf16 split kernels of the port's flash attention (K3 and both passes
of K5 at head dims 384 and 512, whose two warpgroups share the head dim),
against their variants, on one CUDA card:

    python3 experiments/torch_flash_split_ab.py     # from the repo root
    python3 experiments/torch_flash_split_ab.py k4  # K4's variants

A variant is deeplearning4j_tpu_torch/ops/csrc/flash_attention_sm90.cu with
string edits, built by nvcc into its own directory under _scratch/ (all
variants at once) and loaded in place of the package's library:
  - "package": the source as it is;
  - "whole_s": K3's warpgroups each form S over the whole head dim (K =
    D) and exchange nothing: 1.5x the tensor work, no barrier a tile;
  - "fwd_other", "dq_other", "dkv_other": K3's, the dq pass's or the
    dk/dv pass's tiles swapped for the other choice at each head dim,
    each the largest ring the shared memory then holds (keys a tile,
    stages of the ring, exchange slots; one slot takes two barriers a
    tile, two slots one). The package takes: K3 64 keys, one stage, one
    slot at D 512 and 32, three, two at 384 (other: 32, two, two and 64,
    one, one); the dq pass 32, one, one and 16, three, two (other: 16,
    two, two and 32, two, one); the dk/dv pass 32 q rows, one stage, one
    slot at 512 and 32, two, one at 384 (other: 16, two, two and 16,
    three, two);
  - "opaque_other": `opaque` switched at each head dim: the descriptors
    of the resident operand and of a one-stage ring may be held in
    registers across the walk at D 512 (the compiler hoists them) and are
    recomputed at each product at 384, where the package does the
    opposite;
  - "no_dq", "no_dkv": K5 at D 384/512 without its dq pass or without
    its dk/dv pass (timing only: the pass's outputs are not written);
  - "no_exchange": no exchange in any split kernel, each warpgroup keeps
    its partial scores (timing only: the outputs are wrong).
At B*H 16, causal, bf16, T 1024 and 8192, each variant's K3 and K5 (the
whole call, with the torch work around the launch) are timed by CUDA
events in turns (each variant, then each again in reverse order). At T
1024 the variants that compute the function must hold chip_smoke.py's
bf16 flash limits against the plain versions (the backward with a key
mask and a non-zero lse cotangent) and give the same bits on two calls.
Prints one JSON object: {"device": ..., "ms": {case: {variant: [ms,
ms]}}, "err": {case: {variant: [max abs err, tile rel err]}}, "spills":
{variant: {kernel: [registers, spill stores, spill loads]}}}.

With `k4`, the fused backward (K4) at D 384/512 against its variants
(K4_VARIANTS, each edit only where K4's switch DQ is true):
  - "package": as it is: sweep 2 exchanges S^T, then dP^T, through a 16
    KB slot whose part of each warpgroup is its one dq piece slot between
    exchanges, the dS^T tiles beyond it, K5's stages;
  - "at_once": S^T and dP^T exchanged at once through a 32 KB slot, as
    K5 does, the dS^T tile in the warpgroup's part of it behind its piece
    slot; so one stage (with two the next exchange would overwrite dS^T
    before its dq products read it);
  - "one_stage": one stage at D 384 (D 512 as the package);
  - "opaque": the descriptors recomputed at each product at D 384 too;
  - "no_reduce": every staged piece handed back without its TMA
    reduce-adds (dq stays zero): the reductions compiled out;
  - "no_stage": the dq products run, nothing is staged;
  - "no_dq": no dq products and nothing staged.
At B*H 16, causal, bf16, T 1024 and 8192, each variant's K4 and the
package's K5 (the yardstick) are timed in turns, the whole call. At T 1024
(key mask, non-zero lse cotangent) each variant's dk and dv must equal
K5's bit for bit, and those that form dq must hold the bf16 flash limits
against the plain version. Prints the same JSON object.
"""
import json
import os
import sys

import _ab  # puts the repo on sys.path

import torch  # noqa: E402

from deeplearning4j_tpu_torch.ops import build  # noqa: E402
from deeplearning4j_tpu_torch.ops import flash_attention as fa  # noqa: E402

VARIANTS = {
    "package": [],
    "whole_s": [
        ("          ss_product<DH, BM, BN>(sc, at(qs), 0, at(ks + s * TILE));",
         "          ss_product<D, BM, BN>(sc, at(smem_u32(sm)), 0,\n"
         "                                at(smem_u32(Ks) + s * TILE));"),
        ("          exchange<BN, 1, C::XSLOTS>(xs, t, wg, tw, sc, sc);\n",
         "")],
    "fwd_other": [
        ("  static constexpr int BN = D > 384 ? 64 : 32;  // keys per tile\n"
         "  static constexpr int STAGES = D > 384 ? 1 : 3;\n"
         "  static constexpr int XSLOTS = D > 384 ? 1 : 2;",
         "  static constexpr int BN = D > 384 ? 32 : 64;  // keys per tile\n"
         "  static constexpr int STAGES = D > 384 ? 2 : 1;\n"
         "  static constexpr int XSLOTS = D > 384 ? 2 : 1;")],
    "dq_other": [
        ("  static constexpr int BN = D > 384 ? 32 : 16;  // keys per tile\n"
         "  static constexpr int STAGES = D > 384 ? 1 : 3;\n"
         "  static constexpr int XSLOTS = D > 384 ? 1 : 2;",
         "  static constexpr int BN = D > 384 ? 16 : 32;  // keys per tile\n"
         "  static constexpr int STAGES = 2;\n"
         "  static constexpr int XSLOTS = D > 384 ? 2 : 1;")],
    "dkv_other": [
        ("  static constexpr int BQ = 32;                 // q rows per tile\n"
         "  static constexpr int STAGES = D > 384 ? 1 : 2;\n"
         "  static constexpr int XSLOTS = 1;",
         "  static constexpr int BQ = 16;                 // q rows per tile\n"
         "  static constexpr int STAGES = D > 384 ? 2 : 3;\n"
         "  static constexpr int XSLOTS = 2;")],
    "opaque_other": [
        ("  static constexpr bool OPAQUE = D > 384;       // see opaque",
         "  static constexpr bool OPAQUE = D <= 384;      // see opaque")]
    + [("  static constexpr bool OPAQUE = D > 384;\n",
        "  static constexpr bool OPAQUE = D <= 384;\n")] * 2,
    "no_dq": [
        ("  kq<<<dim3((g.T + Q::BM - 1) / Q::BM, B * H), NT, Q::SMEM, st>>>(",
         "  if (D < 384)\n"
         "  kq<<<dim3((g.T + Q::BM - 1) / Q::BM, B * H), NT, Q::SMEM, st>>>(")],
    "no_dkv": [
        ("  return launch_dkv<D, false>(q, k, v, km, dout, lse, di, nullptr, "
         "dk, dv, B,",
         "  if (D >= 384) return 0;\n"
         "  return launch_dkv<D, false>(q, k, v, km, dout, lse, di, nullptr, "
         "dk, dv, B,")],
    "no_exchange": [
        ("                                         float (&b)[N / 2]) {\n"
         "  constexpr int PART = N / 2 * 128;\n",
         "                                         float (&b)[N / 2]) {\n"
         "  if (true) return;\n  constexpr int PART = N / 2 * 128;\n")],
}
# the variants whose outputs are the function's
CORRECT = ("package", "whole_s", "fwd_other", "dq_other", "dkv_other",
           "opaque_other")

STAGES = ("  static constexpr int STAGES = D > 384 ? 1 : 2;\n"
          "  static constexpr int XSLOTS = 1;\n",
          "  static constexpr int STAGES = D > 384 || DQ ? 1 : 2;\n"
          "  static constexpr int XSLOTS = 1;\n")
NO_HANDOFF = ("  const int uses = C::NPC * nt;\n", "  const int uses = 0;\n")
K4_VARIANTS = {
    "package": [],
    "at_once": [
        ("  static constexpr int XWG = (DQ ? 1 : 2) * PART;\n",
         "  static constexpr int XWG = 2 * PART;\n"),
        ("  static constexpr int L_OFF = DS_OFF + (DQ ? NCWG * DSBYTES : 0);\n",
         "  static constexpr int L_OFF = DS_OFF;\n"),
        ("    unsigned char* dsp = sm + C::DS_OFF + wg * C::DSBYTES;\n",
         "    unsigned char* dsp = sm + C::X_OFF + wg * C::XWG + C::PIECE;\n"),
        ("          if constexpr (DQ) {\n"
         "            exchange<BQ, 1, C::XSLOTS>(xs, nt + t, wg, tw, st, st);\n",
         "          if constexpr (false) {\n"
         "            exchange<BQ, 1, C::XSLOTS>(xs, nt + t, wg, tw, st, st);\n"),
        STAGES],
    "one_stage": [STAGES],
    "opaque": [("  static constexpr int XSLOTS = 1;\n"
                "  static constexpr bool OPAQUE = D > 384;\n",
                "  static constexpr int XSLOTS = 1;\n"
                "  static constexpr bool OPAQUE = D > 384 || DQ;\n")],
    "no_reduce": [
        ("        tma_reduce_add(p + h * (C::PIECE / 2), &tdq,\n"
         "                       w * (D / 2) + 64 * pc + 32 * h, "
         "(i0 + n) * C::BQ, bh);\n",
         "        (void)p;\n")],
    "no_stage": [
        ("    auto stage = [&](const float (&d)[16]) {\n",
         "    auto stage = [&](const float (&d)[16]) {\n      return;\n"),
        NO_HANDOFF],
    "no_dq": [
        ("    auto dq_tile = [&](int) {\n      if constexpr (DQ) {\n",
         "    auto dq_tile = [&](int) {\n      if constexpr (false) {\n"),
        NO_HANDOFF],
}
K4_FORMS_DQ = ("package", "at_once", "one_stage", "opaque")


def use(lib):
    _ab.use({fa.SM90_SOURCE: lib})
    fa._library(fa.SM90_SOURCE)


def spills_of(cs, tags):
    """{variant: {kernel: [registers, spill stores, spill loads]}} of the
    split kernels of each built variant (tags: {variant: build tag})"""
    out = {}
    for name, tag in tags.items():
        log = (_ab.REPO / "_scratch" / tag / "_build" /
               "flash_attention_sm90.log").read_text()
        out[name] = {k: [r.get("registers"), r.get("spill_stores"),
                         r.get("spill_loads")]
                     for k, r in cs.ptxas_kernels(log).items()
                     if "split" in k}
    return out


def device():
    return os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()


def main_k4():
    cs = _ab.load_chip_smoke()
    tags = {name: f"flash_k4_split_{name}" for name in K4_VARIANTS}
    libs = dict(zip(K4_VARIANTS, _ab.build_variants(fa.SM90_SOURCE, {
        tags[name]: [(fa.SM90_SOURCE, old, new) for old, new in edits]
        for name, edits in K4_VARIANTS.items()}).values()))
    spills = spills_of(cs, tags)
    print(json.dumps({"spills": spills}), flush=True)
    order = list(libs) + list(libs)[::-1]
    res, errs = {}, {}
    for D in (384, 512):
        for T in (1024, cs.TRAIN_T):
            key = f"D={D},T={T}"
            masked = T <= 1024
            q, k, v, do, m = cs.flash_case(torch, cs.TRAIN_B, cs.TRAIN_HEADS,
                                           cs.TRAIN_HEADS, T, D,
                                           torch.bfloat16, masked,
                                           seed=4646 + D)
            use(libs["package"])
            o, l = fa.flash_attention_fwd_cuda(q, k, v, m, True)
            dlse = None
            if masked:
                dlse = 0.3 * torch.randn(l.shape, device="cuda",
                                         generator=torch.Generator(
                                             "cuda").manual_seed(D))
                ref = fa.flash_bwd_plain(q, k, v, m, o, l, do, dlse, True)

            def bwd(mode):
                return fa.flash_attention_bwd_cuda(q, k, v, m, o, l, do,
                                                   dlse, True, None, 0, mode)
            g5 = bwd("two_pass")
            for name in order:
                use(libs[name])
                if masked and name not in errs.get(key, {}):
                    g4 = bwd("fused")
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b)
                               for a, b in zip(g4[1:], g5[1:])):
                        raise SystemExit(f"{key}: {name}'s K4 dk, dv differ "
                                         "from K5's")
                    err = max(cs.max_err(a, b) for a, b in zip(g4, ref))
                    rel = max(cs.tile_rel_err(torch, a, b,
                                              cs.FLASH_REF_FLOOR["bfloat16"])
                              for a, b in zip(g4, ref))
                    errs.setdefault(key, {})[name] = [err, rel]
                    if name in K4_FORMS_DQ and not (
                            err <= cs.FLASH_TOL["bfloat16"]
                            and rel <= cs.FLASH_REL_TOL["bfloat16"]):
                        raise SystemExit(f"{key}: {name}'s K4 vs plain: max "
                                         f"abs err {err}, tile rel err {rel}")
                    del g4
                row = res.setdefault(key, {})
                row.setdefault(f"K4 {name}", []).append(
                    cs.event_ms(torch, lambda: bwd("fused")))
                if name == "package":
                    row.setdefault("K5 package", []).append(
                        cs.event_ms(torch, lambda: bwd("two_pass")))
            print(json.dumps({key: res[key]}), flush=True)
            del q, k, v, do, m, o, l, g5
            if masked:
                del dlse, ref
    build._LOADED.pop(fa.SM90_SOURCE, None)
    print(json.dumps({"device": device(), "ms": res, "err": errs,
                      "spills": spills}))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if sys.argv[1:] == ["k4"]:
        return main_k4()
    cs = _ab.load_chip_smoke()
    libs = dict(zip(VARIANTS, _ab.build_variants(fa.SM90_SOURCE, {
        f"flash_split_{name}": [(fa.SM90_SOURCE, old, new)
                                for old, new in edits]
        for name, edits in VARIANTS.items()}).values()))
    # registers and spills of the split kernels, per variant
    spills = spills_of(cs, {name: f"flash_split_{name}"
                            for name in VARIANTS})
    print(json.dumps({"spills": spills}), flush=True)
    order = list(libs) + list(libs)[::-1]
    res, errs = {}, {}
    for D in (384, 512):
        for T in (1024, cs.TRAIN_T):
            key = f"D={D},T={T}"
            q, k, v, do, m = cs.flash_case(torch, cs.TRAIN_B, cs.TRAIN_HEADS,
                                           cs.TRAIN_HEADS, T, D,
                                           torch.bfloat16, T <= 1024,
                                           seed=4646 + D)
            o, l = fa.flash_attention_fwd_cuda(q, k, v, None, True)
            if T <= 1024:
                ro, rl = fa.flash_fwd_plain(q, k, v, m, True)
                dlse = 0.3 * torch.randn(rl.shape, device="cuda",
                                         generator=torch.Generator(
                                             "cuda").manual_seed(D))
                ref = fa.flash_bwd_plain(q, k, v, m, ro, rl, do, dlse, True)
            for name in order:
                use(libs[name])
                if T <= 1024 and name in CORRECT and name not in errs.get(
                        key, {}):
                    o1, l1 = fa.flash_attention_fwd_cuda(q, k, v, m, True)
                    o2, l2 = fa.flash_attention_fwd_cuda(q, k, v, m, True)
                    g1, g2 = (fa.flash_attention_bwd_cuda(
                        q, k, v, m, ro, rl, do, dlse, True, None, 0,
                        "two_pass") for _ in range(2))
                    torch.cuda.synchronize()
                    if not (torch.equal(o1, o2) and torch.equal(l1, l2)
                            and all(torch.equal(a, b)
                                    for a, b in zip(g1, g2))):
                        raise SystemExit(f"{key}: {name} differs between "
                                         "two calls")
                    err = max([cs.max_err(o1, ro), cs.lse_err(torch, l1, rl)]
                              + [cs.max_err(a, b) for a, b in zip(g1, ref)])
                    rel = max(cs.tile_rel_err(torch, a, b,
                                              cs.FLASH_REF_FLOOR["bfloat16"])
                              for a, b in zip((o1,) + tuple(g1),
                                              (ro,) + tuple(ref)))
                    errs.setdefault(key, {})[name] = [err, rel]
                    if not (err <= cs.FLASH_TOL["bfloat16"]
                            and rel <= cs.FLASH_REL_TOL["bfloat16"]):
                        raise SystemExit(f"{key}: {name} vs plain: max abs "
                                         f"err {err}, tile rel err {rel}")
                    del o1, o2, l1, l2, g1, g2
                row = res.setdefault(key, {})
                row.setdefault(f"K3 {name}", []).append(cs.event_ms(
                    torch, lambda: fa.flash_attention_fwd_cuda(q, k, v, None,
                                                               True)))
                row.setdefault(f"K5 {name}", []).append(cs.event_ms(
                    torch, lambda: fa.flash_attention_bwd_cuda(
                        q, k, v, None, o, l, do, None, True, None, 0,
                        "two_pass")))
            print(json.dumps({key: res[key]}), flush=True)
            del q, k, v, do, m, o, l
            if T <= 1024:
                del ro, rl, dlse, ref
    build._LOADED.pop(fa.SM90_SOURCE, None)
    print(json.dumps({"device": device(), "ms": res, "err": errs,
                      "spills": spills}))


if __name__ == "__main__":
    main()
