#!/usr/bin/env python3
"""Where the fused backward (K4) of the port's bf16 flash attention spends
its time at head dims 192 and 256, on one CUDA card:

    python3 experiments/torch_flash_k4_wide_ab.py     # from the repo root

A variant is deeplearning4j_tpu_torch/ops/csrc/flash_attention_sm90.cu with
string edits, built by nvcc into its own directory under _scratch/ and
loaded in place of the package's library:
  - "package": the source as it is;
  - "p0_first": the first dq piece of a tile multiplied before the dk and
    dv products instead of after them, and staged while they run;
  - "hold_box": a dq warp hands a box back once the reduction of the box
    after it has been issued (and this one's has read it), not as soon as
    its own reduction has read it;
  - "ring_swap": the two warpgroups' staging rings swapped: two boxes
    for warpgroup 0 and one for 1 at D 256, three and two at D 192;
  - "no_reduce": every staged box is handed back without the TMA
    reduce-add (dq stays zero): the reductions compiled out;
  - "no_reduce_fence": that, and no proxy fence after each box is written;
  - "no_stage": the dq products run, nothing is staged;
  - "no_dq": no dq products and nothing staged: K5's wide dk/dv pass at
    K4's stage count (two at D 192, where K5 takes three).
Every edit leaves the source as it was where K4's switch DQ is false.
At B*H 16, T 8192, causal, bf16, each variant's K4 and K5 (the two-pass
backward, unchanged by every edit: the yardstick inside the call) are timed
by CUDA events in turns (each variant, then each again in reverse order),
the whole call, with the torch work around the launch (D_i, the zeroed fp32
dq, its cast). Each variant's dk and dv must equal K5's bit for bit; those
that form dq must also hold chip_smoke.py's bf16 flash limits against the
plain version. Prints one JSON object: {case: {variant: [ms, ms]}}.
"""
import json
import os

import _ab  # puts the repo on sys.path

import torch  # noqa: E402

from deeplearning4j_tpu_torch.ops import build  # noqa: E402
from deeplearning4j_tpu_torch.ops import flash_attention as fa  # noqa: E402

RED = ("          tma_reduce_add(sb + s * C::SBYTES, &tdq,\n"
       "                         64 * (P::PC0 + pc) + 32 * h, "
       "(i0 + n) * C::BQ, bh);\n")
NO_STAGE = [
    ("  auto stage_piece = [&] {\n",
     "  auto stage_piece = [&] {\n    if (true) return;\n"),
    ("  const int uses = 2 * P::NPC * nt;\n",
     "  if (true) return;\n  const int uses = 2 * P::NPC * nt;\n")]
VARIANTS = {
    "package": [],
    "p0_first": [
        ("    wg_fence();\n    dkv_products(sp);\n    dq_piece(0);\n"
         "    wg_commit();\n",
         "    wg_fence();\n    dq_piece(0);\n"
         "    if constexpr (DQ) wg_commit();\n"
         "    dkv_products(sp);\n    wg_commit();\n"),
        ("    wg_wait<1>();\n    fence_regs(dva);\n    fence_regs(dka);\n"
         "    fence_regs(dqa);\n    mbar_arrive(&empty[sp]);\n"
         "    stage_piece();\n",
         "    if constexpr (DQ) {\n      wg_wait<2>();\n"
         "      fence_regs(dqa);\n      stage_piece();\n    }\n"
         "    wg_wait<1>();\n    fence_regs(dva);\n    fence_regs(dka);\n"
         "    mbar_arrive(&empty[sp]);\n")],
    "hold_box": [
        ("          bulk_wait_read<0>();\n        }\n        __syncwarp();\n"
         "        if (j + NSB < uses) named_arrive(P::FREE + s, DQ_HANDOFF);",
         "          bulk_wait_read<NSB - 1>();\n        }\n"
         "        __syncwarp();\n        const int f = j - (NSB - 1);\n"
         "        if (f >= 0 && f + NSB < uses)\n"
         "          named_arrive(P::FREE + f % NSB, DQ_HANDOFF);")],
    "ring_swap": [
        ("NSB0 = !DQ ? 0 : D > 192 ? 1 : 2;\n"
         "  static constexpr int NSB1 = !DQ ? 0 : D > 192 ? 2 : 3;",
         "NSB0 = !DQ ? 0 : D > 192 ? 2 : 3;\n"
         "  static constexpr int NSB1 = !DQ ? 0 : D > 192 ? 1 : 2;")],
    "no_reduce": [(RED, "")],
    "no_reduce_fence": [
        (RED, ""),
        ("tw, cq);\n    fence_async_smem();\n", "tw, cq);\n")],
    "no_stage": NO_STAGE,
    "no_dq": [
        ("        wgmma_ss_t<64>(dqa, desc_mn<64, BK>(dss, kk),\n"
         "                       desc_mn<64, BK>(kb, kk), kk > 0);", "{}")]
    + NO_STAGE,
}
FORMS_DQ = ("package", "p0_first", "hold_box", "ring_swap")


def use(lib):
    _ab.use({fa.SM90_SOURCE: lib})
    fa._library(fa.SM90_SOURCE)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cs = _ab.load_chip_smoke()
    libs = {name: _ab.build_variant(
        f"flash_k4_{name}", [fa.SM90_SOURCE],
        [(fa.SM90_SOURCE, old, new) for old, new in edits])[fa.SM90_SOURCE]
            for name, edits in VARIANTS.items()}
    order = list(libs) + list(libs)[::-1]
    res = {}
    for D in (192, 256):
        q, k, v, do, _ = cs.flash_case(torch, cs.TRAIN_B, cs.TRAIN_HEADS,
                                       cs.TRAIN_HEADS, cs.TRAIN_T, D,
                                       torch.bfloat16, False, seed=4545 + D)
        o, l = fa.flash_fwd_plain(q, k, v, None, True)
        ref = fa.flash_bwd_plain(q, k, v, None, o, l, do, None, True)

        def bwd(mode):
            return fa.flash_attention_bwd_cuda(q, k, v, None, o, l, do, None,
                                               True, None, 0, mode)
        for name in order:
            use(libs[name])
            g4, g5 = bwd("fused"), bwd("two_pass")
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(g4[1:], g5[1:])):
                raise SystemExit(f"D {D}: {name}'s K4 dk, dv differ from "
                                 "K5's")
            if name in FORMS_DQ:
                err = max(cs.max_err(a, b) for a, b in zip(g4, ref))
                rel = max(cs.tile_rel_err(torch, a, b,
                                          cs.FLASH_REF_FLOOR["bfloat16"])
                          for a, b in zip(g4, ref))
                if not (err <= cs.FLASH_TOL["bfloat16"]
                        and rel <= cs.FLASH_REL_TOL["bfloat16"]):
                    raise SystemExit(f"D {D}: {name}'s K4 vs plain: max abs "
                                     f"err {err}, tile rel err {rel}")
            del g4, g5
            for case, mode in (("K4", "fused"), ("K5", "two_pass")):
                res.setdefault(f"D={D} {case}", {}).setdefault(
                    name, []).append(cs.event_ms(torch, lambda: bwd(mode)))
        del q, k, v, do, o, l, ref
    build._LOADED.pop(fa.SM90_SOURCE, None)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(json.dumps({"device": smi, "ms": res}))


if __name__ == "__main__":
    main()
