#!/usr/bin/env python3
"""Time the in-launch merge of the port's split-K decode kernels (K1/K2 in
deeplearning4j_tpu_torch/ops/csrc/flash_decode_paged.cu, K6 in
flash_decode_contiguous.cu) in variants, on one CUDA card:

    python3 experiments/torch_decode_merge_ab.py     # from the repo root

A variant is the sources with string edits (`merge_partitions`'s E output
elements a thread and U partitions a step, or the per-element merge only),
each built by nvcc into its own directory under _scratch/ and loaded in
place of the package's library. K1 (Q 1) and K2 (Q 5, 9) at chip_smoke.py's
served shape with the bf16 and the int8 pool, and K6 at its served shape,
are timed by CUDA-graph replay in turns (each variant, then each again in
reverse order), and every variant's output must equal the package's bit for
bit. Prints one JSON object: {case: {variant: [ms, ms]}}.
"""
import json
import os

import _ab  # puts the repo on sys.path

import torch  # noqa: E402

from deeplearning4j_tpu_torch.ops import build  # noqa: E402
from deeplearning4j_tpu_torch.ops import decode_attention as da  # noqa: E402

PAGED_CALL = "merge_partitions<TQ, NT, 4, 4>"
CONT_CALL = "merge_partitions<T, NT, 8, 2>"
STAGED = "if (R * D > NT && (n + 1) * R <= cap) {"
VARIANTS = {
    "per_element": [("flash_decode_common.cuh", STAGED, "if (false) {")],
    "paged_e8u2": [("flash_decode_paged.cu", PAGED_CALL,
                    "merge_partitions<TQ, NT, 8, 2>")],
    "cont_e4u4": [("flash_decode_contiguous.cu", CONT_CALL,
                   "merge_partitions<T, NT, 4, 4>")],
}
SOURCES = (da.SOURCE, da.CONTIGUOUS_SOURCE)


def use(libs):
    _ab.use(libs)
    da._library()
    da._contiguous_library()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cs = _ab.load_chip_smoke()
    libs = {"package": {s: build.load(s) for s in SOURCES}}
    for name, edits in VARIANTS.items():
        libs[name] = _ab.build_variant(f"merge_{name}", SOURCES, edits)
    order = list(libs) + list(libs)[::-1]
    S, Hk, G, D, bs, bps, visible = cs.served_shape()
    cases = {}
    for kind in ("bfloat16", "int8_bf16q"):
        for Q in (1, 5, 9):
            a, sc = cs.paged_case(torch, S, Hk, G, D, bs, bps, 0,
                                  torch.bfloat16, cs.SWEEP[kind][1],
                                  seed=77 + Q, visible=visible,
                                  Q=None if Q == 1 else Q)
            fn = da.flash_decode_attention_paged if Q == 1 \
                else da.flash_decode_attention_spec_paged
            cases[f"K{1 if Q == 1 else 2} {kind} Q{Q}"] = (
                lambda fn=fn, a=a, sc=sc: fn(*a, **sc))
    q, kc, vc, vis, scale = cs.contiguous_case(
        torch, S, 1024, Hk, G, D, torch.bfloat16, seed=99, visible=visible)
    cases["K6 bfloat16"] = lambda: da.flash_decode_attention(q, kc, vc, vis,
                                                             scale)
    res = {}
    for case, call in cases.items():
        ref = None
        for name in order:
            use(libs[name])
            out = call()
            ref = out if ref is None else ref
            if not torch.equal(out, ref):
                raise SystemExit(f"{case}: {name} differs from the package")
            res.setdefault(case, {}).setdefault(name, []).append(
                cs.graph_ms(torch, call))
    use(libs["package"])
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(json.dumps({"device": smi, "ms": res}))


if __name__ == "__main__":
    main()
