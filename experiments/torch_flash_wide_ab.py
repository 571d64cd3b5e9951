#!/usr/bin/env python3
"""Where the two-pass backward (K5) of the port's bf16 flash attention spends
its time at head dims 192 and 256, and one tile choice of its dq pass, on
one CUDA card:

    python3 experiments/torch_flash_wide_ab.py     # from the repo root

A variant is deeplearning4j_tpu_torch/ops/csrc/flash_attention_sm90.cu with
string edits, built by nvcc into its own directory under _scratch/ and
loaded in place of the package's library. Every variant gets a switch that
makes `dl4j_flash_sm90_bwd` launch only its dq pass (mode 1) or only its
dk/dv pass (mode 2); "package" is the source as it is plus the switch, and
"dq_bn64" gives the dq pass at D 192 key tiles of 64 in two stages instead
of 32 in three. At B*H 16, T 8192, causal, bf16, each variant's K5 (modes
0, 1, 2: the whole call, which includes the torch work around the
launches, then each pass with that work) and K3 are timed by CUDA events
in turns (each variant, then each again in reverse order); each variant's
K5 must hold chip_smoke.py's bf16 flash limits against the plain version.
Prints one JSON object: {case: {variant: [ms, ms]}}.
"""
import ctypes
import importlib.util
import json
import os
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from deeplearning4j_tpu_torch.ops import build  # noqa: E402
from deeplearning4j_tpu_torch.ops import flash_attention as fa  # noqa: E402

# the switch: a global read by launch_bwd, set through probe_set_mode
SWITCH = [
    ("namespace {\n\nusing namespace sm90;",
     "int g_probe_mode = 0;\nnamespace {\n\nusing namespace sm90;"),
    ("  kq<<<dim3((g.T + Q::BM - 1) / Q::BM, B * H), NT, Q::SMEM, st>>>(",
     "  if (g_probe_mode != 2)\n"
     "  kq<<<dim3((g.T + Q::BM - 1) / Q::BM, B * H), NT, Q::SMEM, st>>>("),
    ("  if constexpr (D <= 128) {\n    return launch_dkv<D, false>",
     "  if (g_probe_mode == 1) return 0;\n"
     "  if constexpr (D <= 128) {\n    return launch_dkv<D, false>"),
]
VARIANTS = {
    "package": [],
    "dq_bn64": [
        ("  static constexpr int BN = D <= 64 ? 128 : D <= 128 ? 64 : 32;\n"
         "  static constexpr int STAGES = 3;",
         "  static constexpr int BN = D <= 64 ? 128 : D <= 192 ? 64 : 32;\n"
         "  static constexpr int STAGES = D == 192 ? 2 : 3;")],
}
MODES = {"K5": 0, "K5_dq_pass": 1, "K5_dkv_pass": 2}


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variant(name, edits):
    csrc = REPO / "_scratch" / f"flash_wide_{name}"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(build.CSRC, csrc)
    path = csrc / fa.SM90_SOURCE
    text = path.read_text()
    for old, new in SWITCH + edits:
        if old not in text:
            raise SystemExit(f"{name}: {old!r} not in {fa.SM90_SOURCE}")
        text = text.replace(old, new, 1)
    path.write_text(text + '\nextern "C" void probe_set_mode(int m) '
                    '{ g_probe_mode = m; }\n')
    real = (build.CSRC, build.BUILD_DIR)
    build.CSRC, build.BUILD_DIR = csrc, csrc / "_build"
    try:
        lib = ctypes.CDLL(build.build([fa.SM90_SOURCE])[fa.SM90_SOURCE][
            "path"])
    finally:
        build.CSRC, build.BUILD_DIR = real
    lib.probe_set_mode.argtypes = [ctypes.c_int]
    return lib


def use(lib, mode=0):
    build._LOADED[fa.SM90_SOURCE] = lib
    fa._library(fa.SM90_SOURCE)
    lib.probe_set_mode(mode)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cs = load_chip_smoke()
    libs = {name: build_variant(name, edits)
            for name, edits in VARIANTS.items()}
    order = list(libs) + list(libs)[::-1]
    res = {}
    for D in (192, 256):
        q, k, v, do, _ = cs.flash_case(torch, cs.TRAIN_B, cs.TRAIN_HEADS,
                                       cs.TRAIN_HEADS, cs.TRAIN_T, D,
                                       torch.bfloat16, False, seed=4545 + D)
        o, l = fa.flash_fwd_plain(q, k, v, None, True)
        ref = fa.flash_bwd_plain(q, k, v, None, o, l, do, None, True)

        def k5():
            return fa.flash_attention_bwd_cuda(q, k, v, None, o, l, do, None,
                                               True, None, 0, "two_pass")
        for name in order:
            use(libs[name])
            g = k5()
            torch.cuda.synchronize()
            err = max(cs.max_err(a, b) for a, b in zip(g, ref))
            rel = max(cs.tile_rel_err(torch, a, b,
                                      cs.FLASH_REF_FLOOR["bfloat16"])
                      for a, b in zip(g, ref))
            if not (err <= cs.FLASH_TOL["bfloat16"]
                    and rel <= cs.FLASH_REL_TOL["bfloat16"]):
                raise SystemExit(f"D {D}: {name}'s K5 vs plain: max abs "
                                 f"err {err}, tile rel err {rel}")
            del g
            for case, mode in MODES.items():
                use(libs[name], mode)
                res.setdefault(f"D={D} {case}", {}).setdefault(
                    name, []).append(cs.event_ms(torch, k5))
            use(libs[name])
            res.setdefault(f"D={D} K3", {}).setdefault(name, []).append(
                cs.event_ms(torch, lambda: fa.flash_attention_fwd_cuda(
                    q, k, v, None, True)))
        del q, k, v, do, o, l, ref
    build._LOADED.pop(fa.SM90_SOURCE, None)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(json.dumps({"device": smi, "ms": res}))


if __name__ == "__main__":
    main()
