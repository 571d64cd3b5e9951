#!/usr/bin/env python3
"""Compare checkouts of the port on one CUDA card, in turns:

    python3 experiments/torch_tree_ab.py OTHER [OTHER ...]   # repo root

Each OTHER is a directory holding another checkout of the repo, for
example `git archive` of the parent commit unpacked under _scratch/. Every
tree (this one first) builds the kernel sources of the flash and decode
paths, all trees at once; then the trees run in turns (the list, then the
list reversed), each in a process of its own that imports its own package
and its own chip_smoke.py: the long-context training step and the serve
of chip_smoke.py (phase_train, phase_serve, which check their own
outputs), and K4 and K5 at B*H 16, T 8192, causal, bf16, head dims 192 and
256, timed by CUDA events (the whole call, with its torch work). Prints
one JSON object: {"device": ..., "trees": [...], "values": {case: {tree:
[value, value]}}}.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
MARK = "TREE_AB "


def child(root: Path, build_only: bool) -> None:
    """In `root`: build, then print one MARK line of this tree's values."""
    os.chdir(root)
    sys.path.insert(0, str(root))
    import importlib.util

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.ops import build
    from deeplearning4j_tpu_torch.ops import decode_attention as da
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    build.build(sorted({*da.SOURCES, *fa.SOURCES}))
    if build_only:
        return
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    train = cs.phase_train(torch, np)
    serve = cs.phase_serve(torch, np)
    res = {"long-context fused ms/step": train["ms_per_step"],
           "long-context two_pass ms/step": train["two_pass"]["ms_per_step"],
           "serve tok/s": serve["tokens_per_s"]}
    for D in (192, 256):
        q, k, v, do, _ = cs.flash_case(torch, cs.TRAIN_B, cs.TRAIN_HEADS,
                                       cs.TRAIN_HEADS, cs.TRAIN_T, D,
                                       torch.bfloat16, False, seed=4545 + D)
        o, lse = fa.flash_fwd_plain(q, k, v, None, True)
        for case, mode in (("K4", "fused"), ("K5", "two_pass")):
            res[f"D={D} {case} ms"] = cs.event_ms(
                torch, lambda: fa.flash_attention_bwd_cuda(
                    q, k, v, None, o, lse, do, None, True, None, 0, mode))
        del q, k, v, do, o, lse
    print(MARK + json.dumps(res), flush=True)


def run(root: str, *extra: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, __file__, "--child", root,
                             *extra], stdout=subprocess.PIPE, text=True)


def main() -> None:
    trees = [str(REPO)] + [str(Path(t).resolve()) for t in sys.argv[1:]]
    if len(trees) < 2:
        raise SystemExit("usage: torch_tree_ab.py OTHER [OTHER ...]")
    builds = [run(t, "--build") for t in trees]
    if any(p.wait() for p in builds):
        raise SystemExit("a tree's build failed")
    values = {}
    for t in trees + trees[::-1]:
        p = run(t)
        out, _ = p.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith(MARK)]
        if p.returncode or not lines:
            raise SystemExit(f"{t}: exit {p.returncode}\n{out[-2000:]}")
        for case, x in json.loads(lines[-1][len(MARK):]).items():
            values.setdefault(case, {}).setdefault(t, []).append(x)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(json.dumps({"device": smi, "trees": trees, "values": values}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(Path(sys.argv[2]), sys.argv[3:] == ["--build"])
    else:
        main()
