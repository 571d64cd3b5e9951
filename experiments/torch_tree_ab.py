#!/usr/bin/env python3
"""Compare checkouts of the port on one CUDA card, in turns:

    python3 experiments/torch_tree_ab.py [--paths P] OTHER [OTHER ...]

from the repo root. Each OTHER is a directory holding another checkout of
the repo, for example `git archive` of the parent commit unpacked under
_scratch/. Every tree (this one first) builds the kernel sources of the
chosen paths, all trees at once; then the trees run in turns (the list,
then the list reversed), each in a process of its own that imports its
own package and its own chip_smoke.py. P (default "lstm_resnet"):
  - "lstm_resnet": the char-RNN's masked `fit_batch` (chip_smoke.py's zoo
    GravesLSTM stack at B 8192, T 100, bf16, its mask: every step of each
    layer through K8, forward and backward) and the ResNet50 b256 bf16
    step through `ParallelWrapper` in SHARED_GRADIENTS on one card (K10,
    and K11 over the 214 parameter tensors), each as ms per call on the
    host clock around a synchronized run after a warm call: the masked
    step 3 times, the wrapped step as `fit_on_device(steps=5, sync=False)`;
  - "flash": the long-context training step and the serve of
    chip_smoke.py (phase_train, phase_serve, which check their own
    outputs), and K3, K4 and K5 at B*H 16, T 8192, causal, bf16, head dims
    64, 128, 192 and 256, timed by CUDA events (the whole call, with its
    torch work).
Prints one JSON object: {"device": ..., "trees": [...], "values": {case:
{tree: [value, value]}}}.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
MARK = "TREE_AB "


def lstm_resnet(torch, np, cs) -> dict:
    """ms per call of the masked GravesLSTM fit_batch and of the wrapped
    ResNet50 step."""
    import time

    from deeplearning4j_tpu_torch.parallel import TrainingMode
    net = cs.char_rnn(torch, "bfloat16")
    x, y = (torch.from_numpy(a).cuda() for a in cs.char_data(np))
    m = torch.from_numpy(cs.char_mask(np)).cuda()
    net.fit_batch(x, y, m, m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        net.fit_batch(x, y, m, m)
    torch.cuda.synchronize()
    res = {"masked GravesLSTM fit_batch ms":
           (time.perf_counter() - t0) / 3 * 1e3}
    del net, x, y, m
    pw = cs.resnet_wrapper(cs.resnet_net("bfloat16"),
                           TrainingMode.SHARED_GRADIENTS)
    x, y = cs.resnet_data(torch, np, cs.RESNET_B)
    pw.fit_on_device(x, y, steps=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pw.fit_on_device(x, y, steps=5, sync=False)
    torch.cuda.synchronize()
    res["wrapped ResNet50 ms/step"] = (time.perf_counter() - t0) / 5 * 1e3
    return res


def child(root: Path, paths: str, build_only: bool) -> None:
    """In `root`: build, then print one MARK line of this tree's values."""
    os.chdir(root)
    sys.path.insert(0, str(root))
    import importlib.util

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.ops import build
    if paths == "flash":
        from deeplearning4j_tpu_torch.ops import decode_attention as da
        from deeplearning4j_tpu_torch.ops import flash_attention as fa
        build.build(sorted({*da.SOURCES, *fa.SOURCES}))
    else:
        from deeplearning4j_tpu_torch.ops import conv_fused as cf
        from deeplearning4j_tpu_torch.ops import lstm_gates as tg
        from deeplearning4j_tpu_torch.ops import lstm_scan_fused as ts
        from deeplearning4j_tpu_torch.ops import threshold_encode as te
        build.build(sorted({*ts.SOURCES, tg.SOURCE, cf.SOURCE, te.SOURCE}))
    if build_only:
        return
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if paths != "flash":
        print(MARK + json.dumps(lstm_resnet(torch, np, cs)), flush=True)
        return
    train = cs.phase_train(torch, np)
    serve = cs.phase_serve(torch, np)
    res = {"long-context fused ms/step": train["ms_per_step"],
           "long-context two_pass ms/step": train["two_pass"]["ms_per_step"],
           "serve tok/s": serve["tokens_per_s"]}
    for D in (64, 128, 192, 256):
        q, k, v, do, _ = cs.flash_case(torch, cs.TRAIN_B, cs.TRAIN_HEADS,
                                       cs.TRAIN_HEADS, cs.TRAIN_T, D,
                                       torch.bfloat16, False, seed=4545 + D)
        o, lse = fa.flash_fwd_plain(q, k, v, None, True)
        res[f"D={D} K3 ms"] = cs.event_ms(
            torch, lambda: fa.flash_attention_fwd_cuda(q, k, v, None, True))
        for case, mode in (("K4", "fused"), ("K5", "two_pass")):
            res[f"D={D} {case} ms"] = cs.event_ms(
                torch, lambda: fa.flash_attention_bwd_cuda(
                    q, k, v, None, o, lse, do, None, True, None, 0, mode))
        del q, k, v, do, o, lse
    print(MARK + json.dumps(res), flush=True)


def run(root: str, paths: str, *extra: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, __file__, "--child", root,
                             paths, *extra], stdout=subprocess.PIPE,
                            text=True)


def main() -> None:
    args = sys.argv[1:]
    paths = "lstm_resnet"
    if args[:1] == ["--paths"]:
        paths, args = args[1], args[2:]
    trees = [str(REPO)] + [str(Path(t).resolve()) for t in args]
    if len(trees) < 2 or paths not in ("lstm_resnet", "flash"):
        raise SystemExit("usage: torch_tree_ab.py [--paths lstm_resnet|"
                         "flash] OTHER [OTHER ...]")
    builds = [run(t, paths, "--build") for t in trees]
    if any(p.wait() for p in builds):
        raise SystemExit("a tree's build failed")
    values = {}
    for t in trees + trees[::-1]:
        p = run(t, paths)
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
        child(Path(sys.argv[2]), sys.argv[3], sys.argv[4:] == ["--build"])
    else:
        main()
