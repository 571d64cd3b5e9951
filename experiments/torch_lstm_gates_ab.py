#!/usr/bin/env python3
"""The per-step LSTM cells (K8, the Graves peephole cell, and K9, the
plain cell; `deeplearning4j_tpu_torch/ops/lstm_gates.py`), old design
against new, on one CUDA card:

    python3 experiments/torch_lstm_gates_ab.py OLD     # from the repo root

OLD is a directory holding another checkout of the repo (for example the
parent commit, from `git archive`, under _scratch/). Its `lstm_gates.py`
and `csrc/lstm_gates.cu` are the old design: one element a thread in
2-byte loads, and K8's backward writing per-block fp32 partials that a
torch sum and three casts reduce after the launch. This tree's are the
new: 16-byte rows and K8's backward in one launch, its last CTA of each
column block summing the partials. Besides the package's source, the new
design runs as variants, string edits of `csrc/lstm_gates.cu` built by
nvcc under _scratch/ (all at once) and loaded in the package's place:
  - "package": the source as it is: 128 rows a backward CTA in K8, 64 in
    K9, at least two CTAs an SM (registers capped at 128);
  - "rpb64", "rpb256": 64 or 256 rows a backward CTA in K8;
  - "k9_rpb128": 128 rows a backward CTA in K9;
  - "occ1": the backward's registers not capped;
  - "no_tail" (timing only: dpi/dpf/dpo are not written): K8's backward
    without its last CTA's sum over the row blocks;
  - "no_sums" (timing only): K8's backward without its peephole sums, so
    K8's cell math and K9's epilogue.
Each process (OLD, this tree, this tree, OLD) times the forward and the
backward of K8 and K9 at (B, H) = (8192, 256) in bf16 and fp32, each
call captured 20 times in a CUDA graph and replayed (chip_smoke.py's
`graph_ms`), and holds every output against the plain version within
chip_smoke.py's GATES_REL_TOL. Prints one JSON object: {"device": ...,
"ms": {case: {design: [ms, ms]}}, "bounds_ms": {case: ms}}.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "experiments"))
MARK = "GATES_AB "
SOURCE = "lstm_gates.cu"
VARIANTS = {
    "rpb64": [(SOURCE, "constexpr int RPB = 128;",
               "constexpr int RPB = 64;")],
    "rpb256": [(SOURCE, "constexpr int RPB = 128;",
                "constexpr int RPB = 256;")],
    "k9_rpb128": [(SOURCE, "constexpr int RPB_K9 = 64;",
                   "constexpr int RPB_K9 = 128;")],
    "occ1": [(SOURCE, "__global__ void __launch_bounds__(THREADS, 2)\n"
                      "gates_bwd_kernel(",
              "__global__ void __launch_bounds__(THREADS)\n"
              "gates_bwd_kernel(")],
    "no_tail": [(SOURCE, "nrb, &last)) return;",
                 "nrb, &last) || B) return;")],
    "no_sums": [(SOURCE, "  if constexpr (PEEP) {\n    __shared__",
                 "  if constexpr (PEEP && false) {\n    __shared__")],
}
TIMING_ONLY = ("no_tail", "no_sums")
B, H = 8192, 256


def child(root: Path, libs) -> None:
    """In `root`: time K8 and K9 with the package's library or each of
    `libs` (paths of variant builds) in its place; print one MARK line."""
    os.chdir(root)
    sys.path.insert(0, str(root))
    import ctypes
    import importlib.util

    import torch

    from deeplearning4j_tpu_torch.ops import build
    from deeplearning4j_tpu_torch.ops import lstm_gates as tg
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    designs = {"package": None} | {Path(p).parent.parent.name: p
                                   for p in libs}
    res, bad = {}, []
    for design, path in designs.items():
        build._LOADED.pop(SOURCE, None)
        if path is not None:
            build._LOADED[SOURCE] = ctypes.CDLL(path)
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            args = cs.gates_case(torch, B, H, dtype, seed=777)
            for peep, name in ((True, "K8"), (False, "K9")):
                kf, kb, pf_, pb = cs.gates_calls(tg, peep, args)
                torch.cuda.synchronize()
                for i, (k, p) in enumerate(zip(kf + kb, pf_ + pb)):
                    e = cs.rel_err(torch, k, p, 1e-3)
                    if design not in TIMING_ONLY and \
                            not e <= cs.GATES_REL_TOL[dt]:
                        bad.append(f"{design} {name} {dt} output {i}: {e}")
                g, c, pi, pf, po, dc, dh = args
                calls = {
                    "fwd": (lambda: tg.graves_gates_cuda(g, c, pi, pf, po))
                    if peep else (lambda: tg.lstm_gates_cuda(g, c)),
                    "bwd": (lambda: tg.graves_gates_bwd_cuda(
                        g, c, pi, pf, po, dc, dh))
                    if peep else (lambda: tg.lstm_gates_bwd_cuda(
                        g, c, dc, dh))}
                for kind, fn in calls.items():
                    res[f"{name} {kind} {dt} {design}"] = cs.graph_ms(
                        torch, fn)
            del args
    if bad:
        raise SystemExit(f"outside the limits: {bad}")
    print(MARK + json.dumps(res), flush=True)


def run(root, libs=()):
    return subprocess.Popen([sys.executable, __file__, "--child", str(root),
                             *map(str, libs)], stdout=subprocess.PIPE,
                            text=True)


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit("usage: torch_lstm_gates_ab.py OLD")
    import _ab
    old = Path(sys.argv[1]).resolve()
    built = _ab.build_variants(SOURCE, VARIANTS)
    libs = [REPO / "_scratch" / tag / "_build" / "lstm_gates.so"
            for tag in built]
    ms = {}
    for tree in (old, REPO, REPO, old):
        p = run(tree, libs if tree == REPO else ())
        out, _ = p.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith(MARK)]
        if p.returncode or not lines:
            raise SystemExit(f"{tree}: exit {p.returncode}\n{out[-2000:]}")
        for key, x in json.loads(lines[-1][len(MARK):]).items():
            name, kind, dt, design = key.split()
            design = "old" if tree == old else design
            ms.setdefault(f"{name} {kind} {dt}", {}).setdefault(
                design, []).append(x)
    cs = _ab.load_chip_smoke()
    bounds = {f"{name} {kind} {dt}": cs.gates_bound(
        B, H, 2 if dt == "bfloat16" else 4, kind, name == "K8")[2]
        for name in ("K8", "K9") for kind in ("fwd", "bwd")
        for dt in ("bfloat16", "float32")}
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(json.dumps({"device": smi, "shape": {"B": B, "H": H},
                      "ms": ms, "bounds_ms": bounds}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(Path(sys.argv[2]), sys.argv[3:])
    else:
        main()
