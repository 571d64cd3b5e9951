"""What the port's A/B experiments share. A variant is the package's CUDA
sources with string edits, copied into its own directory under _scratch/,
built by nvcc there and loaded in place of the package's library;
chip_smoke.py supplies the cases, timers and limits. Imported by the
experiments/torch_*_ab.py scripts, which hold their variants' edits."""
import ctypes
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from deeplearning4j_tpu_torch.ops import build  # noqa: E402


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def edited_copy(tag, edits, tail=None):
    """The package's CUDA sources copied to _scratch/<tag>, each edit
    (file, old, new) made once, and each text of `tail` ({file: text})
    appended to its file; fails naming an edit whose text is missing."""
    csrc = REPO / "_scratch" / tag
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(build.CSRC, csrc)
    for fname, old, new in edits:
        path = csrc / fname
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"{tag}: {old!r} not in {fname}")
        path.write_text(text.replace(old, new, 1))
    for fname, text in (tail or {}).items():
        path = csrc / fname
        path.write_text(path.read_text() + text)
    return csrc


def build_variant(tag, sources, edits, tail=None):
    """{source: library} of `sources` built from edited_copy(tag, ...)."""
    csrc = edited_copy(tag, edits, tail)
    real = (build.CSRC, build.BUILD_DIR)
    build.CSRC, build.BUILD_DIR = csrc, csrc / "_build"
    try:
        return {s: ctypes.CDLL(b["path"])
                for s, b in build.build(sources).items()}
    finally:
        build.CSRC, build.BUILD_DIR = real


def build_variants(source, variants):
    """{tag: library} of `source` built from edited_copy(tag, edits) for
    each (tag, edits) of `variants`, one nvcc each, all started together
    (the compiler's output kept beside each library as .log); fails naming
    a variant whose build fails."""
    procs = []
    for tag, edits in variants.items():
        csrc = edited_copy(tag, edits)
        out = csrc / "_build" / f"{Path(source).stem}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
               str(csrc / source)]
        procs.append((tag, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for tag, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{tag}: nvcc failed:\n{log[-4000:]}")
        out.with_suffix(".log").write_text(log)
        libs[tag] = ctypes.CDLL(str(out))
    return libs


def use(libs):
    """Put `libs` ({source: library}) in the place of the package's; the
    caller then rebinds its module's entry points."""
    build._LOADED.update(libs)
