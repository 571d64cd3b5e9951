"""The port's kernel build (deeplearning4j_tpu_torch/ops/build.py) on the
CPU: the library name follows the source, every csrc header and the
flags; a library already built is reused with its compiler log. nvcc
itself runs only on the machine with the card."""
import pytest

from deeplearning4j_tpu_torch.ops import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "common.cuh"\nint a;\n')
    (src / "b.cu").write_text("int b;\n")
    (src / "common.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return src


def test_library_path_hashes_source_and_headers(csrc):
    a, b = build.library_path("a.cu"), build.library_path("b.cu")
    assert a.name.startswith("a-") and a.suffix == ".so" and a != b
    assert build.library_path("a.cu") == a
    (csrc / "common.cuh").write_text("#pragma once\nint c;\n")
    a2 = build.library_path("a.cu")
    assert a2 != a                            # an edited header rebuilds
    (csrc / "new.cuh").write_text("int d;\n")
    assert build.library_path("a.cu") != a2   # so does a new one
    a3 = build.library_path("a.cu")
    (csrc / "b.cu").write_text("int b2;\n")    # another source does not
    assert build.library_path("a.cu") == a3


def test_flags_enter_the_hash(csrc, monkeypatch):
    a = build.library_path("a.cu")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-G"])
    assert build.library_path("a.cu") != a


def test_built_library_is_reused_with_its_log(csrc, monkeypatch):
    lib = build.library_path("a.cu")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text("ptxas info : Used 96 registers\n")

    def no_nvcc():
        raise AssertionError("a built library must not be rebuilt")
    monkeypatch.setattr(build, "nvcc", no_nvcc)
    out = build.build(["a.cu"])["a.cu"]
    assert out == {"path": str(lib), "seconds": 0.0,
                   "log": "ptxas info : Used 96 registers\n"}
