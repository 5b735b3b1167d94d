"""The kernel build cache (``repro_torch.kernels._build``) on the CPU: a
library's name hashes its source and every shared header, so an edit to
either gives a new library and never a stale one."""
import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "common.cuh"\nint a;\n')
    (src / "b.cu").write_text("int b;\n")
    (src / "common.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_library_path_is_stable(csrc):
    assert _build.library_path("a") == _build.library_path("a")
    assert _build.library_path("a") != _build.library_path("b")
    assert _build.library_path("a").name.startswith("liba-")


@pytest.mark.parametrize("edit", [
    ("a.cu", "int a2;\n"),            # the source itself
    ("common.cuh", "// edited\n"),    # a header it includes
    ("new.cuh", "#pragma once\n"),    # a header added beside it
])
def test_edit_changes_library_path(csrc, edit):
    before = _build.library_path("a")
    name, text = edit
    with open(csrc / name, "a") as f:
        f.write(text)
    assert _build.library_path("a") != before


def test_other_source_does_not_change_library_path(csrc):
    before = _build.library_path("a")
    (csrc / "b.cu").write_text("int b2;\n")
    assert _build.library_path("a") == before


def test_built_library_is_reused_without_nvcc(csrc, monkeypatch):
    lib = _build.library_path("a")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")

    def no_nvcc():
        raise AssertionError("nvcc must not run for a built library")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert _build.build("a") == lib
    (csrc / "common.cuh").write_text("// edited\n")
    with pytest.raises(AssertionError, match="nvcc must not run"):
        _build.build("a")
