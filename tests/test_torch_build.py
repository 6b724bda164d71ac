"""The kernel build's cache key: a library is named by the hash of its
source and of every header the source includes, so editing a shared header
(``kernels/csrc/hopper.cuh``) rebuilds every kernel that includes it.

Runs on the CPU on temporary files; no nvcc is called.
"""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.fused_swiglu import kernel as sw  # noqa: E402


@pytest.fixture
def tree(tmp_path):
    """kernel/a.cu includes "local.cuh" (beside it) and "shared.cuh" (in
    the include dir), which includes "deep.cuh"; b.cu includes nothing."""
    inc = tmp_path / "csrc"
    src = tmp_path / "kernel"
    inc.mkdir()
    src.mkdir()
    (inc / "shared.cuh").write_text('#pragma once\n#include "deep.cuh"\n'
                                    "int shared();\n")
    (inc / "deep.cuh").write_text("#pragma once\nint deep();\n")
    (inc / "unrelated.cuh").write_text("int unrelated();\n")
    (src / "local.cuh").write_text("int local();\n")
    (src / "a.cu").write_text('#include <cuda_runtime.h>\n'
                              '#include "local.cuh"\n'
                              '  #  include "shared.cuh"\n'
                              "int a() { return 0; }\n")
    (src / "b.cu").write_text("int b() { return 0; }\n")
    return src, inc


def test_includes_are_followed_through_headers(tree):
    src, inc = tree
    found = _build.included_headers(src / "a.cu", (inc,))
    assert [p.name for p in found] == ["local.cuh", "shared.cuh",
                                       "deep.cuh"]
    assert _build.included_headers(src / "b.cu", (inc,)) == []


@pytest.mark.parametrize("edited", ["shared.cuh", "deep.cuh", "local.cuh",
                                    "a.cu"])
def test_editing_an_included_file_changes_the_library(tree, edited):
    src, inc = tree
    before = _build.library_path(src / "a.cu", (inc,))
    path = (src if edited in ("local.cuh", "a.cu") else inc) / edited
    path.write_text(path.read_text() + "// edited\n")
    after = _build.library_path(src / "a.cu", (inc,))
    assert after != before
    assert after.name.startswith("liba_") and after.suffix == ".so"


def test_editing_an_unrelated_file_keeps_the_library(tree):
    src, inc = tree
    before_a = _build.library_path(src / "a.cu", (inc,))
    before_b = _build.library_path(src / "b.cu", (inc,))
    (inc / "unrelated.cuh").write_text("int unrelated(int);\n")
    (inc / "shared.cuh").write_text((inc / "shared.cuh").read_text()
                                    + "// edited\n")
    assert _build.library_path(src / "a.cu", (inc,)) != before_a
    assert _build.library_path(src / "b.cu", (inc,)) == before_b
    (inc / "unrelated.cuh").write_text("int unrelated(long);\n")
    assert _build.library_path(src / "b.cu", (inc,)) == before_b


def test_the_wgmma_kernels_include_the_shared_header():
    """Both redesigned kernels pull in kernels/csrc/hopper.cuh, so it is in
    their cache keys; nvcc is told where to find it."""
    hopper = _build.INCLUDE_DIR / "hopper.cuh"
    assert hopper.is_file()
    for source in (fa.WGMMA_SOURCE, sw.WGMMA_SOURCE):
        assert hopper in _build.included_headers(source)
    assert f"-I{_build.INCLUDE_DIR}" in _build.NVCC_FLAGS
