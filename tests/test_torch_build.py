"""The port's kernel build cache: keyed on everything that builds a library.

CPU only, no nvcc: :func:`source_digest` is computed on a temporary
``csrc`` tree.
"""

import pytest

from moolib_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path):
    (tmp_path / "attn.cu").write_text('#include "tiles.cuh"\nextern "C" int f() { return 0; }\n')
    (tmp_path / "other.cu").write_text('extern "C" int g() { return 1; }\n')
    (tmp_path / "tiles.cuh").write_text("#pragma once\nconstexpr int TILE = 64;\n")
    (tmp_path / "notes.txt").write_text("not part of any build\n")
    return tmp_path


def test_unchanged_tree_keeps_its_key(csrc):
    assert _build.source_digest("attn", str(csrc)) == _build.source_digest("attn", str(csrc))


@pytest.mark.parametrize("edit", ["source", "header", "new_header", "flags", "arch"])
def test_anything_that_builds_the_library_changes_its_key(csrc, monkeypatch, edit):
    before = _build.source_digest("attn", str(csrc))
    if edit == "source":
        (csrc / "attn.cu").write_text('#include "tiles.cuh"\nextern "C" int f() { return 2; }\n')
    elif edit == "header":
        (csrc / "tiles.cuh").write_text("#pragma once\nconstexpr int TILE = 128;\n")
    elif edit == "new_header":
        (csrc / "mma.h").write_text("#pragma once\n")
    elif edit == "flags":
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-Ithird_party/include"])
    else:
        monkeypatch.setattr(_build, "ARCH_FLAGS", ["-gencode", "arch=compute_90,code=sm_90"])
    assert _build.source_digest("attn", str(csrc)) != before


def test_other_files_leave_the_key_alone(csrc):
    before = _build.source_digest("attn", str(csrc))
    (csrc / "notes.txt").write_text("edited\n")
    (csrc / "other.cu").write_text('extern "C" int g() { return 3; }\n')
    assert _build.source_digest("attn", str(csrc)) == before


def test_kernel_names_lists_sources_only(csrc):
    assert _build.kernel_names(str(csrc)) == ["attn", "other"]


def test_repo_kernels_and_their_shared_header():
    assert _build.kernel_names() == ["flash_bwd", "flash_fwd"]
    keys = {name: _build.source_digest(name) for name in _build.kernel_names()}
    assert len(set(keys.values())) == 2 and all(len(k) == 16 for k in keys.values())
