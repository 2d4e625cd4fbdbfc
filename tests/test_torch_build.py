"""The build key of the port's CUDA kernels (``kernels/_build.py``): a
library is named by a hash of its source and of every header it includes
with ``#include "..."``, followed transitively, so an edit of a shared
header rebuilds exactly the kernels that include it.  Runs on a temporary
copy of the kernel sources; nothing is compiled."""
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

SHARED = "csrc/sm90.cuh"
# who includes what, directly or through another header
USERS = {
    "csrc/sm90.cuh": {"flash_attn_fwd", "flash_attn_bwd", "moe_gmm_bwd"},
    "moe_gmm/csrc/gmm_common.cuh": {"moe_gmm", "moe_gmm_bwd"},
    "ssd/csrc/ssd_cb.cuh": {"ssd_intra_chunk", "ssd_intra_chunk_bwd"},
    "ssd/csrc/ssd_mma.cuh": {"ssd_intra_chunk", "ssd_intra_chunk_bwd"},
}


@pytest.fixture
def kernels(tmp_path) -> Path:
    """A copy of the package's kernel sources (``*.cu``, ``*.cuh``)."""
    root = tmp_path / "kernels"
    for src in _build._PKG.rglob("*.cu*"):
        dst = root / src.relative_to(_build._PKG)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
    return root


def _keys(root: Path) -> dict[str, Path]:
    return {n: _build.library_path(n, root) for n in _build.SOURCES}


def test_copy_keys_equal_the_package_keys(kernels):
    """The key depends on the bytes, not on where the sources lie."""
    assert _keys(kernels) == _keys(_build._PKG)


def test_shared_header_lies_in_the_shared_directory():
    assert (_build._PKG / SHARED).is_file()
    assert not (_build._PKG / "flash_attention/csrc/sm90.cuh").exists()


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_included_headers_are_followed(name):
    got = {h.relative_to(_build._PKG).as_posix()
           for h in _build.included_headers(_build._PKG / _build.SOURCES[name])}
    assert got == {h for h, users in USERS.items() if name in users}


@pytest.mark.parametrize("header", sorted(USERS))
def test_header_edit_changes_exactly_its_users(kernels, header):
    before = _keys(kernels)
    with open(kernels / header, "a") as f:
        f.write("\n// an edit\n")
    after = _keys(kernels)
    assert {n for n in before if before[n] != after[n]} == USERS[header]


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_source_edit_changes_only_its_own_key(kernels, name):
    before = _keys(kernels)
    with open(kernels / _build.SOURCES[name], "a") as f:
        f.write("\n// an edit\n")
    after = _keys(kernels)
    assert {n for n in before if before[n] != after[n]} == {name}


def test_headers_are_followed_transitively_and_cycles_end(tmp_path):
    (tmp_path / "inc").mkdir()
    (tmp_path / "k.cu").write_text('#include "inc/a.cuh"\nint x;\n')
    (tmp_path / "inc" / "a.cuh").write_text(
        '#pragma once\n  #  include "../b.cuh"\n#include <cuda.h>\n')
    (tmp_path / "b.cuh").write_text('#include "inc/a.cuh"\n')
    got = _build.included_headers(tmp_path / "k.cu")
    assert got == [(tmp_path / "inc" / "a.cuh").resolve(),
                   (tmp_path / "b.cuh").resolve()]


def test_missing_header_raises(tmp_path):
    (tmp_path / "k.cu").write_text('#include "nowhere.cuh"\n')
    with pytest.raises(FileNotFoundError, match="nowhere.cuh"):
        _build.included_headers(tmp_path / "k.cu")
