"""The port's kernel build, on the CPU (no nvcc, no card).

A library's name carries the hash of every file it is built from, the
shared headers under ``kernels/csrc/`` included (in quotes or in angle
brackets, and what they include in turn), so an edit there can never
leave a stale library in use; nvcc finds those headers through ``-I``.
"""

import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import common  # noqa: E402

SHARED = "gibbs_warp.cuh"
USERS = ("lda_gibbs", "lda_l2r", "lda_sparse")


@pytest.fixture
def kernels_copy(tmp_path, monkeypatch):
    """The kernels tree copied to ``tmp_path``, with ``common`` reading it."""
    root = tmp_path / "kernels"
    shutil.copytree(common._PKG, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(common, "_PKG", root)
    return root


def test_shared_header_edit_renames_only_its_users(kernels_copy):
    before = {name: common._target(name)[0] for name in common.KERNEL_NAMES}
    header = kernels_copy / "csrc" / SHARED
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: common._target(name)[0] for name in common.KERNEL_NAMES}
    for name in common.KERNEL_NAMES:
        if name in USERS:
            assert after[name] != before[name], name
        else:
            assert after[name] == before[name], name


def test_own_source_edit_renames_only_that_kernel(kernels_copy):
    before = {name: common._target(name)[0] for name in common.KERNEL_NAMES}
    src = kernels_copy / "lda_sparse" / "csrc" / "lda_sparse.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {name: common._target(name)[0] for name in common.KERNEL_NAMES}
    assert {n for n in common.KERNEL_NAMES if after[n] != before[n]} == {
        "lda_sparse"}


@pytest.mark.parametrize("name", USERS)
def test_users_include_the_shared_header(name):
    src = common._target(name)[1][0].read_text()
    assert f'#include "{SHARED}"' in src
    assert (common._PKG / "csrc" / SHARED).is_file()


@pytest.mark.parametrize("name", common.KERNEL_NAMES)
def test_nvcc_command_carries_the_shared_include_dir(kernels_copy, name,
                                                     tmp_path):
    _lib, sources = common._target(name)
    args = common._nvcc_args(sources, tmp_path / "out.so")
    i = args.index("-I")
    assert args[i + 1] == str(kernels_copy / "csrc")
    assert "--fmad=false" in args and "arch=compute_90a,code=sm_90a" in args
    assert args[-len(sources):] == [str(s) for s in sources]


def _renamed(edit) -> set[str]:
    """The kernels whose library name changes when ``edit()`` runs."""
    before = {name: common._target(name)[0] for name in common.KERNEL_NAMES}
    edit()
    after = {name: common._target(name)[0] for name in common.KERNEL_NAMES}
    return {n for n in common.KERNEL_NAMES if after[n] != before[n]}


@pytest.mark.parametrize("form", ['"{}"', "<{}>", '  "{}"'])
def test_every_include_form_is_hashed(kernels_copy, form):
    """A shared header included in quotes, in angle brackets or with
    blanks before the name renames its user when it changes."""
    extra = kernels_copy / "csrc" / "extra.cuh"
    extra.write_text("#pragma once\n")
    src = kernels_copy / "gossip_mix" / "csrc" / "gossip_mix.cu"
    src.write_text(f"#include {form.format('extra.cuh')}\n"
                   + src.read_text())
    assert _renamed(lambda: extra.write_text("#pragma once\n// v2\n")) == {
        "gossip_mix"}


def test_nested_shared_include_is_hashed(kernels_copy):
    """A header that the shared header includes renames both users."""
    inner = kernels_copy / "csrc" / "inner.cuh"
    inner.write_text("#pragma once\n")
    header = kernels_copy / "csrc" / SHARED
    header.write_text("#include <inner.cuh>\n" + header.read_text())
    assert _renamed(lambda: inner.write_text("#pragma once\n// v2\n")) == (
        set(USERS))


def test_unincluded_shared_file_renames_nothing(kernels_copy):
    """A file of the shared directory that no kernel includes leaves
    every library's name as it was."""
    spare = kernels_copy / "csrc" / "spare.cuh"
    spare.write_text("#pragma once\n")
    assert _renamed(lambda: spare.write_text("// v2\n")) == set()
