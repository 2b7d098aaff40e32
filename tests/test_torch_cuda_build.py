"""PyTorch port: the kernel build cache (ops/cuda_build.py). A library's path hashes its
source, every shared header of csrc/ and the flags, so an edited header (one that two
sources include, such as attention_tile.cuh) never loads a stale library. No nvcc is
needed: only the paths are computed."""

import os
import shutil

import pytest

from distributed_llama_tpu_torch.ops import cuda_build


def _copy_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    return csrc


def test_editing_a_shared_header_changes_every_library_path(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    assert "attention_tile.cuh" in headers
    names = ("paged_attention", "decode_attention", "q4_matvec")
    before = {n: cuda_build.library_path(n) for n in names}
    assert before == {n: cuda_build.library_path(n) for n in names}  # stable
    with open(csrc / "attention_tile.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: cuda_build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    assert all(os.path.basename(after[n]).startswith(n + "-") for n in names)


def test_a_new_header_and_the_source_change_the_path(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    first = cuda_build.library_path("decode_attention")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    second = cuda_build.library_path("decode_attention")
    with open(csrc / "decode_attention.cu", "a") as f:
        f.write("\n")
    third = cuda_build.library_path("decode_attention")
    assert len({first, second, third}) == 3


def test_the_shared_headers_are_there(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    headers = {f for f in os.listdir(csrc) if f.endswith(".cuh")}
    assert {"async_copy.cuh", "attention_tile.cuh", "q4_mm_tile.cuh"} <= headers


@pytest.mark.parametrize("header,names", [
    ("async_copy.cuh", ("paged_attention", "decode_attention", "q4_matmul", "q4_gated_matmul")),
    ("q4_mm_tile.cuh", ("q4_matmul", "q4_gated_matmul")),
])
def test_editing_a_copy_or_tile_header_rebuilds_its_kernels(tmp_path, monkeypatch, header,
                                                            names):
    """The mbarrier and copy helpers of async_copy.cuh serve both tile bodies, and
    q4_mm_tile.cuh both Q40 dequant-matmuls: an edit to either reaches every library
    that includes it."""
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = {n: cuda_build.library_path(n) for n in names}
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    assert all(cuda_build.library_path(n) != before[n] for n in names)
