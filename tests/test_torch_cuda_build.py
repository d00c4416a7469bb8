"""The port's kernel build cache (ops/cuda_build.py), without nvcc.

A library's file name hashes the flags, its sources and every header under
`csrc/`, so that an edit to a header the sources include (csrc/hopper.cuh,
csrc/elem.cuh) rebuilds the library instead of loading a stale one. Only
the `.cu` sources go to nvcc. `_library_path` computes the name and needs no
nvcc, so these run on the CPU, in a temporary `csrc`.
"""
import pytest
import torch

from vision_transformers_torch_xla_tpu_torch.ops import cuda_build


@pytest.fixture
def csrc(tmp_path):
    (tmp_path / "kernel.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    (tmp_path / "other.h").write_text("// v1\n")
    (tmp_path / "notes.txt").write_text("not a header\n")
    return tmp_path


def _path(csrc):
    return cuda_build._library_path("kernel", ("kernel.cu",), csrc)


@pytest.mark.parametrize("edited", ["kernel.cu", "shared.cuh", "other.h"])
def test_an_edited_source_or_header_changes_the_library(csrc, edited):
    before = _path(csrc)
    assert before == _path(csrc)            # the name is stable
    (csrc / edited).write_text("// v2\n")
    assert _path(csrc) != before


def test_other_files_do_not_enter_the_hash(csrc):
    before = _path(csrc)
    (csrc / "notes.txt").write_text("edited\n")
    assert _path(csrc) == before
    assert before.parent == cuda_build.BUILD_DIR
    assert before.name.startswith("kernel-") and before.suffix == ".so"


def test_the_package_headers_are_hashed():
    # the real csrc: both shared headers exist and are picked up
    names = {p.name for p in cuda_build.CSRC_DIR.iterdir()}
    assert {"hopper.cuh", "elem.cuh"} <= names
    assert cuda_build._library_path("flash_bwd", ("flash_bwd.cu",)).name \
        .startswith("flash_bwd-")


@pytest.mark.parametrize("dtype,code", [(torch.bfloat16, 0),
                                        (torch.float16, 1),
                                        (torch.float32, 2)])
def test_dtype_codes_are_elem_cuhs(dtype, code):
    # csrc/elem.cuh: enum DtypeCode { kBf16 = 0, kF16 = 1, kF32 = 2 }
    assert cuda_build.dtype_code(dtype) == code
    text = (cuda_build.CSRC_DIR / "elem.cuh").read_text()
    assert "kBf16 = 0, kF16 = 1, kF32 = 2" in text


def test_other_dtypes_have_no_code():
    with pytest.raises(KeyError):
        cuda_build.dtype_code(torch.float64)


@pytest.mark.parametrize("source", ["attn_fwd_tc.cu", "attn_bwd_tc.cu",
                                    "hp_bwd_tc.cu"])
def test_the_tensor_core_attention_sources_enter_the_hash(tmp_path, source):
    # K1/K7/K9/K11's, K2's and K8/K10/K12's tensor-core sources: each is its
    # library's source, so an edit to it (or to the hopper.cuh it includes)
    # names a new file
    real = cuda_build.CSRC_DIR
    assert "hopper.cuh" in (real / source).read_text()
    for f in (source, "hopper.cuh", "elem.cuh"):
        (tmp_path / f).write_bytes((real / f).read_bytes())
    name = source[:-3]
    before = cuda_build._library_path(name, (source,), tmp_path)
    assert before == cuda_build._library_path(name, (source,), real)
    for edited in (source, "hopper.cuh"):
        (tmp_path / edited).write_text((real / edited).read_text() + "\n")
        assert cuda_build._library_path(name, (source,), tmp_path) != before
        (tmp_path / edited).write_bytes((real / edited).read_bytes())
