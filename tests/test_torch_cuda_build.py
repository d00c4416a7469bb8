"""The port's kernel build cache (ops/cuda_build.py), without nvcc.

A library's file name hashes the flags, its sources and every header under
`csrc/`, so that an edit to a header the sources include (csrc/hopper.cuh,
csrc/elem.cuh, csrc/cc_tiles.cuh, csrc/cp_async.cuh, csrc/simt_tiles.cuh)
rebuilds the library instead of loading a stale one. Only the `.cu`
sources go to nvcc. `_library_path` computes the name and needs no nvcc,
so these run on the CPU, in a temporary `csrc`.
"""
import pytest
import torch

from vision_transformers_torch_xla_tpu_torch.ops import cuda_build
from vision_transformers_torch_xla_tpu_torch.ops import flash_attention as fa


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
    # the real csrc: the shared headers exist and are picked up
    names = {p.name for p in cuda_build.CSRC_DIR.iterdir()}
    assert {"hopper.cuh", "elem.cuh", "cc_tiles.cuh", "cp_async.cuh"} <= names
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


def _headers(csrc):
    """Every header under csrc: each enters every library's hash."""
    return [p.name for p in csrc.iterdir() if p.suffix in (".cuh", ".h")]


@pytest.mark.parametrize("source", ["attn_fwd_tc.cu", "attn_bwd_tc.cu",
                                    "hp_bwd_tc.cu", "mlp_fused.cu"])
def test_the_tensor_core_attention_sources_enter_the_hash(tmp_path, source):
    # K1/K7/K9/K11's, K2's and K8/K10/K12's tensor-core sources, and K3's
    # (its bf16 and fp16 kernel is TMA and wgmma too): each is its
    # library's source, so an edit to it (or to the hopper.cuh it includes)
    # names a new file
    real = cuda_build.CSRC_DIR
    assert "hopper.cuh" in (real / source).read_text()
    for f in (source, *_headers(real)):
        (tmp_path / f).write_bytes((real / f).read_bytes())
    name = source[:-3]
    before = cuda_build._library_path(name, (source,), tmp_path)
    assert before == cuda_build._library_path(name, (source,), real)
    for edited in (source, "hopper.cuh"):
        (tmp_path / edited).write_text((real / edited).read_text() + "\n")
        assert cuda_build._library_path(name, (source,), tmp_path) != before
        (tmp_path / edited).write_bytes((real / edited).read_bytes())


@pytest.mark.parametrize("source,header", [
    ("attn_fwd.cu", "cc_tiles.cuh"), ("attn_bwd.cu", "cc_tiles.cuh"),
    ("flash_blocked.cu", "cc_tiles.cuh"), ("mlp_fused.cu", "cp_async.cuh"),
    ("attn_fwd.cu", "attn_fwd_simt.cuh"),
    ("fused_attn_fwd.cu", "attn_fwd_simt.cuh")])
def test_the_cuda_core_headers_enter_the_hash(tmp_path, source, header):
    # csrc/cc_tiles.cuh holds the register tiles of the CUDA-core kernels
    # (the fp32 K1 and K2, K4-K6's CUDA-core loops), csrc/cp_async.cuh the
    # asynchronous copies (through cc_tiles.cuh, and the fp32 K3's),
    # csrc/attn_fwd_simt.cuh the fp32 K1, K9, K7 and K11: each source that
    # includes one names a new library when it is edited
    real = cuda_build.CSRC_DIR
    assert f'#include "{header}"' in (real / source).read_text()
    for f in (source, *_headers(real)):
        (tmp_path / f).write_bytes((real / f).read_bytes())
    name = source[:-3]
    before = cuda_build._library_path(name, (source,), tmp_path)
    assert before == cuda_build._library_path(name, (source,), real)
    (tmp_path / header).write_text((real / header).read_text() + "\n")
    assert cuda_build._library_path(name, (source,), tmp_path) != before


def _linked_library_changes(tmp_path, name, sources, edited):
    """A library linked from several sources: its name is not the one of
    its first source alone, and an edit to `edited` (a source or a header)
    names a new one."""
    real = cuda_build.CSRC_DIR
    for f in (*sources, *_headers(real)):
        (tmp_path / f).write_bytes((real / f).read_bytes())
    before = cuda_build._library_path(name, sources, tmp_path)
    assert before == cuda_build._library_path(name, sources, real)
    assert before != cuda_build._library_path(name, sources[:1], tmp_path)
    (tmp_path / edited).write_text((real / edited).read_text() + "\n")
    assert cuda_build._library_path(name, sources, tmp_path) != before


@pytest.mark.parametrize("edited", ["flash_blocked.cu", "flash_bwd_simt.cu",
                                    "cp_async.cuh", "flash_fwd_simt.cu",
                                    "simt_tiles.cuh", "simt_wide.cuh"])
def test_the_fp32_backward_source_enters_the_cuda_core_library(tmp_path,
                                                               edited):
    # the CUDA-core library of K4-K6 links csrc/flash_bwd_simt.cu (the fp32
    # K5 and K6 at head dims <= 256) and csrc/flash_fwd_simt.cu (the fp32
    # K4 at <= 256; both past 128 on csrc/simt_wide.cuh's tiles)
    # into csrc/flash_blocked.cu's: an edit to any of them, or to the
    # simt_tiles.cuh, simt_wide.cuh and cp_async.cuh they include, names a
    # new library, and the library is not the one of flash_blocked.cu alone
    from vision_transformers_torch_xla_tpu_torch.ops import flash_blocked

    sources = flash_blocked.CUDA_CORE_SOURCES
    assert sources == ("flash_blocked.cu", "flash_bwd_simt.cu",
                       "flash_fwd_simt.cu")
    real = cuda_build.CSRC_DIR
    for src in sources[1:]:
        assert '#include "simt_tiles.cuh"' in (real / src).read_text()
        assert '#include "simt_wide.cuh"' in (real / src).read_text()
    assert '#include "cp_async.cuh"' in (real / "simt_tiles.cuh").read_text()
    _linked_library_changes(tmp_path, "flash_blocked", sources, edited)


@pytest.mark.parametrize("edited", ["hp_bwd.cu", "hp_bwd_simt.cu",
                                    "simt_tiles.cuh", "elem.cuh",
                                    "simt_wide.cuh"])
def test_the_fp32_hp_backward_source_enters_its_library(tmp_path, edited):
    # the CUDA-core backward of K8, K10 and K12 links csrc/hp_bwd_simt.cu
    # (fp32 at head dims <= 256) into csrc/hp_bwd.cu's library: an edit to
    # either source or to a header they include names a new library
    sources = fa.HP_BWD_SOURCES
    assert sources == ("hp_bwd.cu", "hp_bwd_simt.cu")
    real = cuda_build.CSRC_DIR
    assert '#include "simt_tiles.cuh"' in (real / sources[1]).read_text()
    assert '#include "simt_wide.cuh"' in (real / sources[1]).read_text()
    assert '#include "elem.cuh"' in (real / sources[0]).read_text()
    _linked_library_changes(tmp_path, "hp_bwd", sources, edited)


@pytest.mark.parametrize("edited", ["attn_bwd.cu", "attn_bwd_simt.cu",
                                    "simt_wide.cuh", "simt_tiles.cuh",
                                    "cc_tiles.cuh"])
def test_the_fp32_k2_source_enters_its_library(tmp_path, edited):
    # the CUDA-core K2 links csrc/attn_bwd_simt.cu (fp32 at head dims
    # 129-256, on the wide register tiles of csrc/simt_wide.cuh, which it
    # shares with csrc/hp_bwd_simt.cu) into csrc/attn_bwd.cu's library: an
    # edit to either source or to a header they include names a new one
    sources = fa.ATTN_BWD_SOURCES
    assert sources == ("attn_bwd.cu", "attn_bwd_simt.cu")
    real = cuda_build.CSRC_DIR
    assert '#include "simt_wide.cuh"' in (real / sources[1]).read_text()
    assert '#include "cc_tiles.cuh"' in (real / sources[0]).read_text()
    _linked_library_changes(tmp_path, "attn_bwd", sources, edited)


def _ptxas(text):
    """{(kernel, element type, head dim): (registers, spill stores, spill
    loads, static shared memory)} from nvcc's -Xptxas -v output; a kernel
    with no element type in its name (K6) is bf16's."""
    import re

    out, key = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d(flash_\w+?_kernel)"
                      r"I(13__nv_bfloat16|6__half)?Li(\d+)E", line)
        if m:
            key = (m.group(1), {"6__half": "fp16"}.get(m.group(2), "bf16"),
                   int(m.group(3)))
            out[key] = [None] * 4
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and key:
            out[key][1:3] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and key:
            out[key][0], out[key][3] = int(m.group(1)), int(m.group(2))
    return {k: tuple(v) for k, v in out.items()}


@pytest.mark.cuda
def test_tensor_core_blocked_kernels_build_without_spills(tmp_path):
    # csrc/flash_fwd.cu (K4) and csrc/flash_bwd.cu (K5, K6) built with the
    # library flags: K4, K5 and K6 in bf16 and fp16 at 64, 128, 192 and 256
    # (K6's wide tiles, 192 and 256, a kernel of their own), none spilling
    import subprocess

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    got = {}
    for src in ("flash_fwd.cu", "flash_bwd.cu"):
        res = subprocess.run(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
             str(tmp_path / f"{src}.so"), str(cuda_build.CSRC_DIR / src)],
            capture_output=True, text=True)
        assert res.returncode == 0, res.stderr[-3000:]
        got.update(_ptxas(res.stdout + res.stderr))
    want = {(k, t, d) for k in ("flash_fwd_kernel", "flash_bwd_dkdv_kernel")
            for t in ("bf16", "fp16") for d in (64, 128, 192, 256)}
    want |= {("flash_bwd_dq_kernel", t, d) for t in ("bf16", "fp16")
             for d in (64, 128)}
    want |= {("flash_bwd_dq_tc_wide_kernel", t, d) for t in ("bf16", "fp16")
             for d in (192, 256)}
    assert set(got) == want, sorted(got)
    assert all(v[1] == v[2] == 0 for v in got.values()), got


@pytest.mark.cuda
def test_fp32_forward_register_tiles_instantiations(tmp_path):
    # csrc/attn_fwd.cu and csrc/fused_attn_fwd.cu built with the library
    # flags: each instantiates csrc/attn_fwd_simt.cuh's kernel in its own
    # cast order (K1's, K7's) at kD 32, 64, 128, 192 and 256, its stored
    # and its recomputing path, and beside it only its run-time head-dim
    # loops (every dtype past 256; no fp32 kernel at a compile-time head
    # dim)
    import re
    import subprocess

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    for src, k7 in (("attn_fwd.cu", "0"), ("fused_attn_fwd.cu", "1")):
        res = subprocess.run(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
             str(tmp_path / f"{src}.so"), str(cuda_build.CSRC_DIR / src)],
            capture_output=True, text=True)
        assert res.returncode == 0, res.stderr[-3000:]
        kernels = {(m.group(1), m.group(2)) for m in re.finditer(
            r"Compiling entry function '\S*?\d((?:attn|fused)\w*?_kernel)"
            r"I(\w+?)EEv", res.stdout + res.stderr)}
        loops = "attn_fwd_kernel" if k7 == "0" else "fused_attn_fwd_kernel"
        want = {("attn_fwd_simt_kernel", f"Li{kd}ELb{k7}ELb{store}E")
                for kd in (32, 64, 128, 192, 256) for store in "01"}
        want |= {(loops, f"{t}Li0E")
                 for t in ("13__nv_bfloat16", "6__half", "f")}
        assert kernels == want, sorted(kernels)


def _simt_ptxas(text):
    """{'kernel<ints>': (registers, spill stores, spill loads)} of each
    flash_*_simt_kernel in nvcc's -Xptxas -v output."""
    import re

    out, key = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d(flash_[a-z_]*?"
                      r"_simt_kernel)I((?:Li\d+E)+)E", line)
        if m:
            key = f"{m.group(1)}<{', '.join(re.findall(r'\d+', m.group(2)))}>"
            out[key] = [None] * 3
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and key:
            out[key][1:3] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and key:
            out[key][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


@pytest.mark.cuda
def test_fp32_blocked_backward_register_tiles_instantiations(tmp_path):
    # csrc/flash_bwd_simt.cu built with the library flags: the fp32 K5 and
    # K6 at D <= 64 (<64, 128, 2>) and <= 128 (<128, 64, 1>), and past 128
    # their wide kernels at kD 192 and 256, and nothing else; the wide K6
    # without a spill
    import subprocess

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    src = cuda_build.CSRC_DIR / "flash_bwd_simt.cu"
    res = subprocess.run(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
         str(tmp_path / "flash_bwd_simt.so"), str(src)],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-3000:]
    got = _simt_ptxas(res.stdout + res.stderr)
    want = {f"flash_bwd_{k}_simt_kernel<{a}>" for k in ("dkdv", "dq")
            for a in ("64, 128, 2", "128, 64, 1")}
    want |= {f"flash_bwd_{k}_wide_simt_kernel<{kd}>" for k in ("dkdv", "dq")
             for kd in (192, 256)}
    assert set(got) == want, sorted(got)
    assert all(v[0] <= 255 for v in got.values()), got
    for kd in (192, 256):
        assert got[f"flash_bwd_dq_wide_simt_kernel<{kd}>"][1:] == (0, 0), got
