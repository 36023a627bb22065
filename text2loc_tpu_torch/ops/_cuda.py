"""Build, load and launch the port's hand-written CUDA kernels.

The sources under ``text2loc_tpu_torch/csrc/`` have a plain C interface. At
first use, ``nvcc`` compiles each of them (all at once, one process per
file) for ``sm_90a`` and links them into one shared library under
``build/text2loc_tpu_torch/<hash of the sources>/`` at the repository root,
which is loaded with ``ctypes``. Nothing here runs at import: the CPU tests
import every module of the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "text2loc_tpu_torch"
SOURCES = ("fps.cu", "sa_select.cu", "sa_select_bisect.cu", "sa_gather.cu",
           "sa_exact.cu", "sa_all.cu", "mha_addln.cu", "mha_tiled.cu", "ffn_addln.cu",
           "ffn_tiled.cu", "sa_train_fwd.cu", "sa_train_bwd.cu", "sa_train_e_fwd.cu",
           "sa_train_e_bwd.cu", "add_ln.cu", "gather_rows.cu", "tf32_split.cu")
HEADERS = ("common.cuh", "fused_block.cuh", "gemm_tc.cuh", "gemm_wgmma.cuh",
           "layernorm_rows.cuh", "sa_select_tc.cuh", "sa_train_tiles.cuh", "sa_train_fwd.cuh",
           "sa_train_bwd.cuh")
# -Xptxas -v: each source's registers, shared memory and spills per kernel,
# kept beside the library as <source>.log (ptxas_report reads them).
_NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# FPS must round every product and sum on its own, like the plain version.
_FILE_FLAGS = {"fps.cu": ["-fmad=false"]}
LIB_NAME = "libtext2loc_kernels.so"

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper


@dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    often a wrapper launched it (a plain count, reset by the caller)."""

    name: str
    source: str       # path in the repository
    replaces: str     # file:line of the TPU kernel it ports
    launches: int = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        "/usr/local/cuda/bin/nvcc"
    ]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(repr((_NVCC_FLAGS, _FILE_FLAGS)).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels into the shared library (once per source hash)
    and return its path."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(prefix="objs.", dir=out_dir))
    try:
        def compile_one(name):
            obj = work / (name + ".o")
            cmd = [nvcc, *_NVCC_FLAGS, *_FILE_FLAGS.get(name, []),
                   "-c", str(CSRC / name), "-o", str(obj)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
            (work / (name + ".log")).write_text(proc.stderr)
            return obj

        with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
            objs = list(pool.map(compile_one, SOURCES))
        tmp_lib = work / LIB_NAME
        proc = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs),
             "-lcudart", "-ldl"],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{proc.stderr}")
        for name in SOURCES:
            os.replace(work / (name + ".log"), out_dir / (name + ".log"))
        os.replace(tmp_lib, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


# The inference SA level's selections, all on the tile kernel (sa_select_tc.cuh).
TILE_SELECTIONS = ("first", "bisect", "gather", "exact", "all")
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "t2l_error_string": ([_I], ctypes.c_char_p),
    "t2l_fps_smem": ([_I] * 4, ctypes.c_size_t),
    "t2l_fps": ([_P] * 3 + [_I] * 5 + [_P], _I),
    **{f"t2l_sa_{sel}_layout": ([_I] * 10, ctypes.c_size_t) for sel in TILE_SELECTIONS},
    **{f"t2l_sa_{sel}_occupancy": ([_I] * 10 + [_P], _I) for sel in TILE_SELECTIONS},
    **{f"t2l_sa_{sel}": ([_P] * 11 + [_I] * 7 + [_F] + [_I] * 6 + [_P], _I)
       for sel in TILE_SELECTIONS},
    "t2l_mha_addln_layout": ([_I] * 8, ctypes.c_size_t),
    "t2l_mha_addln": ([_P] * 14 + [_I] * 5 + [_F, _F] + [_I] * 5 + [_P], _I),
    "t2l_mha_tiled_core_smem": ([_I] * 8, ctypes.c_size_t),
    "t2l_mha_addln_tiled": ([_P] * 19 + [_I] * 8 + [_F, _F, _I, _I, _P], _I),
    "t2l_mha_tiled_project": ([_P] * 11 + [_I] * 4 + [_F, _I, _I, _P], _I),
    "t2l_mha_tiled_gemm": ([_P, _I, _P, _I, _P, _P, _P, _P, _I, _P] + [_I] * 5 + [_F, _I, _P],
                           _I),
    "t2l_mha_tiled_core": ([_P, _I, _P, _P, _I, _P, _P] + [_I] * 9 + [_P], _I),
    "t2l_mha_tiled_ln": ([_P] * 4 + [_I, _I, _F, _I, _P], _I),
    "t2l_ffn_addln_layout": ([_I] * 5, ctypes.c_size_t),
    "t2l_ffn_addln": ([_P] * 8 + [_I] * 3 + [_F] + [_I] * 4 + [_P], _I),
    "t2l_ffn_addln_tiled": ([_P] * 12 + [_I] * 3 + [_F, _I, _P], _I),
    "t2l_ffn_tiled_gemm_relu": ([_P] * 6 + [_I] * 4 + [_P], _I),
    "t2l_ffn_tiled_out_addln": ([_P] * 10 + [_I] * 3 + [_F, _I, _P], _I),
    "t2l_tf32_split_t": ([_P, _I, _I] * 4 + [_I, _P, _P, _P], _I),
    **{f"t2l_sa_train_{d}_smem": ([_I] * 7, ctypes.c_size_t) for d in ("fwd", "bwd")},
    **{f"t2l_sa_train{e}_fwd": ([_I] + [_P] * 9 + [_I] * 10 + [_P], _I) for e in ("", "_e")},
    **{f"t2l_sa_train{e}_bwd": ([_I] + [_P] * 13 + [_I] * 10 + [_P], _I) for e in ("", "_e")},
    **{f"t2l_sa_train{e}_{d}_occupancy": ([_I] * 8 + [_P], _I)
       for e in ("", "_e") for d in ("fwd", "bwd")},
    "t2l_sa_train_reduce": ([_P, _I, _I, _P, _P], _I),
    "t2l_add_ln": ([_P] * 5 + [_I, _I, _F] + [_I] * 3 + [_P], _I),
    "t2l_ln_rows_blocks": ([_I] * 3, _I),
    "t2l_gather_rows_smem": ([_I] * 3, ctypes.c_size_t),
    "t2l_gather_rows": ([_P] * 3 + [_I] * 7 + [_P], _I),
    "t2l_scatter_rows_smem": ([_I, _I], ctypes.c_size_t),
    "t2l_scatter_rows": ([_P] * 3 + [_I] * 5 + [_P], _I),
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with every
    function's argument and result types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def ptxas_report(source: str) -> dict:
    """{kernel (mangled name): {"registers": n, "spill_stores": bytes,
    "spill_loads": bytes}} of one source, from the build's ptxas output
    (the library is built first if needed)."""
    report, name = {}, None
    for line in (build().parent / (source + ".log")).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'|Function properties for (\w+)", line)
        if m:
            name = m.group(1) or m.group(2)
            report.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            report[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name]["registers"] = int(m.group(1))
    return report


def launch(kernel: Kernel, symbol: str, *args, count: bool = True) -> None:
    """Call one launcher of the library on the current stream; raise on a
    non-zero cudaGetLastError() and count the launch (`count=False`: a
    stage launched alone by a test, not the kernel's main path)."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, symbol)(*args, stream)
    if err != 0:
        msg = lib.t2l_error_string(err).decode()
        raise RuntimeError(f"{kernel.name} kernel launch failed: {msg} ({err})")
    if count:
        kernel.launches += 1


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The number of SMs of CUDA device `index` (read once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(t: torch.Tensor, name: str, dtype=None, shape=None):
    """Validate a tensor handed to a kernel: on the current CUDA device,
    contiguous, of the given dtype and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: on {t.device}, but the kernels launch on "
                         f"cuda:{torch.cuda.current_device()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def as_given(t: torch.Tensor, dtype) -> torch.Tensor:
    """t itself where a kernel reads it as it is (this dtype, contiguous),
    else a converted copy (one device op)."""
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())
