"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together,
and the objects are linked into ONE shared library with a plain C
interface, which is loaded with ``ctypes``.  No PyTorch headers are
involved, so a cold build takes seconds.  The library is named by the
content hash of the sources and flags and lives in
``speech_recognition_tpu_torch/_build/``
(listed in ``.gitignore``); it is built at first use, so any entry
point that launches a kernel builds it.  A failed build raises with
nvcc's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["NVCC_FLAGS", "library_path", "build", "load_library", "check"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    """``_build/kernels_<hash>.so`` for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"kernels_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "(the CUDA kernels are built on the GPU host)")
    return found


def build() -> str:
    """Compile the kernels if the hashed library is missing; returns its
    path.  Each source compiles in its own ``nvcc`` process, all in
    parallel; one more links the objects.  nvcc's output (including
    ``-Xptxas -v`` register and shared memory reports) is kept beside
    the library as ``<lib>.log``."""
    out = library_path()
    with _lock:
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc, tag = _nvcc(), f"{out}.{os.getpid()}"
        jobs = []
        for src in (p for p in _sources() if p.endswith(".cu")):
            obj = f"{tag}.{os.path.basename(src)}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        steps = [(cmd, proc.communicate()[0], proc.returncode) for cmd, _, proc in jobs]
        objs = [obj for _, obj, _ in jobs]
        if all(rc == 0 for _, _, rc in steps):
            cmd = [nvcc, *_ARCH, "-shared", "-o", f"{tag}.tmp", *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            steps.append((cmd, proc.stdout + proc.stderr, proc.returncode))
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        with open(out + ".log", "w") as f:
            f.writelines(" ".join(cmd) + "\n" + text for cmd, text, _ in steps)
        failed = [(cmd, text, rc) for cmd, text, rc in steps if rc != 0]
        if failed:
            cmd, text, rc = failed[0]
            raise RuntimeError(f"nvcc failed (exit {rc}):\n{' '.join(cmd)}\n{text}")
        os.replace(f"{tag}.tmp", out)
    return out


# lattice_rescore_launch's argument types, shared with the labs that
# build variants of its source (scripts/exp_r9_k7_variants.py)
RESCORE_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with the argument
    types of every exported launcher declared."""
    lib = ctypes.CDLL(build())
    p, i, f, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.mfcc_tail_launch.argtypes = [p, p, p, i, i, i, i, p]
    lib.mfcc_ceps_launch.argtypes = [p, p, p, p, p, p, p, p, p,
                                     i, i, i, i, i, f, i, i, p]
    lib.viterbi_dense_launch.argtypes = [p, p, p, p, p, p, p, p, p,
                                         i, i, i, i, i, i, i, i, i, i, i, i, q, p, p]
    lib.bank_emission_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.banded_forward_launch.argtypes = [i, p, q, q, q, p, p, p, p, p, p, p, p, i, p, p, p,
                                          i, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i,
                                          p, p]
    lib.banded_warp_launch.argtypes = [i, p, q, q, q, p, p, p, p, p, p, i, p, p, p, i, p,
                                       p] + [i] * 9 + [p, p]
    lib.banded_backtrace_launch.argtypes = [p, p, p, p, p, p,
                                            i, i, i, i, i, p]
    lib.banded_backtrace_general_launch.argtypes = [p, p, i, p, p, p, p, p, p, p, p,
                                                    i, i, i, i, i, i, p, p]
    lib.viterbi_lex_launch.argtypes = [i, p, p, p, p, p, p, p, p, p, p, i, p, p, p,
                                       p, p, i, p, p, p, p, p,
                                       i, i, i, i, i, i, i, i, i, i,
                                       i, i, i, i, i, i, i, p]
    lib.lex_backtrace_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, p, p]
    lib.lattice_rescore_launch.argtypes = RESCORE_ARGTYPES
    lib.fb_banded_launch.argtypes = [p] * 23 + [i] * 11 + [p]
    lib.fb_dense_launch.argtypes = [p] * 14 + [i] * 13 + [p]
    lib.dense_backtrace_launch.argtypes = [i, p, q, q, q, p, q, q, q, p, p, p, p,
                                           i, i, i, i, i, i, i, i, i, i, i, p, p]
    lib.lattice_walk_launch.argtypes = [p, q, q, q, p, q, q, q, p, p, p, p, i, i, i, i, p]
    lib.wordtrace_walk_launch.argtypes = [p, i, q, q, q, p, q, q, q, p, p, p, p, p,
                                          i, i, i, p]
    lib.kmeans_fit_launch.argtypes = [p] * 14 + [i] * 6 + [f, f] + [i] * 5 + [q, p]
    lib.em_fit_launch.argtypes = [p] * 14 + [i] * 6 + [f] * 4 + [i] * 4 + [q, p]
    lib.token_beam_launch.argtypes = [p] * 16 + [i] * 14 + [q, p]
    lib.token_walk_launch.argtypes = [p] * 13 + [i] * 7 + [p]
    lib.token_beam_bytes.argtypes = [i] * 5
    lib.token_beam_bytes.restype = q
    for fn in (lib.mfcc_tail_launch, lib.bank_emission_launch, lib.banded_forward_launch,
               lib.banded_warp_launch,
               lib.banded_backtrace_launch,
               lib.banded_backtrace_general_launch, lib.viterbi_lex_launch,
               lib.lex_backtrace_launch,
               lib.lattice_rescore_launch, lib.mfcc_ceps_launch,
               lib.viterbi_dense_launch, lib.fb_banded_launch, lib.fb_dense_launch,
               lib.dense_backtrace_launch, lib.lattice_walk_launch,
               lib.wordtrace_walk_launch, lib.kmeans_fit_launch, lib.em_fit_launch,
               lib.token_beam_launch, lib.token_walk_launch):
        fn.restype = ctypes.c_int
    lib.bank_emission_smem_bytes.argtypes = [i, i, i, i]
    lib.banded_forward_smem_bytes.argtypes = [i, i, i, i, i, i, i, i, i, i]
    lib.banded_forward_work_bytes.argtypes = [i, i, i, i]
    lib.banded_warp_smem_bytes.argtypes = [i] * 3
    lib.banded_forward_work_bytes.restype = q
    lib.viterbi_lex_smem_bytes.argtypes = [i] * 12
    lib.lattice_rescore_smem_bytes.argtypes = [i]
    lib.lattice_rescore_staged_smem_bytes.argtypes = [i, i, i]
    lib.viterbi_dense_cluster_slots.argtypes = [i, i, q, i]
    lib.viterbi_dense_cluster_slots.restype = ctypes.c_int
    lib.viterbi_dense_smem_bytes.argtypes = [i] * 7
    lib.viterbi_dense_smem_bytes.restype = q
    lib.srt_smem_limit.argtypes = []
    lib.fb_banded_smem_bytes.argtypes = [i] * 5
    lib.fb_banded_aux_ints.argtypes = [i] * 3
    lib.fb_banded_rows_floats.argtypes = [i] * 3
    lib.fb_banded_rows_floats.restype = q
    lib.fb_dense_smem_bytes.argtypes = [i] * 6
    lib.fb_dense_list_ints.argtypes = [i, i]
    lib.fb_dense_list_ints.restype = q
    lib.fb_scan_occupancy.argtypes = [i] * 3
    lib.fb_scan_occupancy.restype = ctypes.c_int
    for fn in (lib.bank_emission_smem_bytes, lib.banded_forward_smem_bytes,
               lib.banded_warp_smem_bytes,
               lib.fb_banded_smem_bytes, lib.fb_banded_aux_ints, lib.fb_dense_smem_bytes,
               lib.viterbi_lex_smem_bytes, lib.lattice_rescore_smem_bytes,
               lib.lattice_rescore_staged_smem_bytes, lib.srt_smem_limit):
        fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a nonzero ``cudaError_t``."""
    if rc != 0:
        msg = load_library().cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
