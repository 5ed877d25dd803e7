"""Build the CUDA kernels into one shared library and load it with ctypes.

Every ``*.cu`` under ``csrc/`` is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a`` with a plain C interface, and the
objects are linked into ``_build/libchemkernels_<hash>.so``. The hash
covers the sources, the headers and the flags, so a changed source is
rebuilt and an unchanged one is loaded as it is. Nothing is compiled at
import: :func:`library` builds at first use, which is the first launch of
a kernel on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]
#: flags of single sources: the steady-state solvers (K6, K7) run
#: fixed-iteration Newtons whose path on a fragile lane follows the
#: rounding, so they are compiled without contracting a * b + c into one
#: fused multiply-add, which rounds once where the reference and the
#: plain twins round twice; the flame's block-Thomas solve (K12) likewise:
#: its Newton systems reach condition numbers of 1e16-1e20, where two
#: orders of rounding give directions that differ far beyond 1e-10, and
#: without contraction it rounds as the reference's per-block LU does
FILE_FLAGS = {"equilibrium.cu": ["-fmad=false"],
              "psr_solve.cu": ["-fmad=false"],
              "psr_solve_gm.cu": ["-fmad=false"],
              "block_thomas.cu": ["-fmad=false"]}

_LOCK = threading.Lock()
_LIB = None
#: how the library was obtained: build seconds and the compilers' output
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                    + glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    h.update(repr(sorted(FILE_FLAGS.items())).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if the library for the current sources is
    missing; returns its path. Raises with the compiler's output on
    failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libchemkernels_{source_hash()}.so")
    if os.path.exists(lib_path):
        BUILD_INFO.update(path=lib_path, seconds=0.0, built=False)
        return lib_path
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="build_", dir=BUILD_DIR)
    procs = []
    for src in sources():
        obj = os.path.join(work, os.path.basename(src)[:-3] + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS,
               *FILE_FLAGS.get(os.path.basename(src), []), "-I", CSRC, "-c",
               src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, objs, failed = [], [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {os.path.basename(src)} (rc {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(src)
        objs.append(obj)
    if not failed:
        tmp = os.path.join(work, "lib.so")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                               *objs], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        logs.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode == 0:
            os.replace(tmp, lib_path)
        else:
            failed.append("link")
    log = "\n".join(logs)
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as fh:
        fh.write(log)
    shutil.rmtree(work, ignore_errors=True)
    if failed:
        raise RuntimeError(f"kernel build failed ({failed}):\n{log}")
    BUILD_INFO.update(path=lib_path, seconds=time.perf_counter() - t0,
                      built=True, log=log)
    return lib_path


def _bind(lib):
    P = ctypes.c_void_p
    I = ctypes.c_int
    lib.chem_rhs.argtypes = [P, P, P, P, I, I, P, P, P, P]
    lib.chem_rhs_jac.argtypes = [P, P, P, P, P, I, I, P, P, P, P]
    lib.chem_bordered_factor.argtypes = [P, P, P, P, P, P, I, I, I, P]
    lib.chem_bordered_solve.argtypes = [P, P, P, P, P, P, I, I, P]
    lib.chem_sdirk_round.argtypes = [P, P, I, I, I, I, P]
    lib.chem_equil_solve.argtypes = [P, P, I, I, P]
    lib.chem_psr_solve.argtypes = [P, P, I, P]
    lib.chem_gershgorin.argtypes = [P, P, P, P, I, I, P, P, P, P]
    lib.chem_smem_optin.argtypes = [I, ctypes.POINTER(I)]
    lib.chem_transport_props.argtypes = [P, P, P]
    lib.chem_flame_residual.argtypes = [P, P, P, P]
    lib.chem_flame_jac.argtypes = [P, P, P, P]
    lib.chem_block_thomas.argtypes = [P, P, P, P, P, P, I, I, P]
    for fn in (lib.chem_rhs, lib.chem_rhs_jac, lib.chem_bordered_factor,
               lib.chem_bordered_solve, lib.chem_sdirk_round,
               lib.chem_equil_solve, lib.chem_psr_solve,
               lib.chem_gershgorin, lib.chem_smem_optin,
               lib.chem_transport_props, lib.chem_flame_residual,
               lib.chem_flame_jac, lib.chem_block_thomas):
        fn.restype = ctypes.c_int
    lib.chem_flame_ws_doubles.argtypes = [I, I, I]
    lib.chem_flame_ws_doubles.restype = ctypes.c_longlong
    lib.chem_lane_doubles.argtypes = [P, I, I]
    lib.chem_psr_lane_doubles.argtypes = [P]
    lib.chem_equil_lane_doubles.argtypes = [P]
    for fn in (lib.chem_lane_doubles, lib.chem_psr_lane_doubles,
               lib.chem_equil_lane_doubles):
        fn.restype = ctypes.c_longlong
    return lib


def load(path: str):
    """Load a built library and declare its C functions."""
    return _bind(ctypes.CDLL(path))


def library():
    """The loaded kernel library, built at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = load(build())
        return _LIB
