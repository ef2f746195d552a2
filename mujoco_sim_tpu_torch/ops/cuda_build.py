"""Build and load the hand-written CUDA kernels under csrc/.

Every kernel is one ``.cu`` file with a plain C interface, compiled by nvcc
for sm_90a into a shared library and bound with ctypes (no PyTorch headers:
the build takes seconds).  Libraries go to ``_build/`` next to the package,
named by a hash of the source, the shared headers and the flags, so an edit
rebuilds and an unchanged source does not.

``load(name)`` is what the wrappers call.  Its first call in a process
builds ALL kernels in parallel (one nvcc per source, started together), so
the first launch of any kernel pays one build wait, not one per kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import NamedTuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

_BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The collision kernels pick indices by comparing floats (argmin/argmax
# with lowest-index ties, strict-< updates).  nvcc contracts a*b + c into
# one rounding by default and the plain PyTorch twins do not, which can
# turn an exact tie of the twin into a pick of the other index; without
# contraction the kernels round like the twins.  chol_solve compares no
# floats and keeps FMA, and so does chol_factor, which shares its code.
# newton_solve rounds its elementwise terms as the plain solver's do (its
# sums and the shared factor use explicit fmaf).
_NO_FMA = ("-fmad=false",)


class Kernel(NamedTuple):
    """A row of KERNELS: one hand-written kernel."""
    source: str          # its .cu file under csrc/
    flags: tuple         # nvcc flags beside _BASE_FLAGS
    slot: str            # its launch count in runtime/profiler.SLOTS
    functions: tuple     # the __global__ functions its source defines


# every hand-written kernel, by the name ``load`` takes, in the order of
# the recorder's launch counts (runtime/profiler.LAUNCH_COUNTS); a new
# kernel is its .cu file, its wrapper under ops/ and a row here
KERNELS = {
    "chol_solve": Kernel("chol_solve.cu", (), "chol_solve", (
        "chol_solve_kernel", "chol_solve_panel_kernel",
        "chol_solve_work_kernel")),
    "chol_factor": Kernel("chol_factor.cu", (), "chol_factor", (
        "chol_factor_kernel", "chol_factor_panel_kernel",
        "chol_factor_work_kernel")),
    "hull_sat": Kernel("hull_sat.cu", _NO_FMA, "hull_ref_face_depth",
                       ("hull_sat_kernel",)),
    "face_sat": Kernel("face_sat.cu", _NO_FMA, "face_sat_depth",
                       ("face_sat_kernel",)),
    "mtv_query": Kernel("mtv_query.cu", _NO_FMA, "mtv_query",
                        ("mtv_query_kernel", "mtv_query_block_kernel")),
    "support_minmax": Kernel("support_minmax.cu", _NO_FMA, "support_minmax",
                             ("support_minmax_kernel",)),
    "graph_loop": Kernel("graph_loop.cu", (), "graph_loop", ("set_any",)),
    "trace_stamp": Kernel("trace_stamp.cu", (), "trace_stamp",
                          ("trace_stamp_kernel",)),
    "feature_clip": Kernel("feature_clip.cu", _NO_FMA, "feature_clip",
                           ("feature_clip_kernel",)),
    "newton_solve": Kernel("newton_solve.cu", _NO_FMA, "newton_solve",
                           ("newton_solve_kernel",)),
}
HEADERS = ("support.cuh", "chol_factor.cuh", "async_copy.cuh", "face_sat.cuh")

# name -> dict(path, seconds, ptxas) of the builds this process made or found
BUILD_INFO: dict = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, KERNELS[name].source)


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str) -> str:
    src, flags = KERNELS[name][:2]
    h = hashlib.sha256()
    for fname in (src,) + HEADERS:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    h.update(" ".join(_BASE_FLAGS + flags).encode())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def build_all() -> dict:
    """Compile every kernel that is not built yet, all nvcc processes
    running at once; fills and returns BUILD_INFO.  Raises with nvcc's
    output if any source fails to compile."""
    # imported here: runtime/profiler builds its launch counts from KERNELS
    from mujoco_sim_tpu_torch.runtime import profiler
    with profiler.span("cuda_build.build_all"):
        return _build_all()


def _build_all() -> dict:
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = []
    for name, (src, flags, *_) in KERNELS.items():
        out = _target(name)
        if os.path.exists(out):
            BUILD_INFO.setdefault(name, dict(path=out, seconds=0.0, ptxas=""))
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *_BASE_FLAGS, *flags, "-I", CSRC_DIR, "-o", tmp,
               os.path.join(CSRC_DIR, src)]
        running.append((name, out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, t0, proc in running:
        _, err = proc.communicate()
        try:
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {KERNELS[name].source}:\n{err}")
                continue
            os.replace(tmp, out)  # atomic: a concurrent build never sees half
            BUILD_INFO[name] = dict(path=out, ptxas=err,
                                    seconds=time.perf_counter() - t0)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return BUILD_INFO


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built (with all the others) if needed and
    loaded once per process.  The caller sets argtypes."""
    if name not in BUILD_INFO:
        build_all()
    return ctypes.CDLL(BUILD_INFO[name]["path"])


def build_variant(name: str, tag: str, edits) -> ctypes.CDLL:
    """A copy of kernel ``name``'s source with ``edits`` applied (pairs of
    (text, replacement); each text must occur), built with the kernel's
    own flags into ``_build/{name}_{tag}.so`` and loaded.  For measurement
    scripts that time or stamp a variant of the shipped kernel; the
    caller sets argtypes."""
    src_file, flags = KERNELS[name][:2]
    with open(os.path.join(CSRC_DIR, src_file)) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{src_file} changed: {old!r} not found")
        src = src.replace(old, new)
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = os.path.join(BUILD_DIR, f"{name}_{tag}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    proc = subprocess.run([nvcc(), *_BASE_FLAGS, *flags, "-I", CSRC_DIR,
                           "-o", so, cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stderr}")
    return ctypes.CDLL(so)


def check(rc: int, entry: str) -> None:
    """Raise unless the cudaError_t ``rc`` that the C entry ``entry``
    returned is 0 (cudaSuccess)."""
    if rc != 0:
        raise RuntimeError(f"{entry} failed: cudaError {rc}")


def launch(dev, cfn, *args) -> None:
    """Call the kernel's C entry ``cfn(*args, stream)`` on PyTorch's current
    stream of ``dev``; raises if it returns an error (``check``).  A kernel
    launches on the current device, so ``dev`` is made current for the
    call when it is not; when it already is (the usual case) the device
    guard is skipped."""
    if torch.cuda.current_device() == dev.index:
        rc = cfn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = cfn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    check(rc, cfn.__name__)


def check_f32_cuda(fn: str, **tensors):
    """Raise unless every tensor is float32, contiguous and on one CUDA
    device; returns that device."""
    dev = None
    for k, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{fn}: {k} is on {t.device}, not a CUDA device")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{fn}: {k} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: float32 only, {k} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {k} must be contiguous")
    return dev
