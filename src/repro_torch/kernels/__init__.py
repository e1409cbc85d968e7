"""Hand-written CUDA kernels for Hopper, built at first use and bound with ctypes.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and linked into one shared
library with a plain C interface, which :func:`library` loads with
``ctypes``.  The build lands in ``build/repro_torch/<hash>/`` at the repo
root (git-ignored), keyed by a hash of the sources and flags, so a second
process reuses it; an ``fcntl`` lock on that directory makes processes
that start together (the ranks of a process grid) wait for one build
instead of compiling side by side.  Nothing builds at import time: the CPU
tests import every module on a machine without ``nvcc``.

Each kernel module (``bitpack``, ``popcount``, ``spmv``, ``quant``) has a
plain PyTorch version in ``ref.py`` and a wrapper in ``ops.py``.  The
wrapper takes the plain version only for tensors that lie on the CPU; for
CUDA tensors it launches the kernel through :func:`launch` or raises.
There is no fallback from one to the other.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

#: Kernel launches by kernel name.  A wrapper adds one where it launches its
#: kernel and nowhere else, so a run can show that it went through the
#: kernels; :func:`reset_launches` zeroes the counts.
LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_funcs: dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> tuple[Path, str]:
    """Compile ``csrc/*.cu`` into one shared library (cached by content).

    Returns the library path and the compilers' output (``ptxas -v``
    register and shared-memory report; empty when the cached build was
    reused).  Raises ``RuntimeError`` with nvcc's output on failure.  One
    process builds while the others wait on the directory's lock and then
    reuse its library.
    """
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + sources:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if lib.exists():  # another process built it while this one waited
            return lib, ""
        return lib, _compile(sources, out_dir, lib)


def _compile(sources: list[Path], out_dir: Path, lib: Path) -> str:
    """nvcc every source into ``out_dir`` at once, link them into ``lib``;
    the compilers' output."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        jobs = []
        for src in sources:
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((src, obj, proc))
        logs, failed = [], []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_lib),
             *(str(obj) for _, obj, _ in jobs)],
            capture_output=True, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib)
    return "\n".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def cfunc(name: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``name`` with its arguments declared.

    Pointers are ``c_void_p``; the CUDA stream is appended as the last
    ``c_void_p``.  Every entry point returns ``cudaGetLastError()``.
    """
    fn = _funcs.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _funcs[name] = fn
    return fn


def current_stream(device: torch.device | None = None) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (default: the
    current device), as ``torch.cuda.current_stream(device).cuda_stream``
    gives it, without building a ``torch.cuda.Stream`` object (which costs
    several us a call)."""
    index = device.index if device is not None else None
    return torch._C._cuda_getCurrentRawStream(
        torch._C._cuda_getDevice() if index is None else index)


def launch(kernel: str, name: str, argtypes, *args) -> None:
    """Launch C entry point ``name`` on PyTorch's current stream, raise if
    the launch was refused, and count one launch of ``kernel``."""
    err = cfunc(name, argtypes)(*args, current_stream())
    if err:
        msg = library().rt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
    LAUNCHES[kernel] += 1


def kernel_name(key: str) -> str:
    """A profiler kernel key (a demangled signature) cut to the name."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[<(]", key)[0].split("::")[-1]


def device_ms(fn, reps: int, tries: int = 3) -> tuple[float, dict[str, float]]:
    """``torch.profiler``'s device time of one call of ``fn`` over ``reps``
    calls (ms): in all, and by kernel name (a wrapper may launch more than
    one kernel).  Each kernel's time is its mean per recorded launch times
    its launches per call, so a launch the profiler did not record does not
    lower it; a trace that recorded no kernel at all is taken again, up to
    ``tries`` times, and then raises."""
    for _ in range(tries):
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        totals: dict[str, list[float]] = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
                t = totals.setdefault(kernel_name(e.key), [0.0, 0])
                t[0] += e.self_device_time_total / 1e3
                t[1] += e.count
        by_kernel = {name: total / count * max(1, round(count / reps))
                     for name, (total, count) in totals.items()}
        if by_kernel:
            return sum(by_kernel.values()), by_kernel
    raise RuntimeError(f"the profiler recorded no kernel in {tries} traces of {reps} calls")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when all are on
    the CPU or all on ``meta`` (shapes only: the plain version runs, and no
    kernel runs on any path); anything else (mixed, or another device type)
    raises."""
    if len(tensors) == 1 and isinstance(tensors[0], torch.Tensor):
        t = tensors[0]  # the common case, without building sets of devices
        if t.is_cuda:
            return True
        if t.is_cpu or t.is_meta:
            return False
    devices = {t.device for t in tensors}
    kinds = {d.type for d in devices}
    if kinds == {"cpu"} or kinds == {"meta"}:
        return False
    if kinds == {"cuda"} and len(devices) == 1:
        return True
    raise ValueError(
        f"tensors must all lie on the CPU, all on meta or all on one CUDA device, got "
        f"{sorted(str(d) for d in devices)}"
    )


def require(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """Check what a kernel takes: dtype, rank and a contiguous layout."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def vec_rows(t: torch.Tensor) -> int:
    """1 when every row of the contiguous 2D tensor ``t`` starts 16-byte
    aligned, so a kernel may load the rows as 16-byte vectors; 0 when it
    must load scalars."""
    return int(t.data_ptr() % 16 == 0 and (t.shape[1] * t.element_size()) % 16 == 0)


P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
