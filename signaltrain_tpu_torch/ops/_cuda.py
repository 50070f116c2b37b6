"""Build, load, launch and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), linked against the driver API (``-lcuda``, for the
tensor maps of ``csrc/wgmma_product.cuh``), and loaded with ``ctypes``. Libraries go to
``build/kernels/`` at the repository root, named by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so a fresh checkout builds them at first use and later calls reuse
them. ``build()`` starts one ``nvcc`` per missing source, all at once.

Every exported launcher takes its pointers and the stream as ``void*``,
launches on the stream it is given and returns ``cudaGetLastError()``;
``check()`` raises if that is not 0. Nothing here falls back to anything.

Each kernel has a :class:`KernelCounter`: its wrapper adds one to
``launches`` where it launches the kernel, and the kernel's plain PyTorch
version adds one to ``plain_calls`` where it runs. ``reset_counts()`` zeroes
them all, so a run can show which path it went through. A CUDA graph's
capture calls the wrappers without launching anything, and its replays
launch without calling them: the graph takes back what its capture counted
and adds it once a replay (``add_launches``), so ``launches`` stays the
number of launches on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# after the source: the driver API (cuTensorMapEncodeTiled, csrc/wgmma_product.cuh)
LINK_FLAGS = ("-lcuda",)


class KernelCounter:
    """Launches of one CUDA kernel, and calls of its plain version."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.plain_calls = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0


COUNTERS: dict[str, KernelCounter] = {}


def counter(name: str) -> KernelCounter:
    """The counter registered under ``name`` (created on first use)."""
    if name not in COUNTERS:
        COUNTERS[name] = KernelCounter(name)
    return COUNTERS[name]


def reset_counts() -> None:
    for c in COUNTERS.values():
        c.reset()


def launch_counts() -> dict[str, int]:
    """Every counter's ``launches`` as they stand."""
    return {name: c.launches for name, c in COUNTERS.items()}


def add_launches(counts: dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``counts[name]`` to each named counter's launches: a
    CUDA graph's replay launches what its capture recorded, with no Python
    call of the wrappers (``training/graphs.py``)."""
    for name, k in counts.items():
        counter(name).launches += times * k


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        shutil.which("nvcc"),
        os.path.join(home, "bin", "nvcc") if home else None,
        "/usr/local/cuda/bin/nvcc",
    ]
    for cand in candidates:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels are built from csrc/ at first use and need the CUDA toolkit"
    )


def sources() -> list[str]:
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))  # any may be included
    flags = " ".join(NVCC_FLAGS + LINK_FLAGS).encode()
    key = hashlib.sha256(src + headers + flags).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(names: list[str] | None = None) -> dict[str, float]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together. Returns the seconds each build took (an
    empty dict when everything was built already). Raises with the compiler's
    output if any build fails."""
    names = sources() if names is None else names
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    try:
        for name, out in todo.items():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"), *LINK_FLAGS]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            procs[name] = (proc, tmp, out, time.perf_counter())
        seconds, failures = {}, []
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                failures.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    finally:
        for proc, *_ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """What nvcc and ptxas printed when ``csrc/<name>.cu`` was built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _kernel_name(mangled: str) -> str:
    """A readable name of a kernel from its mangled one: the identifiers in
    it, without the namespaces, and the loader width of a product."""
    vec = re.search(r"Li(\d+)E", mangled)
    rest, names = re.sub(r"Li\d+E", "", mangled), []
    while rest:
        m = re.match(r"\d+", rest)
        if m:
            n = int(m.group())
            names.append(rest[len(m.group()) : len(m.group()) + n])
            rest = rest[len(m.group()) + n :]
        else:
            rest = rest[1:]
    names = [x for x in names if len(x) > 2 and not x.startswith("_GLOBAL__N")]
    return " ".join(names) + (f" (vec {vec.group(1)})" if vec else "")


def build_report(name: str) -> list[str]:
    """One line per kernel of ``csrc/<name>.cu``: its registers, shared
    memory and spills, as ptxas printed them."""
    lines, kernel, spills = [], None, ""
    for line in build_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel, spills = _kernel_name(m.group(1)), ""
        elif kernel and "spill" in line:
            spills = line.split(",", 1)[-1].strip()
        elif kernel and "Used" in line:
            lines.append(f"{kernel}: {line.split(':', 1)[-1].strip()}; {spills}")
            kernel = None
    return lines


_FUNCTIONS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def function(lib: str, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function ``fn`` of ``csrc/<lib>.cu``, built and loaded on first
    use, with its argument types declared and an ``int`` result."""
    key = (lib, fn)
    if key not in _FUNCTIONS:
        build([lib])
        handle = ctypes.CDLL(str(library_path(lib)))
        f = getattr(handle, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        err = handle.st_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        f.error_string = err
        _FUNCTIONS[key] = f
    return _FUNCTIONS[key]


def check(f: ctypes._CFuncPtr, status: int) -> None:
    """Raise if a launcher reported a CUDA error (its cudaGetLastError())."""
    if status != 0:
        msg = f.error_string(status).decode()
        raise RuntimeError(f"{f.__name__}: CUDA error {status}: {msg}")


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """The address of ``t``'s data, or a null pointer for an output that is
    not asked for."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, as the launchers take it."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require(t: torch.Tensor, name: str, shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device``: what every kernel of the port takes."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
