"""Builds the hand-written CUDA kernels and binds them with ``ctypes``.

Each ``csrc/<name>.cu`` exports plain C functions that take device pointers,
ints and the CUDA stream, launch one kernel, and return
``cudaGetLastError()``. ``nvcc`` compiles each source into its own shared
library under ``build/repro_torch/`` at the repo root (``.gitignore`` lists
``build/``), at first use, keyed by a hash of the source, the ``csrc``
headers it includes and the flags, so an edited source or header is rebuilt
and an unchanged one is loaded as it is.
``build`` starts one ``nvcc`` per missing library, all at once, and keeps
each one's ``-Xptxas -v`` report in ``logs``.

No module of the port imports this at load time for a CUDA reason: nothing
here runs until a kernel is launched on a CUDA tensor."""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the compiler's output (ptxas: registers, shared memory, spills per kernel)
# of each library built by this process
logs: Dict[str, str] = {}

_lock = threading.Lock()


class KernelError(RuntimeError):
    """A CUDA kernel that did not build or did not launch. The serving
    engine's fault boundary never absorbs one: a failing kernel stays
    visible."""


def sources() -> Sequence[str]:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelError("nvcc not found: the CUDA kernels cannot be built")
    return path


def ptxas_summary(log: str) -> List[Tuple[str, int, int, int]]:
    """(kernel symbol, registers, spill store bytes, spill load bytes) of
    each entry function in an ``nvcc -Xptxas -v`` report."""
    out, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spill))
            name, spill = None, (0, 0)
    return out


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def source_files(name: str) -> List[pathlib.Path]:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes (``#include
    "..."``), transitively, each once."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        todo += [CSRC / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return files


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` each, in parallel. Returns seconds spent per library built;
    raises with the compiler's output if any build fails."""
    names = list(sources() if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    took, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        logs[n] = log
        took[n] = time.monotonic() - t0
    if failed:
        raise KernelError("CUDA kernel build failed:\n" + "\n".join(failed))
    return took


# every Kernel made, in the order made (the kernel modules make theirs at
# import): what a CUDA-graph capture reads its launch counts from
KERNELS: List["Kernel"] = []


class Kernel:
    """One exported C launcher of one source, with its launch count.

    ``launches`` is a plain integer that ``launch`` raises by one each time
    the kernel is launched; a caller may reset it. Under a CUDA-graph
    capture ``launch`` records the launch and executes nothing, so the
    serving engine's graph cache (``serving.dispatch``) takes a capture's
    count back and adds it again on every replay: the count stays that of
    the device's launches."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        KERNELS.append(self)
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # + stream
        self.launches = 0
        self._fn = None
        self._err = None

    def load(self):
        with _lock:
            if self._fn is None:
                build([self.source])
                lib = ctypes.CDLL(str(library_path(self.source)))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = getattr(lib, "error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._fn, self._err = fn, err
        return self._fn

    def launch(self, *args, stream: int) -> None:
        code = self.load()(*args, stream)
        if code != 0:
            raise KernelError(f"{self.symbol} launch failed: CUDA error "
                               f"{code} ({self._err(code).decode()})")
        self.launches += 1


class Workspaces:
    """The zeroed int32 scratch buffers of one kernel, per device: made at
    ``minimum`` elements or more, grown by adding a larger buffer, and never
    freed, so a CUDA graph that captured a launch keeps a valid pointer. The
    kernel leaves what it must find zeroed at zero after every launch.
    Launches on one device share the newest buffer, so they must run in
    stream order, as the port's single stream does."""

    def __init__(self, what: str, minimum: int):
        self.what, self.minimum = what, minimum
        self._bufs: Dict = {}

    def get(self, dev, n: int, capturing: Callable[[], bool]):
        """A buffer of at least ``n`` elements on ``dev``: the newest one,
        or, when that is too small, a new zeroed one of at least
        ``minimum``. Making one while a CUDA graph is being captured
        (``capturing()``, asked only then) raises: the graph would hold a
        buffer that its replays, not the launches before them, zero."""
        import torch
        bufs = self._bufs.setdefault(dev, [])
        if not bufs or bufs[-1].numel() < n:
            if capturing():
                raise RuntimeError(
                    f"{self.what} of {n} elements on {dev} is first needed "
                    f"inside a CUDA graph capture; run the op once before "
                    f"capturing it")
            bufs.append(torch.zeros(max(n, self.minimum), dtype=torch.int32,
                                    device=dev))
        return bufs[-1]

    def made(self, dev) -> list:
        """The buffers made on ``dev`` so far, oldest first."""
        return list(self._bufs.get(dev, ()))


# ------------------------------------------------------------ wrapper checks
def runs_plain(t) -> bool:
    """Dispatch by device: True for a CPU tensor (the plain version runs)
    and for a meta tensor (the plain version, shapes only: the dry run's
    count of work), False for a CUDA tensor (the kernel launches). Any
    other device raises: there is no quiet fallback."""
    if t.device.type in ("cpu", "meta"):
        return True
    if t.device.type == "cuda":
        return False
    raise RuntimeError(f"no kernel for tensors on {t.device}")


def check(name: str, t, dtype, ndim: int, device) -> None:
    """Raise unless ``t`` is a ``dtype`` tensor of rank ``ndim`` on
    ``device``."""
    if t.dtype != dtype or t.dim() != ndim or t.device != device:
        raise ValueError(f"{name}: expected a {ndim}-d {dtype} tensor on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")


def check_int32(name: str, *sizes: int) -> None:
    for s in sizes:
        if s >= 2 ** 31:
            raise ValueError(f"{name}: size {s} does not fit the kernel's "
                             f"int arguments")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
