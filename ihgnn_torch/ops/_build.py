"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<stem>.cu`` compiles on first use into its own shared library
with a plain C interface, ``build/<stem>-<hash>.so``, where the hash covers
the source, the shared headers ``csrc/*.cuh`` and the compiler flags.
``build`` starts one nvcc process per missing library and waits for all
of them, so the sources compile in parallel. Nothing here includes
PyTorch's headers: tensors cross the boundary as raw pointers
(``tensor.data_ptr()``) and the stream as
``torch.cuda.current_stream().cuda_stream``.

There is no fallback: without nvcc, or when a source does not compile,
``build`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

from ihgnn_torch.utils import tracing

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
SOURCES = ("segsum", "gather", "interact", "interact_bwd", "segmax",
           "edgedot", "permute", "segscan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    """nvcc from ``PATH``, else ``$CUDA_HOME/bin`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path) and os.access(path, os.X_OK):
        return path
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the ihgnn_torch CUDA "
        "kernels need the CUDA toolkit to build")


def nvcc_command(nvcc: str, source: Path, output: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def library_path(stem: str, csrc: Path = CSRC) -> Path:
    """``build/<stem>-<hash>.so``: the hash covers ``<stem>.cu``, every
    header ``*.cuh`` of ``csrc`` (a source may include any of them) and
    the compiler flags, so an edit to any of them names a new library."""
    digest = hashlib.sha256()
    digest.update((csrc / f"{stem}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{stem}-{digest.hexdigest()[:16]}.so"


def build(stems: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile each source of ``stems`` that has no library yet, all at
    once, and return ``{stem: library path}``. The compiler's output,
    including ptxas's register and shared-memory report, is kept beside
    each library as ``<stem>-<hash>.log``. Counts ``kernels.loaded``
    (libraries found built) and ``kernels.compiled`` (libraries nvcc
    built) in ``utils/tracing.py``'s counters."""
    stems = tuple(stems)
    paths = {stem: library_path(stem) for stem in stems}
    missing = [s for s in stems if not paths[s].exists()]
    tracing.count("kernels.loaded", len(stems) - len(missing))
    if not missing:
        return paths
    nvcc = find_nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    for stem in missing:
        out = paths[stem]
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log = open(out.with_suffix(".log"), "w")
        proc = subprocess.Popen(nvcc_command(nvcc, CSRC / f"{stem}.cu", tmp),
                                stdout=log, stderr=subprocess.STDOUT)
        jobs.append((stem, proc, tmp, out, log))
    failed = []
    for stem, proc, tmp, out, log in jobs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{stem}.cu (nvcc rc {rc}):\n"
                          + out.with_suffix(".log").read_text()[-4000:])
    tracing.count("kernels.compiled", len(missing) - len(failed))
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return paths


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build((stem,))[stem]))
            lib.ihgnn_error_string.argtypes = [ctypes.c_int]
            lib.ihgnn_error_string.restype = ctypes.c_char_p
            _LOADED[stem] = lib
        return lib


def function(stem: str, name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """C entry point ``name`` of ``csrc/<stem>.cu``; it returns the
    ``cudaGetLastError()`` after its launch."""
    fn = getattr(load(stem), name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(stem: str, what: str, err: int) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        msg = load(stem).ihgnn_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def use_kernel(what: str, *tensors) -> bool:
    """Dispatch rule of every wrapper: False when the tensors lie on the
    CPU (run the plain twin), True when they lie on one CUDA device (launch
    the kernel). Raises on any other device or on mixed devices, and on a
    CUDA call with grad mode on and an input that requires grad: a kernel's
    output has no ``grad_fn``, so the gradient would be silently dropped.
    Gradients go through the autograd Functions (``InteractFn``,
    ``GatherRolesFn``, ``SpmmFn``, ``BagMeanFn``, ``GatConvFn``, and on the
    routed path ``RoutedGatherFn``, ``RoutedScatterFn``, ``GatherPreFn``,
    ``Scatter2Fn``, ``SigmaToEdgeFn``, ``InteractAbsorbFn``), whose forward
    and backward run with grad mode off and launch the kernels."""
    import torch
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel's output carries no "
                           "gradient; call it through its autograd Function "
                           "or under torch.no_grad()")
    return True


def count(wrapper, bf16: bool) -> None:
    """One launch of ``wrapper``'s kernel: its bf16 form counts in
    ``wrapper.launches_bf16``, its f32 form in ``wrapper.launches``."""
    if bf16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


def require(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")
