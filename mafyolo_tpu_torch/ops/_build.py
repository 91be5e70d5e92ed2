"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface, `build/kernels/<name>-<hash>.so` at the repository root (the hash
covers the source, the headers under csrc/ it includes and the flags, so an
edited source or header rebuilds). Nothing is
built at import time: `load(name)` builds at first use, on the machine with
the card. No PyTorch headers are included, which keeps a build to seconds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

from mafyolo_tpu_torch.utils import trace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas=-v"]
# Per-source extra flags. The NMS keep mask must equal the plain version's
# bit for bit, so its IoU arithmetic may not be contracted into FMAs; the
# FMA probe wants contraction, which is nvcc's default. dw_grad holds 20
# instantiations of its tile kernel: its optimization passes run in parallel.
EXTRA_FLAGS = {"greedy_nms": ["-fmad=false"], "frontend": [], "stem": [], "neck80": [],
               "fma_probe": [], "dw_grad": ["-split-compile=0"], "int8_conv": [],
               "int8_dw": [], "dw_conv": []}

_LOADED: dict = {}
# name -> (seconds, nvcc output) of builds run here: load()'s span seconds,
# nvcc's own where build() is called alone
BUILD_LOG: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _with_headers(src: Path, seen=None) -> bytes:
    """The source's bytes followed by those of every `#include "..."` header
    under csrc/ that it reaches."""
    seen = set() if seen is None else seen
    text = src.read_bytes()
    out = [text]
    for inc in re.findall(rb'^\s*#include\s+"([^"]+)"', text, re.M):
        header = CSRC / inc.decode()
        if header.exists() and header not in seen:
            seen.add(header)
            out.append(_with_headers(header, seen))
    return b"".join(out)


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (if its hashed library is missing) -> .so path."""
    src = CSRC / f"{name}.cu"
    flags = ARCH_FLAGS + COMMON_FLAGS + EXTRA_FLAGS[name]
    digest = hashlib.sha256(_with_headers(src) + " ".join(flags).encode())
    flags = flags + ["-I", str(CSRC)]
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry point.

    The build and load are the set-up span `kernels.load` (utils/trace.py),
    with the library's name and whether it was built here or found built;
    a library built here keeps that span's seconds in BUILD_LOG.

    signatures maps function name -> argtypes; each such function returns
    its cudaError_t as an int. Every library also exports
    `const char* error_string(int)`."""
    lib = _LOADED.get(name)
    if lib is None:
        before = BUILD_LOG.get(name)
        with trace.span("kernels.load", library=name) as span:
            lib = ctypes.CDLL(str(build(name)))
            span.row["built"] = BUILD_LOG.get(name) is not before
        if span.row["built"]:
            BUILD_LOG[name] = (span.seconds, BUILD_LOG[name][1])
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index) -> int:
    """The number of SMs of CUDA device `index`."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def current_stream(device) -> int:
    """The raw cudaStream_t of torch's current stream on `device` (what
    torch.cuda.current_stream(device).cuda_stream gives, without building
    the Stream object)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)


_SCRATCH: dict = {}


def scratch(device, nbytes: int):
    """A uint8 scratch tensor of at least nbytes on `device`, kept per
    (device, current stream) and grown when a call needs more. Kernels on one
    stream run in order, so the next call on that stream may overwrite it; a
    caller on another stream gets a buffer of its own. While a CUDA graph
    is being captured the buffer is fresh and not kept: it belongs to the
    graph's own pool."""
    import torch
    if torch.cuda.is_current_stream_capturing():
        return torch.empty(nbytes, dtype=torch.uint8, device=device)
    key = (device.index, current_stream(device))
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _SCRATCH[key] = torch.empty(max(nbytes, 1 << 20), dtype=torch.uint8, device=device)
    return buf


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")
