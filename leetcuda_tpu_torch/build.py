"""Build the hand-written CUDA kernels under ``csrc/`` and load them.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

and ``ctypes`` loads it. No PyTorch header is included, so a source builds
in seconds. The library name carries a hash of the source, the shared
headers and the flags, so an edited source rebuilds and an unchanged one is
reused. ``build_all`` starts one ``nvcc`` per source, all at once.

``build_variants`` compiles one source again with macros set (``-D``), each
variant into a library of its own, for a benchmark that compares builds;
the package itself only loads the plain builds.

Nothing here runs at import time: the first wrapper call on a CUDA tensor
builds its kernel and binds its entry point (``kernel``), or a script calls
``build_all`` first.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
_bound: dict[tuple[str, str], object] = {}


def sources() -> list[str]:
    """Names (stems) of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the GPU")
    return found


def _lib_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS + list(defines)).encode())
    tag = "-variant" if defines else ""
    return BUILD_DIR / f"{name}{tag}-{h.hexdigest()[:16]}.so"


def _compile(jobs: dict) -> dict[str, str]:
    """Run one ``nvcc`` per job {key: (source name, -D flags)} whose library
    is missing, all started together. Returns {key: the compiler's report,
    or "" when cached}; raises with the compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, (name, defines) in jobs.items():
        out = _lib_path(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    reports, failed = {key: "" for key in jobs}, []
    for key, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[key] = log
        if proc.returncode != 0:
            failed.append(f"--- {key} (exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every named source (default: all) whose library is missing,
    one ``nvcc`` per source, all started together. Returns {name: the
    compiler's resource report (``-Xptxas -v``), or "" when cached}.
    Raises with the compiler's output if any build fails."""
    names = sources() if names is None else names
    return _compile({name: (name, ()) for name in names})


def build_variants(name: str, variants: list[dict]):
    """Compile ``csrc/<name>.cu`` once per variant ({macro: value}), all at
    once, and load each. Returns [(loaded library, the compiler's report)]
    in the order given."""
    jobs = {str(i): (name, tuple(f"-D{k}={v}" for k, v in sorted(d.items())))
            for i, d in enumerate(variants)}
    reports = _compile(jobs)
    return [(ctypes.CDLL(str(_lib_path(*jobs[k]))), reports[k])
            for k in jobs]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


def entry(lib, symbol: str, argtypes: tuple):
    """``symbol`` of ``lib``: a source name (built and bound by ``kernel``)
    or a loaded library (a variant build of ``build_variants``), with
    ``argtypes`` set and an int (CUDA error code) result."""
    if isinstance(lib, str):
        return kernel(lib, symbol, argtypes)
    fn = getattr(lib, symbol)
    fn.restype, fn.argtypes = ctypes.c_int, list(argtypes)
    return fn


def kernel(name: str, symbol: str, argtypes: tuple):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, bound once: its
    library loaded (built first if needed), ``argtypes`` set and an int
    (CUDA error code) result. Later calls return the bound function."""
    fn = _bound.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _bound[(name, symbol)] = fn
    return fn
