"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each kernel is one ``.cu`` file with a plain C entry point.  At first use
it is compiled for Hopper into ``kernels/build/<name>-<hash>/`` (the
directory is listed in ``.gitignore``), keyed by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one loads the
library already built.  The compile writes to a temporary file and renames
it into place, so processes that build at once never load a torn library.

Nothing here runs at import (the CPU tests import every module):
``nvcc`` starts only when a kernel is first launched on a CUDA tensor, or
when ``build`` is called.  A missing toolkit or a failed compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

#: ``-fmad=false`` keeps multiply-adds unfused; never ``--use_fast_math``.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

BUILD_ROOT = Path(__file__).resolve().parent / "build"

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": compile seconds (0.0 when already built),
#:          "log": nvcc's output (register/shared-memory report)}
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                       "toolkit's bin/ on PATH to build the kernels")


def library_path(name: str, source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_ROOT / f"{name}-{digest[:16]}" / f"lib{name}.so"


def build(sources: dict) -> dict:
    """Compile every kernel of ``{name: source}`` whose library is
    missing, one ``nvcc`` per source, all started together.  Returns
    ``{name: library path}``; ``build_info`` holds seconds and logs."""
    t0 = time.perf_counter()
    jobs = {}
    for name, src in sources.items():
        target = library_path(name, Path(src))
        if target.exists():
            build_info.setdefault(name, {"seconds": 0.0, "log": ""})
            continue
        target.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
        os.close(fd)
        proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, target)
    try:
        for name, (proc, tmp, target) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name} "
                                   f"(exit {proc.returncode}):\n{out}")
            os.replace(tmp, target)
            build_info[name] = {"seconds": time.perf_counter() - t0,
                                "log": out}
    finally:                 # a failed build stops the others' compilers
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return {name: library_path(name, Path(src))
            for name, src in sources.items()}


def load(name: str, source: Path) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it first if
    needed (once per process)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build({name: source})[name]))
            _loaded[name] = lib
        return lib
