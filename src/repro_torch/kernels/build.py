"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together) and linked into one shared library with
a plain C interface, ``build/kernels/libapex_kernels.so`` at the root of
the checkout, which ``ctypes`` loads.  No source includes PyTorch's
headers, so a build takes seconds.

The library is built at first use and again whenever the hash of the
sources and flags changes.  Importing this module builds nothing and
needs no ``nvcc``: only the first kernel launched on a CUDA tensor does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/build.py -> the checkout's root
CHECKOUT = Path(__file__).resolve().parents[3]
BUILD_DIR = CHECKOUT / "build" / "kernels"
LIB_NAME = "libapex_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# The link adds no library: the flash kernel's tensor-map encoder comes
# from the driver through cudaGetDriverEntryPointByVersion, not -lcuda.
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

# Devices on which a wrapper runs its kernel's plain version: the CPU,
# and meta tensors, which hold no data for a kernel to read (a shape
# trace such as ``launch.dryrun`` goes through the plain version).
PLAIN_DEVICES = ("cpu", "meta")

_lib: Optional[ctypes.CDLL] = None
_fns: dict = {}
_lock = threading.Lock()


def find_nvcc() -> Optional[str]:
    """Path of nvcc: $CUDA_HOME/bin, then $PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def sources(csrc: Path = CSRC) -> list:
    return sorted(csrc.glob("*.cu"))


def source_hash(csrc: Path = CSRC, flags: Sequence[str] = NVCC_FLAGS,
                link_flags: Sequence[str] = LINK_FLAGS) -> str:
    """sha256 over every source and header file and the nvcc compile and
    link flags."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(b"\0" + " ".join(link_flags).encode())
    for f in sorted(list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh"))):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def require_checkout(csrc: Path = CSRC,
                     checkout: Path = CHECKOUT) -> None:
    """Raise unless the sources lie in a repository checkout
    (``<checkout>/src/repro_torch/kernels/csrc``, beside its
    ``pyproject.toml``).  An installed copy of the package has no
    ``csrc/*.cu`` and no checkout to hold ``build/kernels``."""
    if (csrc.parents[2].name != "src"
            or not (checkout / "pyproject.toml").is_file()
            or not sources(csrc)):
        raise RuntimeError(f"the CUDA kernels build only from a checkout of "
                           f"the repository (src/repro_torch/kernels/csrc "
                           f"beside pyproject.toml); {csrc} is not one")


def compile_library(out_dir: Path = BUILD_DIR) -> Path:
    """Compile every source and link the library into ``out_dir``.

    Raises ``RuntimeError`` outside a checkout, and with nvcc's output
    when nvcc is missing or a step fails.  nvcc's messages (ptxas
    register and shared-memory use) are kept in ``out_dir/build.log``.
    """
    require_checkout()
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found ($CUDA_HOME/bin, $PATH, "
                           "/usr/local/cuda/bin): cannot build the CUDA "
                           "kernels")
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = source_hash()
    log = []
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc={proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            (out_dir / "build.log").write_text("\n".join(log))
            raise RuntimeError(f"nvcc failed on {failed}:\n"
                               + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(tmp_lib),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc={link.returncode})\n{link.stdout}")
        (out_dir / "build.log").write_text("\n".join(log))
        if link.returncode != 0:
            raise RuntimeError("nvcc failed to link the kernels:\n"
                               + link.stdout)
        lib_path = out_dir / LIB_NAME
        os.replace(tmp_lib, lib_path)
    (out_dir / (LIB_NAME + ".sha256")).write_text(digest)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            require_checkout()
            stamp = BUILD_DIR / (LIB_NAME + ".sha256")
            lib_path = BUILD_DIR / LIB_NAME
            fresh = (lib_path.exists() and stamp.exists()
                     and stamp.read_text() == source_hash())
            if not fresh:
                lib_path = compile_library()
            lib = ctypes.CDLL(str(lib_path))
            lib.apex_error_string.argtypes = [ctypes.c_int]
            lib.apex_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def kernel(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``name`` with its argument types declared.

    Every entry point returns the ``cudaError_t`` of its launch as int.
    """
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        text = library().apex_error_string(err).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {err} "
                           f"({text})")
