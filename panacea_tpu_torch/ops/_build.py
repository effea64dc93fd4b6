"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` becomes its own shared library with a plain C interface,
compiled for ``sm_90a``. The build runs at first use, into
``panacea_tpu_torch/_build/<hash of the sources>/`` (listed in .gitignore),
so a fresh checkout builds itself. ``build_all`` starts one ``nvcc`` per
source, all at once. A missing ``nvcc`` or a failed build raises. nvcc's
output (ptxas's registers and spills of each kernel) is kept beside each
library as ``<source>.log`` and read back into ``build_log`` when the
library is reused; a library without its log is built again.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(CSRC), "_build")
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "geglu.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # source -> nvcc's output (ptxas register report)


def _log_path(lib_path: str) -> str:
    return lib_path[:-len(".so")] + ".log"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        "panacea_tpu_torch/csrc at first use and need the CUDA toolkit")


def _build_dir() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def _start(nvcc: str, source: str, out: str) -> subprocess.Popen:
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_all(sources: List[str] = SOURCES) -> Dict[str, ctypes.CDLL]:
    """Build (where not yet built) and load every listed source."""
    with _lock:
        todo = [s for s in sources if s not in _libs]
        if not todo:
            return dict(_libs)
        out_dir = _build_dir()
        os.makedirs(out_dir, exist_ok=True)
        outs = {s: os.path.join(out_dir, s.replace(".cu", ".so")) for s in todo}
        missing = [s for s in todo
                   if not (os.path.exists(outs[s]) and os.path.exists(_log_path(outs[s])))]
        if missing:
            nvcc = find_nvcc()
            procs = {s: _start(nvcc, s, outs[s]) for s in missing}
            failed = []
            for s, p in procs.items():
                log, _ = p.communicate()
                build_log[s] = log
                if p.returncode != 0:
                    failed.append(f"{s} (exit {p.returncode}):\n{log}")
                else:
                    with open(f"{_log_path(outs[s])}.{os.getpid()}.tmp", "w") as f:
                        f.write(log)
                    os.replace(f"{_log_path(outs[s])}.{os.getpid()}.tmp", _log_path(outs[s]))
                    os.replace(f"{outs[s]}.{os.getpid()}.tmp", outs[s])
            if failed:
                raise RuntimeError("nvcc failed to build " + "\n".join(failed))
        for s in todo:
            if s not in build_log:
                with open(_log_path(outs[s])) as f:
                    build_log[s] = f.read()
            lib = ctypes.CDLL(outs[s])
            lib.pn_error_string.argtypes = [ctypes.c_int]
            lib.pn_error_string.restype = ctypes.c_char_p
            _libs[s] = lib
        return dict(_libs)


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built if needed. The module that
    wraps a kernel sets the argtypes of its own C entry."""
    return build_all([source])[source]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if err != 0:
        msg = lib.pn_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")
