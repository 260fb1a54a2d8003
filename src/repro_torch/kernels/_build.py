"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes ``extern "C"`` launchers that take device
pointers, sizes and a stream, and return the launch's CUDA error; K1 and K2
also expose an occupancy query and share ``csrc/rowsum.cuh``; every source
exposes ``<name>_instance``, what the runtime knows of each of its kernel
instances at its launch configuration (``csrc/introspect.cuh``, read by
``repro_torch.analysis.kernel_audit``). Every
library links ``libcuda`` (``-lcuda``) for ``cuTensorMapEncodeTiled``,
which encodes the TMA descriptors of the tensor-core kernels of K3 and K4
(K3's backward, ``csrc/flash_attention_bwd.cu``, loads by ``cp.async`` and
needs none).
On first use every source is compiled for ``sm_90a`` into its own shared
library under ``build/repro_torch_kernels/<hash>/`` at the repository root,
the hash covering the sources, the headers and the flags, with nvcc's output
(ptxas's ``-v`` lines) beside it as ``<name>.log``. All ``nvcc`` processes
start together. Nothing is built or imported at module import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lcuda")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ATTENTION = (_P,) * 5 + (_I,) * 6 + (_F, _I, _I, _I, _P)
_ATTENTION_BWD = (_P,) * 10 + (_I,) * 6 + (_F, _I, _I, _I, _I, _P)
#: ``<name>_instance(i, arg, out, name)``: instance i's attributes into
#: ``out`` (int[introspect::kFields]) and its mangled name
_INSTANCE = (_I, _I, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_char_p))
#: argument types of every launcher, by source name and symbol
SIGNATURES = {
    "union_segsum": {"union_segsum_launch":
                     (_P, _P, _I, _P, _F, _F, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P),
                     "union_segsum_max_blocks": (_I, _I),
                     "union_segsum_instance": _INSTANCE},
    "rowsparse_scatter": {"rowsparse_scatter_launch":
                          (_P, _P, _I, _P, _F, _F, _I, _I, _I, _I, _I, _I, _P, _I, _P),
                          "rowsparse_scatter_max_blocks": (_I, _I),
                          "rowsparse_scatter_instance": _INSTANCE},
    "flash_attention": {"flash_attention_bf16_launch": _ATTENTION,
                        "flash_attention_f32_launch": _ATTENTION,
                        "flash_attention_instance": _INSTANCE},
    "flash_attention_bwd": {"flash_attention_bwd_bf16_launch": _ATTENTION_BWD,
                            "flash_attention_bwd_f32_launch": _ATTENTION_BWD,
                            "flash_attention_bwd_instance": _INSTANCE},
    "flash_decode": {"flash_decode_launch":
                     (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P, _P,
                      _P, _P),
                     "flash_decode_instance": _INSTANCE},
}


@dataclass
class BuildReport:
    """What the last build did: its directory, seconds, and nvcc's output
    (``-Xptxas -v`` register and shared-memory use) per source, read back
    from ``<name>.log`` for a library that was already built."""

    directory: Path
    seconds: float = 0.0
    logs: Dict[str, str] = field(default_factory=dict)


_launchers: Dict[tuple, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):    # sources and the headers they share
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> BuildReport:
    """Compile every source whose library or log is missing, all in
    parallel; every source's log is in the report."""
    out = build_dir()
    report = BuildReport(out)
    todo = [name for name in SIGNATURES
            if not ((out / f"{name}.so").exists() and (out / f"{name}.log").exists())]
    for name in SIGNATURES:
        if name not in todo:
            report.logs[name] = (out / f"{name}.log").read_text()
    if not todo:
        return report
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = out / f"{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        report.logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            # the log first: a library on disk always has its log beside it
            tmp_log = out / f"{name}.{os.getpid()}.tmp.log"
            tmp_log.write_text(log)
            os.replace(tmp_log, out / f"{name}.log")
            os.replace(tmp, out / f"{name}.so")   # atomic against a concurrent build
    report.seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def launcher(name: str, symbol: str):
    """The ``extern "C"`` function ``symbol`` of ``csrc/<name>.cu``, built on
    first use."""
    symbols = SIGNATURES[name]
    fn = _launchers.get((name, symbol))
    if fn is None:
        path = build().directory / f"{name}.so"
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = symbols[symbol]
        fn.restype = ctypes.c_int
        _launchers[(name, symbol)] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise when a launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {err}")
