"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` holds a plain `extern "C"` launcher and compiles
into its own shared library (no PyTorch headers, so a build takes
seconds).  Libraries land in `build/torch_kernels/` at the root of the
checkout, keyed by a hash of the source, the shared headers and the
flags, and are built at first use: a fresh checkout builds everything it
runs.  `build()` starts one nvcc per source, all at once, and waits for
them together.  A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
#: flags of each source beyond NVCC_FLAGS.  The federated kernels equal
#: their plain versions bit for bit, so no multiply-add may be contracted
#: into an FMA; the model kernels are held to a tolerance and keep FMA
#: contraction.  Flash attention (24 (dtype, head-dim) instantiations,
#: its backward 9), and pack_payload (16 staged and 8 streaming ones)
#: let nvcc spread their optimisation over the cores.
SOURCE_FLAGS = {
    "gt_update": ("-fmad=false",),
    "compress_correction": ("-fmad=false",),
    "pack_payload": ("-fmad=false", "--split-compile=0"),
    "unpack_payload": ("-fmad=false",),
    "flash_attention": ("--split-compile=0",),
    "flash_attention_bwd": ("--split-compile=0",),
    "ssm_scan": (),
    "ssm_scan_bwd": (),
}

#: nvcc's output (ptxas register / spill report) of the builds this
#: process ran, by kernel name
build_logs: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    """nvcc on PATH, else under the toolkit PyTorch finds (CUDA_HOME,
    CUDA_PATH or the default install)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def flags(name: str) -> tuple:
    """nvcc's flags for `csrc/<name>.cu`."""
    if name not in SOURCE_FLAGS:
        raise KeyError(f"no CUDA source {name!r}; known: {sorted(SOURCE_FLAGS)}")
    return NVCC_FLAGS + SOURCE_FLAGS[name]


def library_path(name: str) -> Path:
    """Where the library built from `csrc/<name>.cu` lives (its file name
    carries a hash of the source, the shared `*.cuh` headers and the
    source's flags)."""
    h = hashlib.sha256(" ".join(flags(name)).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # shared device code
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, Path]:
    """Build the named kernels that are not built yet, one nvcc each, all
    started together; returns their library paths."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[n] = out
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{out}")
            continue
        # atomic: a concurrent builder of the same source writes the same
        # bytes under its own temporary name
        os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[name]))
        _libs[name] = lib
    return lib


def ptxas_usage(name: str) -> List[dict]:
    """Each entry function's registers, static shared memory, stack and
    spills, from the ptxas report (`-Xptxas=-v`) of the build of
    `csrc/<name>.cu` that this process ran (empty if it ran none)."""
    out: List[dict] = []
    for line in build_logs.get(name, "").splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            out.append({"function": entry.group(1)})
            continue
        if not out:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if frame:
            out[-1].update(stack_bytes=int(frame.group(1)),
                           spill_store_bytes=int(frame.group(2)),
                           spill_load_bytes=int(frame.group(3)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            out[-1]["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[-1]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return out
