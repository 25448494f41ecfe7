"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` to an object
file, all at once in parallel processes, and the objects link into one
shared library with a plain C interface, loaded with ``ctypes``. The build
is keyed on a hash of the sources and the flags, goes to
``ctrlora_tpu_torch/_build/`` (listed in ``.gitignore``) and happens at the
first CUDA use, never at import. ptxas's register and spill report of every
kernel is kept beside the library (:func:`ptxas_report`). Each C entry point
launches on the stream it is given and returns ``cudaGetLastError()``;
:func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL, _STRIDES = ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)
# C entry points and their argument types (pointers and the stream are
# c_void_p: a bare Python int would be passed as a 32-bit int)
_ENTRIES = {
    # q, k, v, out, lse, B, H, Sq, Sk, D, strides (b, s, h) of q, k, v, out,
    # scale, stream
    "ctrlora_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I] + [_LL] * 12 + [_F, _P],
    # the head-pair forward (kernel B6): the same arguments
    "ctrlora_flash_hpack2": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I] + [_LL] * 12 + [_F, _P],
    # D, int[5] out: consumer warpgroups, query rows a head, keys a tile,
    # stages, shared memory bytes (B6's tiling, hpack2_plan's mirror)
    "ctrlora_flash_hpack2_config": [_I, ctypes.POINTER(ctypes.c_int)],
    # kernel A: x, scale, bias, row (or null), y, B, HW, C, G, row stride,
    # row is fp32, eps, silu, dtype (0 bf16, 1 fp32), SMs, stream
    "ctrlora_group_norm": [_P] * 5 + [_I] * 4 + [_LL, _I, _F, _I, _I, _I, _P],
    # B, HW, C, G, itemsize, SMs, int[9] out: the plan (group_norm_plan's
    # mirror) and the launch's cudaOccupancyMaxActiveClusters
    "ctrlora_group_norm_config": [_I] * 6 + [ctypes.POINTER(ctypes.c_int)],
    # kernel A2 (the one-pass GroupNorm): kernel A's arguments and its own
    # plan, reported by the config entry as A's is (group_norm_onepass_plan)
    "ctrlora_group_norm_onepass": [_P] * 5 + [_I] * 4 + [_LL, _I, _F, _I, _I, _I, _P],
    "ctrlora_group_norm_onepass_config": [_I] * 6 + [ctypes.POINTER(ctypes.c_int)],
    # kernel D: block, out, row stride (bytes), int[n] row bytes, int[n]
    # output offsets (bytes), n, stream; and the rows its layout holds
    "ctrlora_unpack_rows": [_P, _P, _LL, ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int), _I, _P],
    "ctrlora_unpack_rows_capacity": [],
    # q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, D, strides (b, s, h) of
    # q, k, v, dout, dq as one int64[15], scale, stream
    "ctrlora_flash_bwd_dq": [_P] * 7 + [_I] * 5 + [_STRIDES, _F, _P],
    # q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, D, strides of q, k, v,
    # dout, dk, dv as one int64[18], scale, stream
    "ctrlora_flash_bwd_dkv": [_P] * 8 + [_I] * 5 + [_STRIDES, _F, _P],
    # D, dkv (1: the dK/dV kernel), int[5] out: rows, tile, stages, shared
    # memory bytes, split (the backward's tiling, flash_bwd_plan's mirror)
    "ctrlora_flash_bwd_config": [_I, _I, ctypes.POINTER(ctypes.c_int)],
    # x, w1 [2F, C], b1, h [rows, F], rows, C, F, up tile width, grid, stream
    "ctrlora_geglu_up": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # h, w2 [C, F], b2, y, split workspace, split counters, rows, C, F,
    # split, grid, down tile width, stream
    "ctrlora_geglu_down": [_P] * 6 + [_I] * 6 + [_P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(so: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs, procs = [], []
    for cu in sorted(CSRC.glob("*.cu")):
        obj = so.with_name(f"{cu.stem}.{tag}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    failed = [(p.returncode, log) for p, log in zip(procs, logs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f"({c}) {log}" for c, log in failed))
    tmp = so.with_suffix(f".{tag}")
    res = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
                          *map(str, objs)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    for obj in objs:
        obj.unlink()
    so.with_suffix(".ptxas.txt").write_text("".join(logs))
    os.replace(tmp, so)
    from ctrlora_tpu_torch.utils import trace

    trace.count("kernels.built")


def ptxas_report() -> str:
    """ptxas's per-kernel registers, shared memory and spills of the built
    library ('' before the first build)."""
    log = BUILD_DIR / f"libctrlora_kernels_{source_hash()}.ptxas.txt"
    return log.read_text() if log.exists() else ""


def spilling_kernels(name_filter: str = "", report: str = None) -> dict:
    """Kernels whose mangled name holds `name_filter` and which ptxas's
    `report` (the built library's by default) shows spilling: name ->
    (spill store, spill load) bytes."""
    out, current = {}, None
    for line in (ptxas_report() if report is None else report).splitlines():
        if "Function properties for " in line:
            current = line.split("Function properties for ", 1)[1].strip()
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if found and current is not None and name_filter in current:
            stores, loads = int(found.group(1)), int(found.group(2))
            if stores or loads:
                out[current] = (stores, loads)
    return out


def serialized_kernels(name_filter: str = "") -> dict:
    """Kernels of the built library whose mangled name holds `name_filter`
    and whose wgmma instructions ptxas serialises (its C7510-C7518 notes:
    the products then run one at a time): name -> the notes' codes."""
    out = {}
    for line in ptxas_report().splitlines():
        found = re.search(r"\((C75\d\d)\).*wgmma\.mma_async instructions are serialized.*"
                          r"function '([^']+)'", line)
        if found and name_filter in found.group(2):
            out.setdefault(found.group(2), []).append(found.group(1))
    return out


def sass_opcodes(opcodes, name_filter: str = "") -> dict:
    """Per kernel of the built library whose mangled name holds
    `name_filter`: how many instructions of each of `opcodes` its SASS has
    (cuobjdump -sass; needs the library built)."""
    so = BUILD_DIR / f"libctrlora_kernels_{source_hash()}.so"
    sass = subprocess.run([str(Path(_nvcc()).parent / "cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            current = counts.setdefault(name, dict.fromkeys(opcodes, 0)) \
                if name_filter in name else None
        elif current is not None:
            words = line.replace(";", " ").split()
            for op in opcodes:
                current[op] += any(w == op or w.startswith(op + ".") for w in words)
    return counts


def cuda_lib() -> ctypes.CDLL:
    """The kernel library, built on first call from the sources in csrc/."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"libctrlora_kernels_{source_hash()}.so"
        if not so.exists():
            _compile(so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    """The raw handle of `device`'s current CUDA stream (torch's own binding,
    which builds no torch.cuda.Stream object: host time on every launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)
