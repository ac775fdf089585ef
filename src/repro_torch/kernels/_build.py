"""Build and load the CUDA kernels, and count their launches.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, at first use (never at import, so the
package imports on a machine without `nvcc`), into `build/repro_torch/`
at the root of the checkout. The library's file name carries a hash of
its source, so an edited kernel is rebuilt and a stale one never loads.
The wrappers load it with `ctypes` and launch on PyTorch's current
stream; every C entry point returns `cudaGetLastError()` after its
launch, which `check` turns into an exception. What `nvcc` printed
(`-Xptxas=-v`: registers, shared memory and spills per kernel) is kept
beside each library as `<library>.log`.

Each wrapper counts its launches (`count_launch`), under the call-site
label that `site()` has set, if any. A CUDA graph capture
(`repro_torch.graphs`) enqueues kernels without launching them, and its
replays launch them without running the wrappers: inside `recording()`
the wrappers' counts go to the recording instead, with their labels, and
`credit()` adds a recording to the counts once per replay.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

#: C signatures of every entry point, per source file
_SIGNATURES = {
    "similarity": {
        # q, db, out, Q, N, D, stream
        "similarity_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                             + [ctypes.c_void_p],
        # ..., tile (0: the path's choice; 8 streaming, 32/64/128 GEMM)
        "similarity_launch_tile": [ctypes.c_void_p] * 3
                                  + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    },
    "elo_scan": {
        # ratings, ratings row stride, a, b, s, v, top_i, hit, n, R, g,
        # costs, budgets, budget stride, out, choices, Q, T, M, k, p,
        # 1 - p, select, stream
        "elo_scan_launch": [ctypes.c_void_p, ctypes.c_int]
                           + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                           + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                           + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                           + [ctypes.c_float] * 3 + [ctypes.c_int]
                           + [ctypes.c_void_p],
    },
    "flash_attention": {
        # q, k, v, out, B, S, S_kv, H, Hk, dh, dtype, scale, causal,
        # window, stream
        "flash_attention_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                                  + [ctypes.c_float] + [ctypes.c_int] * 2
                                  + [ctypes.c_void_p],
    },
    "decode_attention": {
        # q, k, v, kv_len, out, part_acc, part_ml, B, T, H, Hk, dh,
        # q dtype, kv dtype, scale, stream
        "decode_attention_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                                   + [ctypes.c_float] + [ctypes.c_void_p],
        "decode_attention_chunk": [],
    },
    "retrieve_topn": {
        # q, emb, Q, C, D, offset, size, n, tile, split rows, splits,
        # pool_s, pool_i, stream
        "retrieve_topn_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                                + [ctypes.c_void_p] + [ctypes.c_int] * 4
                                + [ctypes.c_void_p] * 3,
        # pool_s, pool_i, Q, P, ld_in, k, top_s, top_i, idx64, ld_out,
        # hit, a, b, s, v, R, by_row, offset, ld_src, out a, b, s, v,
        # farthest, ld_dst, stream
        "topn_merge_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                             + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                             + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                             + [ctypes.c_void_p],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}

#: kernel launches per wrapper since the last reset_launches()
_LAUNCHES: Dict[str, int] = {"similarity": 0, "elo_scan": 0,
                             "elo_scan_select": 0, "flash_attention": 0,
                             "decode_attention": 0, "retrieve_topn": 0,
                             "topn_merge": 0}


#: launches per (wrapper, call-site label) since the last reset
_SITES: Dict[Tuple[str, Optional[str]], int] = {}
#: of the launch counts, those credited by graph replays
_CREDITED: Dict[str, int] = {}
#: the open recording (see recording()) and call-site label (see site())
_recording: Optional[Dict[Tuple[str, Optional[str]], int]] = None
_site: Optional[str] = None


def _add(sink: Dict, key, n: int = 1) -> None:
    sink[key] = sink.get(key, 0) + n


def count_launch(name: str) -> None:
    if _recording is not None:
        _add(_recording, (name, _site))
    else:
        _add(_LAUNCHES, name)
        _add(_SITES, (name, _site))


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def site_counts() -> Dict[Tuple[str, Optional[str]], int]:
    """Launches per (wrapper, call-site label; None where no label was
    set), replays credited under the label their graph was captured
    with."""
    return dict(_SITES)


def credited_counts() -> Dict[str, int]:
    """Of launch_counts(), the launches credited by graph replays."""
    return dict(_CREDITED)


@contextlib.contextmanager
def site(label: str):
    """Inside: the wrappers' launches carry the call-site label `label`."""
    global _site
    outer, _site = _site, label
    try:
        yield
    finally:
        _site = outer


@contextlib.contextmanager
def recording():
    """Inside: the wrappers' launches are counted, with their call-site
    labels, in the yielded dict, not in the launch counts (a graph
    capture: nothing runs yet). Recordings do not nest."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a launch recording is already open")
    _recording = rec = {}
    try:
        yield rec
    finally:
        _recording = None


def credit(rec: Dict[Tuple[str, Optional[str]], int]) -> None:
    """Add a recording's launches to the counts: one replay of the graph
    it was recorded for."""
    for (name, label), n in rec.items():
        _add(_LAUNCHES, name, n)
        _add(_CREDITED, name, n)
        _add(_SITES, (name, label), n)


def dtype_code(dtype: torch.dtype) -> int:
    """The C entry points' element-type code: 0 = fp32, 1 = bf16."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise ValueError(f"the attention kernels take float32 or bfloat16, "
                         f"not {dtype}")
    return codes[dtype]


def reset_launches() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
    _SITES.clear()
    _CREDITED.clear()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source and need the CUDA toolkit")


def _lib_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """The library's path: its name carries a hash of the source, the
    shared headers (`csrc/*.cuh`), the flags and any `-D` defines."""
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS + [f"-D{x}" for x in defines])
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    tag = "".join(f"-{x.lower()}" for x in defines)
    return BUILD_DIR / f"lib{name}{tag}-{digest[:12]}.so"


def build(names: Iterable[str] = tuple(_SIGNATURES),
          defines: Tuple[str, ...] = ()) -> List[Path]:
    """Compile the named sources that are not built yet, one `nvcc` each,
    all started together (with `defines`, a variant: `-D` each, a
    library of its own). Returns the library paths."""
    names = list(names)
    jobs = []
    for name in names:
        out = _lib_path(name, defines)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")   # then an atomic rename
        cmd = [nvcc(), *NVCC_FLAGS, *(f"-D{x}" for x in defines), "-o",
               str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {name}.cu:\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return [_lib_path(n, defines) for n in names]


def build_log(name: str) -> str:
    """What `nvcc` printed when it built `csrc/<name>.cu`."""
    (path,) = build([name])
    return path.with_suffix(".log").read_text()


def library(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` (built with `defines`: a
    control variant, which only the checks load), built on first use."""
    key = name + "".join(f" -D{x}" for x in defines)
    lib = _LIBS.get(key)
    if lib is None:
        (path,) = build([name], defines)
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[key] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_handle(device) -> int:
    """PyTorch's current stream on `device`, as the handle the C entry
    points take."""
    return torch.cuda.current_stream(device).cuda_stream
