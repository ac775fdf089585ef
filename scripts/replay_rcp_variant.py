#!/usr/bin/env python3
"""Time the replay kernel with the IEEE reciprocal (`__frcp_rn`) in place
of the approximate one (`rcp.approx`) that the port builds, on one CUDA
card: the measurement behind that choice.

    python3 scripts/replay_rcp_variant.py

Run from the root of a checkout. It copies `csrc/elo_scan.cu` with its
one `rcp.approx` replaced by `__frcp_rn` into the git-ignored
`build/replay_rcp_variant/`, builds the copy as the port builds the
source, and runs both libraries through the port's wrappers on the
fit's global fold (Q = 1, the fit's 196,000 records padded to 262,144
steps, held against the float64 host fold with the bar `chip_smoke.py`
uses) and on the select epilogue at Q = 1024, T = 160, each timed by
CUDA events over launches queued ahead of the device. Prints one line a
build and the card's name and power limit; exits non-zero if a build
misses its bar.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (the fold log, timing, constants)


APPROX = 'asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'
IEEE = "y = __frcp_rn(x);"


def build_variant():
    """The replay library with the IEEE reciprocal, built and loaded."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "elo_scan.cu").read_text()
    if src.count(APPROX) != 1:
        raise SystemExit("replay_rcp_variant: elo_scan.cu no longer takes "
                         "its reciprocal from one rcp.approx")
    out = ROOT / "build" / "replay_rcp_variant"
    out.mkdir(parents=True, exist_ok=True)
    (out / "elo_scan_ieee_rcp.cu").write_text(src.replace(APPROX, IEEE))
    lib_path = out / "libelo_scan_ieee_rcp.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(out / "elo_scan_ieee_rcp.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in _build._SIGNATURES["elo_scan"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("replay_rcp_variant: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.data.routerbench import make_corpus, pairwise_feedback
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.elo_scan import (elo_scan_cuda,
                                              elo_scan_select_cuda)
    dev = torch.device("cuda")
    card = cs.card_line()
    libs = {"rcp.approx": _build.library("elo_scan"),
            "__frcp_rn": build_variant()}

    corpus = make_corpus(seed=0, n_per_dataset=cs.N_PER_DATASET, dim=cs.DIM)
    fb = pairwise_feedback(corpus, corpus.train_idx, seed=0,
                           pairs_per_query=cs.PAIRS_PER_QUERY)
    a, b, s = fb["model_a"], fb["model_b"], fb["outcome"]
    rec = cs.fold_log(dev, (a, b, s))
    g0 = torch.full((1, cs.M), 1000.0, device=dev)
    host = {dt: ref.elo_fold_host(np.full(cs.M, 1000.0), a, b, s,
                                  np.ones(len(a), bool), dtype=dt)
            for dt in (np.float32, np.float64)}
    r64 = host[np.float64]
    bar = np.maximum(2 * np.abs(host[np.float32] - r64),
                     cs.R_ATOL + cs.R_RTOL * np.abs(r64))

    gen = torch.Generator(device=dev).manual_seed(1)
    sel = cs.replay_inputs(dev, gen, 1024, cs.N * cs.R)
    sel += (1000 + 30 * torch.randn((cs.M,), generator=gen, device=dev),
            0.5 + 40 * torch.rand((cs.M,), generator=gen, device=dev),
            45 * torch.rand((1024,), generator=gen, device=dev))

    missed = []
    for name, lib in libs.items():
        with mock.patch.dict(_build._LIBS, {"elo_scan": lib}):
            got = elo_scan_cuda(g0, *rec)[0].cpu().numpy()
            over = float(np.max(np.abs(got - r64) / bar))
            fold_ms = cs.queued_ms(lambda: elo_scan_cuda(g0, *rec), 5)
            sel_ms = cs.queued_ms(
                lambda: elo_scan_select_cuda(*sel, p=cs.P), 50)
        print(f"{name}: fit fold T={rec[0].shape[1]} ({len(a)} valid) "
              f"kernel_ms={fold_ms}, over its bar {over}; elo_scan_select "
              f"Q=1024 T={cs.N * cs.R} kernel_ms={sel_ms} [{card}]",
              flush=True)
        if not over <= 1.0:
            missed.append(name)
    print(card)
    if missed:
        print(f"replay_rcp_variant: over the bar: {missed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
