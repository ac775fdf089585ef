#!/usr/bin/env python3
"""Where the fused retrieve's kernel 1 (`retrieve_topn`) spends its time
beside the similarity kernel, on one CUDA card.

    python3 scripts/retrieve_topn_variants.py

Run from the root of a checkout. It makes two copies of
`csrc/retrieve_topn.cu` in the git-ignored `build/retrieve_topn_variants/`
and builds them as the port builds the source: one with the call of its
GEMM kernel's merge removed (the scores are still written to shared
memory, and the barriers kept: timing only, its pool is not a top-n),
and one with the merge inlined at every tile size (the source calls it
out of line at 128 query rows). It times, by CUDA events over launches
queued ahead of the device, at the routing buckets 9, 64 and 1024 (C =
32768, D = 1536, the last 768 rows past the live count) and n = 20, 40,
64: kernel 1 as built, the two copies, and the similarity kernel's
panel. The pools of the build and of the inlined copy are held bit for
bit against the per-split stable top-n of the similarity kernel's masked
panel. Prints one line a bucket and the card's name and power limit;
exits non-zero if a pool differs.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (timing, the card line)

MERGE_CALL = "    merge<BM, NE>("
NO_MERGE = "    if (false) merge<BM, NE>("
OUT_OF_LINE = "  if constexpr (BM == 128)\n"
INLINED = "  if constexpr (false)\n"
BUCKETS, NS, C, D, DEAD = (9, 64, 1024), (20, 40, 64), 32768, 1536, 768


def build_variant(name, old, new):
    """`csrc/retrieve_topn.cu` with `old` (found once) replaced by `new`,
    built into build/retrieve_topn_variants/lib<name>.so and loaded."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "retrieve_topn.cu").read_text()
    if src.count(old) != 1:
        raise SystemExit(f"retrieve_topn.cu: {old!r} is not found once")
    out = ROOT / "build" / "retrieve_topn_variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src.replace(old, new))
    lib = out / f"lib{name}.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib), str(out / f"{name}.cu")],
                   check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.retrieve_topn_launch.argtypes = \
        _build._SIGNATURES["retrieve_topn"]["retrieve_topn_launch"]
    dll.retrieve_topn_launch.restype = ctypes.c_int
    return dll


def main() -> int:
    if not torch.cuda.is_available():
        print("retrieve_topn_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import retrieve_topn as RT
    from repro_torch.kernels.similarity_topk import similarity_cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    stream = _build.stream_handle(dev)
    libs = {"retrieve_topn": _build.library("retrieve_topn"),
            "inlined": build_variant("inlined", OUT_OF_LINE, INLINED),
            "without the merge": build_variant("no_merge", MERGE_CALL,
                                               NO_MERGE)}
    gen = torch.Generator(device=dev).manual_seed(0)
    db = torch.randn((C, D), generator=gen, device=dev)
    size = torch.tensor(C - DEAD, dtype=torch.int32, device=dev)
    bad = 0
    for nq in BUCKETS:
        q = torch.randn((nq, D), generator=gen, device=dev)
        tile, rows, splits = RT.plan(nq, C, D, RT._sm_count(dev))
        panel = ref.mask_dead(similarity_cuda(q, db), 0, size)
        times = {"similarity": cs.queued_ms(lambda: similarity_cuda(q, db),
                                            20)}
        for n in NS:
            pool_s = torch.empty((nq, splits * n), device=dev)
            pool_i = torch.empty((nq, splits * n), dtype=torch.int32,
                                 device=dev)

            def launch(lib):
                _build.check(lib.retrieve_topn_launch(
                    q.data_ptr(), db.data_ptr(), nq, C, D, 0,
                    size.data_ptr(), n, tile, rows, splits,
                    pool_s.data_ptr(), pool_i.data_ptr(), stream),
                    "retrieve_topn variant")
            want_s, want_i = ref.panel_pool_ref(panel, n, rows)
            for name, lib in libs.items():
                if name != "without the merge":
                    launch(lib)
                    torch.cuda.synchronize()
                    if not (torch.equal(pool_s, want_s)
                            and torch.equal(pool_i, want_i)):
                        print(f"{name} Q={nq} n={n}: the pool differs from "
                              "the panel's")
                        bad += 1
                times[f"{name} n={n}"] = cs.queued_ms(
                    lambda: launch(lib), 20)
        print(f"Q={nq} C={C} D={D} (tile {tile}, {splits} splits of {rows} "
              f"rows): ms {times}", flush=True)
    print(cs.card_line())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
