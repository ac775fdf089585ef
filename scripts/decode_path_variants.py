#!/usr/bin/env python3
"""Time the decode kernel's two ways of computing a step against each
other on one CUDA card: the measurement behind the choice of path in
`csrc/decode_attention.cu` (tensor cores where a KV head has two or
more bf16 query heads, CUDA cores otherwise).

    python3 scripts/decode_path_variants.py

Run from the root of a checkout. It copies `csrc/decode_attention.cu`
twice into the git-ignored `build/decode_path_variants/`, one copy with
every bf16 query on the CUDA-core path ("cores") and one with rep = 1 on
the tensor-core path too ("tensor cores"), builds each as the port
builds the source, and runs the shipped library and both copies through
the port's wrapper at the main path's decode layouts (`chip_smoke.py`'s
shapes and length draws), each held to the decode bar against the plain
version and timed by CUDA events over launches queued ahead of the
device, in the order shipped, cores, tensor cores, shipped. Prints one
line a layout and the card's name and power limit; exits non-zero if a
build misses its bar.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (the bar, timing, shapes)

MMA_AT_REP2 = "    return F<QT, CT, DH, 8, true>::run(args...);"
CORES_AT_REP2 = ("    if (rep == 2) return F<QT, CT, DH, 2, false>::run(args...);\n"
                 "    if (rep <= 4) return F<QT, CT, DH, 4, false>::run(args...);\n"
                 "    return F<QT, CT, DH, 8, false>::run(args...);")
CORES_AT_REP1 = "  if (rep == 1) return F<QT, CT, DH, 1, false>::run(args...);"
MMA_AT_REP1 = ("  if (rep == 1 && !std::is_same<QT, __nv_bfloat16>::value)\n"
               "    return F<QT, CT, DH, 1, false>::run(args...);")
# layout: (B, T, H, Hk, dh, kv_len draw); draws as chip_smoke.py makes them
LAYOUTS = {
    "qwen3-8b": cs.DECODE_SHAPES["qwen3-8b"] + ("ragged",),
    "olmo-1b": cs.DECODE_SHAPES["olmo-1b"] + ("ragged",),
    "whisper self": cs.WHISPER_DECODE["self decode"] + ("prompt",),
    "whisper cross": cs.WHISPER_DECODE["cross decode"] + ("full",),
    "phi3.5-moe": cs.PHI_DECODE["self decode"] + ("prompt",),
    "bf16 8k": cs.DECODE_SHAPES["bf16 8k"] + ("full",),
}


def build_variant(name: str, old: str, new: str):
    """The decode library with `old` replaced by `new`, built and
    loaded."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "decode_attention.cu").read_text()
    if src.count(old) != 1:
        raise SystemExit("decode_path_variants: decode_attention.cu no "
                         f"longer dispatches as this script expects ({name})")
    out = ROOT / "build" / "decode_path_variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"decode_{name}.cu"
    cu.write_text(src.replace(old, new))
    lib_path = out / f"libdecode_{name}.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(cu)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in _build._SIGNATURES["decode_attention"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_path_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    libs = {"shipped": _build.library("decode_attention"),
            "cores": build_variant("cores", MMA_AT_REP2, CORES_AT_REP2),
            "tensor cores": build_variant("tensor_cores", CORES_AT_REP1,
                                          MMA_AT_REP1)}
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0
    for layout, (b, t, h, hk, dh, draw) in LAYOUTS.items():
        q = cs._bf16(gen, (b, h, dh), dev)
        if layout == "bf16 8k":
            k, v = (cs._bf16(gen, (b, t, hk, dh), dev) for _ in range(2))
        else:
            k, v = (torch.randn((b, t, hk, dh), generator=gen, device=dev)
                    for _ in range(2))
        if draw == "full":
            kv_len = torch.full((b,), t, dtype=torch.int32, device=dev)
        else:
            low = 1 if draw == "ragged" else 129
            kv_len = torch.randint(low, t + 1, (b,), generator=gen,
                                   device=dev, dtype=torch.int32)
        want = ref.decode_attention_ref(q, k.to(q.dtype), v.to(q.dtype),
                                        kv_len)
        n_kv = float(kv_len.sum())
        bms, _ = cs.bound_ms(n_kv * hk * dh * k.element_size() * 2
                             + 2.0 * 2 * b * h * dh + 4 * b,
                             4.0 * h * dh * n_kv, cs.PEAK_BF16_FLOPS)
        times = []
        for name in ("shipped", "cores", "tensor cores", "shipped"):
            lib = libs[name]
            with mock.patch.object(_build, "library", lambda *a, **kw: lib):
                got = decode_attention_cuda(q, k, v, kv_len)
                worst = max(worst, cs.decode_check(got, want)[1])
                times.append((name, cs.queued_ms(
                    lambda: decode_attention_cuda(q, k, v, kv_len), 200)))
        print(f"decode {layout} B={b} T={t} H={h} Hk={hk} dh={dh} cache "
              f"{k.dtype}, {int(n_kv)} valid rows, bound_ms={bms}: queued "
              f"ms " + ", ".join(f"{n} {ms}" for n, ms in times)
              + f" [{card}]", flush=True)
    print(f"largest error over the decode bar {worst} (at most 1)")
    return 0 if worst <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
