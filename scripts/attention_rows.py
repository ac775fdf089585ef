#!/usr/bin/env python3
"""Time the flash and decode kernels at the rows of PERF.md's kernel
table against another checkout's kernels, in one call on one CUDA card.

    python3 scripts/attention_rows.py [--parent DIR] [--check-only]

Run from the root of a checkout. DIR (default `build/parent`) is the root
of another checkout, unpacked for instance with `mkdir -p build/parent &&
git archive <commit> src/repro_torch/kernels | tar -x -C build/parent`.
Its `src/repro_torch/kernels/csrc/{flash,decode}_attention.cu` are built
as the port builds its sources, into the git-ignored
`build/attention_rows/`, and called through its own wrappers
(`kernels/{flash,decode}_attention.py`, with its `_build.py`'s C
signatures), beside this checkout's libraries.

It prints both trees' ptxas reports (registers and spills of each flash
and dh = 256 decode instance, serialised `wgmma`), then at each row runs
the same inputs through each build, each held to chip_smoke.py's bar
against the plain version, and times them in the order parent, change,
change, parent (flash: CUDA events over back-to-back launches; decode:
launches queued behind a spin), beside SDPA and the row's bound. The
long_500k rows are timed with the model's kind of query (the newest key
plus noise, which puts most of the weight on that key) and checked with
that query and with a random one, whose weight spreads over every row.
With --check-only it checks and does not time. Writes `chiprun_out/attention_rows.json`; exits non-zero if a build
misses its bar.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (bars, timing, guards)

# flash rows: (B, S, S_kv, H, Hk, dk, dv, causal, window), chip_smoke.py's
# call sites (phi3.5-moe's prefill is qwen3-8b's shape)
FLASH_ROWS = {
    "qwen3-8b": (8, 1024, 1024, 32, 8, 128, 128, True, 0),
    "olmo-1b": (13, 1024, 1024, 16, 16, 128, 128, True, 0),
    "whisper encoder": (8, 1500, 1500, 20, 20, 64, 64, False, 0),
    "whisper cross prefill": (8, 1024, 1500, 20, 20, 64, 64, False, 0),
    "whisper decoder": (8, 1024, 1024, 20, 20, 64, 64, True, 0),
    "gemma3 local": (8, 1024, 1024, 16, 8, 256, 256, True, 1024),
    "gemma3 global": (8, 1024, 1024, 16, 8, 256, 256, True, 0),
    "window bite": (2, 4096, 4096, 16, 8, 256, 256, True, 1024),
    "internlm2": (8, 1024, 1024, 48, 8, 128, 128, True, 0),
    "llava": (4, 3904, 3904, 32, 8, 128, 128, True, 0),
    "zamba2": (8, 1024, 1024, 32, 32, 112, 112, True, 0),
    "deepseek MLA": (8, 1024, 1024, 128, 128, 192, 128, True, 0),
}
# decode rows: (B, T, H, Hk, dh, cache dtype, window, lengths): "full"
# (every row), ("from", n) (drawn in [n, T], chip_smoke.py's draws),
# "ragged" (drawn in [1, T], the first full); the query is bf16
F32, BF16 = torch.float32, torch.bfloat16
DECODE_ROWS = {
    "qwen3-8b": (16, 2048, 32, 8, 128, F32, 0, "ragged"),
    "olmo-1b": (13, 1056, 16, 16, 128, F32, 0, "ragged"),
    "whisper self": (16, 1056, 20, 20, 64, F32, 0, ("from", 129)),
    "whisper cross": (16, 1500, 20, 20, 64, F32, 0, "full"),
    "phi3.5-moe": (16, 1056, 32, 8, 128, F32, 0, ("from", 129)),
    "bf16 8k": (8, 8192, 8, 8, 128, BF16, 0, "full"),
    "gemma3 local": (16, 1056, 16, 8, 256, F32, 1024, ("from", 129)),
    "gemma3 global": (16, 1056, 16, 8, 256, F32, 0, ("from", 129)),
    "window bite": (16, 4096, 16, 8, 256, F32, 1024, ("from", 3900)),
    "internlm2": (16, 1056, 48, 8, 128, F32, 0, ("from", 129)),
    "llava": (16, 3936, 32, 8, 128, F32, 0, ("from", 2880 + 129)),
    "zamba2": (16, 1056, 32, 32, 112, F32, 0, ("from", 129)),
    "ring local": (16, 1024, 16, 8, 256, F32, 0, "full"),
    "long_500k local": (1, 1024, 16, 8, 256, BF16, 0, "full"),
    "long_500k global": (1, 524288, 16, 8, 256, BF16, 0, "full"),
}


def module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_parent(parent: Path):
    """The parent's flash and decode libraries, built with the port's
    flags, both nvcc at once, their C signatures set from the parent's
    `_build.py`. Returns ({name: library}, {name: log}, {name: the
    parent's wrapper})."""
    from repro_torch.kernels import _build
    kernels = parent / "src/repro_torch/kernels"
    signatures = module("parent_build", kernels / "_build.py")._SIGNATURES
    wrappers = {
        "flash_attention": module(
            "parent_flash", kernels / "flash_attention.py"
        ).flash_attention_cuda,
        "decode_attention": module(
            "parent_decode", kernels / "decode_attention.py"
        ).decode_attention_cuda}
    out = ROOT / "build" / "attention_rows"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in ("flash_attention", "decode_attention"):
        src = parent / "src/repro_torch/kernels/csrc" / f"{name}.cu"
        lib = out / f"lib{name}_parent.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (lib, proc) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"attention_rows: the parent's {name}.cu did "
                             f"not build:\n{logs[name]}")
        libs[name] = ctypes.CDLL(str(lib))
        for fn, argtypes in signatures[name].items():
            getattr(libs[name], fn).argtypes = argtypes
            getattr(libs[name], fn).restype = ctypes.c_int
    return libs, logs, wrappers


def report(tree, logs):
    from repro_torch.kernels import _build
    failures, regs = _build.build_guards(logs)
    print(f"{tree}: registers, spill stores, spill loads of each flash and "
          f"dh = 256 decode instance: {regs}", flush=True)
    for line in failures:
        print(f"{tree}: build guard: {line}", flush=True)
    return dict(registers=regs, guard_failures=failures)


def through(tree, fn):
    """fn(wrapper) with the wrapper's library calls going to the tree's
    library; tree: (library, wrapper)."""
    from repro_torch.kernels import _build
    lib, wrapper = tree
    with mock.patch.object(_build, "library", lambda *a, **kw: lib):
        return fn(wrapper)


def flash_row(name, shape, libs, dev, gen, timing):
    from repro_torch.kernels import ref
    b, s, t, h, hk, dk, dv, causal, window = shape
    q = cs._bf16(gen, (b, s, h, dk), dev)
    k = cs._bf16(gen, (b, t, hk, dk), dev)
    v = cs._bf16(gen, (b, t, hk, dv), dev)
    kw = dict(causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, **kw)
    atol = cs.flash_atol(q, k, v, **kw)
    row = dict(shape=shape, over_bar={}, ms={})
    for tree in ("parent", "change"):
        got = through(libs[tree], lambda fa: fa(q, k, v, **kw))
        row["over_bar"][tree] = cs.flash_check(got, want, atol)[1]
    del want, atol
    if window:
        band = cs._band(s, t, window, dev)
        sdpa = lambda: cs._sdpa(q, k, v, attn_mask=band)  # noqa: E731
        pairs = float(band.sum())
    else:
        sdpa = lambda: cs._sdpa(q, k, v, is_causal=causal)  # noqa: E731
        pairs = s * (s + 1) / 2 if causal else s * t
    nbytes = 2.0 * (b * s * h * (dk + dv) + b * t * hk * (dk + dv))
    row["bound_ms"], row["bound_by"] = cs.bound_ms(
        nbytes, 2.0 * b * h * (dk + dv) * pairs, cs.PEAK_BF16_FLOPS)
    if timing:
        for tree in ("parent", "change", "change", "parent"):
            row["ms"].setdefault(tree, []).append(through(
                libs[tree], lambda fa: cs.cuda_ms(
                    lambda: fa(q, k, v, **kw), 20)))
        row["sdpa_ms"] = cs.cuda_ms(sdpa, 20)
    return row


def decode_row(name, shape, libs, dev, gen, timing):
    b, t, h, hk, dh, cdt, window, lens = shape
    if cdt == BF16:
        k, v = cs._bf16(gen, (b, t, hk, dh), dev), cs._bf16(gen, (b, t, hk,
                                                                  dh), dev)
    else:
        k = torch.randn((b, t, hk, dh), generator=gen, device=dev)
        v = torch.randn((b, t, hk, dh), generator=gen, device=dev)
    if name.startswith("long"):
        # the newest key's K plus noise, as chip_smoke.py's long sites
        newest = k[:, t - 1].float().repeat_interleave(h // hk, dim=1)
        q = (newest + 0.25 * torch.randn(newest.shape, generator=gen,
                                         device=dev)).to(BF16)
    else:
        q = cs._bf16(gen, (b, h, dh), dev)
    if lens == "full":
        kv_len = torch.full((b,), t, dtype=torch.int32, device=dev)
    else:
        low = 1 if lens == "ragged" else lens[1]
        kv_len = torch.randint(low, t + 1, (b,), generator=gen, device=dev,
                               dtype=torch.int32)
        if lens == "ragged":
            kv_len[0] = t
    row = dict(shape=[str(x) for x in shape], over_bar={}, ms={})
    # (label suffix, query) pairs each build is checked with
    checks = [("", q)]
    if name.startswith("long"):
        checks.append((" random q", cs._bf16(gen, (b, h, dh), dev)))
    for suffix, qc in checks:
        want = cs._ref_by_head(qc, k, v, kv_len, window=window)
        for tree in ("parent", "change"):
            got = through(libs[tree],
                          lambda da: da(qc, k, v, kv_len, window=window))
            row["over_bar"][tree + suffix] = cs.decode_check(got, want)[1]
        del want, got
    call = lambda da: da(q, k, v, kv_len, window=window)  # noqa: E731
    rows = torch.arange(t, device=dev)[None]
    mask = rows < kv_len[:, None]
    if window:
        mask &= rows >= kv_len[:, None] - window
    n_kv = float(mask.sum())
    nbytes = (n_kv * hk * dh * k.element_size() * 2 + 2.0 * 2 * b * h * dh
              + 4 * b)
    row["valid_rows"] = int(n_kv)
    row["bound_ms"], row["bound_by"] = cs.bound_ms(
        nbytes, 4.0 * h * dh * n_kv, cs.PEAK_BF16_FLOPS)
    if timing:
        for tree in ("parent", "change", "change", "parent"):
            row["ms"].setdefault(tree, []).append(through(
                libs[tree], lambda da: cs.queued_ms(lambda: call(da), 200)))
        if cdt == BF16 and not window:
            row["sdpa_ms"] = cs.queued_ms(
                lambda: cs._sdpa(q[:, None], k, v)[:, :, 0], 200)
        else:
            m4 = mask[:, None, None]
            row["sdpa_ms"] = cs.queued_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q.float()[:, :, None], k.float().transpose(1, 2),
                    v.float().transpose(1, 2), attn_mask=m4,
                    enable_gqa=True), 20)
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=str(ROOT / "build" / "parent"))
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--rows", default="",
                    help="comma-separated row names (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_rows: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    parent_libs, parent_logs, parent_wrappers = build_parent(
        Path(args.parent))
    names = ("flash_attention", "decode_attention")
    _build.build(names)
    logs = {n: _build.build_log(n) for n in names}
    out = dict(card=card, build={
        "parent": report("parent", parent_logs),
        "change": report("change", logs)})
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    libs = {}
    for kind, name, wrapper in (("flash", "flash_attention",
                                 flash_attention_cuda),
                                ("decode", "decode_attention",
                                 decode_attention_cuda)):
        libs[kind] = {
            "parent": (parent_libs[name], parent_wrappers[name]),
            "change": (_build.library(name), wrapper)}
    pick = set(filter(None, args.rows.split(",")))
    gen = torch.Generator(device=dev).manual_seed(29)
    worst = 0.0
    for kind, rows, fn in (("flash", FLASH_ROWS, flash_row),
                           ("decode", DECODE_ROWS, decode_row)):
        for name, shape in rows.items():
            if pick and name not in pick:
                continue
            row = fn(name, shape, libs[kind], dev, gen,
                     not args.check_only)
            torch.cuda.empty_cache()
            worst = max(worst, *row["over_bar"].values())
            out[f"{kind} {name}"] = row
            line = (f"{kind} {name}: over the bar {row['over_bar']}; "
                    f"bound_ms={row['bound_ms']} ({row['bound_by']})")
            if row["ms"]:
                best = {k: min(v) for k, v in row["ms"].items()}
                line += (f"; ms {row['ms']}; change / parent "
                         f"{best['change'] / best['parent']}; bound / "
                         f"change {row['bound_ms'] / best['change']}; "
                         f"sdpa_ms={row['sdpa_ms']} (change / SDPA "
                         f"{best['change'] / row['sdpa_ms']})")
            print(line + f" [{card}]", flush=True)
    out["worst_over_bar"] = worst
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "attention_rows.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(f"largest error over a bar {worst} (at most 1)")
    return 0 if worst <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
