"""Kernel microbenchmarks on the port: the JAX module's five rows
(`benchmarks/kernels_bench.py`), at its shapes and under its names, and
the fused retrieve at the kernels' largest n:

  PYTHONPATH=src python -m benchmarks_torch.kernels_bench [--device cpu]

  similarity_topk_64x16k       64 queries x 16,384 rows, D = 1536, top-20
                               (the fused retrieve: retrieve_topn +
                               topn_merge)
  elo_local_64x160             64 queries x 160 records x 10 models
                               (the replay kernel)
  retrieve_replay_64x16k       the retrieve and the gather replay, R = 8
  flash_attention_1k           B1 S1024 H8 dh128, causal, bf16
  decode_attention_8k          B8 T8192 H8 dh128 over a bf16 cache
  similarity_topk_64x16k_n512  the first row at n = 512 (retrieve_topn.MAX_N)

On the card each row times, by CUDA events over launches queued behind
a spin (the device's own run, not the host's enqueue), the hand-written
kernel and, where one computes the same function, the PyTorch library
call; its plain version by CUDA events over back-to-back runs (the host
paces those); and gives the bound: the larger of the bytes the
call must move over 3.35 TB/s and its operations over the H100's peak
for their type (67 TFLOP/s fp32, 989 TFLOP/s bf16). On the CPU the
wrappers take the plain versions: a row then has the host's wall time
per call, and its device times are None (not measured). JSON in
results/torch/kernels_bench.json.
"""
from __future__ import annotations

import argparse
import time

import torch

from benchmarks_torch import common as C
from repro_torch import DeviceLike, resolve_device

PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
#: fp32 operations of one replay step of one query
REPLAY_STEP_OPS = 10

#: the rows' shapes (the JAX module's; a row keeps its name at another
#: shape): similarity (Q, C, D, n), replay (Q, T, M), retrieve + replay
#: (Q, C, D, R, n), flash (B, S, H, dh), decode (B, T, H, dh)
SHAPES = dict(similarity=(64, 16384, 1536, 20), elo=(64, 160, 10),
              retrieve_replay=(64, 16384, 1536, 8, 20),
              flash=(1, 1024, 8, 128), decode=(8, 8192, 8, 128),
              similarity_n512=(64, 16384, 1536, 512))


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_FP32):
    """(the least time on the H100 in ms, "bytes" or "operations")."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def device_ms(fn, iters: int = 20) -> float:
    """The device's time of one run of fn(): the launches of `iters` runs
    queue behind a spin kernel (`torch.cuda._sleep`, >= 0.1 s), so CUDA
    events time the device's own run of the sequence, the gaps between
    its kernels included. A try counts only if the spin still held the
    device when the last launch was queued (the start event not yet
    reached); a try that the host outran is made again behind a spin
    twice as long, up to four tries. A stream holds about a thousand
    pending launches before the host blocks: keep runs x launches a run
    well under that."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for spin in (1, 2, 4, 8):
        torch.cuda._sleep(spin * 200_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
    raise RuntimeError(f"device_ms: the host did not queue {iters} runs "
                       "within a spin of 0.8 s")


def event_ms(fn, iters: int = 3) -> float:
    """Mean time of fn() over `iters` back-to-back runs, by CUDA events:
    for the plain versions, whose host work (a Python loop of small
    launches, a sort's temporary storage) keeps the host from running
    ahead of the device, so the host's pace is their time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _cases(dev: torch.device, shapes):
    """(name, kernel, plain, library or None, bytes, operations, peak,
    derived(us)) for each row."""
    from repro_torch.core import elo
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dev, dtype)

    def randint(hi, *shape):
        return torch.randint(0, hi, shape, generator=g,
                             dtype=torch.int32).to(dev)

    norm = torch.nn.functional.normalize
    cases = []

    def similarity(name, nq, c, d, n):
        q, db = randn(nq, d), randn(c, d)
        flops = 2.0 * nq * c * d
        cases.append((
            name, lambda: ops.similarity_topk(q, db, n),
            lambda: ops.similarity_topk(q, db, n, backend="reference"),
            lambda: torch.topk(torch.matmul(norm(q, dim=-1),
                                            norm(db, dim=-1).T), n, dim=-1),
            4.0 * (nq * d + c * d) + 12.0 * nq * n,
            flops + 2.0 * (nq + c) * d, PEAK_FP32,
            lambda us: f"{flops / us / 1e3:.1f}GFLOP/s"))

    similarity("similarity_topk_64x16k", *shapes["similarity"])

    nq, t, m = shapes["elo"]
    ratings = torch.full((nq, m), 1000.0, device=dev)
    a = randint(m, nq, t)
    b = (a + 1) % m
    s = randint(3, nq, t).float() / 2
    v = torch.ones((nq, t), dtype=torch.bool, device=dev)
    cases.append((
        "elo_local_64x160", lambda: ops.elo_scan(ratings, a, b, s, v),
        lambda: elo.local_elo(ratings[0], a, b, s, v), None,
        13.0 * nq * t + 8.0 * nq * m, REPLAY_STEP_OPS * float(nq * t),
        PEAK_FP32, lambda us: f"{nq * t / us:.2f}updates/us"))

    nq, c, d, r, n = shapes["retrieve_replay"]
    q, db = randn(nq, d), randn(c, d)
    pa = randint(m, c, r)
    pb = (pa + 1) % m
    po = randint(3, c, r).float() / 2
    pv = torch.ones((c, r), dtype=torch.bool, device=dev)
    size = torch.tensor(c, dtype=torch.int32, device=dev)
    init = torch.full((m,), 1000.0, device=dev)
    rr_flops = 2.0 * nq * c * d + REPLAY_STEP_OPS * nq * n * r
    cases.append((
        "retrieve_replay_64x16k",
        lambda: ops.retrieve_replay(q, db, pa, pb, po, pv, size, init, n=n),
        lambda: ops.retrieve_replay(q, db, pa, pb, po, pv, size, init, n=n,
                                    backend="reference"), None,
        4.0 * (nq * d + c * d) + 13.0 * nq * n * r + 4.0 * nq * m
        + 12.0 * nq * n, rr_flops + 2.0 * (nq + c) * d, PEAK_FP32,
        lambda us: f"{rr_flops / us / 1e3:.1f}GFLOP/s"))

    bb, ss, h, dh = shapes["flash"]
    qq = randn(bb, ss, h, dh, dtype=torch.bfloat16)
    kk = randn(bb, ss, h, dh, dtype=torch.bfloat16)
    f_flops = 4.0 * bb * ss * ss * h * dh / 2        # the causal half
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases.append((
        "flash_attention_1k",
        lambda: ops.flash_attention(qq, kk, kk),
        lambda: ops.flash_attention(qq, kk, kk, backend="reference"),
        lambda: sdpa(qq.transpose(1, 2), kk.transpose(1, 2),
                     kk.transpose(1, 2), is_causal=True),
        4.0 * bb * ss * h * dh * 2, f_flops, PEAK_BF16,
        lambda us: f"{f_flops / us / 1e3:.1f}GFLOP/s"))

    bb, tt, h, dh = shapes["decode"]
    qd = randn(bb, h, dh, dtype=torch.bfloat16)
    kd = randn(bb, tt, h, dh, dtype=torch.bfloat16)
    vd = randn(bb, tt, h, dh, dtype=torch.bfloat16)
    kl = torch.full((bb,), tt, dtype=torch.int32, device=dev)
    d_bytes = 2.0 * bb * tt * h * dh * 2         # K and V, both distinct
    cases.append((
        "decode_attention_8k",
        lambda: ops.decode_attention(qd, kd, vd, kl),
        lambda: ops.decode_attention(qd, kd, vd, kl, backend="reference"),
        lambda: sdpa(qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)),
        d_bytes + 4.0 * bb * h * dh, 4.0 * bb * h * tt * dh, PEAK_BF16,
        lambda us: f"{d_bytes / us / 1e3:.1f}GB/s"))

    similarity("similarity_topk_64x16k_n512", *shapes["similarity_n512"])
    return cases


def run(verbose: bool = True, device: DeviceLike = None):
    """Each row: on the card its kernel, plain and library times (ms) and
    its bound; on the CPU the host's time of the wrapper (the plain
    version). Returns (name, us_per_call, derived) rows, as the JAX
    module's."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products
    rows, entries = [], []
    for name, kernel, plain, library, nbytes, flops, peak, derived in \
            _cases(dev, SHAPES):
        bms, by = bound_ms(nbytes, flops, peak)
        entry = dict(name=name, device=str(dev), bound_ms=bms, bound_by=by,
                     kernel_ms=None, plain_ms=None, library_ms=None)
        if on_card:
            entry["kernel_ms"] = device_ms(kernel)
            entry["plain_ms"] = event_ms(plain)
            if library is not None:
                entry["library_ms"] = device_ms(library)
            us = entry["kernel_ms"] * 1e3
        else:
            us, _ = C.timer(kernel)
        entry.update(us_per_call=us, derived=derived(us))
        rows.append((name, us, entry["derived"]))
        entries.append(entry)
    if verbose:
        if on_card:
            print(f"[kernels] on {torch.cuda.get_device_name(dev)}; "
                  "ms: kernel, plain, library, bound")
        for e in entries:
            print(f"[kernels] {e['name']},{e['us_per_call']:.1f},"
                  f"{e['derived']}" + (
                      f" kernel_ms={e['kernel_ms']} plain_ms={e['plain_ms']}"
                      f" library_ms={e['library_ms']} bound_ms="
                      f"{e['bound_ms']} ({e['bound_by']})" if on_card
                      else ""))
    C.save_json("kernels_bench.json", entries)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    run(device=args.device)
    print(f"[kernels] {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
