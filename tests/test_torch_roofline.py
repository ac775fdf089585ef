"""The port's roofline report (`benchmarks_torch/roofline.py`) against the
JAX package's (`benchmarks/roofline.py`), on the CPU, over synthetic
dry-run records.

The JAX report's constants are the v5e's; inside each test they are
monkeypatched to the H100's (the port's), so both compute the same
terms. The records carry no collective bytes, as the port's one card
has none: the JAX report's link term is then 0 as well.
"""
import json

import pytest

from benchmarks import roofline as JRF
from benchmarks_torch import roofline as TRF


def _rec(arch, shape, kind, flops, hbm, model_flops, mem, mesh="card",
         status="ok"):
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": status,
            "n_devices": 1, "kind": kind,
            "flops_per_device": 0.8 * flops, "bytes_per_device": 3.0 * hbm,
            "collectives": {"total_bytes": 0},
            "model_flops_global": model_flops,
            "analytic": {"flops_global": flops, "hbm_bytes_global": hbm},
            "memory": {"argument_size_in_bytes": mem[0],
                       "temp_size_in_bytes": mem[1],
                       "output_size_in_bytes": mem[2],
                       "alias_size_in_bytes": mem[3]}}


RECORDS = [
    _rec("a", "train_4k", "train", 4e17, 2e12, 3e17, (30e9, 40e9, 30e9,
                                                       30e9)),
    _rec("b", "train_4k", "train", 9e17, 5e12, 2e17, (90e9, 9e9, 90e9,
                                                       90e9)),
    _rec("a", "prefill_32k", "prefill", 2e16, 1e12, 1.5e16, (3e9, 20e9,
                                                             30e9, 0)),
    _rec("a", "decode_32k", "decode", 1e12, 6e11, 9e11, (600e9, 5e9,
                                                         600e9, 600e9)),
    _rec("b", "decode_32k", "decode", 3e12, 9e11, 2e12, (900e9, 5e9,
                                                         900e9, 900e9)),
    _rec("b", "long_500k", "decode", 4e11, 5e10, 3e11, (58e9, 4e9, 58e9,
                                                        58e9)),
    {"arch": "c", "shape": "long_500k", "mesh": "card", "status": "skipped",
     "reason": "full attention"},
    {"arch": "c", "shape": "train_4k", "mesh": "card", "status": "error",
     "error": "boom"},
]


@pytest.fixture
def h100(monkeypatch):
    """The JAX report's constants set to the port's, in this test only."""
    monkeypatch.setattr(JRF, "PEAK_FLOPS", TRF.PEAK_FLOPS)
    monkeypatch.setattr(JRF, "HBM_BW", TRF.HBM_BW)
    monkeypatch.setattr(JRF, "HBM_BYTES", TRF.HBM_BYTES)


def _jax_rows(records):
    """JAX's analyze on the records with its mesh name ("single")."""
    rows = [JRF.analyze(dict(r, mesh="single")) for r in records]
    return [r for r in rows if r]


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_analyze_matches_jax(h100, i):
    got = TRF.analyze(RECORDS[i])
    want = JRF.analyze(dict(RECORDS[i], mesh="single"))
    if want is None:
        assert got is None
        return
    for key in ("compute_s", "memory_s", "collective_s", "dominant",
                "useful_flops_fraction", "bound_step_s", "per_device_gib",
                "fits_hbm", "suggestion", "arch", "shape", "kind"):
        assert got[key] == want[key], key
    assert got["counted_flops_coverage"] == want["hlo_flops_coverage"]
    assert got["mesh"] == "card" and got["collective_s"] == 0.0


def test_analyze_counts_the_peak_against_the_cards_memory():
    """arguments + temp + outputs - aliases against the card's bytes:
    70, 99, 53, 605, 905 and 62 GB against HBM_BYTES (85 GB), then the
    last against 60 GB."""
    assert TRF.HBM_BYTES > 80e9
    fits = [TRF.analyze(r)["fits_hbm"] for r in RECORDS[:6]]
    assert fits == [True, False, True, False, False, True]
    assert TRF.analyze(RECORDS[5])["per_device_gib"] == 62e9 / 2**30
    assert TRF.analyze(RECORDS[5], hbm_bytes=60e9)["fits_hbm"] is False


def test_pick_hillclimb_matches_jax(h100):
    rows = [TRF.analyze(r) for r in RECORDS if TRF.analyze(r)]
    got = TRF.pick_hillclimb(rows)
    want = JRF.pick_hillclimb(_jax_rows(RECORDS))
    # the most collective-bound pick needs several cards
    assert got.keys() == want.keys() - {"most_collective"}
    for k in got:
        assert (got[k]["arch"], got[k]["shape"]) == \
            (want[k]["arch"], want[k]["shape"]), k
    assert (got["worst_useful"]["arch"], got["serving_representative"][
        "shape"]) == ("b", "decode_32k")


def test_run_reads_a_sweep_and_writes_its_table(h100, tmp_path, capsys):
    sweep = tmp_path / "sweep"
    sweep.mkdir()
    for r in RECORDS:
        (sweep / f"{r['arch']}__{r['shape']}__card.json").write_text(
            json.dumps(r))
    (sweep / "a__decode_32k__card.trace.json").write_text("[]")
    assert len(TRF.load_records(sweep)) == len(RECORDS)
    out = tmp_path / "roofline.json"
    rows = TRF.run(dryrun=sweep, out=out)
    assert len(rows) == 6 and json.loads(out.read_text()) == rows
    table = capsys.readouterr().out.splitlines()
    assert table[0].split()[:4] == ["arch", "shape", "mesh", "compute"]
    assert len(table) == 7
    # the JAX report's terms over the same records
    assert {(r["arch"], r["shape"], r["bound_step_s"]) for r in rows} == {
        (r["arch"], r["shape"], r["bound_step_s"])
        for r in _jax_rows(RECORDS)}


def test_main_prints_the_picks(tmp_path, capsys):
    sweep = tmp_path / "sweep"
    sweep.mkdir()
    for r in RECORDS:
        (sweep / f"{r['arch']}__{r['shape']}__card.json").write_text(
            json.dumps(r))
    TRF.main(["--dir", str(sweep)])
    out = capsys.readouterr().out
    assert "hillclimb picks:" in out
    assert "serving_representative: b x decode_32k" in out
    assert (tmp_path / "roofline_torch.json").exists()
