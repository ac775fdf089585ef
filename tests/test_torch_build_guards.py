"""The build report's guards (`_build.build_guards`, which
`chip_smoke.py` fails the run on), on `-Xptxas -v` logs written here in
ptxas's own format: a note that ptxas serialised a flash instance's
`wgmma`s is a failure, and so is a dh = 256 instance of the decode kernel
or a panel-route kernel of the fused retrieve that spills; other
instances' spills are not, and every flash, dh = 256 decode and
panel-route instance's registers are reported."""
import pytest

from repro_torch.kernels import _build

FLASH_128 = ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_23f0aea72tc15"
             "flash_tc_kernelILi128ELi128EEEv14CUtensorMap_stS2_S2_P13__nv_"
             "bfloat16iiiifiiiiiPi")
FLASH_F32 = ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_23f0aea712"
             "flash_kernelIfLi256ELi256EEEvPKT_S3_S3_PS1_iiiifii")
DECODE_256_MMA = ("_ZN52_GLOBAL__N__408c5d7c_19_decode_attention_cu_3848999b"
                  "13decode_kernelI13__nv_bfloat16fLi256ELi8ELb1EEEvPKT_PKT0"
                  "_S7_PKiPS2_PfSB_Pjiiiiiif")
DECODE_256_CORES = ("_ZN52_GLOBAL__N__408c5d7c_19_decode_attention_cu_3848999"
                    "b13decode_kernelIffLi256ELi8ELb0EEEvPKT_PKT0_S6_PKiPS1_"
                    "PfSA_Pjiiiiiif")
DECODE_128 = ("_ZN52_GLOBAL__N__408c5d7c_19_decode_attention_cu_3848999b13"
              "decode_kernelI13__nv_bfloat16fLi128ELi8ELb1EEEvPKT_PKT0_S7_"
              "PKiPS2_PfSB_Pjiiiiiif")
SELECT = ("_ZN49_GLOBAL__N__7c0f1e2a_16_retrieve_topn_cu_5d2a8b1c18topn_"
          "select_kernelEPKfPKiiiiiiiPfPviiPhNS_7PayloadE")
PANEL_GEMM = ("_ZN49_GLOBAL__N__7c0f1e2a_16_retrieve_topn_cu_5d2a8b1c17panel"
              "_gemm_kernelILi128ELi16ELb1ELb1EEEvPKfS2_iiiiPKiPf")
PANEL_GEMV = ("_ZN49_GLOBAL__N__7c0f1e2a_16_retrieve_topn_cu_5d2a8b1c17panel"
              "_gemv_kernelILb1EEEvPKfS2_iiiiPKiPf")
SERIALISED = ("ptxas info    : (C7515) Potential Performance Loss: "
              "wgmma.mma_async instructions are serialized due to non wgmma "
              "instructions defining accumulator registers of a wgmma "
              "between start and end of the pipeline stage in the function "
              f"'{FLASH_128}'")


def entry(name, regs, stores=0, loads=0):
    """ptxas's lines for one entry function."""
    return (f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    {stores} bytes stack frame, {stores} bytes spill stores, "
            f"{loads} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers, 640 "
            f"bytes cmem[0]\n")


def logs(flash="", decode="", retrieve=""):
    return {"flash_attention": entry(FLASH_128, 168, 16, 16) + flash
            + entry(FLASH_F32, 128),
            "decode_attention": entry(DECODE_256_MMA, 127)
            + entry(DECODE_256_CORES, 168) + entry(DECODE_128, 96)
            + decode,
            "retrieve_topn": entry(SELECT, 40) + entry(PANEL_GEMM, 122)
            + entry(PANEL_GEMV, 40) + retrieve}


def test_ptxas_entries_reads_each_entry():
    got = _build.ptxas_entries(entry(DECODE_256_CORES, 168, 64, 88)
                           + entry(DECODE_128, 96))
    assert got[DECODE_256_CORES]["registers"] == 168
    assert (got[DECODE_256_CORES]["spill_stores"],
            got[DECODE_256_CORES]["spill_loads"]) == (64, 88)
    assert got[DECODE_128]["registers"] == 96
    assert got[DECODE_128]["spill_stores"] == 0


@pytest.mark.parametrize("name,dh256", [(DECODE_256_MMA, True),
                                        (DECODE_256_CORES, True),
                                        (DECODE_128, False),
                                        (FLASH_128, False)])
def test_decode256_picks_the_dh256_decode_instances(name, dh256):
    assert _build.decode256(name) is dh256


def test_clean_logs_pass_and_report_every_guarded_instance():
    failures, regs = _build.build_guards(logs())
    assert failures == []
    # the flash instances (the producer's 16 spilled bytes are not
    # guarded), the dh = 256 decode ones, not dh = 128, and every kernel
    # of the retrieve
    assert set(regs) == {FLASH_128, FLASH_F32, DECODE_256_MMA,
                         DECODE_256_CORES, SELECT, PANEL_GEMM, PANEL_GEMV}
    assert regs[FLASH_128] == (168, 16, 16)
    assert regs[DECODE_256_MMA] == (127, 0, 0)


def test_serialised_wgmma_fails_the_flash_build():
    failures, _ = _build.build_guards(logs(flash=SERIALISED + "\n"))
    assert len(failures) == 1 and _build.WGMMA_SERIALISED in failures[0]


@pytest.mark.parametrize("stores,loads", [(232, 256), (0, 4), (8, 0)])
def test_a_dh256_decode_spill_fails_the_build(stores, loads):
    log = logs()
    log["decode_attention"] = (entry(DECODE_256_MMA, 168, stores, loads)
                               + entry(DECODE_128, 96))
    failures, regs = _build.build_guards(log)
    assert len(failures) == 1 and "decode" in failures[0]
    assert regs[DECODE_256_MMA] == (168, stores, loads)


def test_a_dh128_decode_spill_is_not_guarded():
    log = logs(decode=entry(DECODE_128.replace("Li8E", "Li4E"), 168, 40,
                            40))
    assert _build.build_guards(log)[0] == []


@pytest.mark.parametrize("name", [SELECT, PANEL_GEMM, PANEL_GEMV])
def test_a_panel_route_spill_fails_the_build(name):
    """A spill in any retrieve kernel fails the build, and only that
    kernel is named."""
    log = logs()
    log["retrieve_topn"] = entry(name, 64, 24, 24) + "".join(
        entry(x, 64) for x in (SELECT, PANEL_GEMM, PANEL_GEMV) if x != name)
    failures, regs = _build.build_guards(log)
    assert len(failures) == 1 and "retrieve" in failures[0]
    assert name in failures[0]
    assert regs[name] == (64, 24, 24)
