"""chip_smoke.py's yardsticks of the Threefry draw, on the CPU.

``sass_counts`` reads a kernel's SASS from ``cuobjdump -sass`` (here a
listing in that format, handed over in place of the tool's output) and
counts its main loop by class, per value; ``threefry_work`` is the least
work of one value by pipe, from which ``threefry_bound_ms`` takes the
draw's bound on the card.
"""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from repro_torch.kernels import cuda_build  # noqa: E402

# a loop from 0x20 to 0xd0 holding an inner loop (0x80-0xa0), a forward
# branch, predicated instructions, the trailing self-branch and NOPs
LISTING = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_113threefry_drawILb1ELi4EEEvjjlffffPf
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
                                                                 /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;            /* 0x0000000000007919 */
        /*0020*/                   IADD3 R2, R2, 0x1bd11bda, RZ ;
        /*0030*/                   SHF.L.W.U32.HI R3, R3, 0xd, R3 ;
        /*0040*/                   LOP3.LUT R3, R3, R2, RZ, 0x3c, !PT ;
        /*0050*/              @!P0 BRA 0x70 ;
        /*0060*/                   MUFU.RCP R4, R5 ;
        /*0070*/                   IMAD.MOV.U32 R4, RZ, RZ, R5 ;
        /*0080*/                   FFMA R4, R4, R5, R6 ;
        /*0090*/                   ISETP.GE.AND P1, PT, R4, R5, PT ;
        /*00a0*/               @P1 BRA 0x80 ;
        /*00b0*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*00c0*/                   FSETP.GT.AND P0, PT, R4, R5, PT ;
        /*00d0*/              @!P0 BRA 0x20 ;
        /*00e0*/                   EXIT ;
        /*00f0*/                   BRA 0xf0;
        /*0100*/                   NOP;
\t\tFunction : _ZN12_GLOBAL__N_113threefry_drawILb0ELi4EEEvjjlffffPf
        /*0000*/                   EXIT ;
"""


@pytest.fixture
def listing(monkeypatch):
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "/cuda/bin/nvcc")
    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=LISTING)

    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    return calls


def test_sass_counts_takes_the_main_loop_by_class(listing):
    counts = chip_smoke.sass_counts("lib.so", "threefry_drawILb1ELi4E", 4)
    assert listing == [["/cuda/bin/cuobjdump", "-sass", "lib.so"]]
    # the loop 0x20-0xd0 less the inner loop 0x80-0xa0
    assert counts["loop"] == {"ALU": 3, "MUFU": 1, "FMA": 1, "mem": 1,
                              "other": 3}
    assert counts["per_value"]["ALU"] == 0.75
    assert counts["opcodes"] == {"IADD3": 1, "SHF": 1, "LOP3": 1, "BRA": 2,
                                 "MUFU": 1, "IMAD": 1, "STG": 1, "FSETP": 1}
    # the whole function: NOPs left out
    assert sum(counts["total"].values()) == 16


def test_sass_counts_wants_one_function(listing):
    with pytest.raises(chip_smoke.SmokeFailure, match="2 functions"):
        chip_smoke.sass_counts("lib.so", "threefry_drawILb", 4)


@pytest.mark.parametrize("op,cls", [
    ("IADD3.X", "ALU"), ("SHF.L.W.U32.HI", "ALU"), ("LOP3.LUT", "ALU"),
    ("PRMT", "ALU"), ("IMAD.IADD", "FMA"), ("FFMA", "FMA"), ("MUFU.RCP",
                                                             "MUFU"),
    ("LDS.U16", "mem"), ("STG.E.128", "mem"), ("FSEL", "other"),
    ("BRA", "other")])
def test_sass_classes(op, cls):
    assert chip_smoke._sass_class(op) == cls


def test_threefry_work_by_pipe():
    """The bf16 draw is the hash, a lookup and a share of a store; a
    normal adds erf_inv's float work by the shares of its sides."""
    bf16 = chip_smoke.threefry_work("bf16")
    assert (bf16["alu"], bf16["fma"], bf16["mufu"]) == (41.0, 0.0, 0.0)
    uniform = chip_smoke.threefry_work("uniform")
    assert uniform["alu"] == 42.0 and uniform["fma"] == 3.0
    rational = chip_smoke.threefry_work("normal", rational=1.0)
    cephes = chip_smoke.threefry_work("normal", rational=0.0)
    assert rational["fma"] == 3 + 2 + 23 + 14 and rational["mufu"] == 1.0
    assert cephes["fma"] == 3 + 2 + 30 + 14 and cephes["alu"] == 44.0
    clamped = chip_smoke.threefry_work("normal", 0.5, 0.01, clamp=True)
    plain = chip_smoke.threefry_work("normal", 0.5, 0.01)
    assert clamped["fma"] == plain["fma"] + 2
