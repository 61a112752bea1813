"""The SASS walks of ``tools/kernel_census.py`` on small hand-written
listings: which registers an instruction writes and reads, the sLSTM
kernel's dependent path from one token step's ``h`` to the next, and the
choice of its steady loop.  (The census itself compiles on a machine with
``nvcc``; these walks are plain Python.)"""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "tools"))
import kernel_census as kc  # noqa: E402

LAT = {"FP32": 4.0, "EX2": 18.0, "LG2": 20.0, "RCP": 16.0, "MUFU": 20.0}


def _code(text):
    """``[(address, instruction)]`` from ``/*addr*/ INSTR ;`` lines."""
    out = []
    for line in text.strip().splitlines():
        m = kc._LINE.search(line)
        out.append((int(m.group(1), 16), m.group(2)))
    return out


# Two token steps of a toy cell: h -> f (FFMA) -> ex2 -> add -> lg2 ->
# predicated add -> product = h, with a load and a store between.
STEPS = _code("""
/*0100*/ FFMA R9, R4, R13, R9 ;
/*0110*/ MUFU.EX2 R10, -|R9| ;
/*0120*/ FADD R11, R10, 1 ;
/*0130*/ FSETP.GEU.AND P0, PT, R10, 0.03125, PT ;
/*0140*/ MUFU.LG2 R12, R11 ;
/*0150*/ FFMA R14, R10, 0.5, R3 ;
/*0160*/ @!P0 FADD R14, R3, -R12 ;
/*0170*/ FMUL R13, R14, R5 ;
/*0180*/ STG.E desc[UR4][R2.64], R13 ;
/*0190*/ LDG.E.CONSTANT R4, desc[UR4][R6.64+0x100] ;
/*01a0*/ FFMA R9, R4, R13, R9 ;
/*01b0*/ MUFU.EX2 R10, -|R9| ;
/*01c0*/ FADD R11, R10, 1 ;
/*01d0*/ FSETP.GEU.AND P0, PT, R10, 0.03125, PT ;
/*01e0*/ MUFU.LG2 R12, R11 ;
/*01f0*/ FFMA R14, R10, 0.5, R3 ;
/*0200*/ @!P0 FADD R14, R3, -R12 ;
/*0210*/ FMUL R13, R14, R5 ;
/*0220*/ STG.E desc[UR4][R2.64+0x4], R13 ;
""")


@pytest.mark.parametrize("ins,defs,uses", [
    ("FFMA R9, R4.reuse, R13, R9", {"R9"}, {"R4", "R13", "R9"}),
    ("MUFU.EX2 R10, -|R9|", {"R10"}, {"R9"}),
    ("FSETP.GEU.AND P0, PT, R10, 0.03125, PT", {"P0"}, {"R10"}),
    ("@!P0 FADD R14, R3, -R12", {"R14"}, {"R14", "R3", "R12", "P0"}),
    ("STG.E desc[UR4][R2.64+0x4], R13", set(), {"UR4", "R2", "R13"}),
    ("FSEL R5, R7, 1, P1", {"R5"}, {"R7", "P1"}),
    ("LDG.E.CONSTANT R4, desc[UR4][R6.64+0x100]", {"R4"}, {"UR4", "R6"}),
])
def test_defs_and_uses(ins, defs, uses):
    assert kc.defs_uses(ins) == (defs, uses)


def test_h_chain_follows_the_longest_dependent_path():
    """From the FMUL that makes the first h to the one that makes the
    next: FFMA, EX2, FADD, LG2, the predicated FADD (which also reads the
    series' FFMA, a shorter branch), FMUL."""
    got = kc.h_chain(STEPS)
    assert got["path"] == ["FFMA", "MUFU.EX2", "FADD", "MUFU.LG2", "FADD",
                           "FMUL"]
    assert (got["ops"], got["sfu"], got["cycles"]) == (6, 2, 6.0)
    timed = kc.h_chain(STEPS, LAT)
    assert timed["cycles"] == 4 + 18 + 4 + 20 + 4 + 4
    assert timed["path"] == got["path"]


def test_h_chain_ignores_values_not_from_h():
    """An instruction whose sources do not descend from h breaks the
    chain through the register it overwrites."""
    code = _code("""
/*0000*/ FMUL R1, R2, R3 ;
/*0010*/ STG.E desc[UR4][R8.64], R1 ;
/*0020*/ MOV R1, 0x3f800000 ;
/*0030*/ FADD R5, R1, R1 ;
/*0040*/ FADD R6, R1, R5 ;
/*0050*/ FMUL R1, R6, R2 ;
/*0060*/ STG.E desc[UR4][R8.64+0x4], R1 ;
""")
    assert kc.h_chain(code) == {}


def test_steady_loop_takes_the_loop_without_tests():
    """Of two loops with the same token steps, the one with fewer
    branches (the untested steady loop); per-step counts divide by the
    stores."""
    tested = [(0x300 + 16 * i, s) for i, (_, s) in enumerate(STEPS)]
    tested.insert(4, (0x338, "@P1 BRA 0x400"))
    steady = STEPS + [(0x230, "@P2 BRA 0x100")]
    tested.append((0x3f8, "@P3 BRA 0x300"))
    code = sorted(steady + tested)
    body = kc.steady_loop(code)
    assert body[0][0] == 0x100 and body[-1][0] == 0x230
    counts = kc.counts(body)
    assert counts["store"] == 2 and counts["conv_mufu"] == 4
