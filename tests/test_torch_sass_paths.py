"""The instruction count behind chip_smoke.py's bounds of the integer kernels.

``parse_nvdisasm`` reads ``nvdisasm -g`` output (SASS with source lines) and
counts the instructions a warp issues: at a branch on a condition the launch
decides and every warp enters, the longer side; at any other branch the
shorter. The snippets below are in the tool's format; the chip run parses the
built library itself.
"""

import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses look their module up
    spec.loader.exec_module(module)
    yield module
    sys.modules.pop(spec.name, None)


# a kernel with an early return, a loop of one guarded step and one data
# branch, and a store after the loop
LOOP = """
//--------------------- .text._Z4demoPiii --------------------------
        .section        .text._Z4demoPiii,"ax",@progbits
_Z4demoPiii:
.text._Z4demoPiii:
        //## File "/src/demo.cu", line 1
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/               @P0 EXIT ;
.L_x_0:
        //## File "/src/demo.cu", line 2
        /*0020*/                   IADD3 R1, R1, 0x1, RZ ;
        //## File "/src/demo.cu", line 3
        /*0030*/               @P1 BRA `(.L_x_1) ;
        /*0040*/                   IMAD R2, R2, R2, RZ ;
        //## File "/opt/cuda/include/sm_30_intrinsics.hpp", line 9
        /*0050*/                   IMAD R2, R2, R2, RZ ;
        /*0060*/                   IMAD R2, R2, R2, RZ ;
.L_x_1:
        //## File "/src/demo.cu", line 4
        /*0070*/               @P2 BRA `(.L_x_2) ;
        /*0080*/                   IMAD R3, R3, R3, RZ ;
        /*0090*/                   NOP ;
.L_x_2:
        //## File "/src/demo.cu", line 2
        /*00a0*/              @!P3 BRA `(.L_x_0) ;
        //## File "/src/demo.cu", line 5
        /*00b0*/                   STG.E desc[UR4][R4.64], R2 ;
        /*00c0*/                   EXIT ;
.L_x_3:
        /*00d0*/                   BRA `(.L_x_3);
"""
SOURCE = {
    1: "  if (b >= B) return;",
    2: "  for (int t0 = 0; t0 < T; t0 += 4) {",
    3: "      if (t0 + j < T) acc += step(s);",
    4: "    if (x > best) best = x;",
    5: "  out[b] = acc;",
}


def line_text(where):
    return SOURCE[where[1]] if where[0].endswith("demo.cu") else ""


def test_path_takes_entered_steps_and_skips_data_branches(smoke):
    (name, p), = smoke.parse_nvdisasm(LOOP, line_text).items()
    assert name == "_Z4demoPiii"
    # 13 instructions but the NOP; the loop from 0x0020 to its branch at 0x00a0
    assert (p.static, p.static_body) == (13, 8)
    # before the loop: S2R and the EXIT's fall-through; a trip: the loop's
    # add, the entered step (branch + 3), the data branch taken past its
    # IMAD, the latch; after: the store and EXIT
    assert (p.pro, p.body, p.epi) == (2, 7, 2)


def test_branch_side_follows_the_condition(smoke):
    """The same branch, on a line the launch decides, takes the longer side;
    on a data line the shorter."""
    data = {**SOURCE, 3: "      if (key[j] > best) best = key[j];"}
    (_, p), = smoke.parse_nvdisasm(LOOP, lambda w: data[w[1]] if w[0].endswith("demo.cu") else "").items()
    assert p.body == 4
    lane = {**SOURCE, 4: "    if (lane == p) picks[p] = out[p];"}
    (_, p), = smoke.parse_nvdisasm(LOOP, lambda w: lane[w[1]] if w[0].endswith("demo.cu") else "").items()
    assert p.body == 8 == p.static_body


def test_instruction_bound_from_the_path(smoke, monkeypatch):
    (name, p), = smoke.parse_nvdisasm(LOOP, line_text).items()
    monkeypatch.setattr(smoke, "SASS", {name: p})
    monkeypatch.setattr(smoke, "SM_CLOCK_HZ", 1.98e9)
    warps, trips = 512, 64
    want = warps * (2 + 7 * trips + 2) / (132 * 4 * 1.98e9) * 1e3
    assert smoke.instruction_bound_ms("demo", warps, trips) == pytest.approx(want, rel=1e-12)


def test_a_function_without_a_loop(smoke):
    text = "\n".join(line for line in LOOP.splitlines() if "0x00a0" not in line and "/*00a0*/" not in line)
    (_, p), = smoke.parse_nvdisasm(text, line_text).items()
    # no backward branch but the trailing self-loop: the whole kernel is one
    # path, and the early return (a data branch) is its shorter side
    assert (p.static, p.static_body, p.body, p.epi) == (12, 0, 0, 0)
    assert p.pro == 2
