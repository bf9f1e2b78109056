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


def test_lines_the_launch_decides(smoke, monkeypatch):
    """``sass_under``: the branches on lines a launch decides take their
    longer side, each launch its own lines; with ``loop`` False the path is
    the whole run of a warp that takes no backward branch."""
    data = {**SOURCE, 3: "      if (key[j] > best) best = key[j];"}
    monkeypatch.setattr(smoke, "DISASM", [
        (LOOP, lambda w: data[w[1]] if w[0].endswith("demo.cu") else "")])
    p = smoke.sass_under("demo", smoke.NO_LINE)
    assert (p.pro, p.body, p.epi) == (2, 4, 2)
    p = smoke.sass_under("demo", r"key\[j\] > best")
    assert (p.pro, p.body, p.epi) == (2, 7, 2)
    # past the early return, the loop's body once, the store and EXIT
    p = smoke.sass_under("demo", r"b >= B|key\[j\] > best", loop=False)
    assert (p.pro, p.body, p.epi, p.static_body) == (11, 0, 0, 8)
    # the early return is a data branch: its shorter side
    assert smoke.sass_under("demo", smoke.NO_LINE, loop=False).pro == 2


def test_bound_of_warps_on_different_paths(smoke, monkeypatch):
    """``warps_bound_ms``: the instructions and the integer-pipe ones summed
    over every kind of warp, the larger of all and twice the integer ones;
    one kind of warp gives ``pipe_bound_ms``."""
    int_heavy = ["IADD3 R1, R1, 0x1, RZ", "LOP3.LUT R2, R2, R1, RZ, 0x3c, !PT",
                 "SHF.L.W.U32.HI R3, R2, 0xd, R2"]
    fma_heavy = ["IMAD R1, R1, R1, RZ", "IMAD.IADD R2, R1, 0x1, R2", "FFMA R3, R3, R3, R3",
                 "IMAD.MOV.U32 R4, RZ, RZ, R3", "IADD3 R5, R4, R1, RZ"]
    (a_name, a), = smoke.parse_nvdisasm(listing(int_heavy), lambda w: "").items()
    (_, b), = smoke.parse_nvdisasm(listing(fma_heavy), lambda w: "").items()
    monkeypatch.setattr(smoke, "SASS", {a_name: a})
    monkeypatch.setattr(smoke, "SM_CLOCK_HZ", 1.98e9)
    per_clock = 132 * 4 * 1.98e9
    assert smoke.warps_bound_ms([(512, a, 9)]) == pytest.approx(
        smoke.pipe_bound_ms("pipe", 512, 9), rel=1e-12)
    n = lambda p, t: p.pro + p.body * t + p.epi
    for wa, wb in ((512, 64), (64, 512)):
        issued, integer = wa * n(a, 9) + wb * n(b, 9), wa * a.on_pipe("int", 9) + wb * b.on_pipe("int", 9)
        assert smoke.warps_bound_ms([(wa, a, 9), (wb, b, 9)]) == pytest.approx(
            max(issued, 2 * integer) / per_clock * 1e3, rel=1e-12)
    # the integer-heavy warps alone are bound by their pipe, the mix by issue
    assert 2 * a.on_pipe("int", 9) > n(a, 9)
    assert 2 * (64 * a.on_pipe("int", 9) + 512 * b.on_pipe("int", 9)) < 64 * n(a, 9) + 512 * n(b, 9)


def listing(body):
    """A canned ``nvdisasm -g`` listing of a kernel whose one loop issues ``body``."""
    ins = ["S2R R0, SR_TID.X"] + [".L_x_0:"] + body + ["@!P0 BRA `(.L_x_0)",
                                                        "STG.E desc[UR4][R4.64], R2", "EXIT"]
    out, addr = ["        .section        .text._Z4pipePiii,\"ax\",@progbits",
                 ".text._Z4pipePiii:", '        //## File "/src/pipe.cu", line 1'], 0
    for op in ins:
        if op.endswith(":"):
            out.append(op)
            continue
        out.append(f"        /*{addr:04x}*/                   {op} ;")
        addr += 16
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("body,pipes,binds", [
    # integer-heavy: the step's compares, selects and bit logic
    (["IADD3 R1, R1, 0x1, RZ", "LOP3.LUT R2, R2, R1, RZ, 0x3c, !PT",
      "ISETP.NE.AND P1, PT, R2, RZ, PT", "@P1 SEL R3, R3, R2, P1",
      "SHF.R.U32.HI R4, RZ, 0x10, R3", "PRMT R5, R4, 0xbb99, RZ", "IMNMX R6, R5, R4, PT"],
     (7, 0, 0, 1), "int"),
    # IMAD-heavy: Philox's products and the moves and adds the compiler puts on the FMA pipe
    (["IMAD R1, R1, R1, RZ", "IMAD.WIDE.U32 R2, R1, 0x3, RZ", "IMAD.HI.U32 R4, R1, R3, RZ",
      "IMAD.MOV.U32 R5, RZ, RZ, R4", "IADD3 R6, R5, R4, RZ"],
     (1, 4, 0, 1), "all"),
    # mixed, with a load, a uniform add and a predicated move: 8 clocks of the
    # integer pipe a trip under its 9 issue slots
    (["IADD3 R1, R1, 0x1, RZ", "IMAD R2, R1, R1, RZ", "LOP3.LUT R3, R2, R1, RZ, 0x3c, !PT",
      "LDG.E R7, desc[UR4][R8.64]", "UIADD3 UR4, UR4, 0x1, URZ", "@!P2 MOV R9, R7",
      "IMAD.SHL.U32 R10, R9, 0x2, RZ", "ISETP.GE.AND P2, PT, R10, R3, PT"],
     (4, 2, 1, 2), "all"),
])
def test_path_by_pipe_and_two_rate_bound(smoke, monkeypatch, body, pipes, binds):
    (name, p), = smoke.parse_nvdisasm(listing(body), lambda w: "").items()
    assert (p.pro, p.body, p.epi) == (1, len(body) + 1, 2)
    trip = tuple(p.pipes[k][1] for k in smoke.PIPES)
    assert trip == pipes and sum(trip) == p.body
    # before the loop S2R (other); after it STG (memory) and EXIT (other)
    assert {k: (p.pipes[k][0], p.pipes[k][2]) for k in smoke.PIPES} == {
        "int": (0, 0), "fma": (0, 0), "mem": (0, 1), "other": (1, 1)}
    monkeypatch.setattr(smoke, "SASS", {name: p})
    monkeypatch.setattr(smoke, "SM_CLOCK_HZ", 1.98e9)
    warps, trips = 512, 75
    n_all, n_int = 1 + p.body * trips + 2, p.on_pipe("int", trips)
    assert n_int == pipes[0] * trips
    per_clock = 132 * 4 * 1.98e9
    one = smoke.instruction_bound_ms("pipe", warps, trips)
    two = smoke.pipe_bound_ms("pipe", warps, trips)
    assert one == pytest.approx(warps * n_all / per_clock * 1e3, rel=1e-12)
    assert two == pytest.approx(warps * max(n_all, 2 * n_int) / per_clock * 1e3, rel=1e-12)
    assert (two > one) if binds == "int" else (two == one)
    # a share over 100% of the two-rate bound is not published
    assert "not published" in smoke.shares("pipe", warps, trips, 0.5 * two)
    assert f"{0.5:.1%} of its two-rate" in smoke.shares("pipe", warps, trips, 2 * two)


@pytest.mark.parametrize("op,pipe", [
    ("IADD3.X R1, R1, RZ, RZ, P0, !PT", "int"), ("IMAD.IADD R1, R1, 0x1, R2", "fma"),
    ("SHFL.BFLY PT, R1, R2, 0x1, 0x1f", "mem"), ("ULDC.64 UR4, c[0x0][0x118]", "other"),
    ("BRA `(.L_x_1)", "other"), ("VIMNMX R1, R2, R3, PT", "int"), ("LDS.U16 R1, [R2]", "mem"),
    ("VIADD R0, R26, 0xffffffff", "fma"), ("VIADDMNMX R29, R29, R18, RZ, !PT", "int"),
])
def test_pipe_classes(smoke, op, pipe):
    assert smoke.pipe_of(op) == pipe


def test_ring_of_loads_ahead_is_left_out_of_the_bounds(smoke, monkeypatch):
    """The moves, compare and index of an actions kernel's ring of actions
    loaded ahead (``AHEAD`` lines) are counted apart and left out of both
    bounds; the ring's load stays in. The bounds equal those of the same loop
    without the ring's other instructions."""
    step = ["IADD3 R1, R1, 0x1, RZ", "LOP3.LUT R2, R2, R1, RZ, 0x3c, !PT", "IMAD R3, R2, R2, RZ"]
    ring = ["MOV R7, R8", "ISETP.GE.AND P1, PT, R9, R10, PT", "IADD3 R9, R9, 0x1, RZ",
            "@!P1 LDG.E.CONSTANT R8, desc[UR4][R12.64]"]
    text = listing(step + ring).replace(
        f"/*{16 * (1 + len(step)):04x}*/",
        '//## File "/src/pipe.cu", line 2\n        ' f"/*{16 * (1 + len(step)):04x}*/").replace(
        f"/*{16 * (1 + len(step + ring)):04x}*/",
        '//## File "/src/pipe.cu", line 1\n        ' f"/*{16 * (1 + len(step + ring)):04x}*/")
    source = {1: "      reward[at] = slot_step(s, action, cfg, d);",
              2: "      ring[CW_SLOT_AHEAD - 1] = ahead < T ? __ldg(actions + at) : 0;"}
    (name, p), = smoke.parse_nvdisasm(text, lambda w: source[w[1]]).items()
    assert p.body == len(step + ring) + 1
    assert p.pipes["ahead"] == (0, 3, 0) and p.pipes["ahead_int"] == (0, 3, 0)
    (bare_name, bare), = smoke.parse_nvdisasm(listing(step + ring[3:]), lambda w: "").items()
    monkeypatch.setattr(smoke, "SM_CLOCK_HZ", 1.98e9)
    warps, trips = 512, 256
    bounds = []
    for sass in ({name: p}, {bare_name: bare}):
        monkeypatch.setattr(smoke, "SASS", sass)
        bounds.append((smoke.instruction_bound_ms("pipe", warps, trips),
                       smoke.pipe_bound_ms("pipe", warps, trips)))
    assert bounds[0] == pytest.approx(bounds[1], rel=1e-12)
    # the kernel's own path is still what the two-rate count would give unmasked
    assert bounds[0][1] < warps * 2 * p.on_pipe("int", trips) / (132 * 4 * 1.98e9) * 1e3
