"""`frankenz_tpu_torch.tools.sweep_stats` on the CPU: the SASS rule that
finds `scale_sweeps`' list iteration (on cuobjdump-shaped text), the
statistics of the -DFZ_REST counts, the issue floor and the table
comparison.  No card, no `nvcc`, no JAX."""

import pytest
import torch

from frankenz_tpu_torch.tools import sweep_stats as SS

INST = "ILb1ELb1ELb1ELi5EE"


def _sass(blocks, inst=INST):
    """cuobjdump-shaped text of one function: `blocks` is a list of
    (label or None, [instruction, ...]); addresses advance by 0x10."""
    lines = ["\tcode for sm_90a", f"\t\tFunction : _Z19scale_sweeps_kernel{inst}"
             "PKfS1_", "\t.headerflags @\"EF_CUDA_SM90\""]
    addr = 0
    for label, insns in blocks:
        if label:
            lines.append(f"{label}:")
        for text in insns:
            lines.append(f"        /*{addr:04x}*/                   {text} ;"
                         "   /* 0x000fe20000000f00 */")
            addr += 0x10
    return "\n".join(lines) + "\n"


def _body(nrcp, lds16=True, nlg2=0):
    return ((["LDS.U16 R2, [R3]"] if lds16 else [])
            + ["MUFU.RCP R4, R5"] * nrcp + ["MUFU.LG2 R6, R7"] * nlg2
            + ["FFMA R8, R4, R5, R6"] * 3)


def test_parse_sass_loop_takes_the_innermost_list_loop():
    """An enclosing loop with more divides around the list loop: the rule
    counts the list loop, head to backward branch, both ends included."""
    inner = _body(6, nlg2=2) + ["@P0 BRA `(.L_x_2)"]
    text = _sass([(None, ["MOV R1, c[0x0][0x28]"]),
                  (".L_x_1", _body(6)),
                  (".L_x_2", inner),
                  (None, ["@P1 BRA `(.L_x_1)", "EXIT"])])
    got = SS.parse_sass_loop(text, INST, 6)
    assert got == {"instructions": len(inner), "mufu_rcp": 6, "mufu_lg2": 2,
                   "function": f"_Z19scale_sweeps_kernel{INST}PKfS1_"}


def test_parse_sass_loop_reads_hex_branch_targets():
    """A backward branch written as an address, not a label."""
    loop = _body(6) + ["@!P2 BRA 0x10"]
    text = _sass([(None, ["MOV R1, c[0x0][0x28]"]), (None, loop)])
    assert SS.parse_sass_loop(text, INST, 6)["instructions"] == len(loop)


@pytest.mark.parametrize("blocks,inst,why", [
    # The shortest loop holds 7 reciprocals: an enclosing loop, refused.
    ([(".L_x_1", _body(7) + ["@P0 BRA `(.L_x_1)"])], INST, "MUFU.RCP"),
    # No 16-bit shared load: not the list loop.
    ([(".L_x_1", _body(6, lds16=False) + ["@P0 BRA `(.L_x_1)"])], INST,
     "no list loop"),
    # Too few reciprocals.
    ([(".L_x_1", _body(5) + ["@P0 BRA `(.L_x_1)"])], INST, "no list loop"),
    # A forward branch only.
    ([(None, _body(6) + ["@P0 BRA `(.L_x_9)"]), (".L_x_9", ["EXIT"])],
     INST, "no list loop"),
    # Another instantiation.
    ([(".L_x_1", _body(6) + ["@P0 BRA `(.L_x_1)"])], "ILb0ELb1ELb1ELi5EE",
     "no scale_sweeps_kernel"),
])
def test_parse_sass_loop_refuses_what_is_not_the_list_loop(blocks, inst,
                                                          why):
    got = SS.parse_sass_loop(_sass(blocks, inst), INST, 6)
    assert "instructions" not in got and why in got["error"]


def _counts(live, gone, cyc, hist, chunks=(0, 0, 0), rows=0, pairs=0):
    cnt = [0] * SS.REST_WORDS
    for it, (v, g, c) in enumerate(zip(live, gone, cyc), start=1):
        cnt[it], cnt[128 + it], cnt[389 + it] = v, g, c
    for k, h in hist.items():
        cnt[256 + k] = h
    cnt[384:389] = [*chunks, rows, pairs]
    return cnt


def test_rest_stats_counts_the_pair_sweeps_run():
    """Two (object, group)s of 40 slots (80 pairs), one frozen at k = 2,
    one at k = 3: sweep 0 runs all 80, then the live lists (80, 50, 20);
    50 pair-sweeps left out, 10 of them as 2-cycles."""
    st = SS.rest_stats(_counts(live=[80, 50, 20], gone=[0, 30, 20],
                               cyc=[0, 4, 6], hist={2: 1, 3: 1},
                               chunks=(12, 2, 8), rows=2, pairs=80))
    assert st["pair_sweeps_after_sweep0"] == 200
    assert st["pair_sweeps_run"] == 80 + 150
    assert st["pair_sweeps_left_out"] == 50
    assert st["pair_sweeps_in_2cycles"] == 10
    assert st["pair_sweeps_at_rest"] == 40
    assert st["left_out_share"] == pytest.approx(50 / 200)
    assert st["rest_share"] == pytest.approx(40 / 200)
    assert st["rest_share_by_sweep"] == {1: 0.0, 2: 0.325, 3: 0.35}
    assert st["cycle_share_by_sweep"] == {1: 0.0, 2: 0.05, 3: 0.15}
    assert st["all_left_chunk_share"] == pytest.approx(2 / 12)
    assert st["list_iterations_per_chunk"] == pytest.approx(8 / 12)
    assert (st["k_mean"], st["k_p10"], st["k_p50"], st["k_max"]) == (
        2.5, 2, 2, 3)


def test_issue_floor_is_iterations_times_instructions_over_issue_rate():
    # 132 SMs x 4 schedulers at 1,980 MHz issue 1.04544e12 warp
    # instructions a second.
    assert SS.issue_floor(1e9, 396, 132, 1980.0) == pytest.approx(
        1e3 * 396e9 / 1.04544e12)


def test_pair_waits_reads_two_row_blocks():
    sw = torch.tensor([[3, 5], [3, 2], [4, 4], [1, 4], [7, 7]],
                      dtype=torch.int16)  # the fifth row has no partner
    got = SS.pair_waits(sw)
    # Blocks (rows 0-1, 2-3) x groups: (3, 3), (5, 2), (4, 1), (4, 4).
    assert got["blocks_with_a_waiting_row"] == pytest.approx(2 / 4)
    # |k0 - k1| summed (0 + 3 + 3 + 0) over 2 max(k0, k1) (6 + 10 + 8 + 8).
    assert got["row_sweeps_waited"] == pytest.approx(6 / 32)


def test_same_bits_holds_nan_places_and_every_other_bit():
    a = torch.tensor([1.0, float("nan"), -0.0, 3.5])
    assert SS.same_bits(a.clone(), a)
    assert not SS.same_bits(torch.tensor([1.0, float("nan"), 0.0, 3.5]), a)
    assert not SS.same_bits(torch.tensor([1.0, 2.0, -0.0, 3.5]), a)
    assert not SS.same_bits(torch.tensor([float("nan")] * 4), a)
    nudged = a.clone()
    nudged[3] = torch.nextafter(a[3], torch.tensor(4.0))
    assert not SS.same_bits(nudged, a)
    s = torch.tensor([[1, 2], [3, 4]], dtype=torch.int16)
    assert SS.same_bits(s.clone(), s) and not SS.same_bits(s + 1, s)
