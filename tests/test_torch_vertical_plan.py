"""The banded vertical scan's launch plan (``banded_cuda.vertical_plan``),
pure Python, at the H100's 132 SMs and 232,448 bytes of opt-in shared
memory a block and at a smaller card's: every column is covered exactly
once, the shared memory fits, a cluster has at most 16 blocks and divides
the grid, and every width is taken. The same for the exact vertical scan's
register form (``sgm_cuda.register_plan``) at the clusters and warps an
H100 reports. The kernels that follow the plans are held to their plain
forms on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from stereo_vision_tpu_torch.stereo import banded_cuda, sgm_cuda
from stereo_vision_tpu_torch.stereo.banded_cuda import diag_max_threads, vertical_plan

CARDS = {"H100": (132, 232_448), "smaller": (46, 101_376)}
WIDTHS = (1, 31, 33, 1152, 4097, 8192, 65536)


def _covered(plan, P, Wv):
    """How many times each column is walked under the plan."""
    hits = np.zeros(Wv, dtype=np.int64)
    gx = plan["grid"][0]
    if plan["form"] == "ring":
        cpt, nt = plan["cols_per_thread"], plan["threads"]
        for t in range(gx * nt):
            hits[t * cpt: min(t * cpt + cpt, Wv)] += 1
    elif plan["form"] == "cluster":  # block `rank` stores its own SW columns (its halo threads store none)
        sw = plan["cols_per_block"]
        assert plan["threads"] == sw + (2 * banded_cuda.DIAG_HALO if plan["cluster"] > 1 else 0)
        for rank in range(plan["cluster"]):
            hits[rank * sw: (rank + 1) * sw] += 1
    elif plan["form"] == "group":  # block g walks chains (direction, frame, column) g * n .. g * n + n - 1
        n, chains = plan["cols_per_block"], 2 * P * Wv
        walked = np.zeros(chains, dtype=np.int64)
        for g in range(gx):
            walked[g * n: min(g * n + n, chains)] += 1
        assert (gx - 1) * n < chains
        hits += walked.reshape(2 * P, Wv).min(axis=0)
    else:  # strips: each of a chain's block's threads walks t, t + NT, ...
        for t in range(plan["threads"]):
            hits[t::plan["threads"]] += 1
    return hits


@pytest.mark.parametrize("card", list(CARDS))
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("K,dtype", [(4, torch.int16), (8, torch.int16), (12, torch.int32), (16, torch.int16),
                                     (32, torch.int16), (64, torch.int32)])
def test_plan_covers_every_column_once_within_the_card(card, diag, K, dtype):
    sm_count, optin = CARDS[card]
    for P in (1, 8, 32):
        for Wv in WIDTHS:
            plan = vertical_plan(P, 11, Wv, K, dtype, diag, sm_count=sm_count, smem_optin=optin)
            assert plan["form"] in (("cluster", "strips") if diag else ("ring", "group")), plan
            assert (_covered(plan, P, Wv) == 1).all(), (P, Wv, plan)
            assert plan["smem_bytes"] <= optin and plan["device_launches"] == 1
            assert plan["grid"][1:] == {"strips": (2, 1), "group": (1, 1)}.get(plan["form"], (P, 2))
            if plan["form"] == "group":
                kp = 1 << (K - 1).bit_length()
                assert kp >= 16 and plan["cols_per_block"] * min(32, kp) == banded_cuda.GROUP_THREADS
            elif plan["form"] == "ring":
                assert plan["ring"] in banded_cuda.RING_DEPTHS and plan["threads"] in banded_cuda.RING_THREADS
                assert plan["cols_per_block"] == plan["threads"] * plan["cols_per_thread"]
            elif plan["form"] == "cluster":
                cs = plan["cluster"]
                assert 1 <= cs <= 16 and plan["grid"][0] % cs == 0 and plan["ring"] in banded_cuda.RING_DEPTHS
                assert plan["threads"] % 32 == 0 and plan["threads"] <= diag_max_threads(K)
            else:
                elem = 2 if dtype == torch.int16 else 4
                assert plan["scratch_bytes"] == 12 * P * Wv * K * elem and plan["threads"] <= 256


def test_main_path_plans_fill_the_card():
    """hier4x8's 64 chains take clusters over at least 128 SMs; every level
    of hier4x3 and hier16x3 spreads its ring blocks over the SMs with ~32 KB
    of reads in flight an SM where the grid gives it the threads."""
    sm, optin = CARDS["H100"]
    p = vertical_plan(32, 720, 1152, 4, torch.int16, True, sm_count=sm, smem_optin=optin)
    assert p["form"] == "cluster" and 64 * p["cluster"] >= 128 and p["cols_per_block"] * p["cluster"] >= 1152
    p = vertical_plan(8, 180, 288, 32, torch.int16, False, sm_count=sm, smem_optin=optin)
    assert p["form"] == "group"  # hier16x3's coarse level: 4608 chains, too few for a thread each
    for P, H, Wv, K in ((32, 720, 1152, 4), (32, 360, 576, 8), (32, 180, 288, 32), (8, 720, 1152, 16)):
        p = vertical_plan(P, H, Wv, K, torch.int16, False, sm_count=sm, smem_optin=optin)
        blocks = p["grid"][0] * P * 2
        assert p["form"] == "ring" and blocks >= min(sm, 2 * P * -(-Wv // p["cols_per_block"]))
        per_sm = -(-blocks // sm) * p["threads"]
        read = p["cols_per_thread"] * (K * 2 + 4)  # a thread's bytes a row
        assert p["ring"] == 16 or per_sm * read * p["ring"] >= banded_cuda.IN_FLIGHT


def test_plan_follows_the_clusters_the_card_holds():
    """The occupancy answer decides: none held -> the strips form; only
    small clusters held -> a small cluster."""
    sm, optin = CARDS["H100"]
    none = vertical_plan(32, 720, 1152, 4, torch.int16, True, sm_count=sm, smem_optin=optin,
                         active_clusters=lambda cs, nt, s: 0)
    assert none["form"] == "strips"
    small = vertical_plan(32, 720, 1152, 4, torch.int16, True, sm_count=sm, smem_optin=optin,
                          active_clusters=lambda cs, nt, s: 66 if cs <= 2 else 0)
    assert small["form"] == "cluster" and small["cluster"] == 2
    wide = vertical_plan(2, 9, 65536, 4, torch.int16, True, sm_count=sm, smem_optin=optin)
    assert wide["form"] == "strips" and wide["cols_per_block"] == 65536


def test_plan_refuses_what_the_kernels_do_not_store():
    with pytest.raises(TypeError):
        vertical_plan(1, 1, 8, 4, torch.float32, False, sm_count=132, smem_optin=232_448)
    # A band off K % 4 == 0 is planned at its memory stride (K = 6: 8 lanes a column).
    six = vertical_plan(1, 1, 8, 6, torch.int16, False, sm_count=132, smem_optin=232_448)
    assert six["form"] == "ring" and six["smem_bytes"] == six["ring"] * six["threads"] * (16 + 4)
    with pytest.raises(ValueError):
        vertical_plan(1, 1, 8, 0, torch.int16, False, sm_count=132, smem_optin=232_448)
    assert vertical_plan(1, 1, 8, 68, torch.int16, True, sm_count=132, smem_optin=232_448)["form"] == "wide"


# The exact vertical scan's register form (#2, ``sgm_cuda.register_plan``):
# clusters resident at one block an SM as an H100's occupancy calculator
# answers them (132 SMs: 7 clusters of 16, 15 of 8, 17 of 6), and a smaller
# card of 46 SMs in four GPCs; warps a block as the H100's builds allow
# them (by words a lane: 16 warps, 12 at the widest columns, none where a
# build spills).
REG_ACTIVE_H100 = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9, 10: 7, 11: 7, 12: 7, 13: 7, 14: 7,
                   15: 7, 16: 7}
REG_CARDS = {"H100": (132, lambda cs, nw, cpw: REG_ACTIVE_H100[cs]),
             "smaller": (46, lambda cs, nw, cpw: sum(g // cs for g in (12, 12, 12, 10)))}
REG_WARPS = {1: lambda cpw: 16, 2: lambda cpw: 16 if cpw <= 12 else 12,
             4: lambda cpw: 16 if cpw <= 5 else 0 if cpw == 6 else 12}


def _register_plan(card, B, W, D):
    return sgm_cuda.register_plan(B, W, D, active_clusters=REG_CARDS[card][1], max_warps=REG_WARPS[D // 64])


@pytest.mark.parametrize("card", list(REG_CARDS))
@pytest.mark.parametrize("D", [64, 128, 256])
def test_register_plan_covers_every_column_once_within_the_card(card, D):
    sms, active = REG_CARDS[card]
    widest = max(REG_WARPS[D // 64](c) * c for c in sgm_cuda.REGISTER_COLUMNS[D // 64])  # columns a block, at most
    largest = max(cs for cs in range(1, 17) if active(cs, 1, 1) >= 1)  # blocks a cluster the card holds
    for B in (1, 2, 4, 8, 16, 32):
        for W in (1, 2, 31, 33, 300, 1151, 1152, 1153, 3072):
            p = _register_plan(card, B, W, D)
            if p is None:  # only where no cluster the card holds covers W in registers
                assert W > largest * widest
                continue
            cs, nw, cpw = p["cluster"], p["warps"], p["cols_per_warp"]
            assert p["form"] == "registers" and p["device_launches"] == 1 and p["scratch_bytes"] == 0
            assert 1 <= cs <= 16 and cpw in sgm_cuda.REGISTER_COLUMNS[D // 64] and 1 <= nw <= REG_WARPS[D // 64](cpw)
            assert p["columns"] == nw * cpw and cs * nw * cpw >= W > (cs - 1) * nw * cpw  # no block without columns
            warps_with_columns = -(-W // cpw)  # warp g owns columns g * cpw .. g * cpw + cpw - 1
            assert (warps_with_columns - 1) * cpw < W <= warps_with_columns * cpw <= cs * nw * cpw
            assert p["active_clusters"] == active(cs, nw, cpw) >= 1
            assert p["waves"] == -(-2 * B // p["active_clusters"]) and p["sms"] == min(2 * B, p["active_clusters"]) * cs
            assert p["sms"] <= sms
    # Wider than the largest cluster of the widest blocks holds: no register plan (the cluster kernel takes it).
    assert _register_plan(card, 1, largest * widest + 1, D) is None
    assert _register_plan(card, 1, largest * widest, D) is not None


def test_register_plan_at_the_exact_paths_shape():
    """720 x 1152 x 128 on the H100: 8 frames (the benchmark's windows) in one
    wave of 16 clusters of 6 over 96 SMs, 12 columns a warp; 4 frames in
    clusters of 9 (8 resident, 72 SMs); 1 frame over 30 SMs at 5 columns a
    warp; 16 frames in two waves of clusters of 6 (the splits the card timed
    fastest, PERF.md)."""
    expect = {1: (15, 16, 5, 1, 30), 4: (9, 16, 8, 1, 72), 8: (6, 16, 12, 1, 96), 16: (6, 16, 12, 2, 102)}
    for B, (cs, nw, cpw, waves, sms) in expect.items():
        p = _register_plan("H100", B, 1152, 128)
        assert (p["cluster"], p["warps"], p["cols_per_warp"], p["waves"], p["sms"]) == (cs, nw, cpw, waves, sms), B


def test_register_form_applies_to_the_packed_step_with_diagonals():
    for D, words in ((64, 1), (128, 2), (256, 4)):
        assert sgm_cuda.packed_words(D, torch.int16, True, 200) == words
        assert sgm_cuda.packed_words(D, torch.int16, True, 0x7FFF) == words
        assert sgm_cuda.packed_words(D, torch.int16, True, 0x8000) == 0
        assert sgm_cuda.packed_words(D, torch.int16, False, 200) == 0
        assert sgm_cuda.packed_words(D, torch.int32, True, 200) == 0
    for D in (16, 32, 96, 100, 200, 512, 1000):
        assert sgm_cuda.packed_words(D, torch.int16, True, 200) == 0
