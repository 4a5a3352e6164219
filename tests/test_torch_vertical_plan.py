"""The banded vertical scan's launch plan (``banded_cuda.vertical_plan``),
pure Python, at the H100's 132 SMs and 232,448 bytes of opt-in shared
memory a block and at a smaller card's: every column is covered exactly
once, the shared memory fits, a cluster has at most 16 blocks and divides
the grid, and every width is taken. The kernels that follow the plan are
held to their plain forms on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from stereo_vision_tpu_torch.stereo import banded_cuda
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
