"""The local searches: K8's pre-pass and chain (random_ls.cu), K10
(lahc.cu) and K12 (full_eval_ls.cu), built for the CPU with the
stand-in of tests/test_torch_cuda_emu.py, against their plain
versions. The file imports no JAX.
"""

import pytest
import torch

from tests.test_torch_cuda_emu import (
    emulated_fixture, _event_draws, k10_equals_plain, K10_GLOBAL_LH, K12_CASES,
    K12_GLOBAL, K12_TABLE, lahc_start, _tied_top3)
from tests.test_torch_kernels import (
    _instances, k10_wide_equal_plain, k8_k12_wide_equal_plain, _ls_draws,
    _past_one_warp, _state, WIDE_R)
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import delta, fitness, lahc, local_search

torch.set_num_threads(1)

emulated = emulated_fixture("random_ls", "full_eval_ls", K12_GLOBAL, K12_TABLE,
                            "lahc")


@pytest.mark.parametrize("P,n_rounds,K", [(3, 2, 4), (1, 1, 1), (2, 3, 5)])
def test_k8_events_source_equals_plain(emulated, P, n_rounds, K):
    """K8's pre-pass (one streaming pass, a top 3 a lane, a warp merge)
    on every draw row, odd row counts included: with ties among the
    uniforms (a few distinct values; rows whose top three tie), at E = 80
    and E = 83 (not a multiple of 4) and on rows that start off a 16-byte
    boundary, so the scalar head and tail and the float4 body all run."""
    pa = _instances("cpu")[1]
    draws = _ls_draws(pa, "cpu", P, n_rounds, K, 60 + K)
    cases = [draws, draws._replace(u=(draws.u * 4).floor() / 4),
             _tied_top3(draws)]
    for E, offset in ((83, 0), (80, 1), (83, 3), (5, 2)):
        d = _event_draws(P, n_rounds, K, E, offset, 70 + E + offset)
        cases += [d, _tied_top3(d)]
    for d in cases:
        kernels.reset_launches()
        assert torch.equal(delta.random_ls_events_kernel(d),
                           delta.random_ls_events_plain(d))
        assert kernels.LAUNCHES["random_ls_events"] == 1


@pytest.mark.parametrize("inst", range(4))
def test_k8_source_equals_plain(emulated, inst):
    pa = _instances("cpu")[inst]
    st = delta.init_rows(pa, *_state(pa, 3, 40 + inst)[:2])
    draws = _ls_draws(pa, "cpu", 3, 3, 4, 50 + inst)
    kernels.reset_launches()
    got = delta.random_local_search_kernel(pa, draws, st)
    want = delta.random_local_search_plain(pa, draws, st)
    assert all(torch.equal(w, g) for w, g in zip(want, got))
    assert kernels.LAUNCHES["random_ls_events"] == 1
    assert kernels.LAUNCHES["random_ls"] == 1
    assert not torch.equal(got.slots, st.slots)
    # the epilogue's terms are a full evaluation of the rows it wrote
    full = fitness.batch_penalty_plain(pa, got.slots, got.rooms)
    assert all(torch.equal(w, g) for w, g in zip(full, got[2:]))


@pytest.mark.parametrize("inst,k_cands", [(0, 4), (1, 1), (2, 3), (3, 4),
                                          (1, 5), (3, 5)])
def test_k10_source_equals_plain(emulated, inst, k_cands):
    """K8's pre-pass and K10 (two-warp blocks, so that K > 2 gives a
    warp several candidates, and chunks of one to three steps, so that 7
    steps cross chunks) equal lahc_steps_plain in every field: with
    histories of 3 (a ring that wraps), 1 (the entry read is the one the
    step before wrote) and 30,000 (the ring in global memory), on tied
    uniforms, on the ITC-like, medium, padded and anchored instances."""
    pa = _instances("cpu")[inst]
    for Lh, tied in ((3, False), (1, False), (K10_GLOBAL_LH, False),
                     (3, True)):
        ls0 = lahc_start(pa, 3, Lh, 120 + inst)
        g = torch.Generator().manual_seed(130 + inst)
        draws = lahc.make_lahc_draws([g], 3, 7, k_cands, pa.n_events,
                                     pa.n_slots, 1.0, 1.0, 0.5, "cpu")
        if tied:
            draws = _tied_top3(draws)
        got = k10_equals_plain(pa, draws, ls0)
        assert not torch.equal(got.ls.slots, ls0.ls.slots)
    # the global layout: the ring does not fit beside the rest
    assert lahc.lahc_smem_bytes(pa, k_cands, K10_GLOBAL_LH) + \
        8 * K10_GLOBAL_LH > kernels.SMEM_LIMIT


@pytest.mark.parametrize("inst,K,cluster", K12_CASES)
def test_k12_source_equals_plain(emulated, inst, K, cluster):
    """K12 (fed by K8's pre-pass) as clusters of 1, 2 and 4 two-warp
    CTAs, each CTA its candidates' relocations and full evaluations and
    the choice exchanged through the others' shared memory, equals
    batch_local_search_plain in rows and penalty terms; the terms are a
    full evaluation of the rows it wrote."""
    pa = _instances("cpu")[inst]
    rows = delta.init_rows(pa, *_state(pa, 3, 500 + inst)[:2])
    draws = _ls_draws(pa, "cpu", 3, 4, K, 510 + inst)
    kernels.reset_launches()
    got = local_search.batch_local_search_kernel(pa, draws, rows, cluster)
    want = local_search.batch_local_search_plain(pa, draws, rows)
    assert all(torch.equal(w, g) for w, g in zip(want, got))
    assert kernels.LAUNCHES["random_ls_events"] == 1
    assert kernels.LAUNCHES["full_eval_ls"] == 1
    assert not torch.equal(got.slots, rows.slots)
    full = fitness.batch_penalty_plain(pa, got.slots, got.rooms)
    assert all(torch.equal(w, g) for w, g in zip(full, got[2:]))


def test_k12_global_memory_path_equals_plain(emulated, monkeypatch):
    """K12 built to stage nothing reads the conflict bitset and the CSR
    from global memory, as it does where they do not fit in shared
    memory, and equals batch_local_search_plain."""
    monkeypatch.setitem(kernels._LIBS, "full_eval_ls",
                        kernels._LIBS[K12_GLOBAL])
    pa = _instances("cpu")[3]
    rows = delta.init_rows(pa, *_state(pa, 2, 520)[:2])
    draws = _ls_draws(pa, "cpu", 2, 3, 3, 521)
    got = local_search.batch_local_search_kernel(pa, draws, rows, 3)
    want = local_search.batch_local_search_plain(pa, draws, rows)
    assert all(torch.equal(w, g) for w, g in zip(want, got))


@pytest.mark.parametrize("R", WIDE_R)
def test_k8_k10_k12_sources_past_one_warp_equal_plain(emulated, R):
    """K8 (pre-pass and chain), K10 and K12 at 33 and 80 rooms: the K4
    body's and K12's relocation's room choice over rooms l, l + 32, ...
    of each lane."""
    pa = _past_one_warp(R, "cpu")
    k8_k12_wide_equal_plain(pa, "cpu", 720 + R)
    k10_wide_equal_plain(pa, "cpu", 730 + R)


@pytest.mark.parametrize("R", WIDE_R)
def test_k12_global_table_equals_plain(emulated, monkeypatch, R):
    """K12 built to stage neither its suitable-rooms table nor the
    conflict bitset and CSR reads all three from global memory, as it
    does at E = 2000 and R = 80 (a 160,000-byte table), and equals
    batch_local_search_plain at 33 and 80 rooms."""
    monkeypatch.setitem(kernels._LIBS, "full_eval_ls",
                        kernels._LIBS[K12_TABLE])
    pa = _past_one_warp(R, "cpu")
    rows = delta.init_rows(pa, *_state(pa, 2, 530 + R)[:2])
    draws = _ls_draws(pa, "cpu", 2, 3, 3, 531 + R)
    got = local_search.batch_local_search_kernel(pa, draws, rows, 3)
    want = local_search.batch_local_search_plain(pa, draws, rows)
    assert all(torch.equal(w, g) for w, g in zip(want, got))
