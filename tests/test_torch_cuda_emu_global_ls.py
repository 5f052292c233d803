"""The global-memory branches of the random-candidate searches, built
for the CPU with the stand-in of tests/test_torch_cuda_emu.py, against
their plain versions: K8's chain and K10 with att, amask and occ in
global memory (K8 in an individual's scratch row, K10 in the walker's
own rows in place and amask in a scratch row), K12 with its two
occupancies in a scratch row a CTA and its clusters striding over the
individuals; K2 with its occupancy in a scratch row a CTA so;
kernels.STAGE_LIMIT lowered, so that small instances take the branches
thousands of students and hundreds of rooms take on the card. The file
imports no JAX.
"""

import pytest
import torch

from tests.test_torch_cuda_emu import _k2_rows, emulated_fixture
from tests.test_torch_kernels import (
    _instances, _past_one_warp, k8_k12_wide_equal_plain,
    k10_wide_equal_plain)
from timetabling_ga_tpu_torch import kernels
from timetabling_ga_tpu_torch.ops import delta, fitness, lahc, local_search

torch.set_num_threads(1)

emulated = emulated_fixture("random_ls", "full_eval_ls", "lahc",
                            "batch_penalty")


@pytest.mark.parametrize("inst,cluster", [(3, 2), (33, None), (80, 1)])
def test_k8_k10_k12_global_branches_equal_plain(emulated, monkeypatch,
                                                inst, cluster):
    """K8 (pre-pass and chain), K12 (clusters of 2, 4 and 1 CTAs) and
    K10 with nothing staged that grows with the students or the rooms
    equal their plain versions, every field, on the anchored instance
    and at 33 and 80 rooms."""
    monkeypatch.setattr(kernels, "STAGE_LIMIT", 0)
    pa = (_instances("cpu")[inst] if inst < 4
          else _past_one_warp(inst, "cpu"))
    assert delta.random_ls_layout(pa, 4)[2] == 0
    assert lahc.lahc_layout(pa, 4, 3)[3] == 0
    assert not local_search.full_eval_ls_layout(pa, 4)[1]
    kernels.reset_launches()
    k8_k12_wide_equal_plain(pa, "cpu", 900 + inst, cluster=cluster)
    k10_wide_equal_plain(pa, "cpu", 910 + inst)
    assert kernels.LAUNCHES["random_ls"] == 1
    assert kernels.LAUNCHES["full_eval_ls"] == 1
    assert kernels.LAUNCHES["lahc"] == 1


@pytest.mark.parametrize("inst", [3, 80])
def test_k2_global_occupancy_equals_plain(emulated, monkeypatch, inst):
    """K2 with each CTA's occupancy in a global scratch row, clusters of
    1, 2 and 4 CTAs striding over five rows, equals batch_penalty_plain
    on the anchored instance and at 80 rooms."""
    monkeypatch.setattr(kernels, "STAGE_LIMIT", 0)
    pa = (_instances("cpu")[inst] if inst < 4
          else _past_one_warp(inst, "cpu"))
    assert not fitness.batch_penalty_stage(pa)[1]
    slots, rms = _k2_rows(pa, 5, 940 + inst)
    want = fitness.batch_penalty_plain(pa, slots, rms)
    for cs in (1, 2, 4):
        got = fitness.batch_penalty_kernel(pa, slots, rms, cs)
        assert all(torch.equal(w, g) for w, g in zip(want, got)), cs
