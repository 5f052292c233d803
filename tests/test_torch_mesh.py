"""The island mesh (parallel/islands.py Mesh, mesh_migrate, the mesh
programs) on the CPU, its shards a repeated `cpu` device.

  - the halo migrate — K7's ring inside each shard, the shard-boundary
    edges as halo rows — equals JAX `_migrate` under shard_map on
    make_mesh(D) over the virtual CPU devices (JAX tests/test_islands.py
    :225), bit for bit, gain included, at (D, L) in {(2, 1), (2, 2),
    (4, 2)} and P in {3, 8}; P = 2 skips on both sides;
  - K7's halo form itself (the CUDA source built for the CPU, the
    stand-in of tests/test_torch_cuda_emu.py) equals migrate_plain given
    the same halo rows;
  - a run on a 2-shard mesh gives the records of one shard holding the
    same 4 islands (the sweep config and the reference config), and a
    checkpoint a 2-shard mesh writes resumes on one shard as if never
    interrupted;
  - a recording process group counts the collectives, as JAX
    tests/test_collectives.py counts the compiled programs': init,
    polish, kick, shrink and LAHC run none, each migration one halo
    exchange, each generation dispatch one MIN and its fetch one gather;
  - the serve lane mesh: per-job records identical at 1 and 2 shards,
    resident and parked (the identity of JAX tests/test_serve_mesh.py
    :126).
"""

import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tests.test_torch_cuda_emu import emulated_fixture
from timetabling_ga_tpu.compat import shard_map
from timetabling_ga_tpu.ops import ga as jga
from timetabling_ga_tpu.parallel import islands as jisl
from timetabling_ga_tpu.problem import dump_tim, random_instance
from timetabling_ga_tpu_torch.obs.metrics import MetricsRegistry
from timetabling_ga_tpu_torch.ops import ga as tga
from timetabling_ga_tpu_torch.parallel import comm
from timetabling_ga_tpu_torch.parallel import islands as tisl
from timetabling_ga_tpu_torch.problem import load_tim
from timetabling_ga_tpu_torch.runtime import config as tconfig
from timetabling_ga_tpu_torch.runtime import dispatch_core as dcore
from timetabling_ga_tpu_torch.runtime import engine
from timetabling_ga_tpu_torch.runtime import jsonl as tjsonl
from timetabling_ga_tpu_torch.serve.service import SolveService

torch.set_num_threads(1)
CPU = torch.device("cpu")
E = 8

emulated = emulated_fixture("survivors")


def _host_state(n_islands: int, pop: int, seed: int) -> tga.PopState:
    """A numpy population of n_islands sorted islands, with ties in
    (penalty, scv) and both feasible and infeasible rows."""
    rng = np.random.default_rng(seed)
    n = n_islands * pop
    pen = rng.integers(0, 6, n).astype(np.int32)
    scv = rng.integers(0, 4, n).astype(np.int32)
    hcv = (rng.integers(0, 2, n) * rng.integers(1, 3, n)).astype(np.int32)
    order = np.concatenate([
        i * pop + np.lexsort((scv[i * pop:(i + 1) * pop],
                              pen[i * pop:(i + 1) * pop]))
        for i in range(n_islands)])
    slots = rng.integers(0, 45, (n, E)).astype(np.int32)
    rooms = rng.integers(0, 5, (n, E)).astype(np.int32)
    return tga.PopState(slots[order], rooms[order], pen[order], hcv[order],
                        scv[order])


def _jax_migrate(host, D: int, L: int, gain: bool):
    spec = jga.PopState(*(P(jisl.AXIS),) * 5)

    @jax.jit
    @functools.partial(shard_map, mesh=jisl.make_mesh(D), in_specs=(spec,),
                       out_specs=(spec, P(jisl.AXIS)) if gain else spec)
    def run(st):
        return jisl._migrate(st, D * L, L=L, return_gain=gain)
    out = run(jga.PopState(*map(jnp.asarray, host)))
    if gain:
        return [np.asarray(x) for x in out[0]], np.asarray(out[1])
    return [np.asarray(x) for x in out], None


def _port_migrate(host, D: int, L: int, gain: bool):
    mesh = tisl.Mesh([CPU] * D, comm.SOLO)
    out = tisl.mesh_migrate(mesh, dcore.reshard_state(host, mesh), L,
                            return_gain=gain)
    states, gains = out if gain else (out, None)
    got = [np.concatenate([st[i].numpy() for st in states])
           for i in range(5)]
    return got, (None if gains is None
                 else np.concatenate([g.numpy() for g in gains]))


@pytest.mark.parametrize("gain", [False, True])
@pytest.mark.parametrize("pop", [3, 8])
@pytest.mark.parametrize("D,L", [(2, 1), (2, 2), (4, 2)])
def test_halo_migrate_matches_jax(D, L, pop, gain):
    host = _host_state(D * L, pop, seed=10 * D + L + pop)
    want, wgain = _jax_migrate(host, D, L, gain)
    got, ggain = _port_migrate(host, D, L, gain)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    if gain:
        np.testing.assert_array_equal(wgain, ggain)
        assert ggain.shape == (D * L,)
    # the exchange moved rows across the shard boundary
    assert not np.array_equal(got[2], host.penalty) or pop == 3


@pytest.mark.parametrize("gain", [False, True])
def test_two_rows_skip_migration_on_both_sides(gain):
    host = _host_state(4, 2, seed=1)
    want, wgain = _jax_migrate(host, 2, 2, gain)
    got, ggain = _port_migrate(host, 2, 2, gain)
    for w, g, h in zip(want, got, host):
        np.testing.assert_array_equal(w, g)
        np.testing.assert_array_equal(h, g)
    if gain:
        assert not ggain.any() and not wgain.any()


@pytest.mark.parametrize("pop", [3, 8])
@pytest.mark.parametrize("D,L", [(2, 1), (2, 2), (4, 2)])
def test_k7_halo_source_equals_plain(emulated, D, L, pop):
    """K7's migrate entry with halo rows (csrc/survivors.cu, built for
    the CPU) against migrate_plain with the same rows, gain included, on
    every shard of the mesh: one launch a shard."""
    from timetabling_ga_tpu_torch import kernels
    host = _host_state(D * L, pop, seed=7 * D + L + pop)
    mesh = tisl.Mesh([CPU] * D, comm.SOLO)
    states = dcore.reshard_state(host, mesh)
    to_next = [tisl.halo_row(st, (L - 1) * pop) for st in states]
    to_prev = [tisl.halo_row(st, 1) for st in states]
    from_prev, from_next = mesh.halo(to_next, to_prev)
    kernels.reset_launches()
    for st, f, b in zip(states, from_prev, from_next):
        got, ggain = tisl.migrate_kernel(st, L, True, f, b)
        want, wgain = tisl.migrate_plain(st, L, True, f, b)
        for w, g in zip(want, got):
            assert torch.equal(w, g)
        assert torch.equal(wgain, ggain)
    assert kernels.LAUNCHES["migrate_halo"] == D
    assert kernels.LAUNCHES["migrate"] == 0


# ------------------------------------------------- runs on the mesh

@pytest.fixture(scope="module")
def tim_path(tmp_path_factory):
    problem = random_instance(1, n_events=30, n_rooms=4, n_features=3,
                              n_students=20, attend_prob=0.15)
    path = tmp_path_factory.mktemp("mesh") / "small.tim"
    path.write_text(dump_tim(problem))
    return str(path)


# deep enough converge sweeps that islands stop at different passes (the
# test checks that some pass ran with stopped islands)
SWEEP = ["-s", "3", "--backend", "cpu", "-t", "300", "--no-auto-tune",
         "--ls-mode", "sweep", "--ls-sweeps", "6", "--ls-converge",
         "--ls-sideways", "0.25", "--init-sweeps", "2", "--pop-size", "4",
         "--generations", "2", "--migration-period", "1", "--islands", "4",
         "--no-precompile"]
REFERENCE = ["-s", "5", "--backend", "cpu", "-t", "300", "--no-auto-tune",
             "-p", "1", "-m", "16", "--pop-size", "4", "--generations", "8",
             "--migration-period", "2", "--islands", "4"]


def _run(tim_path, flags, devices):
    cfg = tconfig.parse_args(["-i", tim_path] + flags)
    out = io.StringIO()
    engine.run(cfg, out=out, devices=devices)
    return [json.loads(line) for line in out.getvalue().splitlines()]


@pytest.mark.parametrize("config", ["sweep", "reference"])
def test_mesh_run_equals_one_shard(tim_path, config, monkeypatch):
    """4 islands on 2 shards give one shard's records: each island draws
    from its own generator by its global index, a converged island draws
    no more, and the ring crosses the shards by the halo."""
    from timetabling_ga_tpu_torch.ops import ga as tga_mod
    stopped = []
    real = tga_mod.make_sweep_draws

    def draws(*a, **k):
        live = a[6] if len(a) > 6 else k.get("live")
        stopped.append(live is not None)
        return real(*a, **k)
    monkeypatch.setattr(tga_mod, "make_sweep_draws", draws)
    flags = SWEEP if config == "sweep" else REFERENCE
    one = _run(tim_path, flags, [CPU])
    two = _run(tim_path, flags, [CPU, CPU])
    assert tjsonl.strip_timing(two) == tjsonl.strip_timing(one)
    assert any(stopped) == (config == "sweep")
    run_entry = [r["runEntry"] for r in two if "runEntry" in r][-1]
    assert run_entry["procsNum"] == 4


def test_checkpoint_written_on_two_shards_resumes_on_one(tim_path,
                                                         tmp_path):
    """A 2-shard mesh writes the whole population and every island's
    generator; one shard resumes it and ends where an uninterrupted run
    on one shard ends (JAX engine.py:2201: a checkpoint resumes on any
    layout)."""
    ck = str(tmp_path / "ck.npz")
    base = REFERENCE[:-6] + ["--migration-period", "2", "--islands", "4"]
    first = _run(tim_path, base + ["--generations", "4", "--checkpoint",
                                   ck], [CPU, CPU])
    assert first
    resumed = _run(tim_path, base + ["--generations", "8", "--checkpoint",
                                     ck, "--resume"], [CPU])
    straight = _run(tim_path, base + ["--generations", "8"], [CPU])

    def core(recs):
        return [r for r in tjsonl.strip_timing(recs)
                if "solution" in r or "runEntry" in r]
    assert core(resumed) == core(straight)
    with np.load(ck) as z:
        assert z["slots"].shape[0] == 4 * 4
        assert z["torch_generators"].shape[0] == 4


class _Recorder(comm.ProcessGroup):
    """One process that counts the collectives it is asked for."""

    def __init__(self):
        super().__init__()
        self.calls = {"all_gather": 0, "all_reduce_min": 0, "exchange": 0,
                      "broadcast": 0}

    def all_gather(self, x, axis=0):
        self.calls["all_gather"] += 1
        return super().all_gather(x, axis)

    def all_reduce_min(self, t):
        self.calls["all_reduce_min"] += 1
        return super().all_reduce_min(t)

    def exchange(self, to_next, to_prev):
        self.calls["exchange"] += 1
        return super().exchange(to_next, to_prev)

    def broadcast(self, vals):
        self.calls["broadcast"] += 1
        return super().broadcast(vals)


def test_collectives_counted(tim_path):
    """Which collectives each mesh program runs (JAX tests/
    test_collectives.py): none in init, polish, kick, shrink and the
    LAHC programs; one halo exchange a migration and one MIN a dispatch
    in the generation runner; one gather a control fetch."""
    from timetabling_ga_tpu_torch.ops import lahc
    problem = load_tim(open(tim_path).read())
    rec = _Recorder()
    mesh = tisl.Mesh([CPU, CPU], rec)
    pa = [problem.device_arrays(CPU)] * 2
    L, pop = 2, 4
    cfg = tga.GAConfig(pop_size=pop, ls_mode="sweep", ls_sweeps=1,
                       ls_converge=True, ls_swap_block=3)

    def gens(seed):
        return [[torch.Generator().manual_seed(seed + 10 * s + i)
                 for i in range(L)] for s in range(2)]

    def counted(fn, *a):
        before = dict(rec.calls)
        out = fn(*a)
        return out, {k: rec.calls[k] - before[k] for k in rec.calls}
    none = {"all_gather": 0, "all_reduce_min": 0, "exchange": 0,
            "broadcast": 0}
    st, c = counted(tisl.mesh_init, mesh, pa, gens(1), pop)
    assert c == none
    (st, _), c = counted(tisl.mesh_polish, mesh, pa, gens(2), st, cfg, 2)
    assert c == none
    st2, c = counted(tisl.mesh_kick, mesh, pa, gens(3), st, cfg, 3)
    assert c == none
    _, c = counted(tisl.mesh_shrink, mesh, st2, L, 2)
    assert c == none
    ls, c = counted(tisl.mesh_lahc_init, mesh, pa, st, 5)
    assert c == none
    (ls, _), c = counted(tisl.mesh_lahc_run, mesh, pa, gens(4), ls, cfg, 3,
                         2)
    assert c == none
    _, c = counted(tisl.mesh_lahc_finalize, mesh, ls, L)
    assert c == none
    assert isinstance(ls[0], lahc.LahcState)
    for n_ep in (1, 3):
        (st, tr, best), c = counted(tisl.mesh_run_epochs, mesh, pa, gens(5),
                                    st, cfg, n_ep, 2)
        assert c == dict(none, exchange=n_ep, all_reduce_min=1)
        assert int(best) == min(int(s.penalty.reshape(L, pop)[:, 0].min())
                                for s in st)
        comm.install(rec)
        try:
            _, c = counted(dcore.fetch, tr)
        finally:
            comm.install(None)
        assert c == dict(none, all_gather=1)


# --------------------------------------------------------- serve mesh

_SHAPE_A = dict(n_events=12, n_rooms=3, n_features=2, n_students=8,
                attend_prob=0.2)
_PA = load_tim(dump_tim(random_instance(71, **_SHAPE_A)))
_PA2 = load_tim(dump_tim(random_instance(73, **_SHAPE_A)))


def _serve(jobs, mesh_devices, resident):
    buf = io.StringIO()
    cfg = tconfig.ServeConfig(backend="cpu", lanes=2, quantum=5, pop_size=4,
                              max_steps=8, mesh_devices=mesh_devices,
                              resident=resident, usage=False)
    reg = MetricsRegistry()
    svc = SolveService(cfg, out=buf, registry=reg)
    for jid, problem, seed, gens in jobs:
        svc.submit(problem, job_id=jid, seed=seed, generations=gens)
    svc.drive()
    svc.close()
    by = {}
    for line in buf.getvalue().splitlines():
        rec = json.loads(line)
        body = rec[next(iter(rec))]
        if isinstance(body, dict) and body.get("job") in dict.fromkeys(
                j[0] for j in jobs):
            by.setdefault(body["job"], []).append(rec)
    return reg, svc, {j: tjsonl.strip_timing(r) for j, r in by.items()}


def test_serve_records_identical_across_lane_meshes():
    """Per-job records are the same on one shard and on two, parked or
    resident (JAX tests/test_serve_mesh.py:126): the lanes of a card run
    as their own lane_run there, and a lane's stream depends only on its
    job's seed and progress."""
    jobs = [("ia", _PA, 3, 15), ("ib", _PA2, 4, 15), ("ic", _PA, 5, 9)]
    _, _, base = _serve(jobs, 1, resident=False)
    assert set(base) == {"ia", "ib", "ic"}
    for md, resident in ((2, False), (2, True), (1, True)):
        reg, svc, got = _serve(jobs, md, resident)
        assert got == base, (md, resident)
        assert reg.gauge("serve.mesh_devices").value == md
        assert svc.scheduler.lanes == tisl.pad_lanes(2, md)
        assert svc.scheduler.mesh.n_shards == md


def test_fleet_passes_mesh_devices_to_its_workers(monkeypatch):
    """`fleet --spawn N -- --mesh-devices 2`: each spawned `serve
    --http` worker gets the flag, and it parses there."""
    from timetabling_ga_tpu_torch.fleet import replicas
    seen = []

    class _Proc:
        def __init__(self, argv, **kw):
            seen.append(argv)
    monkeypatch.setattr(replicas.subprocess, "Popen", _Proc)
    cfg = tconfig.parse_fleet_args(["--spawn", "1", "--backend", "cpu",
                                    "--", "--mesh-devices", "2"])
    replicas.spawn_one(cfg, "r0")
    argv = seen[0]
    i = argv.index("serve")
    assert argv[argv.index("--mesh-devices") + 1] == "2"
    served = tconfig.parse_serve_args(argv[i + 1:])
    assert served.mesh_devices == 2 and served.backend == "cpu"
