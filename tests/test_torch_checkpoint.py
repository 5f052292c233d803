"""The port's checkpoint/resume (timetabling_ga_tpu_torch/runtime/
checkpoint.py, engine.py) against the JAX package's: the same npz
arrays and fingerprint, the same refusals and fallbacks, an exact
continuation of a port run, and resumes across the two packages in both
directions."""

import io
import json
import os

import numpy as np
import pytest
import torch

from timetabling_ga_tpu.problem import dump_tim, load_tim_file
from timetabling_ga_tpu.runtime import checkpoint as jckpt
from timetabling_ga_tpu.runtime import config as jconfig
from timetabling_ga_tpu_torch import cli as tcli
from timetabling_ga_tpu_torch.obs.metrics import REGISTRY
from timetabling_ga_tpu_torch.ops import ga as tga
from timetabling_ga_tpu_torch.problem import load_tim_file as tload
from timetabling_ga_tpu_torch.runtime import checkpoint as tckpt
from timetabling_ga_tpu_torch.runtime import config as tconfig
from timetabling_ga_tpu_torch.runtime import engine as tengine
from timetabling_ga_tpu_torch.runtime import jsonl as tjsonl

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMP01S = os.path.join(_REPO, "fixtures", "comp01s.tim")

# a light explicit config: no post phase, no kicks, no polish, so a
# resume at an epoch boundary continues the run exactly
FLAGS = ["--backend", "cpu", "-t", "300", "--no-auto-tune", "--ls-mode",
         "sweep", "--ls-sweeps", "1", "--pop-size", "6",
         "--migration-period", "4", "--islands", "2", "--trace"]


@pytest.fixture(scope="module")
def tim(tmp_path_factory, small_problem):
    path = tmp_path_factory.mktemp("ck") / "small.tim"
    path.write_text(dump_tim(small_problem))
    return str(path)


def _records(text):
    return [json.loads(line) for line in text.splitlines()]


def _port(tim, argv, capsys):
    assert tcli.main(["-i", tim] + FLAGS + argv) == 0
    out = capsys.readouterr()
    return _records(out.out), out.err


def _jax(tim, argv):
    from timetabling_ga_tpu.runtime import engine as jengine
    buf = io.StringIO()
    jengine.run(jconfig.parse_args(["-i", tim] + FLAGS + argv), out=buf)
    return _records(buf.getvalue())


def _logs(records):
    return [(r["logEntry"]["procID"], r["logEntry"]["best"])
            for r in records if "logEntry" in r]


def _dispatched(records):
    return sum(r["phase"]["gens"] for r in records
               if "phase" in r and r["phase"]["name"] == "dispatch")


def _state(seed, n=4, E=7):
    g = np.random.default_rng(seed)
    return tga.PopState(*(g.integers(0, 45, (n, E)).astype(np.int32)
                          for _ in range(2)),
                        *(g.integers(0, 9, n).astype(np.int32)
                          for _ in range(3)))


def test_save_load_round_trip_with_jax_names_and_dtypes(tmp_path):
    """The port's file holds JAX's arrays under JAX's names and dtypes
    (plus the generator states), and both loaders read it."""
    st = _state(0)
    gens = tengine.generator_states(
        tengine.island_generators(torch.device("cpu"), 5, 0, 2))
    key = tckpt.key_words(5, 0, 120)
    port, ref = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    tckpt.save(port, st, key, 120, "fp", [42, 99], 5, gens, "cpu")
    jckpt.save(ref, st, key, 120, "fp", [42, 99], 5)
    with np.load(port) as zp, np.load(ref) as zj:
        assert set(zp.files) == set(zj.files) | {
            "torch_generators", "torch_generator_device"}
        for name in zj.files:
            assert zp[name].dtype == zj[name].dtype, name
            np.testing.assert_array_equal(zp[name], zj[name])
    got = tckpt.load(port, "fp")
    assert (got.generation, got.best_seen, got.seed) == (120, [42, 99], 5)
    assert got.generator_device == "cpu"
    np.testing.assert_array_equal(got.generators, gens)
    np.testing.assert_array_equal(got.key, key)
    for a, b in zip(got.state, st):
        np.testing.assert_array_equal(a, b)
    jst, jkey, jgen, jbest, jseed = jckpt.load(port, "fp")
    assert (jgen, jbest, jseed) == (120, [42, 99], 5)
    import jax
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jkey)),
                                  key)
    # a JAX file has no generator states
    assert tckpt.load(ref, "fp").generators is None


def test_fingerprint_mismatch_is_refused(tmp_path, small_problem):
    cfg = tga.GAConfig(pop_size=8)
    fp = tckpt.config_fingerprint(small_problem, cfg, 2)
    path = str(tmp_path / "ck.npz")
    tckpt.save(path, _state(1), tckpt.key_words(1, 0, 4), 4, fp)
    with pytest.raises(tckpt.FingerprintMismatch):
        tckpt.load(path, fp + "X")
    # another island count is another fingerprint
    with pytest.raises(tckpt.FingerprintMismatch):
        tckpt.load(path, tckpt.config_fingerprint(small_problem, cfg, 4))
    assert issubclass(tckpt.FingerprintMismatch, ValueError)


def test_truncated_newest_file_falls_back_to_prev(tmp_path, capsys):
    path = str(tmp_path / "ck.npz")
    tckpt.save(path, _state(2), tckpt.key_words(1, 0, 4), 4, "fp", [7, 8])
    tckpt.save(path, _state(3), tckpt.key_words(1, 0, 8), 8, "fp", [5, 6])
    assert os.path.exists(tckpt.prev_path(path))
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    got = tckpt.load(path, "fp")
    assert (got.generation, got.best_seen) == (4, [7, 8])
    np.testing.assert_array_equal(got.state.slots, _state(2).slots)
    err = capsys.readouterr().err
    assert "is unreadable" in err and "resuming from the previous" in err


def test_two_bad_files_raise_corrupt_naming_both(tmp_path):
    path = str(tmp_path / "ck.npz")
    for p in (path, tckpt.prev_path(path)):
        with open(p, "wb") as f:
            f.write(b"not a zip file")
    with pytest.raises(tckpt.CheckpointCorrupt) as e:
        tckpt.load(path, "fp")
    assert path in str(e.value) and tckpt.prev_path(path) in str(e.value)
    os.unlink(tckpt.prev_path(path))
    with pytest.raises(tckpt.CheckpointCorrupt, match="no previous"):
        tckpt.load(path, "fp")
    with pytest.raises(FileNotFoundError):
        tckpt.load(str(tmp_path / "none.npz"), "fp")


@pytest.mark.parametrize("argv", [
    [], ["--no-auto-tune"], ["--no-auto-tune", "-p", "2",
                             "--ls-candidates", "5"],
    ["--nsga2", "--rooms-mode", "parallel", "--islands", "3"],
    ["--ls-sideways", "0.5", "--init-sweeps", "3", "--pop-size", "12"],
    ["--no-auto-tune", "--ls-mode", "sweep", "--ls-converge",
     "--ls-block-events", "2", "--islands", "4"]])
@pytest.mark.parametrize("instance", ["comp01s", "small"])
def test_fingerprint_equals_jax(argv, instance, tim):
    """config_fingerprint of the same instance, flags and island count is
    JAX's string, so a resume across the packages is not refused."""
    from timetabling_ga_tpu.runtime import engine as jengine
    path = COMP01S if instance == "comp01s" else tim
    argv = ["-i", path, "--checkpoint", "c.npz"] + argv
    j, t = jconfig.parse_args(argv), tconfig.parse_args(argv)
    jp, tp = load_tim_file(path), tload(path)
    j.apply_tuned_defaults(jp.n_events)
    t.apply_tuned_defaults(tp.n_events)
    n = t.islands or 1
    assert tckpt.config_fingerprint(tp, tengine.build_ga_config(t), n) == \
        jckpt.config_fingerprint(jp, jengine.build_ga_config(j), n)


def test_resume_continues_the_run_exactly(tim, tmp_path, capsys):
    """8 generations then a resume to 16 give the uninterrupted 16-
    generation run's final population and logEntry values, with the
    generators restored from the file (same device type)."""
    a_ck, b_ck = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    before = REGISTRY.counter("engine.checkpoints").value
    a, _ = _port(tim, ["-s", "3", "--generations", "8", "--checkpoint",
                       a_ck], capsys)
    b, err = _port(tim, ["-s", "3", "--generations", "16", "--checkpoint",
                         a_ck, "--resume"], capsys)
    c, _ = _port(tim, ["-s", "3", "--generations", "16", "--checkpoint",
                       b_ck], capsys)
    assert "reseeding" not in err
    assert _dispatched(a) == 8 and _dispatched(b) == 8
    assert [x[1] for x in _logs(a) + _logs(b)] == \
        [x[1] for x in _logs(c)]
    with np.load(a_ck) as za, np.load(b_ck) as zb:
        for name in ("slots", "rooms", "penalty", "hcv", "scv",
                     "generation", "best_seen", "seed", "key",
                     "torch_generators"):
            np.testing.assert_array_equal(za[name], zb[name])
        assert int(za["generation"]) == 16
    # pipelined (the default), a save at the fence of dispatch N covers
    # the dispatch N+1 in flight, as JAX's does (engine.py:1846-1933):
    # 8 generations in two epochs save once, at generation 8; the resume
    # once, at 16; the 16-generation run at 8, 12 and 16
    assert REGISTRY.counter("engine.checkpoints").value - before == 5
    sol = [r for r in b if "solution" in r or "runEntry" in r]
    assert tjsonl.strip_timing(sol) == tjsonl.strip_timing(
        [r for r in c if "solution" in r or "runEntry" in r])


def test_resume_seed_conflict_and_adoption(tim, tmp_path, capsys):
    """An explicit conflicting -s is refused with JAX's message; no -s
    adopts the saved seed (JAX tests/test_runtime.py:173)."""
    ck = str(tmp_path / "seed.npz")
    _port(tim, ["-s", "5", "--generations", "4", "--checkpoint", ck],
          capsys)
    cfg = tconfig.parse_args(["-i", tim] + FLAGS + [
        "-s", "6", "--generations", "8", "--checkpoint", ck, "--resume"])
    with pytest.raises(ValueError, match="refusing to mix RNG streams"):
        tengine.run(cfg, out=io.StringIO())
    _port(tim, ["--generations", "8", "--checkpoint", ck, "--resume"],
          capsys)
    with np.load(ck) as z:
        assert int(z["seed"]) == 5 and int(z["generation"]) == 8
    # the adopted seed continues the seeded run exactly
    ref = str(tmp_path / "ref.npz")
    _port(tim, ["-s", "5", "--generations", "8", "--checkpoint", ref],
          capsys)
    with np.load(ck) as za, np.load(ref) as zb:
        np.testing.assert_array_equal(za["slots"], zb["slots"])


def test_resume_without_a_file_starts_fresh(tim, tmp_path, capsys):
    ck = str(tmp_path / "none.npz")
    a, _ = _port(tim, ["-s", "2", "--generations", "4", "--checkpoint", ck,
                       "--resume"], capsys)
    b, _ = _port(tim, ["-s", "2", "--generations", "4"], capsys)
    assert tjsonl.strip_timing(a) == tjsonl.strip_timing(b)
    assert os.path.exists(ck)


def _copy(src, dst):
    with open(src, "rb") as f, open(dst, "wb") as g:
        g.write(f.read())
    return dst


def _check_resumed(records, saved, total):
    """A resumed stream: it runs total - saved generations, and each
    island's logEntry bests fall, below the saved floor."""
    with np.load(saved) as z:
        gen, floor = int(z["generation"]), z["best_seen"].tolist()
    assert _dispatched(records) == total - gen
    per = {}
    for proc, best in _logs(records):
        per.setdefault(proc, []).append(best)
    for proc, bests in per.items():
        assert all(b < floor[proc] for b in bests)
        assert bests == sorted(bests, reverse=True)
    return gen


def test_a_jax_checkpoint_resumes_in_the_port(tim, tmp_path, capsys):
    ck = str(tmp_path / "jax.npz")
    _jax(tim, ["-s", "4", "--generations", "8", "--checkpoint", ck])
    saved = _copy(ck, str(tmp_path / "saved.npz"))
    recs, err = _port(tim, ["-s", "4", "--generations", "16",
                            "--checkpoint", ck, "--resume"], capsys)
    assert "reseeding the cpu island generators" in err
    assert _check_resumed(recs, saved, 16) == 8
    with np.load(ck) as z:
        assert int(z["generation"]) == 16 and "torch_generators" in z.files


def test_a_port_checkpoint_resumes_in_the_jax_engine(tim, tmp_path,
                                                     capsys):
    ck = str(tmp_path / "port.npz")
    _port(tim, ["-s", "4", "--generations", "8", "--checkpoint", ck],
          capsys)
    saved = _copy(ck, str(tmp_path / "saved.npz"))
    recs = _jax(tim, ["-s", "4", "--generations", "16", "--checkpoint", ck,
                      "--resume"])
    assert _check_resumed(recs, saved, 16) == 8
    with np.load(ck) as z:
        assert int(z["generation"]) == 16

