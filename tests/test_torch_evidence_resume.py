"""Probe runs cut and resumed against uncut ones, on the CPU
(neural_invertible_warp_tpu_torch/evidence: ``harness.RowCheckpoint``,
``--resume`` in probe_b3, probe_dtu, probe_zoo_r4 and probe_extra_datasets,
``rows --resume``). A run of N steps in one process must equal N/2 steps,
a stop as SIGTERM makes it, and a fresh ``--resume`` for the rest, bit for
bit in every readout row and every record field but the timing ones."""

import json
import os
import pickle
import signal
import subprocess
import sys

import pytest
import torch

from neural_invertible_warp_tpu_torch.evidence import (harness, probe_b3, probe_dtu,
                                                       probe_extra_datasets, probe_zoo_r4,
                                                       rows, scenes)

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

# fields that time a run: the only ones a resumed run may change
TIMING = {"elapsed", "elapsed_s", "ms_per_step", "segments"}
STEPS = 4
TINY_RAYS = ["nerf.rand_rays=32", "nerf.sample_intvs=8"]
B3 = ["--device=cpu", "--iters", str(STEPS), "--log-every", "2", "--n-images", "8",
      "--size", "24,32", "--max-iter", str(STEPS), "--max-pe-iter", "2"]
DTU = ["--device=cpu", "--iters", str(STEPS), "--log-every", "2", "--n-images", "8",
       "--size", "15,20", "--model", "barf_inn_dtu", "--init", "noisy_gt"]
# the zoo's and the extra datasets' scenes cut to a few views
TINY_BLENDER = (scenes.blob_blender_arrays, dict(n_train=6, n_val=2, img_size=16, n_blobs=60,
                                                 radius=1.3, s_range=(0.22, 0.45)))
EXTRA_IMAGES = 10     # the iPhone split holds out int(N / 10) views
EXTRA_SIZE = {"iphone": (12, 20), "tandt": (12, 20)}


def _untimed(rec):
    out = {k: v for k, v in rec.items() if k not in TIMING}
    out["history"] = [{k: v for k, v in r.items() if k not in TIMING}
                      for r in rec["history"]]
    return out


def _stop_after(mp, step):
    """Make the next probe run stop after ``step`` train steps: SIGTERM to
    this process, which the handler ``train_loop`` installs takes."""
    make_trainer = harness.make_trainer

    def make(opt, train, val, device):
        trainer = make_trainer(opt, train, val, device)
        system = trainer.system
        train_step = system.train_step

        def step_then_stop(*a, **k):
            out = train_step(*a, **k)
            if system.step == step:
                handler = signal.getsignal(signal.SIGTERM)
                assert isinstance(getattr(handler, "__self__", None), harness.RowCheckpoint)
                signal.raise_signal(signal.SIGTERM)
            return out
        system.train_step = step_then_stop
        return trainer
    mp.setattr(harness, "make_trainer", make)


def _small_extra_options(mp):
    """probe_extra_datasets at EXTRA_IMAGES views of EXTRA_SIZE and 32 rays x
    8 samples (its sizes are fixed: 108x192 and 180x320)."""
    run_options = probe_extra_datasets.run_options

    def small(run, horizon=20000, out_dir=probe_extra_datasets.OUT_DIR):
        opt = run_options(run, horizon, out_dir)
        opt.H, opt.W = EXTRA_SIZE[run.split("_")[0]]
        opt.data.image_size = [opt.H, opt.W]
        opt.nerf.rand_rays, opt.nerf.sample_intvs = 32, 8
        return opt
    mp.setattr(probe_extra_datasets, "run_options", small)
    mp.setattr(probe_extra_datasets, "N_IMAGES", EXTRA_IMAGES)


def _b3(tmp, overrides=()):
    return B3 + ["--out-root", str(tmp / "runs"), "--out", str(tmp / "rows.jsonl"),
                 "--name", "cut", "--overrides"] + TINY_RAYS + ["data.val_ratio=0.25"] + list(
                     overrides)


def _dtu(tmp):
    return DTU + ["--out-root", str(tmp / "runs"), "--out", str(tmp / "rows.jsonl"),
                  "--name", "cut", "--overrides"] + TINY_RAYS + ["optim.test_iter=2"]


def _zoo(tmp):
    return ["--run", "barf_inn_blender_20k", "--horizon", str(STEPS), "--device=cpu",
            "--tag", "cut", "--out-dir", str(tmp)] + sum(
                (["--over", o] for o in TINY_RAYS), [])


def _extra(run):
    return lambda tmp: ["--run", run, "--horizon", str(STEPS), "--device=cpu",
                        "--tag", "cut", "--out-dir", str(tmp)]


# case -> (probe, its arguments in a directory, whether it shrinks the extra
# datasets' options, the step the cut run stops after)
CASES = {
    "b3": (probe_b3, _b3, False, STEPS // 2),
    "b3_fused_inn": (probe_b3, lambda tmp: _b3(tmp, ["tpu.fused_inn=true"]), False, STEPS // 2),
    "b3_between_readouts": (probe_b3, _b3, False, 1),
    "zoo_barf_inn_blender": (probe_zoo_r4, _zoo, False, STEPS // 2),
    "dtu_noisy_gt": (probe_dtu, _dtu, False, STEPS // 2),
    "iphone_narrow": (probe_extra_datasets, _extra("iphone_narrow"), True, STEPS // 2),
    "tandt_narrow": (probe_extra_datasets, _extra("tandt_narrow"), True, STEPS // 2),
}


# the cases whose uncut run finds a torn temporary file
TORN = ("b3", "iphone_narrow")
# a case whose uncut run is another case's (the same arguments)
UNCUT_OF = {"b3_between_readouts": "b3"}


def _checkpoints(tmp):
    return sorted(str(p.relative_to(tmp)) for p in tmp.rglob("*.row.ckpt*"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """case -> dict(uncut=record, resumed=record, cut_rc, after_cut, after_end):
    the uncut run with ``--resume`` over an empty directory that holds only a
    torn temporary file (so it starts from step 0 and never reads that
    file), the cut run without ``--resume`` (its exit code and the
    checkpoint files it left), then ``--resume`` (the files left after)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(scenes.PROBE_SCENES, "blender_dense", TINY_BLENDER)
        for case, (probe, make_args, extra, stop) in CASES.items():
            with pytest.MonkeyPatch.context() as case_mp:
                if extra:
                    _small_extra_options(case_mp)
                if case in UNCUT_OF:
                    res = {k: out[UNCUT_OF[case]][k] for k in ("uncut", "torn", "after_uncut")}
                else:
                    whole = tmp_path_factory.mktemp(case + "_uncut")
                    args = make_args(whole)
                    torn = _torn_temporary(probe, args) if case in TORN else None
                    uncut = probe.main(args + ["--resume"])
                    res = dict(uncut=uncut, torn=torn, after_uncut=_checkpoints(whole))
                cut = tmp_path_factory.mktemp(case + "_cut")
                args = make_args(cut)
                with pytest.MonkeyPatch.context() as stop_mp:
                    _stop_after(stop_mp, stop)
                    with pytest.raises(SystemExit) as stopped:
                        probe.main(args)
                res.update(cut_rc=stopped.value.code, after_cut=_checkpoints(cut),
                           cut_step=_checkpoint_step(cut),
                           handler=signal.getsignal(signal.SIGTERM))
                res["resumed"] = probe.main(args + ["--resume"])
                res["after_end"] = _checkpoints(cut)
                out[case] = res
    return out


def _checkpoint_step(tmp):
    path, = tmp.rglob("*.row.ckpt")
    return harness.RowCheckpoint.step_of(str(path))


def _torn_temporary(probe, args):
    """Write half a checkpoint where the run's temporary file will be, by a
    run of the probe that stops at its first save (nothing of it
    stays but that file). Returns its path."""
    seen = {}
    save = harness.RowCheckpoint.save

    def torn_save(self, system, history, train_s):
        save(self, system, history, train_s)
        with open(self.path, "rb") as f:
            data = f.read()
        os.remove(self.path)
        with open(self.path + ".tmp", "wb") as f:
            f.write(data[:len(data) // 2])
        seen["path"] = self.path + ".tmp"
        raise SystemExit(harness.STOPPED_RC)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness.RowCheckpoint, "save", torn_save)
        mp.setattr(harness.RowCheckpoint, "finish", lambda self: None)
        with pytest.raises(SystemExit):
            probe.main(args)
    with open(seen["path"], "rb") as f:
        with pytest.raises(Exception):
            pickle.load(f)
    return seen["path"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_cut_and_resumed_run_equals_the_uncut_one(runs, case):
    """Bit for bit in every readout row and every record field but the
    timing ones; the cut run exits with STOPPED_RC and leaves one
    checkpoint at its step, no temporary file, and the SIGTERM handler as it
    was; the resumed run took two processes and deletes its checkpoint."""
    r = runs[case]
    stop = CASES[case][3]
    print("{}: uncut {} rows, resumed after step {}; uncut {:.3f} ms/step".format(
        case, len(r["uncut"]["history"]), r["cut_step"], r["uncut"]["ms_per_step"]))
    assert r["cut_rc"] == harness.STOPPED_RC
    assert r["cut_step"] == stop
    assert [p.endswith(".row.ckpt") for p in r["after_cut"]] == [True]
    assert not isinstance(getattr(r["handler"], "__self__", None), harness.RowCheckpoint)
    assert r["after_end"] == []
    assert r["uncut"]["segments"] == 1 and r["resumed"]["segments"] == 2
    assert _untimed(r["resumed"]) == _untimed(r["uncut"])
    assert [row["it"] for row in r["uncut"]["history"]] == (
        [STEPS] if CASES[case][0] in (probe_zoo_r4, probe_extra_datasets) else [2, STEPS])


@pytest.mark.parametrize("case", TORN)
def test_no_checkpoint_means_step_0_and_a_torn_temporary_is_never_read(runs, case):
    """The uncut runs were started with ``--resume`` where only a torn
    temporary file lay: they ran from step 0 (one process, the same record
    as the cut-and-resumed run) and left no file behind."""
    r = runs[case]
    assert r["torn"].endswith(".row.ckpt.tmp")
    assert r["after_uncut"] == []
    assert r["uncut"]["segments"] == 1
    assert _untimed(r["uncut"]) == _untimed(r["resumed"])


def test_resume_in_a_new_process_equals_the_uncut_run(runs, tmp_path):
    """The cut run resumed by ``python -m ...probe_b3 --resume`` in a new
    Python process (one intra-op thread, as here), as a row is resumed in
    a later call: its record, read from its ``--out`` file, equals the
    uncut run's but in the timing fields."""
    args = _b3(tmp_path)
    with pytest.MonkeyPatch.context() as mp:
        _stop_after(mp, STEPS // 2)
        with pytest.raises(SystemExit):
            probe_b3.main(args)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = subprocess.run(
        [sys.executable, "-m", "neural_invertible_warp_tpu_torch.evidence.probe_b3"]
        + args + ["--resume"], cwd=root, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert child.returncode == 0, child.stderr[-3000:]
    resumed = json.loads((tmp_path / "rows.jsonl").read_text().splitlines()[-1])
    assert resumed["segments"] == 2
    assert _untimed(resumed) == _untimed(runs["b3"]["uncut"])
    assert _checkpoints(tmp_path) == []


def test_resume_refuses_a_different_start(tmp_path):
    """A checkpoint whose initial readout the rebuilt run does not repeat
    (another scene, draw or SfM) is not loaded."""
    args = _b3(tmp_path)
    with pytest.MonkeyPatch.context() as mp:
        _stop_after(mp, 1)
        with pytest.raises(SystemExit):
            probe_b3.main(args)
    path, = tmp_path.rglob("*.row.ckpt")
    with open(path, "rb") as f:
        payload = pickle.load(f)
    payload["init"] = dict(payload["init"], rot=payload["init"]["rot"] + 1.0)
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(ValueError, match="starts at"):
        probe_b3.main(args + ["--resume"])


class _Done:
    """A finished child process, as ``subprocess.Popen`` returns it."""
    returncode = 0

    def __init__(self, cmd, stdout=None, stderr=None):
        self.cmd = cmd
        _Done.started.append(cmd)

    def poll(self):
        return 0


def test_rows_resume_skips_finished_rows_and_resumes_checkpointed_ones(
        tmp_path, monkeypatch, capsys):
    """``rows --resume``: a row with its record is not started, a row with a
    checkpoint starts its probe with ``--resume`` and keeps its log; without
    ``--resume`` every row starts. ``--summary`` lists a row with neither
    record nor end as partial, with its checkpoint's step."""
    out = tmp_path / "rows"
    out.mkdir()
    (out / "R1.jsonl").write_text(json.dumps({"name": "R1", "horizon": 20000}) + "\n")
    (out / "barf_llff_20k").mkdir()
    (out / "barf_llff_20k" / "results.jsonl").write_text(
        json.dumps({"name": "barf_llff_20k", "horizon": 20000}) + "\n")
    ckpt_dir = out / "runs" / "r2" / "probe_seed1"
    ckpt_dir.mkdir(parents=True)
    with open(ckpt_dir / ("R6s1" + harness.RowCheckpoint.SUFFIX), "wb") as f:
        pickle.dump({"state": {"step": 1234}}, f)
    log = "cmd --max-iter 20000\n{'it': 1000, 'psnr': 20.0}\n"
    (out / "R6s1.log").write_text(log)
    _Done.started = []
    monkeypatch.setattr(rows.subprocess, "Popen", _Done)
    monkeypatch.setattr(rows.time, "sleep", lambda s: None)
    names = ["R1", "barf_llff_20k", "R6s1", "R2s2"]
    assert rows.main(names + ["--resume", "--device", "cpu", "--out-dir", str(out)]) == 0
    started = {cmd[2].rsplit(".", 1)[1] + ":" + cmd[cmd.index("--name") + 1]: cmd
               for cmd in _Done.started}
    assert sorted(started) == ["probe_b3:R2s2", "probe_b3:R6s1"]
    assert all(cmd[-1] == "--resume" for cmd in started.values())
    assert (out / "R6s1.log").read_text().startswith(log)
    printed = capsys.readouterr().out
    assert "R1 has its record; skipped" in printed
    assert "R6s1 resumes at step 1234" in printed and "R2s2 from step 0" in printed

    _Done.started = []
    assert rows.main(["R1", "R6s1", "--device", "cpu", "--out-dir", str(out)]) == 0
    assert len(_Done.started) == 2 and "--resume" not in _Done.started[0]

    (out / "R6s1.log").write_text(log)
    found = rows.summary(str(out))
    assert found["R6s1"][0] is None
    assert "R6s1 partial: checkpoint at step 1234" in capsys.readouterr().out


# the rows this slice adds, against the row they repeat at another seed
SEED_ROWS = {"R1s1": ("R1", 1), "R1s2": ("R1", 2), "R6s1": ("R6", 1), "R6s2": ("R6", 2),
             "R2s2": ("R2", 2)}


@pytest.mark.parametrize("row", sorted(SEED_ROWS))
def test_seed_rows_are_their_row_at_another_seed(row):
    base, seed = SEED_ROWS[row]
    probe, args = rows.ROWS[row]
    assert probe == rows.ROWS[base][0] == "probe_b3"
    got, ref = vars(probe_b3.parse_args(args)), vars(probe_b3.parse_args(rows.ROWS[base][1]))
    assert ref["seed"] == 0 and got["seed"] == seed
    assert dict(got, seed=0) == ref


def test_200k_rows_are_the_paper_horizon():
    """R7 is probe_b3 at 200k on its default schedule, D4 D1 at 200k."""
    probe, args = rows.ROWS["R7"]
    got = vars(probe_b3.parse_args(args))
    assert probe == "probe_b3"
    assert (got["iters"], got["max_iter"], got["max_pe_iter"]) == (200000, 200000, 100000)
    assert dict(got, iters=0, log_every=0) == dict(vars(probe_b3.parse_args([])), iters=0,
                                                   log_every=0)
    probe, args = rows.ROWS["D4"]
    d4, d1 = (vars(probe_dtu.parse_args(a)) for a in (args, rows.ROWS["D1"][1]))
    assert probe == rows.ROWS["D1"][0] == "probe_dtu" and d4["iters"] == 200000
    assert dict(d4, iters=0, log_every=0) == dict(d1, iters=0, log_every=0)
