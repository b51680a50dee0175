"""The trainer's profiler window and tensorboard writer (rsn's
profile_dir / profile_start_step / profile_num_steps and
vis="tensorboard"): on a tiny CPU run, and held against rsn's Trainer
driven over the same steps."""
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsn.configs as jcfg
from rsn.engine import trainer as jtrainer
import rsn_torch.configs as tcfg
from rsn_torch.engine import trainer as ttrainer

RADAM_STEP = "Optimizer.step#RAdam.step"


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny steps on one thread: beside the suite's other workers, a
    thread pool per core makes each small op wait on the others (five
    copies of this file at once: ~10 minutes, against ~20 s on one
    thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(tmp, cfg_lib=tcfg, **kw):
    mcfg = cfg_lib.ModelConfig(compute_dtype="bfloat16", num_coarse_samples=8,
                            num_importance_samples=8,
                            num_reflect_coarse_samples=8,
                            num_reflect_importance_samples=8)
    dm = cfg_lib.DataManagerConfig(dataparser="synthetic",
                                data="sphere:res=8,cams=2",
                                train_num_rays_per_batch=16)
    kw = {"output_dir": str(tmp), "steps_per_log": 1, "steps_per_save": 0,
          "max_num_iterations": 6, "seed": 3, **kw}
    return cfg_lib.TrainerConfig(pipeline=cfg_lib.PipelineConfig(
        model=mcfg, datamanager=dm), **kw)


def _run(tmp, name, **kw):
    tr = ttrainer.Trainer(_config(tmp, **kw), run_dir=str(tmp / name),
                          device="cpu")
    tr.train()
    return tr


def _losses(run_dir):
    with open(os.path.join(run_dir, "train_log.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    for line in lines:
        line.pop("rays_per_sec")
    return lines


def _traces(prof_dir):
    if not os.path.isdir(prof_dir):
        return {}
    out = {}
    for name in sorted(os.listdir(prof_dir)):
        with open(os.path.join(prof_dir, name)) as f:
            events = json.load(f)["traceEvents"]
        # the host's annotations (a CUDA trace repeats them on the
        # device's timeline as "gpu_user_annotation")
        out[name] = sum(e.get("name") == RADAM_STEP
                        and e.get("cat") == "user_annotation"
                        for e in events)
    return out


def test_profile_window_traces_its_steps_and_changes_no_loss(tmp_path):
    """The window opens when the loop reaches profile_start_step and
    closes profile_num_steps steps later: one trace, named by those step
    counts, with exactly that many RAdam steps; the log's losses equal a
    run without the profiler bit for bit."""
    prof = tmp_path / "prof"
    _run(tmp_path, "traced", profile_dir=str(prof), profile_start_step=2,
         profile_num_steps=3)
    assert _traces(prof) == {"trace_step000002_to_step000005.json": 3}
    _run(tmp_path, "plain")
    traced, plain = (_losses(tmp_path / "traced"),
                     _losses(tmp_path / "plain"))
    assert [line["step"] for line in plain] == [1, 2, 3, 4, 5, 6]
    assert traced == plain


@pytest.mark.parametrize("case", ["start_at_max_steps", "restored_past"])
def test_no_trace_when_the_loop_never_reaches_the_start(tmp_path, case):
    """rsn's test is `step == profile_start_step`: a window that starts at
    or after max_steps, or before the step a run is restored at, traces
    nothing."""
    prof = tmp_path / "prof"
    if case == "start_at_max_steps":
        _run(tmp_path, "a", profile_dir=str(prof), profile_start_step=6,
             profile_num_steps=2)
    else:
        _run(tmp_path, "a", max_num_iterations=3)
        tr = ttrainer.Trainer(_config(tmp_path, profile_dir=str(prof),
                                      profile_start_step=2),
                              run_dir=str(tmp_path / "b"), device="cpu")
        tr.restore(str(tmp_path / "a" / "checkpoints"))
        assert tr.step == 3
        tr.train()
        assert tr.step == 6
    assert _traces(prof) == {}


def test_window_cut_by_the_end_of_train_is_written(tmp_path):
    """A window that runs past max_steps is stopped and written when
    train() returns (rsn never stops that trace and loses it)."""
    prof = tmp_path / "prof"
    _run(tmp_path, "a", profile_dir=str(prof), profile_start_step=4,
         profile_num_steps=5)
    assert _traces(prof) == {"trace_step000004_to_step000006.json": 2}


class _StubWriter:
    instances = []

    def __init__(self, logdir):
        self.logdir = logdir
        self.calls = []
        _StubWriter.instances.append(self)

    def add_scalar(self, tag, value, step):
        self.calls.append((tag, value, step))


@pytest.fixture
def stub_tensorboardx(monkeypatch):
    _StubWriter.instances = []
    mod = types.ModuleType("tensorboardX")
    mod.SummaryWriter = _StubWriter
    monkeypatch.setitem(sys.modules, "tensorboardX", mod)
    return _StubWriter


def test_tensorboard_writer_logs_what_the_log_lines_hold(
        tmp_path, stub_tensorboardx):
    """vis="tensorboard": one writer in <run_dir>/tb; its add_scalar calls
    are every log line's keys, values and step, in order (the eval-batch
    lines too)."""
    tr = _run(tmp_path, "a", vis="tensorboard", max_num_iterations=4,
              steps_per_eval_batch=2)
    (writer,) = stub_tensorboardx.instances
    assert tr._tb is writer
    assert writer.logdir == os.path.join(str(tmp_path / "a"), "tb")
    with open(tmp_path / "a" / "train_log.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert any("eval_loss" in line for line in lines)
    want = [(k, v, line["step"]) for line in lines
            for k, v in line.items() if k != "step"]
    assert writer.calls == want


@pytest.mark.parametrize("case", ["no_module", "jsonl_with_module"])
def test_no_writer_without_tensorboardx_or_with_jsonl(tmp_path, monkeypatch,
                                                      case):
    """Without tensorboardX (the card machine has none), vis="tensorboard"
    opens nothing and raises nothing; vis="jsonl" opens no writer even
    when the module is there."""
    _StubWriter.instances = []
    if case == "no_module":
        monkeypatch.setitem(sys.modules, "tensorboardX", None)
        vis = "tensorboard"
    else:
        mod = types.ModuleType("tensorboardX")
        mod.SummaryWriter = _StubWriter
        monkeypatch.setitem(sys.modules, "tensorboardX", mod)
        vis = "jsonl"
    tr = _run(tmp_path, "a", vis=vis, max_num_iterations=2)
    assert tr._tb is None and _StubWriter.instances == []
    assert not os.path.exists(tmp_path / "a" / "tb")
    assert len(_losses(tmp_path / "a")) == 2


# ---- against rsn's Trainer ------------------------------------------------
#
# Both loops run over stand-in steps that only advance the step count and
# return the same metrics, on the same clock, so what is compared is the
# loop itself: where the window opens and closes, and what reaches the
# writer.  rsn's window is read from jax.profiler.start_trace / stop_trace.

_LOSSES = ("loss_mid_coarse", "loss_mid_fine", "predicted_normal_loss_fine",
           "orientation_loss_fine")


def _metrics(step):
    m = {k: 0.1 * (i + 1) + 0.01 * step for i, k in enumerate(_LOSSES)}
    m["total_loss"] = sum(m.values())
    m.update(mask_fraction=0.3, reflect_overflow=0.0)
    return m


_EVAL = {"eval_loss": 0.25, "eval_psnr_batch": 12.5}


class _Clock:
    """A host clock where the step k takes k seconds."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _both(tmp, monkeypatch, restored_at=0, **kw):
    """rsn's and the port's Trainer on one config, their steps stood in
    for, starting at restored_at -> (rsn's, the port's, rsn's window
    calls as ("start" | "stop", the step, the trace dir))."""
    monkeypatch.setattr(jtrainer.ckpt_lib, "save_checkpoint",
                        lambda *a, **k: None)
    calls = []
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: calls.append(
        ("start", int(jt.state.step), d)))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: calls.append(
        ("stop", int(jt.state.step), None)))
    jclock, tclock = _Clock(), _Clock()
    monkeypatch.setattr(jtrainer, "time", types.SimpleNamespace(time=jclock))
    monkeypatch.setattr(ttrainer, "time",
                        types.SimpleNamespace(perf_counter=tclock))

    kw["num_devices"] = 1  # rsn's default: every device jax sees
    jt = jtrainer.Trainer(_config(tmp, jcfg, **kw),
                          run_dir=str(tmp / "j"))
    jt.state = jt.state.replace(step=jnp.int32(restored_at))

    def jstep(state, images, cameras, key, chunk):
        step = int(state.step) + int(chunk)
        jclock.now += step
        # float32, as the device's metrics and the port's tensors
        return state.replace(step=state.step + chunk), {
            k: np.float32(v) for k, v in _metrics(step).items()}

    jt._build_multi_step = lambda frac: jstep
    jt._multi_step_fn = jstep
    jt._eval_step_fn = lambda *a: dict(_EVAL)
    jt._maybe_adapt_reflect_fraction = lambda m: None

    tt = ttrainer.Trainer(_config(tmp, **kw), run_dir=str(tmp / "t"),
                          device="cpu")
    tt.step = restored_at

    def tstep():
        tt.step += 1
        tclock.now += tt.step
        return {k: torch.tensor(v) for k, v in _metrics(tt.step).items()}

    tt.train_step = tstep
    tt.eval_batch = lambda: dict(_EVAL)
    tt._maybe_adapt_reflect_fraction = lambda m: None
    tt.save = lambda: None
    jt.train()
    tt.train()
    return jt, tt, calls


@pytest.mark.parametrize("case,start,num,restored_at", [
    ("window", 2, 3, 0), ("start_at_max_steps", 6, 2, 0),
    ("restored_past", 2, 3, 3), ("cut_by_the_end", 4, 5, 0)])
def test_profile_window_is_rsns(tmp_path, monkeypatch, case, start, num,
                                restored_at):
    """rsn fuses steps up to the window's bounds (steps_per_dispatch 100,
    no log cadence) and starts and stops jax.profiler there; the port's
    one trace covers the same steps.  A window past max_steps rsn starts
    and never stops (its trace is lost); the port writes it at the end of
    train()."""
    prof = tmp_path / "prof"
    _, tt, calls = _both(tmp_path, monkeypatch, restored_at=restored_at,
                         profile_dir=str(prof), profile_start_step=start,
                         profile_num_steps=num, steps_per_log=0)
    assert tt.step == 6
    traces = sorted(os.listdir(prof)) if prof.is_dir() else []
    if not calls:
        assert case in ("start_at_max_steps", "restored_past")
        assert traces == []
        return
    assert calls[0] == ("start", start, str(prof))
    if case == "cut_by_the_end":
        assert calls == [("start", start, str(prof))]
        stop = 6
    else:
        assert calls == [("start", start, str(prof)),
                         ("stop", start + num, None)]
        stop = calls[1][1]
    assert traces == [f"trace_step{start:06d}_to_step{stop:06d}.json"]


def test_tensorboard_writer_is_rsns(tmp_path, monkeypatch, stub_tensorboardx):
    """The same stub writer under both loops: one writer each in
    <run_dir>/tb, and the port's add_scalar calls are rsn's (tag, step,
    value) in order, the eval-batch lines included."""
    jt, tt, _ = _both(tmp_path, monkeypatch, max_num_iterations=4,
                      steps_per_eval_batch=2, vis="tensorboard")
    jw, tw = stub_tensorboardx.instances
    assert (jt._tb, tt._tb) == (jw, tw)
    assert jw.logdir == os.path.join(str(tmp_path / "j"), "tb")
    assert tw.logdir == os.path.join(str(tmp_path / "t"), "tb")
    assert [(k, s) for k, _, s in tw.calls] == [(k, s) for k, _, s
                                                in jw.calls]
    assert {k for k, _, _ in jw.calls} >= {"rays_per_sec", "total_loss",
                                          "reflect_fraction", "eval_loss"}
    assert [s for k, _, s in jw.calls if k == "eval_loss"] == [2, 4]
    for (k, got, _), (_, want, _) in zip(tw.calls, jw.calls):
        assert got == pytest.approx(want, rel=1e-12), k
