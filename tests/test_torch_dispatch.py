"""rsn's chunked train dispatch in the port (steps_per_dispatch), on the
CPU, where a chunk is n eager steps: _next_chunk against rsn's over a grid
of cadences; the log lines and the controller's calls against rsn's loop
under the default dispatch (the steps stood in for, as
tests/test_torch_trainer_obs.py does); chunks of 1, 3 and 100 steps give
the same parameters, optimizer state, generator state and log lines bit
for bit (the port of tests/test_engine.py's chunking test); the step
counter's schedules (the warmup's coefficients, the proposal's anneal,
each group's lr) against the host functions and rsn's.  The CUDA graph
that runs a chunk on a card is held to eager steps by chip_smoke.py's
graphed-dispatch phase."""
import dataclasses
import io
import itertools
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsn.configs as jcfg
from rsn.engine import optimizers as joptim
from rsn.engine import trainer as jtrainer
import rsn_torch.configs as tcfg
from rsn_torch.engine import optimizers as toptim
from rsn_torch.engine import trainer as ttrainer


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny steps on one thread (see tests/test_torch_trainer_obs.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- _next_chunk against rsn's ------------------------------------------

def _chunker(module, cfg):
    """A stand-in trainer for `module`'s unbound _next_chunk: the config
    and the adapt cadence as each Trainer computes it."""
    cadence = (cfg.steps_per_log if cfg.steps_per_log > 0
               else module.REFLECT_ADAPT_FALLBACK_CADENCE)
    return types.SimpleNamespace(config=cfg, _adapt_cadence=cadence)


_CADENCES = {  # log, eval batch, eval image, save
    "defaults": (10, 100, 500, 1000),
    "log3": (3, 1000, 1000, 6),
    "log0_fallback": (0, 0, 0, 0),
    "odd": (7, 11, 0, 13),
    "log1": (1, 0, 0, 0),
}
_WINDOWS = {"none": ("", 20, 5), "inside": ("prof", 20, 5),
            "at_zero": ("prof", 0, 3), "past_end": ("prof", 290, 50)}


@pytest.mark.parametrize("cadences,window,dispatch,debug_nans,adaptive", [
    (c, w, d, n, a) for c, w, d, n, a in itertools.product(
        _CADENCES, _WINDOWS, (1, 3, 100, 10_000), (False, True),
        (True, False))
    if not (n and d != 100) and not (not a and w != "inside")])
def test_next_chunk_is_rsns(cadences, window, dispatch, debug_nans,
                            adaptive):
    """At every step up to max_steps, and with max_steps cut short, the
    port's chunk is rsn's: the nearest log / eval / save / adapt boundary
    (the fallback cadence with steps_per_log 0), the profile window's two
    bounds, max_steps, capped by steps_per_dispatch, 1 under debug_nans."""
    log, ev_batch, ev_image, save = _CADENCES[cadences]
    prof_dir, prof_start, prof_num = _WINDOWS[window]
    kw = dict(steps_per_log=log, steps_per_eval_batch=ev_batch,
              steps_per_eval_image=ev_image, steps_per_save=save,
              steps_per_dispatch=dispatch, debug_nans=debug_nans,
              adaptive_reflect_fraction=adaptive, profile_dir=prof_dir,
              profile_start_step=prof_start, profile_num_steps=prof_num)
    j = _chunker(jtrainer, jcfg.TrainerConfig(**kw))
    t = _chunker(ttrainer, tcfg.TrainerConfig(**kw))
    assert t._adapt_cadence == j._adapt_cadence
    for max_steps in (1, 17, 300):
        for step in range(max_steps):
            want = jtrainer.Trainer._next_chunk(j, step, max_steps)
            got = ttrainer.Trainer._next_chunk(t, step, max_steps)
            assert got == want, (step, max_steps)
            assert 1 <= got <= max_steps - step


# ---- the loop against rsn's, the steps stood in for ----------------------

def _config(tmp, cfg_lib=tcfg, **kw):
    mcfg = cfg_lib.ModelConfig(compute_dtype="bfloat16", num_coarse_samples=8,
                               num_importance_samples=8,
                               num_reflect_coarse_samples=8,
                               num_reflect_importance_samples=8)
    dm = cfg_lib.DataManagerConfig(dataparser="synthetic",
                                   data="sphere:res=8,cams=2",
                                   train_num_rays_per_batch=16)
    kw = {"output_dir": str(tmp), "steps_per_save": 0, "seed": 3, **kw}
    return cfg_lib.TrainerConfig(pipeline=cfg_lib.PipelineConfig(
        model=mcfg, datamanager=dm), **kw)


_LOSSES = ("loss_mid_coarse", "loss_mid_fine", "predicted_normal_loss_fine",
           "orientation_loss_fine")


def _metrics(step):
    m = {k: 0.1 * (i + 1) + 0.01 * step for i, k in enumerate(_LOSSES)}
    m["total_loss"] = sum(m.values())
    m.update(mask_fraction=0.3, reflect_overflow=0.0)
    return m


class _Clock:
    """A host clock where every step takes one second."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _loops(tmp, monkeypatch, **kw):
    """rsn's and the port's Trainer on one config under the default
    dispatch, their steps stood in for (rsn's chunk program advances the
    step by the chunk, the port's train_step by one), each controller
    recording the step it is called at -> (rsn's log, the port's log,
    rsn's controller steps, the port's, the port's trainer)."""
    monkeypatch.setattr(jtrainer.ckpt_lib, "save_checkpoint",
                        lambda *a, **k: None)
    jclock, tclock = _Clock(), _Clock()
    monkeypatch.setattr(jtrainer, "time", types.SimpleNamespace(time=jclock))
    monkeypatch.setattr(ttrainer, "time",
                        types.SimpleNamespace(perf_counter=tclock))
    kw["num_devices"] = 1  # rsn's default: every device jax sees
    jt = jtrainer.Trainer(_config(tmp, jcfg, **kw), run_dir=str(tmp / "j"))

    def jstep(state, images, cameras, key, chunk):
        step = int(state.step) + int(chunk)
        jclock.now += int(chunk)
        return state.replace(step=state.step + chunk), {
            k: np.float32(v) for k, v in _metrics(step).items()}

    jt._build_multi_step = lambda frac: jstep
    jt._multi_step_fn = jstep
    jt._eval_step_fn = lambda *a: {"eval_loss": 0.25,
                                   "eval_psnr_batch": 12.5}
    jcalls, tcalls = [], []
    jt._maybe_adapt_reflect_fraction = lambda m: jcalls.append(
        int(jt.state.step))

    tt = ttrainer.Trainer(_config(tmp, **kw), run_dir=str(tmp / "t"),
                          device="cpu")

    def tstep():
        tt.step += 1
        tclock.now += 1
        return {k: torch.tensor(v) for k, v in _metrics(tt.step).items()}

    tt.train_step = tstep
    tt.eval_batch = lambda: {"eval_loss": 0.25, "eval_psnr_batch": 12.5}
    tt._maybe_adapt_reflect_fraction = lambda m: tcalls.append(tt.step)
    tt.save = lambda: None
    jt.train()
    tt.train()
    logs = [[json.loads(line) for line in open(tmp / d / "train_log.jsonl")]
            for d in ("j", "t")]
    return logs[0], logs[1], jcalls, tcalls, tt


@pytest.mark.parametrize("kw,log_steps,adapt_steps", [
    # tests/test_engine.py's _mini_trainer_cfg: no step-1 line
    (dict(steps_per_log=3, max_num_iterations=6), [3, 6], [3, 6]),
    (dict(steps_per_log=5, max_num_iterations=12,
          steps_per_eval_batch=4), [4, 5, 10], [5, 10]),
    # logging off: the controller at the fallback cadence, and the first
    # chunk's line (rsn writes it at the chunk's end)
    (dict(steps_per_log=0, max_num_iterations=250, steps_per_eval_batch=0,
          steps_per_eval_image=0), [100], [100, 200]),
    (dict(steps_per_log=10, max_num_iterations=25, steps_per_dispatch=4),
     [4, 10, 20], [10, 20]),
])
def test_log_lines_and_controller_fall_on_rsns_steps(tmp_path, monkeypatch,
                                                     kw, log_steps,
                                                     adapt_steps):
    """Under the default dispatch the port's train_log.jsonl holds rsn's
    lines (steps, keys in order, values, rays_per_sec from the start) and
    its controller decides at rsn's steps."""
    ref, got, jcalls, tcalls, tt = _loops(tmp_path, monkeypatch, **kw)
    assert [e["step"] for e in got] == [e["step"] for e in ref]
    assert [e["step"] for e in ref if "total_loss" in e] == log_steps
    for g, r in zip(got, ref):
        assert list(g) == list(r)
        for k in r:
            assert g[k] == pytest.approx(r[k], rel=1e-12), (g["step"], k)
    assert tcalls == jcalls == adapt_steps
    assert tt.step == kw["max_num_iterations"]


# ---- chunking invariance (tests/test_engine.py:377-393) ------------------

_ROUTES = {
    "default": {},
    # the anneal ends at step 4: its exponent moves within the 6 steps
    "preset": dict(use_proposal=True, use_proposal_reflect=True,
                   num_proposal_samples=8, distortion_loss_mult=0.002,
                   proposal_weights_anneal_max_num_iters=4),
    "camera": "SO3xR3",
}


def _route_config(tmp, route, dispatch):
    cfg = _config(tmp, steps_per_log=5, max_num_iterations=6,
                  steps_per_dispatch=dispatch)
    mcfg, dm = cfg.pipeline.model, cfg.pipeline.datamanager
    if route == "preset":
        mcfg = dataclasses.replace(mcfg, **_ROUTES["preset"])
    elif route == "camera":
        mcfg = dataclasses.replace(mcfg, use_pallas_acts=False)
        dm = dataclasses.replace(dm, camera_optimizer="SO3xR3")
    return dataclasses.replace(cfg, pipeline=tcfg.PipelineConfig(
        model=mcfg, datamanager=dm))


def _trained(tmp, route, dispatch):
    tr = ttrainer.Trainer(_route_config(tmp, route, dispatch),
                          run_dir=str(tmp / f"d{dispatch}"), device="cpu")
    tr.train()
    with open(tmp / f"d{dispatch}" / "train_log.jsonl") as f:
        log = [json.loads(line) for line in f]
    for line in log:
        line.pop("rays_per_sec", None)
    opt = {}
    for name, o in (("field", tr.optimizer), ("proposal", tr.prop_optimizer),
                    ("camera", tr.cam_optimizer)):
        if o is not None:
            opt[name] = o.state_dict()["state"]
    return tr, log, opt


@pytest.mark.parametrize("route", list(_ROUTES))
def test_chunking_gives_the_same_bits(tmp_path, route):
    """steps_per_dispatch 1, 3 and 100 over 6 steps (chunks 1 x 6; 3, 2,
    1; 5, 1): every parameter, the optimizers' state, the generator's
    state and the log lines bit for bit."""
    ref, ref_log, ref_opt = _trained(tmp_path, route, 1)
    assert [e["step"] for e in ref_log] == [1, 5]
    for dispatch in (3, 100):
        tr, log, opt = _trained(tmp_path, route, dispatch)
        assert tr.step == ref.step == 6
        for a, b in zip(ref.live_params(), tr.live_params()):
            assert torch.equal(a, b)
        assert torch.equal(tr.generator.get_state(),
                           ref.generator.get_state())
        assert int(tr._step_t) == 6
        for name, states in ref_opt.items():
            for i, st in states.items():
                for k, v in st.items():
                    assert torch.equal(torch.as_tensor(v), torch.as_tensor(
                        opt[name][i][k])), (name, i, k)
        # the chunks differ, so the first line does: at 3 / 5, then 5
        assert log[-1] == ref_log[-1]
        assert [e["step"] for e in log] == ([3, 5] if dispatch == 3
                                            else [5])


# ---- the step counter's schedules ----------------------------------------

@pytest.mark.parametrize("method", ["default", "preset"])
def test_traced_coefficients_and_anneal_equal_the_host_functions(method):
    """loss_coefficients_traced and proposal_anneal_traced on a counter
    tensor equal loss_coefficients and proposal_anneal at steps 0, 49, 50
    and N - 1, N, N + 1 of the anneal, in float32, and the coefficients
    equal rsn's loss_coefficients_traced."""
    mcfg = tcfg.ModelConfig()
    if method == "preset":
        mcfg = dataclasses.replace(mcfg, **dict(
            _ROUTES["preset"], proposal_weights_anneal_max_num_iters=1000))
    n = mcfg.proposal_weights_anneal_max_num_iters
    for step in [0, 49, 50, n - 1, n, n + 1]:
        counter = torch.tensor(step, dtype=torch.int64)
        got = ttrainer.loss_coefficients_traced(mcfg, counter)
        want = ttrainer.loss_coefficients(mcfg, step)
        assert list(got) == list(want)
        for k, v in want.items():
            g = torch.as_tensor(got[k], dtype=torch.float32)
            assert g.dtype == torch.float32 and float(g) == np.float32(v), k
        rsn = jtrainer.loss_coefficients_traced(jnp.int32(step))
        for k, v in rsn.items():
            assert float(torch.as_tensor(got[k], dtype=torch.float32)) \
                == float(v), k
        a = ttrainer.proposal_anneal_traced(mcfg, counter)
        host = ttrainer.proposal_anneal(mcfg, step)
        if method == "default":
            assert a is None and host is None
        else:
            assert a.dtype == torch.float32 and float(a) == host, step


@pytest.mark.parametrize("group", ["fields", "proposal_networks",
                                   "camera_opt"])
def test_counter_lr_equals_the_host_schedule_and_rsns(group):
    """decay_at on a counter tensor at steps 0, 49, 50 and T - 1, T, T + 1
    in float32: within float32's rounding of the host's float64 schedule
    (the LambdaLR the CPU runs), and rsn's optax schedule within an ulp."""
    cfg = tcfg.TrainerConfig().optimizers[group]
    T = cfg.max_steps
    steps = [0, 49, 50, T - 1, T, T + 1]
    got = toptim.decay_at(cfg, torch.tensor(steps, dtype=torch.int64))
    assert got.dtype == torch.float32
    host = np.array([cfg.lr * toptim.exponential_decay(
        cfg.lr, cfg.lr_final, T)(s) for s in steps])
    np.testing.assert_allclose(got.double().numpy(), host, rtol=2e-7)
    jcfg_group = jcfg.TrainerConfig().optimizers[group]
    rsn = np.asarray(joptim.exponential_decay(
        jcfg_group.lr, jcfg_group.lr_final, jcfg_group.max_steps)(
            jnp.asarray(steps, jnp.int32)), np.float32)
    ulps = np.abs(got.numpy().view(np.int32) - rsn.view(np.int32))
    assert ulps.max() <= 1, (got.numpy(), rsn)
    assert float(got[-1]) == float(got[-2])  # held at lr_final past T


def test_step_sets_the_counter_and_restore_continues_it(tmp_path):
    """Trainer.step writes the device counter the schedules read; a
    restored trainer's counter is the checkpoint's step, and its next
    step equals the uninterrupted run's bit for bit."""
    cfg = _config(tmp_path, steps_per_log=2, steps_per_save=2,
                  max_num_iterations=2)
    a = ttrainer.Trainer(cfg, run_dir=str(tmp_path / "a"), device="cpu")
    a.train()
    assert a.step == int(a._step_t) == 2
    b = ttrainer.Trainer(cfg, run_dir=str(tmp_path / "b"), device="cpu")
    b.restore(str(tmp_path / "a" / "checkpoints"))
    assert b.step == int(b._step_t) == 2
    assert b.optimizer.param_groups[0]["lr"] == a.optimizer.param_groups[0][
        "lr"]
    a.train_step()
    b.train_step()
    assert int(a._step_t) == int(b._step_t) == 3
    for x, y in zip(a.live_params(), b.live_params()):
        assert torch.equal(x, y)
    b.step = 60
    assert int(b._step_t) == 60
    assert float(ttrainer.loss_coefficients_traced(
        cfg.pipeline.model, b._step_t)["orientation_loss_fine"]) > 0


def _saved(state):
    """A state dict as a checkpoint holds it: written and read back."""
    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    return torch.load(buf, weights_only=True)


def test_load_state_takes_either_form():
    """optimizers.load_state: a CPU optimizer's checkpoint (LambdaLR, a
    float lr) loaded into the card's form (capturable, the counter's lr
    tensor, float32 step counts on the counter's device), and that form's
    checkpoint back into a fresh CPU optimizer, which then steps as the
    uninterrupted one bit for bit."""
    cfg = tcfg.TrainerConfig().optimizers["fields"]
    gen = torch.Generator().manual_seed(0)
    init = torch.randn(5, generator=gen)
    grads = [torch.randn(5, generator=gen) for _ in range(4)]

    def cpu_form():
        p = torch.nn.Parameter(init.clone())
        return (p, *toptim.build_optimizer([p], cfg))

    p, opt, sched = cpu_form()
    for g in grads[:3]:
        p.grad = g.clone()
        opt.step()
        sched.step()
    q = torch.nn.Parameter(p.detach().clone())
    counter = torch.tensor(3)
    card, decay = toptim.build_optimizer([q], cfg, counter)
    toptim.load_state(card, decay, _saved(opt.state_dict()),
                      _saved(sched.state_dict()))
    group = card.param_groups[0]
    assert group["capturable"] and group["lr"] is decay.lr
    assert float(decay.lr) == pytest.approx(opt.param_groups[0]["lr"],
                                            rel=2e-7)
    for k, v in opt.state[p].items():
        got = card.state[q][k]
        assert torch.equal(got.float(), torch.as_tensor(v).float()), k
    assert card.state[q]["step"].dtype == torch.float32

    r, back, back_sched = cpu_form()
    toptim.load_state(back, back_sched, _saved(card.state_dict()),
                      _saved(decay.state_dict()))
    assert back.param_groups[0]["capturable"] is False
    assert back.param_groups[0]["lr"] == opt.param_groups[0]["lr"]
    assert back_sched.last_epoch == sched.last_epoch == 3
    with torch.no_grad():
        r.copy_(p)
    for param, o, s in ((p, opt, sched), (r, back, back_sched)):
        param.grad = grads[3].clone()
        o.step()
        s.step()
    assert torch.equal(p, r)
    assert back.param_groups[0]["lr"] == opt.param_groups[0]["lr"]
