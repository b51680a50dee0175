"""The port's multi-process data parallelism through its entry points, on
the CPU (gloo, one torch thread per rank); the port of
tests/test_multihost.py.

rsn's test runs rsn-train --multihost in 2 processes over a 4-device mesh
against one process over the same mesh.  The port runs one rank per
device: 2 train CLI processes (--multihost, one rank each) against one CLI
process that spawns 2 local ranks (--num-devices 2), at rsn's test sizes,
within rsn's 1e-5; then a save at step 3 resumed to step 6 on 2 ranks
against the uninterrupted run (bit for bit: every rank's generator state
travels in the checkpoint), and the eval CLI over 2 ranks against 1.

The CLIs run on the card unless a Python caller asks for the CPU, so the
processes call main(argv, device="cpu")."""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from rsn_torch.cli import eval as teval
from rsn_torch.cli import run_io as trun_io
from rsn_torch.cli import train as ttrain_cli
from rsn_torch.engine import checkpoints as tckpt
from rsn_torch.engine import trainer as ttrainer
from rsn_torch.models.field import Field
from rsn_torch.parallel import mesh as mesh_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6
_MAIN = ("import sys; from rsn_torch.cli import train; "
         "sys.exit(train.main(sys.argv[1:], device='cpu'))")


def _env() -> dict:
    path = os.environ.get("PYTHONPATH", "")
    return dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path
                                               else ""),
                OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def _train_args(out_dir: str, steps: int = STEPS) -> list:
    """rsn's test sizes (tests/test_multihost.py's _train_args)."""
    return [
        sys.executable, "-c", _MAIN, "reflect-sampling-nerf",
        "--pipeline.datamanager.dataparser", "synthetic",
        "--data", "sphere:res=16,cams=4",
        "--pipeline.datamanager.train-num-rays-per-batch", "64",
        "--pipeline.model.num-coarse-samples", "16",
        "--pipeline.model.num-importance-samples", "16",
        "--pipeline.model.num-reflect-coarse-samples", "8",
        "--pipeline.model.num-reflect-importance-samples", "8",
        "--max-num-iterations", str(steps),
        "--steps-per-save", str(steps),
        "--steps-per-log", str(steps),
        "--steps-per-eval-batch", "0",
        "--steps-per-eval-image", "0",
        "--adaptive-reflect-fraction", "False",
        "--output-dir", out_dir,
    ]


def _run_dirs(out_dir: str) -> list:
    return sorted(glob.glob(os.path.join(out_dir, "*", "*", "*")))


def _cli_runs(tmp: str) -> dict:
    """2 processes of one rank each (--multihost) and 1 process of 2 local
    ranks (--num-devices 2), at once -> {name: (run dirs, outputs)}."""
    os.makedirs(tmp)
    port = mesh_lib.free_port()
    mh, nd = os.path.join(tmp, "mh"), os.path.join(tmp, "nd")
    cmds = [_train_args(mh) + [
        "--multihost", "--coordinator-address", f"127.0.0.1:{port}",
        "--num-processes", "2", "--process-id", str(pid)]
        for pid in range(2)]
    cmds.append(_train_args(nd) + ["--num-devices", "2"])
    procs = [subprocess.Popen(c, env=_env(), cwd=tmp,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return {"mh": (_run_dirs(mh), outs[:2]), "nd": (_run_dirs(nd), outs[2:])}


def _final_checkpoint(run: str, steps: int = STEPS) -> dict:
    return tckpt.load_checkpoint(os.path.join(
        run, "checkpoints", f"step-{steps:09d}.pt"))


def _tensors(tree, prefix=""):
    """Every tensor of a checkpoint, by its path."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{prefix}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def test_two_processes_match_one_process_of_two_ranks(runs):
    (mh_run,), (out0, out1) = runs["mh"]
    (nd_run,), _ = runs["nd"]
    assert "2 device(s)" in out0, out0[-2000:]
    assert "run dir:" not in out1 and "step " not in out1, out1[-2000:]
    with open(os.path.join(mh_run, "train_log.jsonl")) as f:
        # rsn's chunks: one chunk of STEPS steps (--steps-per-log STEPS),
        # its line at its end
        assert [json.loads(line)["step"] for line in f] == [STEPS]
    assert trun_io.load_config(nd_run).num_devices == 2
    got, want = (dict(_tensors(_final_checkpoint(r)))
                 for r in (mh_run, nd_run))
    assert got.keys() == want.keys() and "/field/mlp_base.layers.0.weight" \
        in got and len(want["/trainer/rank_generators/1"]) > 0
    for k, v in want.items():
        if v.is_floating_point():
            dev = float((got[k].double() - v.double()).abs().max())
            assert dev < 1e-5, (k, dev)


def _resume(mesh, config, out_dir):
    """Rank `mesh.rank`: 3 steps and their checkpoint, then a new trainer
    restored from it to step 6 -> (the generator state at the save, the
    restored one)."""
    a = ttrainer.Trainer(config, run_dir=os.path.join(out_dir, "a"),
                         mesh=mesh)
    a.train(3)
    b = ttrainer.Trainer(config, run_dir=os.path.join(out_dir, "b"),
                         mesh=mesh)
    b.restore(a.ckpt_dir)
    restored = b.generator.get_state()
    b.train()
    return a.generator.get_state(), restored


def _evals(tmp: str) -> dict:
    """The eval CLI on a run of num_devices 2 (two spawned ranks) and on
    the same run with num_devices 1 -> {"two", "one": eval.json}.  The
    run: the CLI runs' config, a field from seed 1."""
    config, _ = ttrain_cli.parse_args(_train_args(tmp)[3:])
    res = {}
    for name, n in (("two", 2), ("one", 1)):
        run = os.path.join(tmp, name)
        tckpt.dump_config(run, dataclasses.replace(config, num_devices=n))
        tckpt.save_checkpoint(os.path.join(run, "checkpoints"), 6,
                              Field(torch.Generator().manual_seed(1)))
        out = os.path.join(tmp, f"{name}.json")
        assert teval.main(["--load-dir", run, "--max-images", "1",
                           "--output-path", out], device="cpu") == 0
        with open(out) as f:
            res[name] = json.load(f)
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """At once: the CLI runs, the resume on 2 ranks (3 steps, their
    checkpoint, a new trainer restored to step 6; the CLI runs' config)
    and the eval CLI runs (no LPIPS weights: HOME is a fresh
    directory)."""
    tmp = tmp_path_factory.mktemp("runs")
    config, _ = ttrain_cli.parse_args(
        _train_args(str(tmp / "nd"))[3:] + ["--num-devices", "2"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOME", str(tmp))
        mp.delenv("RSN_LPIPS_WEIGHTS", raising=False)
        with ThreadPoolExecutor(3) as pool:
            cli = pool.submit(_cli_runs, str(tmp / "cli"))
            resume = pool.submit(mesh_lib.launch, _resume, 2,
                                 (config, str(tmp / "resume")),
                                 device="cpu")
            evals = pool.submit(_evals, str(tmp / "eval"))
            return dict(cli.result(), resume=resume.result(),
                        resume_dir=str(tmp / "resume"),
                        evals=evals.result())


def test_resume_on_two_ranks_is_the_uninterrupted_run(runs):
    (nd_run,), _ = runs["nd"]
    states, out = runs["resume"], runs["resume_dir"]
    for saved, restored in states:
        assert torch.equal(saved, restored)
    assert not torch.equal(states[0][0], states[1][0])
    mid = _final_checkpoint(os.path.join(out, "a"), 3)
    assert [torch.equal(g, s[0]) for g, s in zip(
        mid["trainer"]["rank_generators"], states)] == [True, True]
    got = dict(_tensors(_final_checkpoint(os.path.join(out, "b"))))
    want = dict(_tensors(_final_checkpoint(nd_run)))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_eval_cli_on_two_ranks_writes_the_one_rank_numbers(runs):
    res = runs["evals"]
    assert sorted(res["one"]) == ["coarse_psnr", "fine_psnr", "fine_ssim",
                                  "psnr"]
    assert res["two"] == res["one"]
