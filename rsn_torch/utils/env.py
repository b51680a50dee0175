"""The environment of a spawned rank (port of rsn.utils.env).

rsn's force_cpu_env builds the environment of a process that runs JAX on
fake CPU devices; the port's ranks are processes of their own, one per
device, so their environment carries the rendezvous instead: torchrun's
variables (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE), PYTHONPATH with the repo prepended (a rank's own
subprocesses import the package from the checkout), and on the CPU one
torch thread per rank: several ranks with a thread per core each make a
tiny step many times slower.
"""
from __future__ import annotations

import os
from typing import Dict

CPU_THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")


def repo_root() -> str:
    """The checkout that holds this package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def rank_env(rank: int, world: int, local_rank: int, local_world: int,
             master_addr: str, master_port: int, cpu: bool) -> Dict[str, str]:
    """The environment of rank `rank` of `world`: this process's, the
    rendezvous variables, the repo prepended to PYTHONPATH, and one
    thread per rank when the ranks run on the CPU."""
    env = dict(os.environ)
    env.update(MASTER_ADDR=master_addr, MASTER_PORT=str(master_port),
               RANK=str(rank), WORLD_SIZE=str(world),
               LOCAL_RANK=str(local_rank), LOCAL_WORLD_SIZE=str(local_world))
    path = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = repo_root() + (os.pathsep + path if path else "")
    if cpu:
        env.update({k: "1" for k in CPU_THREAD_VARS})
    return env


def apply_rank_env(env: Dict[str, str]) -> None:
    """Make `env` this process's (a spawned rank, whose interpreter has
    started): os.environ, and torch's thread count where it asks for one
    thread."""
    os.environ.update(env)
    if env.get("OMP_NUM_THREADS") == "1":
        import torch

        torch.set_num_threads(1)
