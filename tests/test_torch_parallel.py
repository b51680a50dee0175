"""rsn_torch.parallel.mesh on the CPU: gloo ranks spawned by mesh.launch
(one torch thread each), the collectives against numpy, a one-rank group
training bit for bit as the single device, the sharded render against the
single device's (bit for bit) and rsn's mesh render, __graft_entry__'s
1-vs-N check of one data-parallel step for its two configs, and what
raises.  The all-reduced gradients against rsn's pmean:
tests/test_torch_parallel_rsn.py.

The ranks import this module by name: its top level imports nothing of
rsn or jax (the tests import them where they use them), so a rank starts
with torch and the port alone."""
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from rsn_torch import configs as tcfg
from rsn_torch.cli.registry import get_method
from rsn_torch.data.synthetic import make_synthetic_cameras
from rsn_torch.engine import checkpoints as tckpt
from rsn_torch.engine import trainer as ttrainer
from rsn_torch.models.field import Field
from rsn_torch.parallel import mesh as mesh_lib
from rsn_torch.utils import env as env_lib

CHUNK = 12  # 8 x 8 rays: 6 chunks, the last ragged, three on each rank
R = 16  # rays per rank in the 1-vs-N step


# ---- what the ranks run ----------------------------------------------------

def _rank_inputs(rank: int):
    rng = np.random.default_rng(100 + rank)
    return {"a": torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(5,))).to(torch.bfloat16),
            "x": torch.from_numpy(rng.normal(size=(6,)).astype(np.float32)),
            "rows": torch.from_numpy(rng.normal(
                size=(3 + 2 * rank, 2)).astype(np.float32))}


def _collectives(mesh):
    mine = _rank_inputs(mesh.rank)
    mean_a, mean_b = mesh_lib.all_reduce_mean(mesh, [mine["a"], mine["b"]])
    t = mine["x"].clone()
    mesh_lib.broadcast_(mesh, [t])
    # one param reached by every rank, one by none; then a third reached
    # by rank 1 alone, which raises on every rank
    params = [torch.nn.Parameter(torch.zeros(2)) for _ in range(3)]
    params[0].grad = torch.full((2,), float(mesh.rank + 1))
    mesh_lib.average_gradients(mesh, params[:2])
    if mesh.rank == 1:
        params[2].grad = torch.full((2,), 4.0)
    try:
        mesh_lib.average_gradients(mesh, params)
        mismatch = None
    except RuntimeError as e:
        mismatch = str(e)
    return {"mean_a": mean_a, "mean_b": mean_b,
            "max": mesh_lib.all_reduce_max(mesh, mine["x"]),
            "bcast": t,
            "bcast_obj": mesh_lib.broadcast_object(
                mesh, {"from": mesh.rank}),
            "gathered_obj": mesh_lib.all_gather_object(mesh, mesh.rank * 10),
            "rows": mesh_lib.all_gather_rows(mesh, mine["rows"]),
            "grads": [p.grad for p in params[:2]], "mismatch": mismatch}


def _render_config(**model):
    mcfg = tcfg.ModelConfig(num_coarse_samples=8, num_importance_samples=8,
                            num_reflect_coarse_samples=8,
                            num_reflect_importance_samples=8, **model)
    return tcfg.TrainerConfig(pipeline=tcfg.PipelineConfig(model=mcfg))


def _renders(field, mesh=None):
    """The renders the sharded one is held to: fp32 both ways, and bf16
    from a remembered bucket (0.25) below the mask, which overflows and
    re-renders; -> ({name: image dict}, the bf16 memo after)."""
    cams = make_synthetic_cameras(num_cameras=2, H=8, W=8)
    out = {}
    for po in (False, True):
        out[f"fp32-{po}"] = ttrainer.render_image(
            field, cams, 1, _render_config(), rays_per_chunk=CHUNK,
            product_only=po, mesh=mesh)
    config = _render_config(compute_dtype="bfloat16")
    memo = {(config.pipeline.model, CHUNK): 0.25}
    out["bf16-rerender"] = ttrainer.render_image(
        field, cams, 1, config, rays_per_chunk=CHUNK, reflect_memo=memo,
        mesh=mesh)
    return out, memo[(config.pipeline.model, CHUNK)]


def _tiny_config(name: str, out_dir: str) -> tcfg.TrainerConfig:
    """The two configs of __graft_entry__.dryrun_multichip, at a tiny
    size: the default method, and the preset with the camera optimizer
    (the field, camera and proposal groups)."""
    method = ("reflect-sampling-nerf" if name == "default"
              else "reflect-sampling-nerf-proposal")
    base = get_method(method).config_factory()
    mcfg = dataclasses.replace(
        base.pipeline.model, compute_dtype="bfloat16", num_coarse_samples=8,
        num_importance_samples=8, num_reflect_coarse_samples=8,
        num_reflect_importance_samples=8, num_proposal_samples=8)
    dm = dataclasses.replace(
        base.pipeline.datamanager, dataparser="synthetic",
        data="sphere:res=8,cams=2", train_num_rays_per_batch=R,
        camera_optimizer="off" if name == "default" else "SO3xR3")
    return dataclasses.replace(
        base, seed=3, output_dir=out_dir, max_num_iterations=3,
        steps_per_log=1, steps_per_eval_batch=0, steps_per_eval_image=0,
        pipeline=dataclasses.replace(base.pipeline, model=mcfg,
                                     datamanager=dm))


def _trained_state(tr):
    out = {"field": {k: v.clone() for k, v in tr.field.state_dict().items()}}
    if tr.proposal is not None:
        out["proposal"] = {k: v.clone()
                           for k, v in tr.proposal.state_dict().items()}
    if tr.camera is not None:
        out["camera"] = tr.camera.detach().clone()
    return out


def _field(state) -> Field:
    field = Field()
    field.load_state_dict(state)
    return field.eval()


def _two_ranks(mesh, render_state, out_dir):
    """Everything the 2-rank tests read, from one launch."""
    renders, bucket = _renders(_field(render_state), mesh)
    steps = {}
    for name in ("default", "preset-so3xr3"):
        tr = ttrainer.Trainer(_tiny_config(name, out_dir),
                              run_dir=os.path.join(out_dir, name), mesh=mesh)
        tr.train_step()
        steps[name] = _trained_state(tr)
    return {"collectives": _collectives(mesh),
            "renders": renders, "bucket": bucket, "steps": steps}


# ---- the tests -------------------------------------------------------------

@pytest.fixture(scope="module")
def render_tree():
    """tests/test_torch_render.py's weights: rsn's seed-0 field, its
    normals head crafted to split the rays into masked and unmasked."""
    from torch_parity import rsn_params

    return rsn_params(0, crafted_normals=True)


@pytest.fixture(scope="module")
def ranks_running(render_tree, tmp_path_factory):
    """The 2-rank launch, from a thread: rsn's mesh render compiles while
    the ranks run."""
    out = str(tmp_path_factory.mktemp("ranks"))
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(mesh_lib.launch, _two_ranks, 2, (
            tckpt.params_from_rsn(render_tree), out), device="cpu")


@pytest.fixture(scope="module")
def two_ranks(ranks_running):
    return ranks_running.result()


def test_sharded_render_matches_rsns_mesh_render(render_tree, ranks_running):
    """rsn's render_image over a 2-device mesh (conftest's fake CPU
    devices), its chunk the ranks' (rsn's global chunk is chunk * 2), all
    four passes in full."""
    import rsn.configs as jcfg
    from rsn.data.synthetic import make_synthetic_dataset
    from rsn.engine import trainer as jtrainer
    from rsn.parallel.mesh import make_mesh
    from torch_parity import jax_params

    config = jcfg.TrainerConfig(pipeline=jcfg.PipelineConfig(
        model=jcfg.ModelConfig(num_coarse_samples=8, num_importance_samples=8,
                               num_reflect_coarse_samples=8,
                               num_reflect_importance_samples=8)))
    jcams = make_synthetic_dataset(num_cameras=2, H=8, W=8).cameras
    ref = jtrainer.render_image(jax_params(render_tree), jcams, 1, config,
                                mesh=make_mesh(2), rays_per_chunk=CHUNK)
    got = ranks_running.result()[0]["renders"]["fp32-False"]
    assert set(got) == set(ref) | {"mask"}
    for k in ref:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_all_reduce_mean_is_the_ranks_mean(two_ranks):
    ins = [_rank_inputs(r) for r in range(2)]
    for res in two_ranks:
        a, b = res["collectives"]["mean_a"], res["collectives"]["mean_b"]
        np.testing.assert_array_equal(
            a.numpy(), (ins[0]["a"].numpy() + ins[1]["a"].numpy()) / 2)
        assert b.dtype == torch.bfloat16
        want = (ins[0]["b"].float() + ins[1]["b"].float()) / 2
        assert torch.equal(b, want.to(torch.bfloat16))
    # every rank holds the same bits
    assert torch.equal(two_ranks[0]["collectives"]["mean_a"],
                       two_ranks[1]["collectives"]["mean_a"])


def test_all_reduce_max_is_the_ranks_max(two_ranks):
    want = np.maximum(_rank_inputs(0)["x"].numpy(),
                      _rank_inputs(1)["x"].numpy())
    for res in two_ranks:
        np.testing.assert_array_equal(res["collectives"]["max"].numpy(), want)


def test_broadcast_gives_rank_0s(two_ranks):
    for res in two_ranks:
        c = res["collectives"]
        np.testing.assert_array_equal(c["bcast"].numpy(),
                                      _rank_inputs(0)["x"].numpy())
        assert c["bcast_obj"] == {"from": 0}
        assert c["gathered_obj"] == [0, 10]


def test_all_gather_rows_keeps_each_ranks_rows(two_ranks):
    for res in two_ranks:
        got = res["collectives"]["rows"]
        assert [g.shape[0] for g in got] == [3, 5]
        for r in range(2):
            np.testing.assert_array_equal(got[r].numpy(),
                                          _rank_inputs(r)["rows"].numpy())


def test_average_gradients_keeps_an_unreached_param_none(two_ranks):
    for res in two_ranks:
        g = res["collectives"]["grads"]
        np.testing.assert_array_equal(g[0].numpy(), [1.5, 1.5])
        assert g[1] is None
        assert "reached different parameters" in res["collectives"][
            "mismatch"]


def test_sharded_render_is_the_single_devices_bit_for_bit(render_tree,
                                                          two_ranks):
    from torch_parity import port_field

    want, bucket = _renders(port_field(render_tree))
    assert 0 < want["bf16-rerender"]["mask"].mean() < 1
    for res in two_ranks:
        assert res["bucket"] == bucket > 0.25  # the re-render happened
        for name, ref in want.items():
            got = res["renders"][name]
            assert set(got) == set(ref), name
            for k in ref:
                assert got[k].dtype == ref[k].dtype, (name, k)
                np.testing.assert_array_equal(got[k], ref[k],
                                              err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", ["default", "preset-so3xr3"])
def test_one_step_on_two_ranks_is_one_process_averaging(two_ranks, name,
                                                        tmp_path):
    """__graft_entry__._certify_config's 1-vs-N check: one process draws
    each rank's batch from that rank's generator, averages the two
    ranks' gradients of every live group and steps; the ranks' replicas
    must agree with it within 1e-5, and with each other bit for bit."""
    tr = ttrainer.Trainer(_tiny_config(name, str(tmp_path)),
                          run_dir=str(tmp_path / "ref"), device="cpu")
    grads = []
    for r in range(2):
        tr.generator.manual_seed(ttrainer.rank_seed(tr.config.seed, r))
        _, groups = tr.forward_backward()
        grads.append([None if p.grad is None else p.grad.clone()
                      for p in tr.live_params()])
    for p, g0, g1 in zip(tr.live_params(), *grads):
        p.grad = (None if g0 is None and g1 is None else
                  ((g0 if g0 is not None else 0) + (g1 if g1 is not None
                                                    else 0)) / 2)
    for opt, sched in groups:
        opt.step()
        sched.step()
    want = _trained_state(tr)
    assert set(want) == ({"field"} if name == "default"
                         else {"field", "proposal", "camera"})
    a, b = (res["steps"][name] for res in two_ranks)
    for group, ref in want.items():
        refs = ref if isinstance(ref, dict) else {"": ref}
        got_a = a[group] if isinstance(ref, dict) else {"": a[group]}
        got_b = b[group] if isinstance(ref, dict) else {"": b[group]}
        for k, v in refs.items():
            assert torch.equal(got_a[k], got_b[k]), (group, k)
            err = float((got_a[k].float() - v.float()).abs().max())
            assert err <= 1e-5, (group, k, err)
    # the ranks drew different batches: the step is not rank 0's alone
    assert not torch.equal(grads[0][0], grads[1][0])


def test_one_rank_group_trains_as_the_single_device(tmp_path):
    """A one-rank gloo group (the mesh path: all-reduced gradients and
    metrics, rank 0's files) trains 3 steps bit for bit as the plain
    trainer: every tensor of the final checkpoint."""
    runs = {}
    for name in ("plain", "group"):
        config = _tiny_config("default", str(tmp_path))
        mesh = None
        if name == "group":
            mesh = mesh_lib.init_mesh(
                "cpu", coordinator_address=f"127.0.0.1:"
                f"{mesh_lib.free_port()}", num_processes=1, process_id=0)
        try:
            tr = ttrainer.Trainer(config, run_dir=str(tmp_path / name),
                                  device="cpu", mesh=mesh)
            tr.train()
        finally:
            if mesh is not None:
                mesh_lib.close(mesh)
        runs[name] = tckpt.load_checkpoint(
            str(tmp_path / name / "checkpoints" / "step-000000003.pt"))

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from flat(v, f"{prefix}/{i}")
        else:
            yield prefix, tree

    a, b = dict(flat(runs["plain"])), dict(flat(runs["group"]))
    assert a.keys() == b.keys()
    assert "/trainer/generator" in a
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k]), k
        else:
            assert v == b[k], k


def _never_runs(mesh):
    raise AssertionError("launched")


def test_more_ranks_than_cards_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one rank per card"):
        mesh_lib.launch(_never_runs, 2, device="cuda")
    with pytest.raises(ValueError, match="backend='gloo'"):
        mesh_lib.launch(_never_runs, 2, device="cuda:0")


def test_nccl_unavailable_raises(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_nccl_available",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="NCCL is not available"):
        mesh_lib.launch(_never_runs, 1, device="cuda")
    with pytest.raises(RuntimeError, match="NCCL is not available"):
        mesh_lib.init_mesh("cuda:0", coordinator_address="127.0.0.1:1",
                           num_processes=1, process_id=0)


def test_trainer_of_several_devices_needs_a_group(tmp_path, monkeypatch):
    config = dataclasses.replace(_tiny_config("default", str(tmp_path)),
                                 num_devices=2)
    with pytest.raises(ValueError, match="mesh.launch") as info:
        ttrainer.Trainer(config, run_dir=str(tmp_path / "r"), device="cpu")
    assert "--num-devices" in str(info.value)
    for k in mesh_lib.TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no group to join"):
        mesh_lib.init_mesh("cpu")


def test_rank_env_and_local_ranks(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", "/x")
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    env = env_lib.rank_env(rank=3, world=4, local_rank=1, local_world=2,
                           master_addr="127.0.0.1", master_port=1234,
                           cpu=True)
    assert (env["RANK"], env["WORLD_SIZE"], env["LOCAL_RANK"],
            env["LOCAL_WORLD_SIZE"], env["MASTER_ADDR"],
            env["MASTER_PORT"]) == ("3", "4", "1", "2", "127.0.0.1", "1234")
    assert env["PYTHONPATH"] == env_lib.repo_root() + os.pathsep + "/x"
    assert env["OMP_NUM_THREADS"] == "1"
    monkeypatch.delenv("PYTHONPATH")
    card = env_lib.rank_env(0, 1, 0, 1, "h", 1, cpu=False)
    assert "OMP_NUM_THREADS" not in card
    assert os.path.isdir(os.path.join(card["PYTHONPATH"], "rsn_torch"))
    assert mesh_lib.local_ranks_for(0, 1, "cpu") == 1
    assert mesh_lib.local_ranks_for(4, 2, "cpu") == 2
    with pytest.raises(ValueError, match="does not split"):
        mesh_lib.local_ranks_for(3, 2, "cpu")
