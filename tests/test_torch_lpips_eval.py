"""rsn_torch's LPIPS and eval against rsn's: the VGG16 LPIPS with rsn's
seeded weights carried across, both state-dict namings, the weight
lookup, and evaluate() / the eval CLI on a tiny synthetic run."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from rsn import lpips as jlpips
from rsn import metrics as jmetrics
from rsn.cli import eval as jeval
from rsn.cli.registry import get_method as jget_method
from rsn.data.synthetic import make_synthetic_dataset as jmake_dataset
from rsn_torch import lpips as tlpips
from rsn_torch import metrics as tmetrics
from rsn_torch.cli import eval as teval
from rsn_torch.cli.registry import get_method as tget_method
from rsn_torch.data.synthetic import make_synthetic_dataset
from rsn_torch.engine import checkpoints as tckpt
from rsn_torch.models.field import Field
from rsn_torch.models.proposal import ProposalField
from torch_parity import jax_params, port_field


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """rsn's init_lpips_params(PRNGKey(0)) saved in the torchvision +
    lpips naming (rsn's export_torch_state_dict), and rsn's distance."""
    params = jax.jit(jlpips.init_lpips_params)(jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_vgg.pth")
    torch.save({k: torch.tensor(np.asarray(v))
                for k, v in jlpips.export_torch_state_dict(params).items()},
               path)
    dist = jax.jit(lambda a, b: jlpips.lpips_distance(params, a, b))
    return path, dist


def _pair(case: str):
    rng = np.random.default_rng(7)
    a = rng.random((64, 64, 3), np.float32)
    if case == "identical":
        return a, a.copy()
    if case == "noisy":
        return a, np.clip(a + 0.1 * rng.standard_normal(a.shape), 0,
                          1).astype(np.float32)
    return a, np.roll(a, 3, axis=1)  # shifted


@pytest.mark.parametrize("case", ["identical", "noisy", "shifted"])
def test_lpips_matches_rsn(weights, case):
    path, dist = weights
    net = tlpips.load_torch_weights(path)
    a, b = _pair(case)
    got = float(net(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(dist(a, b))
    if case == "identical":
        assert got == 0.0 and want == 0.0
    else:
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def _torchmetrics_naming(sd):
    """torchvision + lpips keys -> torchmetrics' `net.net.sliceS.N.*`
    and `net.linN.model.1.weight`."""
    out = {}
    for ci, fi in enumerate(tlpips.VGG16_CONV_IDX):
        s = sum(1 for b in tlpips.SLICE_AFTER_CONV if b < ci) + 1
        for p in ("weight", "bias"):
            out[f"net.net.slice{s}.{fi}.{p}"] = sd[f"features.{fi}.{p}"]
    for li in range(len(tlpips.LIN_CHANNELS)):
        out[f"net.lins.{li}.model.1.weight"] = sd[f"lin{li}.model.1.weight"]
    return out


@pytest.mark.parametrize("naming", ["torchvision_lpips", "torchmetrics"])
def test_state_dict_namings_load_and_round_trip(weights, tmp_path, naming):
    """Both namings load to the same weights as rsn's loader reads;
    export_torch_state_dict gives the file's tensors back; a file
    without them, or missing, gives None."""
    path, _ = weights
    sd = torch.load(path, weights_only=True)
    if naming == "torchmetrics":
        path = str(tmp_path / "tm.pth")
        torch.save(_torchmetrics_naming(sd), path)
    net = tlpips.load_torch_weights(path)
    jparams = jlpips.load_torch_weights(path)
    for ci in range(len(tlpips.VGG16_CONV_IDX)):
        np.testing.assert_array_equal(net.conv_w[ci].detach().numpy(),
                                      np.asarray(jparams["convs"][ci]["w"]))
    out = tlpips.export_torch_state_dict(net)
    assert sorted(out) == sorted(sd)
    for k in sd:
        assert torch.equal(out[k], sd[k]), k
    partial = dict(sd)
    del partial["lin4.model.1.weight"]
    torch.save(partial, str(tmp_path / "partial.pth"))
    assert tlpips.load_torch_weights(str(tmp_path / "partial.pth")) is None
    assert tlpips.load_torch_weights(str(tmp_path / "none.pth")) is None


def test_lpips_weight_lookup(weights, tmp_path, monkeypatch):
    """$RSN_LPIPS_WEIGHTS first, then ~/.cache/rsn/lpips_vgg.pth, as
    rsn looks; none found: lpips() is None."""
    path, dist = weights
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("RSN_LPIPS_WEIGHTS", raising=False)
    a, b = _pair("noisy")
    assert tmetrics.lpips_weight_candidates()[0] == str(
        tmp_path / ".cache" / "rsn" / "lpips_vgg.pth")
    assert tmetrics.load_lpips() is None
    assert tmetrics.lpips(a, b) is None
    os.makedirs(tmp_path / ".cache" / "rsn")
    os.symlink(path, tmp_path / ".cache" / "rsn" / "lpips_vgg.pth")
    assert tmetrics.lpips(a, b) == pytest.approx(float(dist(a, b)),
                                                 rel=1e-5)
    monkeypatch.setenv("RSN_LPIPS_WEIGHTS", str(tmp_path / "missing.pth"))
    assert tmetrics.lpips_weight_candidates()[0] == str(
        tmp_path / "missing.pth")
    assert tmetrics.lpips(a, b) is not None  # falls through to ~/.cache


_TINY = dict(num_coarse_samples=8, num_importance_samples=8,
             num_reflect_coarse_samples=8, num_reflect_importance_samples=8,
             num_proposal_samples=8)
DATA = "sphere:res=16,cams=2"  # 16x16: the SSIM window is 11 wide


def _config(get, method):
    base = get(method).config_factory()
    model = dataclasses.replace(base.pipeline.model, **_TINY)
    dm = dataclasses.replace(base.pipeline.datamanager,
                             dataparser="synthetic", data=DATA)
    return dataclasses.replace(base, pipeline=dataclasses.replace(
        base.pipeline, model=model, datamanager=dm))


def test_evaluate_matches_rsn(weights, monkeypatch):
    """rsn's evaluate and the port's on the same weights and test split:
    every key within 1e-4 (fine_lpips from the same LPIPS file), the keys
    in rsn's order."""
    path, _ = weights
    monkeypatch.setenv("RSN_LPIPS_WEIGHTS", path)
    # rsn's lookup runs once per process: start it afresh
    monkeypatch.setattr(jmetrics, "_LPIPS_CACHE",
                        {"checked": False, "fn": None})
    tree = tckpt.params_to_rsn(Field(torch.Generator().manual_seed(1))
                               .state_dict())
    method = "reflect-sampling-nerf"
    want = jeval.evaluate(jax_params(tree), jmake_dataset(
        num_cameras=2, H=16, W=16, split="test"), _config(jget_method,
                                                          method))
    got = teval.evaluate(port_field(tree), make_synthetic_dataset(
        num_cameras=2, H=16, W=16, split="test"), _config(tget_method,
                                                          method),
        lpips_net=tmetrics.load_lpips())
    assert list(got) == list(want) == ["fine_psnr", "fine_ssim",
                                       "coarse_psnr", "fine_lpips", "psnr"]
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4, (k, got[k], v)


def test_eval_cli_writes_the_five_keys(weights, tmp_path, monkeypatch,
                                       capsys):
    """main(device="cpu") on a run dir: eval.json with rsn's five keys,
    all finite, a line per image, the results as the last line; no
    weights, no fine_lpips; a config with two devices raises (no mesh in
    the port yet)."""
    path, _ = weights
    run = str(tmp_path / "run")
    cfg = _config(tget_method, "reflect-sampling-nerf")
    tckpt.dump_config(run, cfg)
    tckpt.save_checkpoint(os.path.join(run, "checkpoints"), 5,
                          Field(torch.Generator().manual_seed(1)))
    monkeypatch.setenv("RSN_LPIPS_WEIGHTS", path)
    assert teval.main(["--load-dir", run, "--max-images", "1"],
                      device="cpu") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    with open(os.path.join(run, "eval.json")) as f:
        res = json.load(f)
    assert json.loads(lines[-1]) == res
    assert lines[0].startswith("image 1/1: ")
    assert sorted(res) == ["coarse_psnr", "fine_lpips", "fine_psnr",
                           "fine_ssim", "psnr"]
    assert all(np.isfinite(v) for v in res.values())
    assert res["psnr"] == res["fine_psnr"]

    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("RSN_LPIPS_WEIGHTS")
    out = str(tmp_path / "e.json")
    teval.main(["--load-dir", run, "--max-images", "1", "--split", "train",
                "--output-path", out], device="cpu")
    with open(out) as f:
        assert "fine_lpips" not in json.load(f)

    # the preset: its proposal field renders passes 1 and 3, and there is
    # no coarse rgb head, so coarse_psnr is null (rsn's key set)
    prun = str(tmp_path / "preset")
    tckpt.dump_config(prun, _config(tget_method,
                                    "reflect-sampling-nerf-proposal"))
    tckpt.save_checkpoint(
        os.path.join(prun, "checkpoints"), 5,
        Field(torch.Generator().manual_seed(1)),
        proposal=ProposalField(torch.Generator().manual_seed(3)))
    teval.main(["--load-dir", prun, "--max-images", "1"], device="cpu")
    with open(os.path.join(prun, "eval.json")) as f:
        res = json.load(f)
    assert res["coarse_psnr"] is None and np.isfinite(res["fine_psnr"])

    tckpt.dump_config(run, dataclasses.replace(cfg, num_devices=2))
    with pytest.raises(NotImplementedError, match="rsn/parallel/mesh.py"):
        teval.main(["--load-dir", run], device="cpu")
