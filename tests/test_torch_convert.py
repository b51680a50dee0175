"""rsn_torch convert against rsn-convert on the same weights: a seeded
reference-layout .ckpt imported by both (the field bit for bit, the same
config), both run dirs exported (the same .ckpt bit for bit), export ->
import -> export the identity, the proposal method's fresh proposal
field, --data / --dataparser, and the two rejection errors."""
import json
import os

import numpy as np
import pytest
import torch

import jax

from rsn.cli import convert as jconvert
from rsn.cli.run_io import load_run_full as jload_run_full
from rsn.engine import checkpoints as jckpt
from rsn.models.field import init_field_params
from rsn_torch.cli import convert as tconvert
from rsn_torch.cli.run_io import load_config, load_run_full
from rsn_torch.engine import checkpoints as tckpt
from rsn_torch.engine.trainer import Trainer


def _reference_ckpt(path, params, step=1234, prefix="_model.field."):
    """A nerfstudio-Trainer-shaped .ckpt of an rsn params tree."""
    state = {prefix + k: torch.from_numpy(np.array(v, np.float32))
             for k, v in jckpt.export_torch_state_dict(params,
                                                       prefix="").items()}
    torch.save({"step": step, "pipeline": state, "optimizers": {},
                "schedulers": {}}, path)


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """rsn's and the port's import of one reference .ckpt per prefix of a
    nerfstudio Trainer (plain and DDP-wrapped)."""
    root = tmp_path_factory.mktemp("convert")
    params = init_field_params(jax.random.PRNGKey(0))
    out = {}
    for prefix in ("_model.field.", "module._model.field."):
        d = root / prefix.replace(".", "_")
        ckpt = str(root / f"{prefix}ckpt")
        _reference_ckpt(ckpt, params, prefix=prefix)
        jconvert.import_torch(ckpt, str(d / "rsn"), "reflect-sampling-nerf")
        tconvert.import_torch(ckpt, str(d / "port"), "reflect-sampling-nerf")
        out[prefix] = d
    return out, params


@pytest.mark.parametrize("prefix", ["_model.field.", "module._model.field."])
def test_import_equals_rsn_bit_for_bit(imported, prefix):
    dirs, params = imported
    root = dirs[prefix]
    jparams, jconfig, jstep, _ = jload_run_full(str(root / "rsn"))
    field, config, step, extras = load_run_full(str(root / "port"))
    assert step == jstep == 1234 and extras == {}
    got = jax.tree.leaves(tckpt.params_to_rsn(field.state_dict()))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    assert len(got) == len(want) == len(jax.tree.leaves(params))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    with open(root / "rsn" / "config.json") as f:
        jdoc = json.load(f)
    with open(root / "port" / "config.json") as f:
        assert json.load(f) == jdoc
    state = tckpt.load_checkpoint(tckpt.latest_checkpoint(
        str(root / "port" / "checkpoints")))
    assert state["optimizer"]["state"] == {}  # fresh moments


def test_export_equals_rsn_bit_for_bit(imported):
    root = imported[0]["module._model.field."]
    jout, tout = str(root / "rsn.ckpt"), str(root / "port.ckpt")
    jconvert.export_torch(str(root / "rsn"), jout)
    tconvert.export_torch(str(root / "port"), tout)
    want = torch.load(jout, weights_only=False)
    got = torch.load(tout, weights_only=False)
    assert got["step"] == want["step"] == 1234
    assert list(got["pipeline"]) == list(want["pipeline"])
    for k, v in want["pipeline"].items():
        assert got["pipeline"][k].dtype == v.dtype == torch.float32
        assert torch.equal(got["pipeline"][k], v), k


@pytest.mark.parametrize("prefix", ["_model.field.", "module._model.field.",
                                    "field."])
def test_export_import_export_is_the_identity(imported, tmp_path, prefix):
    """Each prefix the importer knows; the import's field equals the
    reference tensors; exporting it again gives the same file."""
    ckpt = str(tmp_path / "ref.ckpt")
    _reference_ckpt(ckpt, imported[1], step=7, prefix=prefix)
    ref = torch.load(ckpt, weights_only=False)["pipeline"]
    tconvert.import_torch(ckpt, str(tmp_path / "a"), "reflect-sampling-nerf")
    tconvert.export_torch(str(tmp_path / "a"), str(tmp_path / "a.ckpt"))
    tconvert.main(["--torch-ckpt", str(tmp_path / "a.ckpt"), "--output",
                   str(tmp_path / "b")])
    tconvert.main(["--load-dir", str(tmp_path / "b"), "--to-torch",
                   str(tmp_path / "b.ckpt")])
    a = torch.load(str(tmp_path / "a.ckpt"), weights_only=False)
    b = torch.load(str(tmp_path / "b.ckpt"), weights_only=False)
    assert a["step"] == b["step"] == 7
    assert list(a["pipeline"]) == list(b["pipeline"])
    for k, v in a["pipeline"].items():
        assert torch.equal(v, b["pipeline"][k])
        assert torch.equal(v, ref[prefix + k[len("_model.field."):]])


def test_import_proposal_method_with_data_is_resumable(imported, tmp_path):
    """The preset gets a fresh proposal field (as a fresh trainer draws
    it) with its optimizer; --data / --dataparser land in config.json;
    the trainer restores the run."""
    ckpt = str(tmp_path / "ref.ckpt")
    _reference_ckpt(ckpt, imported[1], step=40)
    out = str(tmp_path / "run")
    tconvert.main(["--torch-ckpt", ckpt, "--output", out, "--method",
                   "reflect-sampling-nerf-proposal", "--data",
                   "sphere:res=8,cams=2", "--dataparser", "synthetic"])
    config = load_config(out)
    assert config.method_name == "reflect-sampling-nerf-proposal"
    assert (config.pipeline.datamanager.data,
            config.pipeline.datamanager.dataparser) == (
        "sphere:res=8,cams=2", "synthetic")
    _, _, step, extras = load_run_full(out)
    assert step == 40 and "proposal" in extras
    trainer = Trainer(config, run_dir=str(tmp_path / "resumed"),
                      device="cpu")
    fresh = {k: v.clone() for k, v in trainer.proposal.state_dict().items()}
    trainer.restore(os.path.join(out, "checkpoints"))
    assert trainer.step == 40
    for k, v in trainer.proposal.state_dict().items():
        assert torch.equal(v, fresh[k])  # the trainer's own seeded draw


def test_import_rejections(tmp_path):
    """rsn's two errors: a checkpoint that is not a dict, and one with no
    field under a known prefix."""
    bad = str(tmp_path / "list.ckpt")
    torch.save([1, 2, 3], bad)
    with pytest.raises(SystemExit, match="unrecognized torch checkpoint"):
        tconvert.import_torch(bad, str(tmp_path / "x"),
                              "reflect-sampling-nerf")
    other = str(tmp_path / "other.ckpt")
    torch.save({"pipeline": {"encoder.weight": torch.zeros(2)}}, other)
    with pytest.raises(SystemExit, match="no field parameters found"):
        tconvert.import_torch(other, str(tmp_path / "y"),
                              "reflect-sampling-nerf")
    with pytest.raises(SystemExit):  # import and export at once
        tconvert.main(["--torch-ckpt", bad, "--load-dir", str(tmp_path)])
