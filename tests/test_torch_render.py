"""rsn_torch's render path end to end on the CPU: render_image against
rsn's, the adaptive-compaction re-render, the render CLI, and the
port's freedom from jax."""
import dataclasses
import os
import re
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from rsn.configs import ModelConfig, PipelineConfig, TrainerConfig
from rsn.data.synthetic import make_synthetic_dataset
from rsn.engine import trainer as jtrainer
from rsn_torch.cli import render as trender_cli
from rsn_torch.data.synthetic import make_synthetic_cameras
from rsn_torch.engine import checkpoints as tckpt
from rsn_torch.engine import trainer as ttrainer
from rsn_torch.models.field import Field
from torch_parity import jax_params, port_field, rsn_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(**model) -> TrainerConfig:
    mcfg = ModelConfig(num_coarse_samples=8, num_importance_samples=8,
                       num_reflect_coarse_samples=8,
                       num_reflect_importance_samples=8, **model)
    return TrainerConfig(pipeline=PipelineConfig(model=mcfg))


@pytest.fixture(scope="module")
def scene():
    tree = rsn_params(0, crafted_normals=True)
    jcams = make_synthetic_dataset(num_cameras=2, H=8, W=8).cameras
    tcams = make_synthetic_cameras(num_cameras=2, H=8, W=8)
    return jax_params(tree), port_field(tree), jcams, tcams


def test_synthetic_cameras_match_rsn(scene):
    _, _, jcams, tcams = scene
    np.testing.assert_allclose(tcams.camera_to_worlds.numpy(),
                               np.asarray(jcams.camera_to_worlds), atol=1e-6)
    for k in ("fx", "fy", "cx", "cy"):
        np.testing.assert_array_equal(getattr(tcams, k).numpy(),
                                      np.asarray(getattr(jcams, k)))
    assert (tcams.width, tcams.height) == (jcams.width, jcams.height)


@pytest.mark.parametrize("model", ["perspective", "opencv", "fisheye",
                                   "equirectangular"])
def test_generate_image_rays_match_rsn(model):
    import jax.numpy as jnp

    from rsn.data import cameras as jcam
    from rsn_torch.data import cameras as tcam

    base = make_synthetic_cameras(num_cameras=2, H=6, W=10)
    dist = None
    if model == "opencv":
        dist = np.array([[-0.28, 0.07, 0.01, -0.002, 1e-3, -5e-4]] * 2,
                        np.float32)
    elif model == "fisheye":
        dist = np.array([[0.05, -0.01, 0.002, 0.0, 0.0, 0.0]] * 2,
                        np.float32)
    kind = "perspective" if model == "opencv" else model
    fx = np.asarray(base.fx) * (0.5 if model == "fisheye" else 1.0)
    if model == "equirectangular":
        fx, fy = np.full(2, 5.0, np.float32), np.full(2, 6.0, np.float32)
    else:
        fy = fx
    arrays = dict(c2w=base.camera_to_worlds.numpy(), fx=fx, fy=fy,
                  cx=base.cx.numpy(), cy=base.cy.numpy(), dist=dist)

    def cams(mod, conv):
        a = {k: None if v is None else conv(np.array(v))
             for k, v in arrays.items()}
        return mod.Cameras(camera_to_worlds=a["c2w"], fx=a["fx"], fy=a["fy"],
                           cx=a["cx"], cy=a["cy"], width=10, height=6,
                           distortion=a["dist"], camera_model=kind)

    jc, tc = cams(jcam, jnp.asarray), cams(tcam, torch.from_numpy)
    for factor in (1.0, 2.0):
        ref = jcam.generate_image_rays(jcam.rescale_cameras(jc, factor), 1)
        got = tcam.generate_image_rays(tcam.rescale_cameras(tc, factor), 1)
        for a, b, name in zip(got, ref, ("origins", "directions", "area")):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{name} x{factor}")


@pytest.mark.parametrize("product_only", [False, True])
def test_render_image_matches_rsn(scene, product_only):
    params, field, jcams, tcams = scene
    config = _config(use_pallas=False)
    ref = jtrainer.render_image(params, jcams, 1, config,
                                product_only=product_only)
    got = ttrainer.render_image(field, tcams, 1, config,
                                product_only=product_only)
    assert set(got) == set(ref) | {"mask"}
    assert 0 < got["mask"].mean() < 1
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_adaptive_compaction_rerender_equals_full(scene):
    _, field, _, tcams = scene
    config = _config(compute_dtype="bfloat16")
    full = ttrainer.render_image(field, tcams, 1, dataclasses.replace(
        config, pipeline=PipelineConfig(model=dataclasses.replace(
            config.pipeline.model, adaptive_eval_reflect_fraction=False))))
    frac = float(full["mask"].mean())
    assert 0.25 < frac < 0.9
    # a remembered bucket below the mask fraction overflows, which forces
    # the re-render at the bucket the mask needs
    memo = {(config.pipeline.model, 1024): 0.25}
    got = ttrainer.render_image(field, tcams, 1, config, reflect_memo=memo)
    for k in full:
        np.testing.assert_array_equal(got[k], full[k], err_msg=k)
    want = next(b for b in ttrainer.REFLECT_FRACTION_BUCKETS
                if b >= frac + ttrainer.REFLECT_HEADROOM)
    assert memo[(config.pipeline.model, 1024)] == want


def _png_size_and_pixels(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return (w, h), raw.reshape(h, 1 + 3 * w)[:, 1:]


def test_render_cli_orbit_end_to_end(tmp_path, capsys):
    run = tmp_path / "run"
    config = TrainerConfig(pipeline=PipelineConfig(
        datamanager=dataclasses.replace(
            PipelineConfig().datamanager, dataparser="synthetic",
            data="sphere:res=8"),
        model=_config().pipeline.model))
    tckpt.dump_config(str(run), config)
    tckpt.save_checkpoint(str(run / "checkpoints"), 7,
                          Field(torch.Generator().manual_seed(0)))
    out = tmp_path / "frames"
    rc = trender_cli.main(["--load-dir", str(run), "--mode", "orbit",
                           "--num-frames", "2", "--output-dir", str(out)],
                          device="cpu")
    assert rc == 0
    frames = sorted(os.listdir(out))
    assert frames == ["frame_00000.png", "frame_00001.png"]
    for name in frames:
        size, pixels = _png_size_and_pixels(out / name)
        assert size == (8, 8) and pixels.shape == (8, 24)
    printed = capsys.readouterr().out
    assert "rendered 2/2" in printed
    ranges = re.findall(r"rgb range \[([-\d.e]+), ([-\d.e]+)\]", printed)
    assert len(ranges) == 2
    for lo, hi in ranges:  # [0, 1] up to fp32 rounding of 1 - accumulation
        assert -1e-4 <= float(lo) <= float(hi) <= 1.0 + 1e-4
    with pytest.raises(SystemExit):  # split mode keeps the dataset's size
        trender_cli.main(["--load-dir", str(run), "--mode", "split",
                          "--downscale-factor", "2"], device="cpu")


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import rsn_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(rsn_torch.__path__,"
        " 'rsn_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods), 'jax' in sys.modules, 'flax' in sys.modules,"
        " 'PIL' in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    count, jax_in, flax_in, pil_in = res.stdout.split()
    assert int(count) >= 15
    assert (jax_in, flax_in, pil_in) == ("False", "False", "False")


def _read_jpeg_frame():
    """A nerfstudio capture's JPEG frame (its start of image marker)."""
    import tempfile

    from rsn_torch.data import blender as tblender

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "frame_00001.jpg")
        with open(path, "wb") as f:
            f.write(b"\xff\xd8\xff\xe0" + bytes(16))
        tblender._load_image(path)


def _not_ported_calls():
    """Each "not ported" error of the port, as a call and the rsn module
    it must name."""
    from rsn_torch import configs as tconfigs
    from rsn_torch.cli import train as ttrain_cli

    return {
        "jpeg frame": (_read_jpeg_frame, "rsn/data/blender.py"),
        "multi-device render": (lambda: ttrainer.render_image(
            None, None, 0, None, mesh=object()), "rsn/parallel/mesh.py"),
        "num_devices": (lambda: ttrainer._check_slice(
            tconfigs.TrainerConfig(num_devices=2)), "rsn/parallel/mesh.py"),
        "profile_dir": (lambda: ttrainer._check_slice(
            tconfigs.TrainerConfig(profile_dir="p")),
            "rsn/engine/trainer.py"),
        "multi-host training": (lambda: ttrain_cli.main(
            ["reflect-sampling-nerf", "--multihost"], device="cpu"),
            "rsn/parallel/mesh.py"),
    }


@pytest.mark.parametrize("what", sorted(_not_ported_calls()))
def test_not_ported_errors_name_the_rsn_module(what):
    """The port's "not ported" errors point at ROADMAP Queue 1 by the rsn
    module still to port, not by a step number that a renumbering of the
    queue would break."""
    call, module = _not_ported_calls()[what]
    with pytest.raises(NotImplementedError) as info:
        call()
    msg = str(info.value)
    assert "ROADMAP Queue 1" in msg and module in msg, msg
    assert not re.search(r"step \d", msg), msg
