"""rsn_torch.utils.websocket and rsn_torch.cli.viewer against rsn's on the
CPU: the two packages' websocket frames read each other (lengths across
the 125 / 126 / 64 KiB boundaries, masked and not); a viewer session on
the port's server with a stubbed _render_pose (the protocol of
tests/test_websocket.py), and a failed render reaching the client; the
real _render_pose at 32x24 against rsn's, whose PNG PIL decodes: within
one level of 255 on every pixel (render_image is held at atol 1e-4 by
tests/test_torch_render.py; both truncate v * 255); the camera-path
document against rsn's, apart from its file name; encode_png against
write_png."""
import io
import json
import os
import socket
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from rsn.cli import viewer as jviewer
from rsn.configs import ModelConfig as JModelConfig
from rsn.configs import PipelineConfig as JPipelineConfig
from rsn.configs import TrainerConfig as JTrainerConfig
from rsn.data.cameras import Cameras as JCameras
from rsn.utils import websocket as jws
from rsn_torch import configs as tconfigs
from rsn_torch.cli import render as trender
from rsn_torch.cli import viewer as tviewer
from rsn_torch.data.cameras import Cameras
from rsn_torch.data.png import encode_png, read_png, write_png
from rsn_torch.utils import websocket as tws
from torch_parity import jax_params, port_field, rsn_params

PIXEL_TOL = 1  # levels of 255


def test_accept_key_rfc_example():
    # the worked example of RFC 6455 section 1.3
    assert (tws.accept_key("dGhlIHNhbXBsZSBub25jZQ==")
            == jws.accept_key("dGhlIHNhbXBsZSBub25jZQ==")
            == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo=")
    assert (tws.handshake_response_headers("abc")
            == jws.handshake_response_headers("abc"))


@pytest.mark.parametrize("writer,reader", [(tws, jws), (jws, tws)],
                         ids=["port_to_rsn", "rsn_to_port"])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("n", [0, 125, 126, 65535, 65536])
def test_frames_cross_read(writer, reader, mask, n):
    payload = bytes(i % 251 for i in range(n))
    raw = writer.encode_frame(payload, writer.OP_BINARY, mask=mask)
    if not mask:  # unmasked frames are the same bytes in both packages
        assert raw == reader.encode_frame(payload, reader.OP_BINARY)
    fin, op, got = reader.read_frame(io.BytesIO(raw))
    assert fin and op == reader.OP_BINARY and got == payload
    # a fragmented text message with a ping between its fragments
    raw = (writer.encode_frame(payload[:n // 2], writer.OP_TEXT, mask=mask,
                               fin=False)
           + writer.encode_frame(b"ping!", writer.OP_PING, mask=mask)
           + writer.encode_frame(payload[n // 2:], writer.OP_CONT,
                                 mask=mask))
    out = io.BytesIO()
    assert reader.read_message(io.BytesIO(raw), out) == (reader.OP_TEXT,
                                                          payload)
    assert writer.read_frame(io.BytesIO(out.getvalue()))[1:] == (
        writer.OP_PONG, b"ping!")
    # close: the status echoed, None returned
    out = io.BytesIO()
    raw = writer.encode_frame(b"\x03\xe8bye", writer.OP_CLOSE, mask=mask)
    assert reader.read_message(io.BytesIO(raw), out) is None
    assert writer.read_frame(io.BytesIO(out.getvalue()))[1:] == (
        writer.OP_CLOSE, b"\x03\xe8")


# ---- a viewer session with a stubbed render -------------------------------

FAKE_PNG = b"\x89PNG\r\n\x1a\nfakedata"


def _cams(n=1, w=32, h=24, fx=30.0):
    return Cameras(camera_to_worlds=torch.eye(3, 4).expand(n, 3, 4).clone(),
                   fx=torch.full((n,), fx), fy=torch.full((n,), fx),
                   cx=torch.full((n,), w / 2.0), cy=torch.full((n,), h / 2.0),
                   width=w, height=h)


@pytest.fixture
def server(monkeypatch, tmp_path):
    calls = []

    def fake_render(theta, phi, r, mode, q):
        calls.append((theta, phi, r, mode, q))
        if mode == "fail":
            raise RuntimeError("CUDA error: an illegal memory access")
        return FAKE_PNG + f"/q{q}/{mode}".encode()

    monkeypatch.setattr(tviewer, "_render_pose", fake_render)
    monkeypatch.setattr(tviewer._State, "run_dir", str(tmp_path))
    monkeypatch.setattr(tviewer._State, "cameras", _cams())
    srv = ThreadingHTTPServer(("127.0.0.1", 0), tviewer._Handler)
    srv.handle_error = lambda request, address: None  # quiet tracebacks
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv.server_address, calls
    finally:
        srv.shutdown()
        srv.server_close()


def _send_json(sock, obj):
    sock.sendall(tws.encode_frame(json.dumps(obj).encode(), tws.OP_TEXT,
                                  mask=True))


def test_viewer_ws_session(server):
    (host, port), calls = server
    sock = socket.create_connection((host, port), timeout=10)
    try:
        tws.client_handshake(sock, f"{host}:{port}")
        rf, wf = sock.makefile("rb"), sock.makefile("wb")
        # one pose -> three progressive frames q = 0, 1, 2
        _send_json(sock, {"type": "pose", "theta": 0.5, "phi": 0.1,
                          "r": 1.0, "mode": "rgb"})
        for q in range(3):
            op, payload = tws.read_message(rf, wf)
            assert op == tws.OP_BINARY and payload[0] == q
            assert payload[1:9] == FAKE_PNG[:8]
        assert [c[4] for c in calls] == [0, 1, 2]
        assert calls[0][:2] == (0.5, 0.1)
        # a camera path over the socket
        _send_json(sock, {"type": "export_path",
                          "poses": [{"theta": 0.0, "phi": 0.3, "r": 1.0}]})
        op, payload = tws.read_message(rf, wf)
        reply = json.loads(payload)
        assert op == tws.OP_TEXT and reply["type"] == "path_exported"
        assert reply["num_frames"] == 1
        with open(reply["path"]) as f:
            assert len(json.load(f)["frames"]) == 1
        # the loop is alive: a second pose renders
        _send_json(sock, {"type": "pose", "theta": 1.0, "phi": 0.0,
                          "r": 2.0, "mode": "depth"})
        op, payload = tws.read_message(rf, wf)
        assert op == tws.OP_BINARY and payload.endswith(b"/q0/depth")
        # a clean close: the server echoes the close frame
        sock.sendall(tws.encode_frame(b"\x03\xe8", tws.OP_CLOSE, mask=True))
        while True:
            fin, op, payload = tws.read_frame(rf)
            if op == tws.OP_CLOSE:
                break
    finally:
        sock.close()


def test_viewer_render_error_reaches_the_client(server):
    """A failed render ends the websocket session with a close frame
    (1011) that carries the error, and fails GET /render with a 500."""
    (host, port), _ = server
    sock = socket.create_connection((host, port), timeout=10)
    try:
        tws.client_handshake(sock, f"{host}:{port}")
        rf = sock.makefile("rb")
        _send_json(sock, {"type": "pose", "mode": "fail"})
        fin, op, payload = tws.read_frame(rf)
        assert op == tws.OP_CLOSE
        assert payload[:2] == (1011).to_bytes(2, "big")
        assert b"illegal memory access" in payload
        assert rf.read(1) == b""  # the server closed the connection
    finally:
        sock.close()
    with pytest.raises(urllib.error.HTTPError) as info:
        urllib.request.urlopen(f"http://{host}:{port}/render?mode=fail",
                               timeout=10)
    assert info.value.code == 500
    assert b"illegal memory access" in info.value.read()


def test_viewer_http_routes(server):
    (host, port), calls = server
    with urllib.request.urlopen(
            f"http://{host}:{port}/render?theta=0&phi=0.3&r=1&q=1",
            timeout=10) as rsp:
        assert rsp.read().startswith(FAKE_PNG[:8])
    assert calls[-1][4] == 1
    with urllib.request.urlopen(f"http://{host}:{port}/", timeout=10) as rsp:
        page = rsp.read().decode()
    assert page == jviewer._PAGE == tviewer._PAGE
    assert "WebSocket" in page and "/ws" in page
    req = urllib.request.Request(
        f"http://{host}:{port}/export_path", method="POST",
        data=json.dumps([{"theta": 0.0, "phi": 0.3, "r": 1.0}] * 2).encode())
    with urllib.request.urlopen(req, timeout=10) as rsp:
        reply = json.loads(rsp.read())
    assert reply["num_frames"] == 2 and os.path.exists(reply["path"])
    with pytest.raises(urllib.error.HTTPError) as info:
        urllib.request.urlopen(f"http://{host}:{port}/nothing", timeout=10)
    assert info.value.code == 404


# ---- the real render against rsn's ----------------------------------------

def _configs():
    kw = dict(num_coarse_samples=8, num_importance_samples=8,
              num_reflect_coarse_samples=8,
              num_reflect_importance_samples=8)
    return (JTrainerConfig(pipeline=JPipelineConfig(
        model=JModelConfig(**kw))),
        tconfigs.TrainerConfig(pipeline=tconfigs.PipelineConfig(
            model=tconfigs.ModelConfig(**kw))))


def _jcams(w=32, h=24, fx=30.0):
    return JCameras(camera_to_worlds=jnp.broadcast_to(jnp.eye(3, 4),
                                                      (1, 3, 4)),
                    fx=jnp.full((1,), fx), fy=jnp.full((1,), fx),
                    cx=jnp.full((1,), w / 2.0), cy=jnp.full((1,), h / 2.0),
                    width=w, height=h)


@pytest.mark.parametrize("mode", ["rgb", "depth"])
def test_render_pose_matches_rsn(monkeypatch, tmp_path, mode):
    tree = rsn_params(1)  # seed 1: neither frame is flat at this pose
    jcfg, tcfg = _configs()
    for mod, params, cams, cfg in (
            (jviewer, jax_params(tree), _jcams(), jcfg),
            (tviewer, port_field(tree), _cams(), tcfg)):
        state = mod._State
        monkeypatch.setattr(state, "config", cfg)
        monkeypatch.setattr(state, "cameras", cams)
        monkeypatch.setattr(state, "radius", 4.0)
        monkeypatch.setattr(state, "proposal", None)
        monkeypatch.setattr(state, "params" if mod is jviewer else "field",
                            params)
    monkeypatch.setattr(tviewer._State, "reflect_memo", {})
    ref = np.asarray(Image.open(io.BytesIO(
        jviewer._render_pose(0.7, 0.3, 1.0, mode, 2))))
    png = tviewer._render_pose(0.7, 0.3, 1.0, mode, 2)
    got = np.asarray(Image.open(io.BytesIO(png)))
    assert got.shape == ref.shape == (24, 32, 3) and got.dtype == np.uint8
    assert got.min() < got.max()  # not a flat frame
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= PIXEL_TOL, diff.max()
    # the port's own decoder reads the same pixels as PIL
    path = str(tmp_path / "frame.png")
    with open(path, "wb") as f:
        f.write(png)
    assert np.array_equal(read_png(path)[1], got)
    # a lower quality level renders at 1/4 of the size
    small = np.asarray(Image.open(io.BytesIO(
        tviewer._render_pose(0.7, 0.3, 1.0, mode, 0))))
    assert small.shape == (6, 8, 3)


def test_export_camera_path_matches_rsn(monkeypatch, tmp_path):
    poses = [{"theta": 0.0, "phi": 0.3, "r": 1.0},
             {"theta": 1.0, "phi": -0.2, "r": 1.5}]
    for mod in (jviewer, tviewer):
        monkeypatch.setattr(mod._State, "radius", 3.5)
    jpath = jviewer.export_camera_path(poses, str(tmp_path / "j"), _jcams())
    tpath = tviewer.export_camera_path(poses, str(tmp_path / "t"), _cams())
    assert os.path.basename(os.path.dirname(tpath)) == "camera_paths"
    with open(jpath) as a, open(tpath) as b:
        ref, doc = json.load(a), json.load(b)
    np.testing.assert_array_equal(
        np.asarray([f["camera_to_world"] for f in doc["frames"]]),
        np.asarray([f["camera_to_world"] for f in ref["frames"]]))
    assert doc == ref
    loaded = trender.path_cameras(tpath, _cams(w=8, h=8))
    assert loaded.num_cameras == 2 and (loaded.width, loaded.height) == (32,
                                                                         24)
    np.testing.assert_allclose(np.linalg.norm(
        loaded.camera_to_worlds[:, :, 3].numpy(), axis=-1), [3.5, 5.25],
        rtol=1e-6)


def test_scaled_cameras_match_rsn():
    for divisor in (1, 2, 4):
        t = tviewer._scaled_cameras(_cams(w=64, h=48), divisor)
        j = jviewer._scaled_cameras(_jcams(w=64, h=48), divisor)
        assert (t.width, t.height) == (j.width, j.height)
        for k in ("fx", "fy", "cx", "cy"):
            assert getattr(t, k).numpy().tolist() == np.asarray(
                getattr(j, k)).tolist()


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_encode_png_is_write_pngs_file(tmp_path, channels):
    rng = np.random.default_rng(channels)
    shape = (7, 9) if channels == 1 else (7, 9, channels)
    px = rng.integers(0, 256, size=shape).astype(np.uint8)
    path = str(tmp_path / "a.png")
    write_png(path, px)
    with open(path, "rb") as f:
        assert f.read() == encode_png(px)
    assert np.array_equal(read_png(path)[1], px)


def test_viewer_cli_raises_without_a_card(tmp_path):
    """The viewer runs on the card by default: no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("holds on a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tviewer.main(["--load-dir", str(tmp_path), "--port", "0"])
