"""Minimal RFC 6455 WebSocket framing, stdlib only (the port's copy of
rsn.utils.websocket).

The wire layer of the viewer (rsn_torch/cli/viewer.py): a browser client
holds a persistent websocket and the server pushes rendered frames.
Handshake accept-key computation plus frame encode/decode (masking,
16/64-bit extended lengths, fragmentation, ping/pong/close control
frames).

Server frames are sent unmasked and client frames masked, per the RFC;
``encode_frame(mask=True)`` exists so tests and the smoke run can speak
the client side of the protocol over a raw socket.
"""
from __future__ import annotations

import base64
import hashlib
import os
import struct
from typing import Optional, Tuple

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


def accept_key(sec_websocket_key: str) -> str:
    """Sec-WebSocket-Accept for a client's Sec-WebSocket-Key."""
    digest = hashlib.sha1((sec_websocket_key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def encode_frame(payload: bytes, opcode: int = OP_BINARY,
                 mask: bool = False, fin: bool = True) -> bytes:
    """One websocket frame.  mask=True produces a client-style frame."""
    head = bytearray([(0x80 if fin else 0) | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        head.append(mask_bit | n)
    elif n < (1 << 16):
        head.append(mask_bit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mask_bit | 127)
        head += struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        head += key
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return bytes(head) + payload


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            raise ConnectionError("websocket peer closed mid-frame")
        buf += chunk
    return buf


def read_frame(rfile) -> Tuple[bool, int, bytes]:
    """-> (fin, opcode, unmasked payload) for a single raw frame."""
    b0, b1 = _read_exact(rfile, 2)
    fin = bool(b0 & 0x80)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack(">H", _read_exact(rfile, 2))
    elif n == 127:
        (n,) = struct.unpack(">Q", _read_exact(rfile, 8))
    key = _read_exact(rfile, 4) if masked else None
    payload = _read_exact(rfile, n)
    if key:
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return fin, opcode, payload


def read_message(rfile, wfile) -> Optional[Tuple[int, bytes]]:
    """Read one complete message, reassembling fragments.

    Control frames interleaved within a fragmented message are handled
    transparently: pings are answered with pongs on `wfile`, pongs are
    ignored.  Returns (opcode, payload), or None when the peer sent a
    close frame (a close reply is written before returning).
    """
    opcode = None
    parts = []
    while True:
        fin, op, payload = read_frame(rfile)
        if op == OP_CLOSE:
            try:
                wfile.write(encode_frame(payload[:2], OP_CLOSE))
                wfile.flush()
            except OSError:
                pass
            return None
        if op == OP_PING:
            wfile.write(encode_frame(payload, OP_PONG))
            wfile.flush()
            continue
        if op == OP_PONG:
            continue
        if op != OP_CONT:
            opcode = op
            parts = [payload]
        elif opcode is None:
            raise ConnectionError("continuation frame with no message")
        else:
            parts.append(payload)
        if fin and opcode is not None:
            return opcode, b"".join(parts)


def handshake_response_headers(sec_websocket_key: str) -> list:
    """(name, value) headers for the 101 Switching Protocols reply."""
    return [
        ("Upgrade", "websocket"),
        ("Connection", "Upgrade"),
        ("Sec-WebSocket-Accept", accept_key(sec_websocket_key)),
    ]


def client_handshake(sock, host: str, path: str = "/ws") -> None:
    """Perform the client side of the opening handshake on a raw
    socket (test helper; validates the server's accept key)."""
    key = base64.b64encode(os.urandom(16)).decode()
    req = (f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
           "Upgrade: websocket\r\nConnection: Upgrade\r\n"
           f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n")
    sock.sendall(req.encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionError("server closed during handshake")
        resp += chunk
    status, _, rest = resp.partition(b"\r\n")
    if b"101" not in status:
        raise ConnectionError(f"handshake rejected: {status!r}")
    headers = {}
    for line in rest.split(b"\r\n"):
        name, _, value = line.partition(b":")
        headers[name.strip().lower()] = value.strip()
    expect = accept_key(key).encode()
    got = headers.get(b"sec-websocket-accept")
    if got != expect:
        raise ConnectionError(f"bad accept key: {got!r} != {expect!r}")
