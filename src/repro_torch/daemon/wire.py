"""Wire framing shared by the daemon server and client.

Length-prefixed JSON over a stream socket: 4-byte big-endian unsigned
payload length, then UTF-8 JSON.  One request -> one response; connections
are long-lived (a client may pipeline many request/response pairs over one
socket).
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Optional

_HDR = struct.Struct(">I")
MAX_MESSAGE_BYTES = 64 * 1024 * 1024


class ProtocolError(RuntimeError):
    pass


def send_msg(sock: socket.socket, obj) -> None:
    payload = json.dumps(obj).encode()
    if len(payload) > MAX_MESSAGE_BYTES:
        raise ProtocolError(f"message of {len(payload)} bytes exceeds the "
                            f"{MAX_MESSAGE_BYTES}-byte frame limit")
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None          # orderly EOF
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock: socket.socket):
    """Read one frame; returns the decoded object or None on clean EOF."""
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    (n,) = _HDR.unpack(hdr)
    if n > MAX_MESSAGE_BYTES:
        raise ProtocolError(f"frame of {n} bytes exceeds the "
                            f"{MAX_MESSAGE_BYTES}-byte limit")
    payload = _recv_exact(sock, n)
    if payload is None:
        raise ProtocolError("connection closed mid-frame")
    return json.loads(payload.decode())
