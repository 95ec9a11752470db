"""Wire format for the sharded cross-worker history service.

Length-prefixed binary frames over a stream socket: a 4-byte big-endian
payload length followed by the payload. Payloads are msgpack when the
module is available (the container bakes it in), with a pure-JSON
fallback (numpy arrays / bytes base64-encoded) so the protocol never
grows a hard dependency — both ends of a connection run the same build,
so the encodings never have to interoperate.

Numpy arrays travel as ``{"__nd__": [dtype, shape, raw-bytes]}`` and
round-trip bit-exactly — the whole delta-replication scheme rests on a
``SuffixTree.pack()`` export arriving at the worker byte-identical to
the shard's local copy (``pack_to_wire``/``wire_to_pack``).

Messages are plain dicts of scalars / lists / arrays. Problem keys
(str or int) always appear as *values*, never as map keys, so the JSON
fallback cannot silently stringify an int key.
"""

from __future__ import annotations

import base64
import json
import socket
import struct
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.core.suffix_tree import PackedSuffixTree

try:  # baked into the image; the JSON fallback keeps tests dep-free
    import msgpack

    HAVE_MSGPACK = True
except ModuleNotFoundError:  # pragma: no cover - exercised via _use_json
    msgpack = None
    HAVE_MSGPACK = False

# Hard cap on a single frame: a forest delta for one tree is O(window
# tokens); anything near this size indicates a protocol error, not data.
MAX_FRAME = 1 << 30

_ND_KEY = "__nd__"
_BYTES_KEY = "__b64__"


# -- value encoding ---------------------------------------------------------
def _mp_default(obj):
    if isinstance(obj, np.ndarray):
        return {_ND_KEY: [str(obj.dtype), list(obj.shape), obj.tobytes()]}
    if isinstance(obj, np.generic):
        return obj.item()
    raise TypeError(f"unencodable wire value: {type(obj)!r}")


def _mp_object_hook(obj: Dict) -> Any:
    nd = obj.get(_ND_KEY)
    if nd is not None:
        dtype, shape, raw = nd
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
    return obj


def _jsonify(obj):
    """JSON-fallback encoder: arrays/bytes -> base64 dicts, recursively."""
    if isinstance(obj, np.ndarray):
        return {_ND_KEY: [
            str(obj.dtype), list(obj.shape),
            base64.b64encode(obj.tobytes()).decode("ascii"),
        ]}
    if isinstance(obj, (bytes, bytearray)):
        return {_BYTES_KEY: base64.b64encode(bytes(obj)).decode("ascii")}
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    return obj


def _dejsonify(obj):
    if isinstance(obj, dict):
        nd = obj.get(_ND_KEY)
        if nd is not None:
            dtype, shape, b64 = nd
            raw = base64.b64decode(b64)
            return np.frombuffer(raw, np.dtype(dtype)).reshape(shape).copy()
        b = obj.get(_BYTES_KEY)
        if b is not None:
            return base64.b64decode(b)
        return {k: _dejsonify(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_dejsonify(v) for v in obj]
    return obj


def dumps(obj: Any) -> bytes:
    if HAVE_MSGPACK:
        return msgpack.packb(obj, default=_mp_default, use_bin_type=True)
    return json.dumps(_jsonify(obj)).encode("utf-8")


def loads(buf: bytes) -> Any:
    if HAVE_MSGPACK:
        return msgpack.unpackb(
            buf, object_hook=_mp_object_hook, raw=False, strict_map_key=False,
        )
    return _dejsonify(json.loads(buf.decode("utf-8")))


# -- framing ----------------------------------------------------------------
def send_msg(sock: socket.socket, obj: Any) -> None:
    payload = dumps(obj)
    if len(payload) > MAX_FRAME:
        raise ValueError(f"frame too large: {len(payload)} bytes")
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def send_truncated(sock: socket.socket, obj: Any, keep: float = 0.5) -> None:
    """Fault-injection only: send a header promising the full payload
    but deliver a prefix, then let the caller close the socket — the
    peer's ``_recv_exact`` sees EOF mid-frame (a torn frame), exactly
    what a server crash between ``sendall`` calls produces."""
    payload = dumps(obj)
    cut = max(0, min(len(payload) - 1, int(len(payload) * float(keep))))
    sock.sendall(struct.pack(">I", len(payload)) + payload[:cut])


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None  # peer closed
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock: socket.socket) -> Optional[Any]:
    """One framed message; ``None`` on orderly EOF."""
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (n,) = struct.unpack(">I", hdr)
    if n > MAX_FRAME:
        raise ValueError(f"frame too large: {n} bytes")
    payload = _recv_exact(sock, n)
    if payload is None:
        return None
    return loads(payload)


# -- PackedSuffixTree <-> wire ---------------------------------------------
_PACK_ARRAYS = (
    "first_child", "next_sibling", "edge_node", "edge_tok", "edge_child",
    "suffix_link", "edge_start", "edge_len", "first_tok", "best_child",
    "corpus",
)


def pack_to_wire(pk: PackedSuffixTree) -> Dict[str, Any]:
    d: Dict[str, Any] = {f: getattr(pk, f) for f in _PACK_ARRAYS}
    d["n_nodes"] = int(pk.n_nodes)
    d["version"] = int(pk.version)
    d["epoch"] = int(pk.epoch)
    return d


def wire_to_pack(d: Dict[str, Any]) -> PackedSuffixTree:
    return PackedSuffixTree(
        **{f: np.ascontiguousarray(d[f], np.int32) for f in _PACK_ARRAYS},
        n_nodes=int(d["n_nodes"]),
        version=int(d["version"]),
        epoch=int(d["epoch"]),
    )
