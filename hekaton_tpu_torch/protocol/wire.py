"""Canonical data-only wire format for coordinator<->worker messages.

The reference moves requests/responses over MPI as arkworks
CanonicalSerialize bytes chunked into fixed 256-byte `Packed` cells with
FIXED-SIZE response slots (mpi-snark/src/lib.rs:9-105) —
responses must have a static size so the gather buffer can be
preallocated. This module is the TPU-native framework's equivalent for the
host-side transport/spill boundary (device-side batches are already
fixed-shape limb tensors in runtime/spmd.py): a fixed little-endian layout
with no code execution on decode — replacing pickle at the one boundary
where artifacts cross between processes (ADVICE.md round 1: pickle is
arbitrary code execution if it ever crosses a trust boundary).

Layouts (all integers little-endian; Fr = 32 bytes; G1/G2 compressed =
32/64 bytes as curves/host.py):

  entry (rom):  addr u64 | val Fr
  entry (ram):  addr u64 | val Fr | timestamp u32 | read u8
  subtrace:     count u32 | entries...
  leaf:         time_eval Fr | addr_eval Fr | nchal u8 | challenges... | entry
  path:         leaf_index u32 | depth u8 | siblings (depth x Fr)
  stage0 req:   HDR | idx u32 | time_subtrace | addr_subtrace
  stage0 resp:  HDR | idx u32 | com G1c | seed 32B            (FIXED SIZE)
  stage1 req:   HDR | idx u32 | leaf | path | root Fr | wlen u32 | witness
                | plen u32 | params-json
  stage1 resp:  HDR | idx u32 | a G1c | b G2c | c G1c | nds u8 | ds...
                                                     (FIXED SIZE given nds)

HDR = magic u32 "HKWR" | version u8 | msg_type u8 | mem_type u8 | pad u8.
"""
from __future__ import annotations

import json
import struct

from ..cpgroth16.data_structures import Proof
from ..curves import host as ch
from .coordinator import Stage0Request, Stage1Request
from .eval_tree import ExecTreeLeaf, MerklePath
from .transcript import (
    RAM,
    ROM,
    RamTranscriptEntry,
    RamRunningEvaluation,
    RomTranscriptEntry,
    RomRunningEvaluation,
)
from .worker import Stage0Response, Stage1Response

MAGIC = 0x52574B48  # "HKWR"
VERSION = 1
MSG_STAGE0_REQ, MSG_STAGE0_RESP, MSG_STAGE1_REQ, MSG_STAGE1_RESP = 0, 1, 2, 3
_MEM = {ROM: 0, RAM: 1}
_MEM_INV = {v: k for k, v in _MEM.items()}

FR_BYTES = 32
G1C_BYTES = 32
G2C_BYTES = 64
HDR = struct.Struct("<IBBBB")


def _hdr(msg_type: int, mem_type: str) -> bytes:
    return HDR.pack(MAGIC, VERSION, msg_type, _MEM[mem_type], 0)


def _check_hdr(data: bytes, msg_type: int):
    magic, ver, mt, mem, _ = HDR.unpack_from(data, 0)
    if magic != MAGIC or ver != VERSION:
        raise ValueError("bad wire header")
    if mt != msg_type:
        raise ValueError(f"wrong message type {mt} != {msg_type}")
    return _MEM_INV[mem], HDR.size


def _fr(x: int) -> bytes:
    return ch.fr_to_bytes(x)


def _entry_to_bytes(e, mem_type: str) -> bytes:
    if mem_type == ROM:
        return struct.pack("<Q", e.addr) + _fr(e.val)
    return struct.pack("<Q", e.addr) + _fr(e.val) + struct.pack("<IB", e.timestamp, int(e.read))


def _entry_size(mem_type: str) -> int:
    return 8 + FR_BYTES + (5 if mem_type == RAM else 0)


def _entry_from(data: bytes, off: int, mem_type: str):
    (addr,) = struct.unpack_from("<Q", data, off)
    val = ch.fr_from_bytes(data[off + 8 : off + 8 + FR_BYTES])
    if mem_type == ROM:
        return RomTranscriptEntry(addr, val), off + _entry_size(ROM)
    ts, rd = struct.unpack_from("<IB", data, off + 8 + FR_BYTES)
    return RamTranscriptEntry(addr, val, ts, bool(rd)), off + _entry_size(RAM)


def _subtrace_to_bytes(st: list, mem_type: str) -> bytes:
    return struct.pack("<I", len(st)) + b"".join(_entry_to_bytes(e, mem_type) for e in st)


def _subtrace_from(data: bytes, off: int, mem_type: str):
    (n,) = struct.unpack_from("<I", data, off)
    off += 4
    out = []
    for _ in range(n):
        e, off = _entry_from(data, off, mem_type)
        out.append(e)
    return out, off


def _leaf_to_bytes(leaf: ExecTreeLeaf, mem_type: str) -> bytes:
    ev = leaf.evals
    chals = list(ev.challenges) if ev.challenges else []
    return (
        _fr(ev.time_ordered_eval)
        + _fr(ev.addr_ordered_eval)
        + struct.pack("<B", len(chals))
        + b"".join(_fr(c) for c in chals)
        + _entry_to_bytes(leaf.last_subtrace_entry, mem_type)
    )


def _leaf_from(data: bytes, off: int, mem_type: str):
    t = ch.fr_from_bytes(data[off : off + FR_BYTES])
    a = ch.fr_from_bytes(data[off + FR_BYTES : off + 2 * FR_BYTES])
    off += 2 * FR_BYTES
    (nch,) = struct.unpack_from("<B", data, off)
    off += 1
    chals = []
    for _ in range(nch):
        chals.append(ch.fr_from_bytes(data[off : off + FR_BYTES]))
        off += FR_BYTES
    entry, off = _entry_from(data, off, mem_type)
    cls = RomRunningEvaluation if mem_type == ROM else RamRunningEvaluation
    evals = cls(t, a, tuple(chals) if chals else None)
    return ExecTreeLeaf(evals, entry), off


def _params_to_json(params) -> bytes:
    d = {}
    for k, v in vars(params).items():
        d[k] = {"__hex__": v.hex()} if isinstance(v, (bytes, bytearray)) else v
    return json.dumps(d, sort_keys=True).encode()


def params_from_json(params_cls, blob: bytes):
    d = json.loads(blob.decode())
    for k, v in d.items():
        if isinstance(v, dict) and "__hex__" in v:
            d[k] = bytes.fromhex(v["__hex__"])
    return params_cls(**d)


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------


def stage0_request_to_bytes(req: Stage0Request, mem_type: str) -> bytes:
    return (
        _hdr(MSG_STAGE0_REQ, mem_type)
        + struct.pack("<I", req.subcircuit_idx)
        + _subtrace_to_bytes(req.time_ordered_subtrace, mem_type)
        + _subtrace_to_bytes(req.addr_ordered_subtrace, mem_type)
    )


def stage0_request_from_bytes(data: bytes) -> Stage0Request:
    mem_type, off = _check_hdr(data, MSG_STAGE0_REQ)
    (idx,) = struct.unpack_from("<I", data, off)
    t, off = _subtrace_from(data, off + 4, mem_type)
    a, off = _subtrace_from(data, off, mem_type)
    return Stage0Request(idx, t, a)


STAGE0_RESPONSE_SIZE = HDR.size + 4 + G1C_BYTES + 32  # fixed slot


def stage0_response_to_bytes(resp: Stage0Response, mem_type: str = ROM) -> bytes:
    out = (
        _hdr(MSG_STAGE0_RESP, mem_type)
        + struct.pack("<I", resp.subcircuit_idx)
        + ch.g1_to_bytes_compressed(resp.com)
        + bytes(resp.com_seed)
    )
    assert len(out) == STAGE0_RESPONSE_SIZE
    return out


def stage0_response_from_bytes(data: bytes) -> Stage0Response:
    _, off = _check_hdr(data, MSG_STAGE0_RESP)
    (idx,) = struct.unpack_from("<I", data, off)
    off += 4
    com = ch.g1_from_bytes_compressed(data[off : off + G1C_BYTES])
    seed = data[off + G1C_BYTES : off + G1C_BYTES + 32]
    return Stage0Response(idx, com, seed)


def stage1_request_to_bytes(req: Stage1Request, mem_type: str) -> bytes:
    path = req.next_leaf_membership
    wit = req.serialized_witnesses or b""
    pj = _params_to_json(req.circ_params)
    return (
        _hdr(MSG_STAGE1_REQ, mem_type)
        + struct.pack("<I", req.subcircuit_idx)
        + _leaf_to_bytes(req.cur_leaf, mem_type)
        + struct.pack("<IB", path.leaf_index, len(path.auth_path))
        + b"".join(_fr(s) for s in path.auth_path)
        + _fr(req.root)
        + struct.pack("<I", len(wit))
        + wit
        + struct.pack("<I", len(pj))
        + pj
    )


def stage1_request_from_bytes(data: bytes, params_cls) -> Stage1Request:
    mem_type, off = _check_hdr(data, MSG_STAGE1_REQ)
    (idx,) = struct.unpack_from("<I", data, off)
    leaf, off = _leaf_from(data, off + 4, mem_type)
    li, depth = struct.unpack_from("<IB", data, off)
    off += 5
    auth = []
    for _ in range(depth):
        auth.append(ch.fr_from_bytes(data[off : off + FR_BYTES]))
        off += FR_BYTES
    root = ch.fr_from_bytes(data[off : off + FR_BYTES])
    off += FR_BYTES
    (wlen,) = struct.unpack_from("<I", data, off)
    off += 4
    wit = data[off : off + wlen]
    off += wlen
    (plen,) = struct.unpack_from("<I", data, off)
    off += 4
    params = params_from_json(params_cls, data[off : off + plen])
    return Stage1Request(idx, leaf, MerklePath(li, auth), root, wit, params)


def stage1_response_size(n_ds: int) -> int:
    """Fixed response slot size given the proof's committed-stage count —
    the property the reference's gather buffers rely on (lib.rs:33-55)."""
    return HDR.size + 4 + G1C_BYTES + G2C_BYTES + G1C_BYTES + 1 + n_ds * G1C_BYTES


def stage1_response_to_bytes(resp: Stage1Response, mem_type: str = ROM) -> bytes:
    p = resp.proof
    out = (
        _hdr(MSG_STAGE1_RESP, mem_type)
        + struct.pack("<I", resp.subcircuit_idx)
        + ch.g1_to_bytes_compressed(p.a)
        + ch.g2_to_bytes_compressed(p.b)
        + ch.g1_to_bytes_compressed(p.c)
        + struct.pack("<B", len(p.ds))
        + b"".join(ch.g1_to_bytes_compressed(d) for d in p.ds)
    )
    assert len(out) == stage1_response_size(len(p.ds))
    return out


def stage1_response_from_bytes(data: bytes) -> Stage1Response:
    _, off = _check_hdr(data, MSG_STAGE1_RESP)
    (idx,) = struct.unpack_from("<I", data, off)
    off += 4
    a = ch.g1_from_bytes_compressed(data[off : off + G1C_BYTES])
    off += G1C_BYTES
    b = ch.g2_from_bytes_compressed(data[off : off + G2C_BYTES])
    off += G2C_BYTES
    c = ch.g1_from_bytes_compressed(data[off : off + G1C_BYTES])
    off += G1C_BYTES
    (nds,) = struct.unpack_from("<B", data, off)
    off += 1
    ds = []
    for _ in range(nds):
        ds.append(ch.g1_from_bytes_compressed(data[off : off + G1C_BYTES]))
        off += G1C_BYTES
    return Stage1Response(idx, Proof(a, b, c, ds))
