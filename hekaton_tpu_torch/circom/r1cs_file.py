"""iden3 .r1cs / .wtns / JSON-witness readers and writers (BN254 only).

Pure-Python equivalent of circom-compat/src/lib.rs:
 - R1CSFile.read / .write — the binary section format (magic `r1cs`,
   version 1, sections: 1=header, 2=constraints, 3=wire2label; lib.rs:32-157)
 - the header hard-codes the BN254 prime (lib.rs:221-229)
 - read_witness / write_witness — the circom JSON witness list (lib.rs:336-376)
 - read_binary_wtns — the binary `wtns` v2 format (lib.rs:423-467)
 - R1CSFile.generate_constraints — replays the raw rows onto a
   ConstraintSystem (lib.rs:380-413)
 - R1CSFile.from_cs — exports one of our ConstraintSystems (lib.rs:160-186)
"""
from __future__ import annotations

import io
import json
import struct
from dataclasses import dataclass, field

from ..fields.bn254 import R

# LE bytes of the BN254 scalar prime (lib.rs:164-165)
BN254_PRIME_BYTES = R.to_bytes(32, "little")

MAGIC_R1CS = b"r1cs"
MAGIC_WTNS = b"wtns"


@dataclass
class Header:
    field_size: int = 32
    prime_size: bytes = BN254_PRIME_BYTES
    n_wires: int = 0
    n_pub_out: int = 0
    n_pub_in: int = 0
    n_prv_in: int = 0
    n_labels: int = 0
    n_constraints: int = 0


@dataclass
class R1CSFile:
    version: int = 1
    header: Header = field(default_factory=Header)
    # constraints: list of (a, b, c), each a list of (wire_index, coeff)
    constraints: list = field(default_factory=list)
    wire_mapping: list = field(default_factory=list)
    witness: list = field(default_factory=list)

    # -- binary format ------------------------------------------------------

    @classmethod
    def read(cls, data: bytes) -> "R1CSFile":
        r = io.BytesIO(data)
        if r.read(4) != MAGIC_R1CS:
            raise ValueError("invalid magic number")
        version = struct.unpack("<I", r.read(4))[0]
        if version != 1:
            raise ValueError("unsupported version")
        (num_sections,) = struct.unpack("<I", r.read(4))
        sec_offsets, sec_sizes = {}, {}
        for _ in range(num_sections):
            sec_type, sec_size = struct.unpack("<IQ", r.read(12))
            sec_offsets[sec_type] = r.tell()
            sec_sizes[sec_type] = sec_size
            r.seek(sec_size, io.SEEK_CUR)

        r.seek(sec_offsets[1])
        header = cls._read_header(r, sec_sizes[1])
        r.seek(sec_offsets[2])
        constraints = cls._read_constraints(r, header)
        return cls(version, header, constraints, [], [])

    @staticmethod
    def _read_header(r, size: int) -> Header:
        (field_size,) = struct.unpack("<I", r.read(4))
        if field_size != 32:
            raise ValueError("only 32-byte fields supported")
        if size != 32 + field_size:
            raise ValueError("invalid header section size")
        prime = r.read(field_size)
        if prime != BN254_PRIME_BYTES:
            raise ValueError("only bn254 supported")
        n_wires, n_pub_out, n_pub_in, n_prv_in = struct.unpack("<IIII", r.read(16))
        (n_labels,) = struct.unpack("<Q", r.read(8))
        (n_constraints,) = struct.unpack("<I", r.read(4))
        return Header(field_size, prime, n_wires, n_pub_out, n_pub_in, n_prv_in, n_labels, n_constraints)

    @staticmethod
    def _read_constraint_vec(r) -> list:
        (n,) = struct.unpack("<I", r.read(4))
        out = []
        for _ in range(n):
            (idx,) = struct.unpack("<I", r.read(4))
            coeff = int.from_bytes(r.read(32), "little")
            out.append((idx, coeff))
        return out

    @classmethod
    def _read_constraints(cls, r, header: Header) -> list:
        return [
            (
                cls._read_constraint_vec(r),
                cls._read_constraint_vec(r),
                cls._read_constraint_vec(r),
            )
            for _ in range(header.n_constraints)
        ]

    def write(self) -> bytes:
        out = io.BytesIO()
        out.write(MAGIC_R1CS)
        out.write(struct.pack("<I", 1))
        out.write(struct.pack("<I", 3))

        def section(sec_type: int, payload: bytes):
            out.write(struct.pack("<IQ", sec_type, len(payload)))
            out.write(payload)

        h = self.header
        hdr = struct.pack("<I", h.field_size) + h.prime_size
        hdr += struct.pack("<IIII", h.n_wires, h.n_pub_out, h.n_pub_in, h.n_prv_in)
        hdr += struct.pack("<QI", h.n_labels, h.n_constraints)
        section(1, hdr)

        cbuf = io.BytesIO()
        for a, b, c in self.constraints:
            for vec in (a, b, c):
                cbuf.write(struct.pack("<I", len(vec)))
                for idx, coeff in vec:
                    cbuf.write(struct.pack("<I", idx))
                    cbuf.write((coeff % R).to_bytes(32, "little"))
        section(2, cbuf.getvalue())

        mbuf = io.BytesIO()
        for v in self.wire_mapping:
            mbuf.write(struct.pack("<Q", v))
        section(3, mbuf.getvalue())
        return out.getvalue()

    # -- constraint replay / export ----------------------------------------

    def generate_constraints(self, cs):
        """Enforce all rows on a ConstraintSystem (lib.rs:380-413). Wire 0 is
        the constant ONE; wires [1, n_pub_out+n_pub_in] are instance."""
        num_inputs = self.header.n_pub_in + self.header.n_pub_out
        num_aux = self.header.n_wires - num_inputs

        from ..r1cs.builder import var_instance, var_witness

        inst0 = cs.num_instance
        wit0 = cs.num_witness
        for i in range(num_inputs):
            cs.new_input(self.witness[i] % R)
        for i in range(num_aux):
            cs.new_witness(self.witness[i + num_inputs] % R)

        def make_key(index: int) -> int:
            # the reference maps every input wire (incl. wire 0, whose witness
            # value is the constant 1) to a freshly allocated instance variable
            # (lib.rs:396-401); mirror that exactly
            if index < num_inputs:
                return var_instance(inst0 + index)
            return var_witness(wit0 + index - num_inputs)

        def make_lc(vec) -> dict:
            lc: dict = {}
            for idx, coeff in vec:
                k = make_key(idx)
                lc[k] = (lc.get(k, 0) + coeff) % R
            return lc

        if not cs.value_only:  # replayed rows are pure bookkeeping
            for a, b, c in self.constraints:
                cs.enforce(make_lc(a), make_lc(b), make_lc(c))

    @classmethod
    def from_cs(cls, cs) -> "R1CSFile":
        """Export one of our ConstraintSystems (lib.rs:160-186 from_cs_slow).
        Wire order: [ONE, instance..., witness...]."""
        a_rows, b_rows, c_rows = cs.matrices()
        header = Header(
            n_wires=cs.num_instance + cs.num_witness,
            n_pub_out=0,
            n_pub_in=cs.num_instance,
            n_prv_in=cs.num_witness,
            n_labels=0,
            n_constraints=cs.num_constraints,
        )
        constraints = [
            (list(a), list(b), list(c)) for a, b, c in zip(a_rows, b_rows, c_rows)
        ]
        return cls(1, header, constraints, [], cs.full_assignment())


def read_witness(text: str) -> list:
    """circom JSON witness: a JSON list of decimal strings (lib.rs:336-351)."""
    return [int(x) % R for x in json.loads(text)]


def write_witness(witness: list) -> str:
    lines = ["["]
    lines.append(f' "{witness[0] % R}"')
    for v in witness[1:]:
        lines.append(f',"{v % R}"')
    lines.append("]")
    return "\n".join(lines) + "\n"


def read_binary_wtns(data: bytes) -> list:
    """Binary `wtns` v2 reader (lib.rs:423-467)."""
    r = io.BytesIO(data)
    if r.read(4) != MAGIC_WTNS:
        raise ValueError("invalid magic number")
    (version,) = struct.unpack("<I", r.read(4))
    if version != 2:
        raise ValueError("unsupported version")
    (num_sections,) = struct.unpack("<I", r.read(4))
    sec_offsets, sec_sizes = {}, {}
    for _ in range(num_sections):
        sec_type, sec_size = struct.unpack("<IQ", r.read(12))
        sec_offsets[sec_type] = r.tell()
        sec_sizes[sec_type] = sec_size
        r.seek(sec_size, io.SEEK_CUR)
    r.seek(sec_offsets[1])
    (field_size,) = struct.unpack("<I", r.read(4))
    if field_size != 32:
        raise ValueError("only 32-byte fields supported")
    if sec_sizes[1] != 8 + field_size:
        raise ValueError("invalid header section size")
    prime = r.read(field_size)
    if prime != BN254_PRIME_BYTES:
        raise ValueError("only bn254 supported")
    (n_witness,) = struct.unpack("<I", r.read(4))
    r.seek(sec_offsets[2])
    return [int.from_bytes(r.read(32), "little") for _ in range(n_witness)]
