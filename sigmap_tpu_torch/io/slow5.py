"""SLOW5/BLOW5 signal file support (capability parity with slow5lib usage in
signal_batch.cc:156-210).

* ASCII .slow5: robust reader/writer (tab-separated, '#'/'@' headers).
* Binary .blow5: reader/writer implemented from the public SLOW5 format
  specification **from memory** (the slow5lib submodule is not vendored and
  this build environment has no network).  The container constants live in
  one place below so they can be corrected against real slow5lib output if a
  mismatch is found; round-tripping through this module is covered by tests.
  Record compression: none/zlib/zstd; signal compression: none/svb-zd
  (StreamVByte over zigzag-delta, implemented in numpy below).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .signals import ReadSignal, dac_to_pa

MAGIC = b"BLOW5\x01"
EOF_MARKER = b"5WOLB"
COMP_NONE, COMP_ZLIB, COMP_ZSTD = 0, 1, 2
SIGCOMP_NONE, SIGCOMP_SVB_ZD = 0, 1
HEADER_FIXED_LEN = 68  # magic(6) ver(3) rec_comp(1) sig_comp(1) ngroups(4) pad


# ---------------------------------------------------------------- svb-zd ----

def zigzag_encode(d: np.ndarray) -> np.ndarray:
    d = d.astype(np.int64)
    return ((d << 1) ^ (d >> 63)).astype(np.uint32)


def zigzag_decode(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.uint64)
    return ((u >> np.uint64(1)) ^ (-(u & np.uint64(1))).astype(np.uint64)).astype(
        np.int64
    )


def svb_encode(values: np.ndarray) -> bytes:
    """StreamVByte encode uint32 values (1-4 bytes each, 2-bit control)."""
    values = values.astype(np.uint32)
    n = len(values)
    nbytes = np.ones(n, np.int64)
    nbytes[values >= (1 << 8)] = 2
    nbytes[values >= (1 << 16)] = 3
    nbytes[values >= (1 << 24)] = 4
    codes = (nbytes - 1).astype(np.uint8)
    ctrl = np.zeros((n + 3) // 4, np.uint8)
    for j in range(4):
        sel = np.arange(j, n, 4)
        ctrl[: len(sel)] |= codes[sel] << (2 * j)
    le = values.astype("<u4").tobytes()  # 4 bytes per value little-endian
    data = bytearray()
    arr = np.frombuffer(le, np.uint8).reshape(n, 4)
    for i in range(n):
        data += arr[i, : nbytes[i]].tobytes()
    return ctrl.tobytes() + bytes(data)


def svb_decode(buf: bytes, n: int) -> np.ndarray:
    ctrl_len = (n + 3) // 4
    ctrl = np.frombuffer(buf[:ctrl_len], np.uint8)
    codes = np.empty(n, np.uint8)
    for j in range(4):
        sel = np.arange(j, n, 4)
        codes[sel] = (ctrl[: len(sel)] >> (2 * j)) & 3
    lens = codes.astype(np.int64) + 1
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    data = np.frombuffer(buf[ctrl_len : ctrl_len + offs[-1]], np.uint8)
    out = np.zeros(n, np.uint32)
    for nb in (1, 2, 3, 4):
        idx = np.nonzero(lens == nb)[0]
        if len(idx) == 0:
            continue
        v = np.zeros(len(idx), np.uint32)
        for b in range(nb):
            v |= data[offs[idx] + b].astype(np.uint32) << (8 * b)
        out[idx] = v
    return out


def svb_zd_encode(signal: np.ndarray) -> bytes:
    x = signal.astype(np.int64)
    d = np.diff(x, prepend=0)
    return svb_encode(zigzag_encode(d))


def svb_zd_decode(buf: bytes, n: int) -> np.ndarray:
    d = zigzag_decode(svb_decode(buf, n))
    return np.cumsum(d).astype(np.int16)


# ----------------------------------------------------------------- binary ---

_REC_FIXED = struct.Struct("<HI")  # read_id_len u16 is first; then id, then:
_REC_BODY = struct.Struct("<IddddQ")  # group, dig, offset, range, rate, len


def _compress(buf: bytes, method: int) -> bytes:
    if method == COMP_NONE:
        return buf
    if method == COMP_ZLIB:
        return zlib.compress(buf)
    if method == COMP_ZSTD:
        import zstandard

        return zstandard.ZstdCompressor().compress(buf)
    raise ValueError(f"unknown compression {method}")


def _decompress(buf: bytes, method: int) -> bytes:
    if method == COMP_NONE:
        return buf
    if method == COMP_ZLIB:
        return zlib.decompress(buf)
    if method == COMP_ZSTD:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(buf)
    raise ValueError(f"unknown compression {method}")


def write_blow5(
    path: str,
    reads: list[dict],
    rec_comp: int = COMP_ZLIB,
    sig_comp: int = SIGCOMP_SVB_ZD,
) -> None:
    """Each read dict: read_id, raw (int16), digitisation, range, offset,
    sampling_rate (optional)."""
    with open(path, "wb") as f:
        hdr = bytearray(HEADER_FIXED_LEN)
        hdr[0:6] = MAGIC
        hdr[6:9] = bytes([1, 0, 0])
        hdr[9] = rec_comp
        hdr[10] = sig_comp
        hdr[11:15] = struct.pack("<I", 1)  # one read group
        f.write(bytes(hdr))
        meta = b"#read_id\tread_group\tdigitisation\toffset\trange\tsampling_rate\tlen_raw_signal\traw_signal\n"
        f.write(struct.pack("<I", len(meta)))
        f.write(meta)
        for r in reads:
            raw = np.asarray(r["raw"], dtype=np.int16)
            rid = r["read_id"].encode()
            if sig_comp == SIGCOMP_SVB_ZD:
                sig = svb_zd_encode(raw)
            else:
                sig = raw.astype("<i2").tobytes()
            body = (
                struct.pack("<H", len(rid))
                + rid
                + _REC_BODY.pack(
                    0,
                    float(r["digitisation"]),
                    float(r["offset"]),
                    float(r["range"]),
                    float(r.get("sampling_rate", 4000.0)),
                    len(raw),
                )
                + struct.pack("<Q", len(sig))
                + sig
            )
            comp = _compress(body, rec_comp)
            f.write(struct.pack("<I", len(comp)))
            f.write(comp)
        f.write(EOF_MARKER)


def read_blow5(
    path: str, pa_lo: float = 30.0, pa_hi: float = 200.0
) -> list[ReadSignal]:
    out: list[ReadSignal] = []
    with open(path, "rb") as f:
        hdr = f.read(HEADER_FIXED_LEN)
        if hdr[0:6] != MAGIC:
            raise ValueError(f"{path}: not a recognized BLOW5 file")
        rec_comp = hdr[9]
        sig_comp = hdr[10]
        (meta_len,) = struct.unpack("<I", f.read(4))
        if len(f.read(meta_len)) != meta_len:
            raise ValueError(f"{path}: truncated BLOW5 header")
        while True:
            lenb = f.read(4)
            if lenb[:4] == EOF_MARKER[:4]:
                break
            if len(lenb) < 4:
                raise ValueError(f"{path}: truncated BLOW5 (missing EOF marker)")
            (rec_len,) = struct.unpack("<I", lenb)
            payload = f.read(rec_len)
            if len(payload) != rec_len:
                raise ValueError(f"{path}: truncated BLOW5 record")
            body = _decompress(payload, rec_comp)
            (id_len,) = struct.unpack_from("<H", body, 0)
            rid = body[2 : 2 + id_len].decode()
            off = 2 + id_len
            _, dig, offset, rng, rate, n = _REC_BODY.unpack_from(body, off)
            off += _REC_BODY.size
            (sig_len,) = struct.unpack_from("<Q", body, off)
            off += 8
            sig = body[off : off + sig_len]
            if sig_comp == SIGCOMP_SVB_ZD:
                raw = svb_zd_decode(sig, n)
            else:
                raw = np.frombuffer(sig, "<i2", count=n)
            out.append(
                ReadSignal(
                    rid, dig, rng, offset,
                    dac_to_pa(raw, dig, rng, offset, pa_lo, pa_hi),
                )
            )
    return out


# ------------------------------------------------------------------ ascii ---

def write_slow5(path: str, reads: list[dict]) -> None:
    with open(path, "w") as f:
        f.write("#slow5_version\t1.0.0\n#num_read_groups\t1\n")
        f.write(
            "#read_id\tread_group\tdigitisation\toffset\trange\t"
            "sampling_rate\tlen_raw_signal\traw_signal\n"
        )
        for r in reads:
            raw = np.asarray(r["raw"], dtype=np.int16)
            f.write(
                f"{r['read_id']}\t0\t{float(r['digitisation'])}\t"
                f"{float(r['offset'])}\t{float(r['range'])}\t"
                f"{float(r.get('sampling_rate', 4000.0))}\t{len(raw)}\t"
                + ",".join(str(int(v)) for v in raw)
                + "\n"
            )


def read_slow5_ascii(
    path: str, pa_lo: float = 30.0, pa_hi: float = 200.0
) -> list[ReadSignal]:
    cols = {
        "read_id": 0, "digitisation": 2, "offset": 3, "range": 4,
        "raw_signal": 7,
    }
    out: list[ReadSignal] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("@"):
                continue
            if line.startswith("#"):
                fields = line[1:].split("\t")
                if "read_id" in fields:
                    cols = {name: i for i, name in enumerate(fields)}
                continue
            parts = line.split("\t")
            rid = parts[cols["read_id"]]
            dig = float(parts[cols["digitisation"]])
            offset = float(parts[cols["offset"]])
            rng = float(parts[cols["range"]])
            raw = np.array(
                [int(v) for v in parts[cols["raw_signal"]].split(",") if v],
                dtype=np.int16,
            )
            out.append(
                ReadSignal(
                    rid, dig, rng, offset,
                    dac_to_pa(raw, dig, rng, offset, pa_lo, pa_hi),
                )
            )
    return out


def read_slow5(path: str, pa_lo: float = 30.0, pa_hi: float = 200.0):
    if path.endswith(".blow5"):
        return read_blow5(path, pa_lo=pa_lo, pa_hi=pa_hi)
    return read_slow5_ascii(path, pa_lo=pa_lo, pa_hi=pa_hi)
