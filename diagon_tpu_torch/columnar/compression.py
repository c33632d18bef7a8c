"""Chainable compression codecs: the port's own copy of
``diagon_tpu/columnar/compression.py`` (reference
``compression/CompressionCodecs.h``: None, LZ4, ZSTD, Delta, DoubleDelta,
Gorilla, T64, chainable "Multiple").

Host-side/on-disk only — device-resident columns are raw arrays. Each codec
frames its output with a method byte, like the reference's
``ICompressionCodec``, and writes the JAX package's bytes, so either
package reads a table the other wrote. LZ4 is a block-format
implementation in the port's host library (``csrc/host/store.cpp``,
implemented from the format's public spec); it always runs there, and a
library that fails to build raises. That is a deliberate deviation: the
JAX codec falls back to a literals-only block without its extension. The
Python block parser (``lz4_decompress_reference``) stays as the plain
reference the host decoder is held against; no codec calls it. ZSTD binds
the system ``libzstd`` via ctypes (the same library the reference's
ZSTDCodec wraps, ``CompressionCodecs.h:141``) and is registered only where
that library is found; zlib fills the stronger-entropy role otherwise.
Delta / DoubleDelta / Gorilla(xor) / T64 (bit-packed transpose-free
variant) are the transform stages.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
import zlib
from typing import Dict, List

import numpy as np

from diagon_tpu_torch import native
from diagon_tpu_torch.codecs.bitpack import (
    bits_needed,
    pack_u32,
    unpack_u32_numpy,
)

METHOD_NONE = 0x00
METHOD_ZLIB = 0x01
METHOD_DELTA = 0x02
METHOD_DOUBLE_DELTA = 0x03
METHOD_GORILLA = 0x04
METHOD_T64 = 0x05
METHOD_LZ4 = 0x06
METHOD_ZSTD = 0x07


def _load_libzstd():
    """Bind the system libzstd (simple one-shot API) via ctypes.

    Returns None when the shared library is absent — the codec registry
    then simply omits "zstd" and zlib remains the entropy stand-in.
    """
    name = ctypes.util.find_library("zstd")
    candidates = [name] if name else []
    candidates += ["libzstd.so.1", "libzstd.so"]
    for cand in candidates:
        if not cand:
            continue
        try:
            lib = ctypes.CDLL(cand)
        except OSError:
            continue
        try:
            lib.ZSTD_compressBound.restype = ctypes.c_size_t
            lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
            lib.ZSTD_compress.restype = ctypes.c_size_t
            lib.ZSTD_compress.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
            ]
            lib.ZSTD_decompress.restype = ctypes.c_size_t
            lib.ZSTD_decompress.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t,
            ]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
            return lib
        except AttributeError:
            continue
    return None


_LIBZSTD = _load_libzstd()


class Codec:
    method: int

    def compress(self, data: bytes) -> bytes:
        raise NotImplementedError

    def decompress(self, data: bytes) -> bytes:
        raise NotImplementedError


class NoneCodec(Codec):
    method = METHOD_NONE

    def compress(self, data: bytes) -> bytes:
        return data

    def decompress(self, data: bytes) -> bytes:
        return data


class ZlibCodec(Codec):
    method = METHOD_ZLIB

    def __init__(self, level: int = 1):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decompress(self, data: bytes) -> bytes:
        return zlib.decompress(data)


class DeltaCodec(Codec):
    """int64 delta transform (reference Delta codec)."""

    method = METHOD_DELTA

    def compress(self, data: bytes) -> bytes:
        v = np.frombuffer(data, dtype=np.int64)
        if len(v) == 0:
            return data
        d = np.diff(v, prepend=v[:1])
        d[0] = v[0]
        return d.tobytes()

    def decompress(self, data: bytes) -> bytes:
        d = np.frombuffer(data, dtype=np.int64)
        if len(d) == 0:
            return data
        return np.cumsum(d).tobytes()


class DoubleDeltaCodec(Codec):
    method = METHOD_DOUBLE_DELTA

    def compress(self, data: bytes) -> bytes:
        v = np.frombuffer(data, dtype=np.int64)
        if len(v) < 2:
            return data
        d1 = np.diff(v, prepend=v[:1])
        d1[0] = v[0]
        d2 = np.diff(d1, prepend=d1[:1])
        d2[0] = d1[0]
        return d2.tobytes()

    def decompress(self, data: bytes) -> bytes:
        d2 = np.frombuffer(data, dtype=np.int64)
        if len(d2) < 2:
            return data
        return np.cumsum(np.cumsum(d2)).tobytes()


class GorillaCodec(Codec):
    """XOR-with-previous transform for floats (Gorilla's core idea; the
    entropy stage is left to a chained zlib)."""

    method = METHOD_GORILLA

    def compress(self, data: bytes) -> bytes:
        v = np.frombuffer(data, dtype=np.uint64)
        if len(v) == 0:
            return data
        x = v.copy()
        x[1:] = v[1:] ^ v[:-1]
        return x.tobytes()

    def decompress(self, data: bytes) -> bytes:
        x = np.frombuffer(data, dtype=np.uint64)
        if len(x) == 0:
            return data
        out = np.empty_like(x)
        acc = np.uint64(0)
        # xor-scan; vectorized via cumulative reduce on blocks is possible,
        # but columns decompress granule-at-a-time (8192) so a loop is fine.
        for i in range(len(x)):
            acc = acc ^ x[i]
            out[i] = acc
        return out.tobytes()


def lz4_decompress_reference(block: bytes, out_size: int) -> bytes:
    """Plain Python decoder of one raw LZ4 block (the JAX codec's parser
    without its extension): the reference the host decoder is held against
    in the tests. No codec calls it."""
    out = bytearray()
    ip, n = 0, len(block)
    while ip < n:
        token = block[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = block[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        out += block[ip : ip + lit]
        ip += lit
        if ip >= n:
            break
        offset = block[ip] | (block[ip + 1] << 8)
        ip += 2
        mlen = (token & 0x0F) + 4
        if token & 0x0F == 15:
            while True:
                b = block[ip]
                ip += 1
                mlen += b
                if b != 255:
                    break
        start = len(out) - offset
        for i in range(mlen):  # overlap-safe
            out.append(out[start + i])
    if len(out) != out_size:
        raise ValueError(
            f"lz4: corrupt block ({len(out)} of {out_size} bytes)"
        )
    return bytes(out)


class Lz4Codec(Codec):
    """LZ4 block format (reference ``CompressionCodecs.h`` LZ4Codec, which
    wraps liblz4; here the block format runs in the port's host library,
    ``csrc/host/store.cpp``). Framed with the decoded size (the block
    format itself does not carry it)."""

    method = METHOD_LZ4

    def compress(self, data: bytes) -> bytes:
        size = struct.pack("<I", len(data))
        return size + native.lz4_compress(data)

    def decompress(self, data: bytes) -> bytes:
        (out_size,) = struct.unpack_from("<I", data)
        block = data[4:]
        if out_size == 0:
            return b""
        return native.lz4_decompress(block, out_size)


class ZstdCodec(Codec):
    """ZSTD via the system libzstd (reference ``CompressionCodecs.h:141``
    ZSTDCodec wraps the same library). One-shot simple API; the frame
    carries the content size so no extra length framing is needed."""

    method = METHOD_ZSTD

    def __init__(self, level: int = 3):
        if _LIBZSTD is None:  # pragma: no cover - env without libzstd
            raise RuntimeError("libzstd not available")
        self.level = level

    def compress(self, data: bytes) -> bytes:
        n = len(data)
        bound = _LIBZSTD.ZSTD_compressBound(n)
        dst = ctypes.create_string_buffer(bound)
        written = _LIBZSTD.ZSTD_compress(dst, bound, data, n, self.level)
        if _LIBZSTD.ZSTD_isError(written):
            raise ValueError("zstd: compression failed")
        # frame the decoded size explicitly (like Lz4Codec) so decompress
        # never depends on the frame header's optional content-size field
        return struct.pack("<Q", n) + dst.raw[:written]

    def decompress(self, data: bytes) -> bytes:
        (out_size,) = struct.unpack_from("<Q", data)
        src = data[8:]
        if out_size == 0:
            return b""
        dst = ctypes.create_string_buffer(out_size)
        got = _LIBZSTD.ZSTD_decompress(dst, out_size, src, len(src))
        if _LIBZSTD.ZSTD_isError(got) or got != out_size:
            raise ValueError(
                f"zstd: corrupt frame ({got} of {out_size} bytes)"
            )
        return dst.raw


class T64Codec(Codec):
    """Bit-width reduction for int64 (the role of ClickHouse T64): subtract
    min, pack at the needed width."""

    method = METHOD_T64

    def compress(self, data: bytes) -> bytes:
        v = np.frombuffer(data, dtype=np.int64)
        if len(v) == 0:
            return struct.pack("<qqB", 0, 0, 1)
        lo = int(v.min())
        rel = (v - lo).astype(np.uint64)
        hi = int(rel.max())
        if hi >= (1 << 32):
            # fall back to raw (method framing still applies)
            return struct.pack("<qqB", lo, -1, 64) + v.tobytes()
        bits = bits_needed(hi)
        words = pack_u32(rel, bits)
        return struct.pack("<qqB", lo, len(v), bits) + words.tobytes()

    def decompress(self, data: bytes) -> bytes:
        lo, n, bits = struct.unpack_from("<qqB", data)
        payload = data[17:]
        if n == 0:
            return b""
        if n == -1:
            return payload
        words = np.frombuffer(payload, dtype=np.uint32)
        rel = unpack_u32_numpy(words, bits, n).astype(np.int64)
        return (rel + lo).tobytes()


CODECS: Dict[str, Codec] = {
    "none": NoneCodec(),
    "zlib": ZlibCodec(),
    "lz4": Lz4Codec(),
    "delta": DeltaCodec(),
    "doubledelta": DoubleDeltaCodec(),
    "gorilla": GorillaCodec(),
    "t64": T64Codec(),
}
if _LIBZSTD is not None:
    CODECS["zstd"] = ZstdCodec()

_BY_METHOD = {c.method: c for c in CODECS.values()}


def compress(data: bytes, chain: List[str]) -> bytes:
    """Apply a codec chain (reference "Multiple"); framed with method bytes."""
    out = data
    methods = []
    for name in chain:
        codec = CODECS[name]
        out = codec.compress(out)
        methods.append(codec.method)
    return bytes([len(methods)]) + bytes(methods) + out


def decompress(data: bytes) -> bytes:
    n = data[0]
    methods = data[1 : 1 + n]
    out = data[1 + n :]
    for m in reversed(methods):
        out = _BY_METHOD[m].decompress(out)
    return out
