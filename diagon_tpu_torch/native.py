"""Build and load the port's host C++ (``csrc/host/bulk.cpp``,
``csrc/host/store.cpp`` and ``csrc/host/ingest.cpp``).

The synthetic-corpus builder samples, inverts and packs billions of tokens
at the 10M-doc scale, which only native code does in minutes; the store
tier decodes freqs and positions of segments read from disk, and the
columnar codecs compress LZ4 blocks; the write path tokenizes and
accumulates postings (``standard_tokenize_ascii``, ``FreqProx``). The
sources compile with the host C++ compiler into one library under
``build/host/`` at the root of the checkout on first use, named by a hash of the sources and the flags, and
load with ``ctypes``; a file lock makes concurrent first uses (test
workers) build it once. A failed build raises: nothing falls back. The
flags are the JAX package's native build's
(``diagon_tpu/native/__init__.py``) without ``-march=native`` and with
``-ffp-contract=off``, so the token stream does not depend on the host
CPU.

Every function returns numpy arrays or Python strings; nothing here touches
a device.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import weakref
from pathlib import Path
from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCES = [_PKG / "csrc" / "host" / n
           for n in ("bulk.cpp", "store.cpp", "ingest.cpp")]
BUILD_DIR = _PKG.parent / "build" / "host"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden",
             "-ffp-contract=off"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_D = ctypes.c_double
_SIGNATURES = {
    "diagon_free": ([_P], None),
    "diagon_synth_tokens": (
        [_I64, ctypes.c_uint64, _P, _I64, _I, _D, _D, _I64, _P, _P, _I64, _D,
         _P, _P, _P, _P], _I),
    "diagon_invert_tokens": ([_P, _I64, _P, _I64, _I64, _P, _P, _P, _P, _P],
                             _I),
    "diagon_pack_blocks": ([_P, _I64, _P, _P, _I64, _P] + [_P] * 15, _I),
    "diagon_decode_freqs": ([_P, _P, _P, _P, _I64, _P, _P], _I),
    "diagon_positions_from_deltas": ([_P, _P, _I64, _P, _I64, _P], _I),
    "diagon_lz4_compress": ([_P, _I64, _P, _P], _I),
    "diagon_lz4_decompress": ([_P, _I64, _P, _I64], _I),
    "diagon_tokenize_ascii": ([_P, _I64, _P, _P, _P], _I),
    "diagon_fp_new": ([], _P),
    "diagon_fp_free": ([_P], None),
    "diagon_fp_add_documents": ([_P, _I32, _P, _P, _I64, _I, _P], _I),
    "diagon_fp_add_keywords": ([_P, _I32, _P, _P, _I64], _I64),
    "diagon_fp_ram_bytes": ([_P], _I64),
    "diagon_fp_num_terms": ([_P], _I64),
    "diagon_fp_finish": ([_P, _I] + [_P] * 14, _I),
}

_lib: Optional[SimpleNamespace] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbulk_{h.hexdigest()[:16]}.so"


def _cxx() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) on PATH")


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if so.exists():  # another process built it while we waited
                return
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=600)
            if res.returncode != 0:
                raise RuntimeError(f"host build failed ({res.returncode}): "
                                   f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
            os.replace(tmp, so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def library() -> SimpleNamespace:
    """The functions of ``_SIGNATURES``, built on first use."""
    global _lib
    if _lib is None:
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        fns = {}
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
            fns[name] = fn
        _lib = SimpleNamespace(**fns, handle=lib)
    return _lib


def _ptr(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data


def _take(lib, ptr: ctypes.c_void_p, n: int, dtype) -> np.ndarray:
    """Copy ``n`` elements of a malloc'd native array into numpy, then free
    it."""
    out = np.empty(n, dtype=dtype)
    if n:
        ctypes.memmove(out.ctypes.data, ptr, out.nbytes)
    lib.diagon_free(ptr)
    return out


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise MemoryError(f"{what}: the host could not allocate its output")


def synth_tokens(num_docs: int, seed: int, probs: np.ndarray, len_kind: int,
                 len_a: float, len_b: float, min_len: int,
                 phrase_flat: np.ndarray, phrase_start: np.ndarray,
                 phrase_prob: float, remap: Optional[np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(doc_len i32 [num_docs], token ids i32 [sum(doc_len)]) of one field,
    sampled as ``_native.synth_tokens`` samples it."""
    lib = library()
    probs = np.ascontiguousarray(probs, np.float64)
    pflat = np.ascontiguousarray(phrase_flat, np.int32)
    pstart = np.ascontiguousarray(phrase_start, np.int32)
    if remap is not None:
        remap = np.ascontiguousarray(remap, np.int32)
        if len(remap) != len(probs):
            raise ValueError("remap must have one entry per vocabulary rank")
    doc_len = np.empty(num_docs, np.int32)
    tok = ctypes.c_void_p()
    n_tok = ctypes.c_int64()
    _check(lib.diagon_synth_tokens(
        num_docs, seed, _ptr(probs), len(probs), len_kind, len_a, len_b,
        min_len, _ptr(pflat), _ptr(pstart), max(0, len(pstart) - 1),
        phrase_prob, _ptr(remap), _ptr(doc_len), ctypes.byref(tok),
        ctypes.byref(n_tok)), "synth_tokens")
    return doc_len, _take(lib, tok, n_tok.value, np.int32)


def invert_tokens(doc_len: np.ndarray, tokens: np.ndarray, vocab_size: int,
                  with_positions: bool):
    """(entry_start i64 [V+1], docs i32 [NE], freqs i32 [NE], positions i32
    [T] or None): ``_native.invert_tokens``' counting sort."""
    lib = library()
    doc_len = np.ascontiguousarray(doc_len, np.int32)
    tokens = np.ascontiguousarray(tokens, np.int32)
    if int(doc_len.sum(dtype=np.int64)) != len(tokens):
        raise ValueError("doc_len must sum to the token count")
    if len(tokens) and not (0 <= tokens.min() and tokens.max() < vocab_size):
        raise ValueError("token ids must lie in [0, vocab_size)")
    entry_start = np.empty(vocab_size + 1, np.int64)
    positions = np.empty(len(tokens), np.int32) if with_positions else None
    docs, freqs = ctypes.c_void_p(), ctypes.c_void_p()
    ne = ctypes.c_int64()
    _check(lib.diagon_invert_tokens(
        _ptr(doc_len), len(doc_len), _ptr(tokens), len(tokens), vocab_size,
        _ptr(positions), _ptr(entry_start), ctypes.byref(docs),
        ctypes.byref(freqs), ctypes.byref(ne)), "invert_tokens")
    return (entry_start, _take(lib, docs, ne.value, np.int32),
            _take(lib, freqs, ne.value, np.int32), positions)


def pack_blocks(entry_start: np.ndarray, docs: np.ndarray, freqs: np.ndarray,
                norms: Optional[np.ndarray]) -> dict:
    """``_native.pack_blocks``: the block columns, the packed word stream
    (u32), max_window, doc_freq and total_tf, by name."""
    lib = library()
    entry_start = np.ascontiguousarray(entry_start, np.int64)
    docs = np.ascontiguousarray(docs, np.int32)
    freqs = np.ascontiguousarray(freqs, np.int32)
    T = len(entry_start) - 1
    NE = len(docs)
    if T < 0 or entry_start[0] != 0 or entry_start[-1] != NE or len(freqs) != NE:
        raise ValueError("entry_start must be a CSR over docs and freqs")
    if norms is not None:
        norms = np.ascontiguousarray(norms, np.uint8)
        if NE and int(docs.max()) >= len(norms):
            raise ValueError("a docid lies beyond the norms")
    NB = int(((np.diff(entry_start) + 127) // 128).sum())
    out = {
        "block_start": np.empty(T + 1, np.int32),
        "doc_freq": np.empty(T, np.int32),
        "total_tf": np.empty(T, np.int64),
    }
    cols = ("block_term", "block_base", "block_count", "block_doc_bits",
            "block_freq_bits", "block_word_off", "block_max_freq",
            "block_max_norm")
    for name in cols:
        out[name] = np.empty(NB, np.int32)
    out["block_entry_start"] = np.empty(NB + 1, np.int64)
    packed = ctypes.c_void_p()
    n_words, max_window = ctypes.c_int64(), ctypes.c_int64()
    _check(lib.diagon_pack_blocks(
        _ptr(entry_start), T, _ptr(docs), _ptr(freqs), NE, _ptr(norms),
        _ptr(out["block_start"]), _ptr(out["doc_freq"]), _ptr(out["total_tf"]),
        *[_ptr(out[n]) for n in cols], _ptr(out["block_entry_start"]),
        ctypes.byref(packed), ctypes.byref(n_words), ctypes.byref(max_window),
    ), "pack_blocks")
    out["packed"] = _take(lib, packed, n_words.value, np.uint32)
    out["max_window"] = int(max_window.value)
    return out


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def decode_freqs(block_count, block_doc_bits, block_freq_bits,
                 block_word_off, packed) -> np.ndarray:
    """Every block's freqs, i32 [sum(block_count)] in segment posting
    order (``_native.decode_freqs``)."""
    lib = library()
    count, dbits, fbits, woff = (_i32(a) for a in (
        block_count, block_doc_bits, block_freq_bits, block_word_off))
    packed = np.ascontiguousarray(packed, np.uint32)
    nb = len(count)
    if not len(dbits) == len(fbits) == len(woff) == nb:
        raise ValueError("the block columns must have one entry a block")
    if nb:
        ends = (woff.astype(np.int64)
                + ((count.astype(np.int64) * dbits + 31) >> 5)
                + ((count.astype(np.int64) * fbits + 31) >> 5))
        if int(ends.max()) + 1 > len(packed):
            raise ValueError("a block's words lie beyond the packed stream")
    freqs = np.empty(int(count.sum(dtype=np.int64)), np.int32)
    lib.diagon_decode_freqs(_ptr(count), _ptr(dbits), _ptr(fbits),
                            _ptr(woff), nb, _ptr(packed), _ptr(freqs))
    return freqs


def positions_from_deltas(lo: bytes, hi: bytes, freqs) -> np.ndarray:
    """Absolute positions i32 [len(lo)] from the low and high byte planes
    of per-entry u16 deltas (``_native.positions_from_deltas``)."""
    lib = library()
    lo_a = np.frombuffer(lo, np.uint8)
    hi_a = np.frombuffer(hi, np.uint8)
    freqs = _i32(freqs)
    if len(lo_a) != len(hi_a):
        raise ValueError("the byte planes differ in length")
    pos = np.empty(len(lo_a), np.int32)
    if lib.diagon_positions_from_deltas(_ptr(lo_a), _ptr(hi_a), len(lo_a),
                                        _ptr(freqs), len(freqs), _ptr(pos)):
        raise ValueError("the freqs do not sum to the number of positions")
    return pos


def lz4_compress(data: bytes) -> bytes:
    """One raw LZ4 block of ``data`` (``_native.lz4_compress``)."""
    lib = library()
    src = np.frombuffer(data, np.uint8)
    out, n = ctypes.c_void_p(), ctypes.c_int64()
    _check(lib.diagon_lz4_compress(_ptr(src), len(src), ctypes.byref(out),
                                   ctypes.byref(n)), "lz4_compress")
    return _take(lib, out, n.value, np.uint8).tobytes()


def lz4_decompress(block: bytes, out_size: int) -> bytes:
    """Decode one raw LZ4 block into exactly ``out_size`` bytes
    (``_native.lz4_decompress``); ValueError on a corrupt block."""
    lib = library()
    src = np.frombuffer(block, np.uint8)
    out = np.empty(out_size, np.uint8)
    if lib.diagon_lz4_decompress(_ptr(src), len(src), _ptr(out), out_size):
        raise ValueError(f"lz4_decompress: corrupt block (not {out_size} "
                         "bytes)")
    return out.tobytes()


def _blob(texts: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    """UTF-8 bytes of ``texts`` end to end, and int64 offsets [n+1]."""
    joined = "".join(texts)
    blob = joined.encode()
    if len(blob) == len(joined):  # all ASCII: one byte a character
        lens = [len(t) for t in texts]
    else:
        enc = [t.encode() for t in texts]
        blob, lens = b"".join(enc), [len(b) for b in enc]
    offs = np.zeros(len(texts) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return blob, offs


def _split(blob: bytes, offs: np.ndarray) -> List[str]:
    o = offs.tolist()
    return [blob[o[i]:o[i + 1]].decode() for i in range(len(o) - 1)]


def standard_tokenize_ascii(text: str) -> List[str]:
    """The lowercased tokens of ASCII ``text``: a token starts at an ASCII
    alphanumeric and runs over alphanumerics and apostrophes
    (``_native.standard_tokenize_ascii``)."""
    lib = library()
    data = text.encode()
    blob, offs, n = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_int64()
    _check(lib.diagon_tokenize_ascii(data, len(data), ctypes.byref(blob),
                                     ctypes.byref(offs), ctypes.byref(n)),
           "tokenize_ascii")
    o = _take(lib, offs, n.value + 1, np.int64)
    return _split(_take(lib, blob, int(o[-1]), np.uint8).tobytes(), o)


class FreqProx:
    """One field's postings accumulator on the host (``_native.FreqProx``):
    documents and keywords in, sorted CSR postings out. Not thread-safe:
    its owner serialises the calls (the writer's mutex)."""

    def __init__(self):
        self._lib = library()
        self._h = self._lib.diagon_fp_new()
        if not self._h:
            raise MemoryError("FreqProx: the host could not allocate it")
        self._free = weakref.finalize(self, self._lib.diagon_fp_free, self._h)

    def add_document(self, doc_id: int, text: str,
                     with_positions: bool) -> int:
        """Tokenize and add one document's text; its token count."""
        return int(self.add_documents(doc_id, [text], with_positions)[0])

    def add_documents(self, doc_id0: int, texts: Sequence[str],
                      with_positions: bool) -> np.ndarray:
        """Text k becomes doc ``doc_id0 + k``; i32 token counts [n]."""
        blob, offs = _blob(texts)
        counts = np.empty(len(texts), np.int32)
        _check(self._lib.diagon_fp_add_documents(
            self._h, doc_id0, blob, _ptr(offs), len(texts),
            int(bool(with_positions)), _ptr(counts)), "FreqProx.add_documents")
        return counts

    def add_keywords(self, doc_id0: int,
                     values: Sequence[Optional[str]]) -> int:
        """Value k, one case-sensitive term, goes to doc ``doc_id0 + k``;
        None or "" means the doc lacks the field. The number of docs with
        the field."""
        blob, offs = _blob(["" if v is None else v for v in values])
        n = self._lib.diagon_fp_add_keywords(self._h, doc_id0, blob,
                                             _ptr(offs), len(values))
        if n < 0:
            raise MemoryError("FreqProx.add_keywords: the host could not "
                              "allocate")
        return int(n)

    def ram_bytes(self) -> int:
        return int(self._lib.diagon_fp_ram_bytes(self._h))

    def num_terms(self) -> int:
        return int(self._lib.diagon_fp_num_terms(self._h))

    def finish(self, with_positions: bool) -> dict:
        """The postings by name: ``terms`` (sorted by their UTF-8 bytes),
        ``entry_start`` i64 [T+1] into ``docs``/``freqs`` i32, ``pos_start``
        i64 [NE+1] into ``positions`` i32 (empty without positions), and
        ``field_docs``/``field_lens`` i32: the docs with the field and
        their token counts."""
        lib = self._lib
        p = [ctypes.c_void_p() for _ in range(9)]
        blob_len, T, NE, NP, ND = (ctypes.c_int64() for _ in range(5))
        blob, toffs, estart, docs, freqs, pstart, pos, fdocs, flens = p
        _check(lib.diagon_fp_finish(
            self._h, int(bool(with_positions)), ctypes.byref(blob),
            ctypes.byref(blob_len), ctypes.byref(toffs), ctypes.byref(T),
            ctypes.byref(estart), ctypes.byref(docs), ctypes.byref(freqs),
            ctypes.byref(NE), ctypes.byref(pstart), ctypes.byref(pos),
            ctypes.byref(NP), ctypes.byref(fdocs), ctypes.byref(flens),
            ctypes.byref(ND)), "FreqProx.finish")
        toffs_a = _take(lib, toffs, T.value + 1, np.int64)
        n_pstart = NE.value + 1 if with_positions else 0
        return {
            "terms": _split(_take(lib, blob, blob_len.value,
                                  np.uint8).tobytes(), toffs_a),
            "entry_start": _take(lib, estart, T.value + 1, np.int64),
            "docs": _take(lib, docs, NE.value, np.int32),
            "freqs": _take(lib, freqs, NE.value, np.int32),
            "pos_start": _take(lib, pstart, n_pstart, np.int64),
            "positions": _take(lib, pos, NP.value, np.int32),
            "field_docs": _take(lib, fdocs, ND.value, np.int32),
            "field_lens": _take(lib, flens, ND.value, np.int32),
        }
