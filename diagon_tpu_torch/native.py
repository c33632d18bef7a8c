"""Build and load the port's host C++ (``csrc/host/bulk.cpp``).

The synthetic-corpus builder samples, inverts and packs billions of tokens
at the 10M-doc scale, which only native code does in minutes. The source
compiles with the host C++ compiler into ``build/host/`` at the root of the
checkout on first use, named by a hash of the source and the flags, and
loads with ``ctypes``; a file lock makes concurrent first uses (test
workers) build it once. The flags are the JAX package's native build's
(``diagon_tpu/native/__init__.py``) without ``-march=native`` and with
``-ffp-contract=off``, so the token stream does not depend on the host
CPU.

Every function returns plain numpy arrays; nothing here touches a device.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host" / "bulk.cpp"
BUILD_DIR = _PKG.parent / "build" / "host"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden",
             "-ffp-contract=off"]

_P = ctypes.c_void_p
_I = ctypes.c_int
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
}

_lib: Optional[SimpleNamespace] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
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
            cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
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
