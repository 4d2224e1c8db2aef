"""ctypes bindings of the port's host C++ library (``csrc/host/gdr_native.cpp``,
a copy of ``native/gdr_native.cpp``): the trie packer, the batch hash
tokenizer and the TSV line scanner.

The library is built at first use with the host C++ compiler (``$CXX``, else
``c++``) into ``build/host/libgdr_native-<hash>.so`` under the repository
root, keyed by a hash of the source, the compiler and the flags, so a
changed source rebuilds and an unchanged one loads at once.  The compiler
writes a temporary file that is renamed into place, so processes that build
at the same time never load a half-written library.  A failed build raises
with the compiler's output; nothing falls back.  The pure-Python bodies in
``ops/trie.py`` and ``data/tokenize.py`` are the oracles the tests hold
this library to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "host" / "gdr_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "host"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lib: ctypes.CDLL | None = None


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "c++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(
            f"host C++ compiler {cxx!r} not found (set $CXX): the port's "
            f"host library {SOURCE.name} is built from source at first use")
    return found


def _lib_path(cxx: str) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join([cxx, *CXX_FLAGS]).encode())
    return BUILD_DIR / f"libgdr_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is already built; returns its path.
    Raises with the compiler's output when the build fails."""
    cxx = _compiler()
    out = _lib_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.gdr_build_trie.restype = ctypes.c_int
        lib.gdr_build_trie.argtypes = [
            i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, i32p, u8p, i32p, i32p, i32p, i32p, i64p]
        lib.gdr_hash_tokenize_batch.restype = None
        lib.gdr_hash_tokenize_batch.argtypes = [
            ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, i32p]
        lib.gdr_scan_lines.restype = ctypes.c_int64
        lib.gdr_scan_lines.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.c_int64, i64p]
        _lib = lib
    return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def build_trie_arrays(paths: Sequence[Sequence[int]], kary: int) -> dict:
    """Pack digit paths into BFS-numbered trie arrays: ``children``,
    ``eos_allowed``, ``depth`` and a CSR map (``doc_start`` / ``doc_count``
    into ``doc_indices``) of each terminal node's path rows."""
    lib = _load()
    n = len(paths)
    max_depth = max((len(p) for p in paths), default=1) or 1
    pbuf = np.full((n, max_depth), -1, np.int32)
    lens = np.zeros(n, np.int32)
    for i, p in enumerate(paths):
        pbuf[i, :len(p)] = p
        lens[i] = len(p)
    max_nodes = n * max_depth + 1
    children = np.full((max_nodes, kary), -1, np.int32)
    eos = np.zeros(max_nodes, np.uint8)
    depth = np.zeros(max_nodes, np.int32)
    doc_start = np.zeros(max_nodes, np.int32)
    doc_count = np.zeros(max_nodes, np.int32)
    doc_indices = np.zeros(max(n, 1), np.int32)
    num_nodes = np.zeros(1, np.int64)
    rc = lib.gdr_build_trie(
        _ptr(pbuf, ctypes.c_int32), _ptr(lens, ctypes.c_int32),
        n, max_depth, kary, max_nodes,
        _ptr(children, ctypes.c_int32), _ptr(eos, ctypes.c_uint8),
        _ptr(depth, ctypes.c_int32), _ptr(doc_start, ctypes.c_int32),
        _ptr(doc_count, ctypes.c_int32), _ptr(doc_indices, ctypes.c_int32),
        _ptr(num_nodes, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"gdr_build_trie failed (rc {rc}: -1 node "
                           f"capacity, -2 digit outside [0, {kary}))")
    m = int(num_nodes[0])
    return {
        "children": children[:m].copy(),
        "eos_allowed": eos[:m].astype(bool),
        "depth": depth[:m].copy(),
        "doc_start": doc_start[:m].copy(),
        "doc_count": doc_count[:m].copy(),
        "doc_indices": doc_indices[:n].copy(),
    }


def hash_encode_batch(texts: Sequence[str], max_length: int, vocab_size: int,
                      lower: bool) -> tuple[np.ndarray, np.ndarray]:
    """FNV-1a word-hash ids [len(texts), max_length] and their mask."""
    if vocab_size <= 2 or max_length < 0:
        raise ValueError(f"vocab_size {vocab_size} must exceed 2 and "
                         f"max_length {max_length} be non-negative")
    lib = _load()
    blobs = [t.encode("utf-8") for t in texts]
    offsets = np.zeros(len(blobs) + 1, np.int64)
    offsets[1:] = np.cumsum([len(b) for b in blobs], dtype=np.int64)
    buf = b"".join(blobs)
    ids = np.zeros((len(blobs), max_length), np.int32)
    lib.gdr_hash_tokenize_batch(
        buf, _ptr(offsets, ctypes.c_int64), len(blobs), max_length,
        vocab_size, int(lower), _ptr(ids, ctypes.c_int32))
    return ids, (ids != 0).astype(np.int32)


def scan_lines(data: bytes, max_rows: int = 1 << 30) -> np.ndarray:
    """Byte offsets of each line start, then the end offset."""
    lib = _load()
    max_rows = min(max_rows, data.count(b"\n") + 1)
    offs = np.zeros(max_rows + 1, np.int64)
    n = lib.gdr_scan_lines(data, len(data), max_rows,
                           _ptr(offs, ctypes.c_int64))
    return offs[:n + 1]
