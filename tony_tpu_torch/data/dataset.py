"""Token datasets: flat token streams backed by memory-mapped binary files
(a copy of the JAX package's data/dataset.py, which is numpy code; the port
keeps its own copy and the same on-disk format).

One flat array of token ids on disk (`<name>.bin`, little-endian
uint16/uint32), memory-mapped at load. No per-example framing: language-model
training reads fixed-length windows, so the OS page cache and sequential
readahead do the work, and a dataset of any size costs O(1) RAM per process.
Writing is append-only via :func:`write_tokens`. Files written here carry a
16-byte TTPU header (dtype + cached max token id); raw headerless streams in
the nanoGPT/llm.c style load via :meth:`TokenDataset.from_raw` with an
explicit dtype.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_MAGIC = b"TTPU"
_VERSION = 1
# header: magic(4) version(4) dtype-code(4) max-token+1(4). The last field
# caches the running max token id (0 = unknown, e.g. files from other
# writers) so vocab validation is O(1) instead of a full-corpus scan.
_HEADER_BYTES = 16
_MAXTOK_OFFSET = 12
_DTYPES = {1: np.uint16, 2: np.uint32}
_DTYPE_CODES = {np.dtype(np.uint16): 1, np.dtype(np.uint32): 2}


def has_ttpu_magic(path: str | Path) -> bool:
    """True iff the file starts with the TTPU magic. Lets callers
    distinguish 'raw headerless stream' (fallback to from_raw) from
    'TTPU file with a bad/unsupported header' (must NOT be reinterpreted
    as raw — the header bytes would decode as garbage tokens)."""
    try:
        with open(path, "rb") as f:
            return f.read(4) == _MAGIC
    except OSError:
        return False


def _read_header_dtype(path: Path) -> np.dtype:
    with open(path, "rb") as f:
        header = f.read(_HEADER_BYTES)
    if len(header) < _HEADER_BYTES or header[:4] != _MAGIC:
        raise ValueError(f"{path} is not a tony-tpu token file")
    version = int.from_bytes(header[4:8], "little")
    if version != _VERSION:
        raise ValueError(
            f"{path}: format version {version} != supported {_VERSION}"
        )
    code = int.from_bytes(header[8:12], "little")
    if code not in _DTYPES:
        raise ValueError(f"{path}: unknown dtype code {code}")
    return np.dtype(_DTYPES[code])


def write_tokens(path: str | Path, tokens, dtype=np.uint16) -> Path:
    """Write (or append to) a token file. Creates the header on first write;
    appends always use the dtype recorded in the existing header (mixing
    widths in one file would corrupt it)."""
    path = Path(path)
    arr = np.asarray(tokens)
    dt = np.dtype(dtype)
    if dt not in _DTYPE_CODES:
        raise ValueError(f"dtype must be uint16 or uint32, got {dt}")
    new = not path.exists()
    if not new:
        dt = _read_header_dtype(path)
    if arr.size and int(arr.min()) < 0:
        raise ValueError(
            f"token id {int(arr.min())} is negative (would wrap to a huge "
            f"unsigned id)"
        )
    if arr.size and int(arr.max()) > np.iinfo(dt).max:
        raise ValueError(
            f"token id {int(arr.max())} exceeds {dt} range"
            + ("; use uint32" if dt == np.uint16 and new else
               f" (file {path} is {dt})")
        )
    with open(path, "ab") as f:
        if new:
            header = (
                _MAGIC
                + _VERSION.to_bytes(4, "little")
                + _DTYPE_CODES[dt].to_bytes(4, "little")
                + b"\x00" * 4
            )
            f.write(header)
        f.write(arr.astype(dt).tobytes())
    if arr.size:
        # keep the cached max-token header field current (stored as max+1;
        # 0 = unknown). max id 2**32-1 can't be encoded as max+1 in 4 bytes,
        # so that corner degrades to unknown (full scan) instead of crashing
        with open(path, "r+b") as f:
            f.seek(_MAXTOK_OFFSET)
            prev = int.from_bytes(f.read(4), "little")
            cur = int(arr.max()) + 1
            if cur >= 2 ** 32:
                cur = 0
            if new or (prev > 0 and (cur > prev or cur == 0)):
                f.seek(_MAXTOK_OFFSET)
                f.write(cur.to_bytes(4, "little"))
    return path


class TokenDataset:
    """A flat token stream; index/slice like an array, tokens come back
    int32 (as the JAX package's loader gives them)."""

    def __init__(self, tokens: np.ndarray, header_max: int | None = None):
        self._tokens = tokens
        self._header_max = header_max  # cached max id from the file header

    @classmethod
    def from_bin(cls, path: str | Path) -> "TokenDataset":
        path = Path(path)
        dt = _read_header_dtype(path)
        with open(path, "rb") as f:
            f.seek(_MAXTOK_OFFSET)
            field = int.from_bytes(f.read(4), "little")
        mm = np.memmap(path, dtype=dt, mode="r", offset=_HEADER_BYTES)
        return cls(mm, header_max=field - 1 if field > 0 else None)

    @classmethod
    def from_raw(cls, path: str | Path, dtype=np.uint16) -> "TokenDataset":
        """Headerless flat token stream (nanoGPT/llm.c style): the whole
        file is one little-endian array of `dtype`. Max token is unknown
        up front, so vocab validation does the chunked scan."""
        dt = np.dtype(dtype)
        if dt not in _DTYPE_CODES:
            raise ValueError(f"dtype must be uint16 or uint32, got {dt}")
        return cls(np.memmap(path, dtype=dt, mode="r"))

    @classmethod
    def from_array(cls, tokens) -> "TokenDataset":
        return cls(np.asarray(tokens))

    def __len__(self) -> int:
        return len(self._tokens)

    def window(self, start: int, length: int) -> np.ndarray:
        """tokens[start : start+length] as int32."""
        return np.asarray(self._tokens[start:start + length], dtype=np.int32)

    def num_windows(self, seq_len: int) -> int:
        """How many non-overlapping (seq_len+1)-token windows fit (each
        window yields seq_len inputs + shifted targets)."""
        return max(0, (len(self._tokens) - 1) // seq_len)

    def split(self, holdout_frac: float) -> tuple["TokenDataset", "TokenDataset"]:
        """(train, holdout) views of the stream — zero-copy memmap slices.
        The holdout is the TAIL of the stream, so growing a corpus by
        appending never leaks future training tokens into old eval sets."""
        if not 0.0 < holdout_frac < 1.0:
            raise ValueError(f"holdout_frac must be in (0, 1), got {holdout_frac}")
        cut = int(len(self._tokens) * (1.0 - holdout_frac))
        return (
            TokenDataset(self._tokens[:cut], header_max=self._header_max),
            TokenDataset(self._tokens[cut:], header_max=self._header_max),
        )

    def max_token(self, chunk: int = 1 << 24) -> int:
        """Max token id over the WHOLE stream. O(1) when the file header
        carries the cached max (files written by write_tokens); otherwise
        one sequential chunked pass over the memmap (O(1) RAM)."""
        if self._header_max is not None:
            return self._header_max
        best = -1
        for lo in range(0, len(self._tokens), chunk):
            part = self._tokens[lo:lo + chunk]
            if len(part):
                best = max(best, int(part.max()))
        return best


__all__ = ["TokenDataset", "write_tokens"]
