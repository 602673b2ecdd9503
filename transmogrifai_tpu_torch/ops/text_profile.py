"""One-pass text column profile shared by every host consumer of a text
column (port of ``transmogrifai_tpu/ops/text_profile.py``; reference:
RawFeatureFilter.scala:137's presence and hashed value distribution,
SmartTextVectorizer.scala:80-123's TextStats pass, OpHashingTF's
tokenize + hash).

ONE native pass (``native/textprof.cpp``) computes parameter-free per-row
products, cached on the Column instance:

* ``null``/``empty``/``lengths`` — presence and TextStats' length counts
* ``crc`` — the zlib crc32 of each value; ``% text_bins`` bins it for
  RawFeatureFilter
* ``tok_lens``/``tok_hash`` — tokens per row and the full 32-bit FNV-1a of
  each token; ``% num_hashes`` buckets them for any hash width

Rows the native tokenizer defers (non-ASCII: unicode case folding must
match Python's) are spliced from the Python tokenizer.  ``native=False``
takes the pure-Python scan instead, which gives the same products.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass
class InternedValues:
    """First-occurrence-ordered distinct values with counts and row codes.

    ``codes``: -1 null, -2 seen only after the freeze cap, else an index
    into ``uniq``.  ``frozen`` is True when the TextStats freeze engaged
    (counting stopped; ``uniq`` holds cap+1 values)."""

    uniq: List[str]
    counts: np.ndarray       # int64[U]
    codes: np.ndarray        # int32[N]
    cap: int
    frozen: bool

    def value_counts(self) -> Dict[str, int]:
        return {v: int(c) for v, c in zip(self.uniq, self.counts)}


@dataclass
class TextProfile:
    null: np.ndarray         # bool[N]
    empty: np.ndarray        # bool[N]
    lengths: np.ndarray      # int32[N] (code points; 0 for null)
    crc: np.ndarray          # uint32[N] (0 for null)
    tok_lens: np.ndarray     # int32[N]
    tok_hash: np.ndarray     # uint32[total] full FNV-1a per token
    native: bool = True      # how interning is done (the scan's own way)
    _interned: Dict[int, InternedValues] = field(default_factory=dict)
    _strings: Optional[np.ndarray] = None
    _device: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]] = \
        field(default_factory=dict)

    @property
    def presence(self) -> np.ndarray:
        """Present = non-null and non-empty (RawFeatureFilter's rule)."""
        return ~(self.null | self.empty)

    def crc_hist(self, text_bins: int) -> np.ndarray:
        """Hashed whole-value distribution over present rows (crc32 %
        text_bins), RawFeatureFilter's text histogram."""
        bins = (self.crc[self.presence] % np.uint32(text_bins)).astype(
            np.int64)
        return np.bincount(bins, minlength=text_bins).astype(np.float64)

    def length_counts(self) -> Dict[int, int]:
        """≙ TextStats.length_counts (lengths of all non-null values)."""
        ls = self.lengths[~self.null]
        if not ls.size:
            return {}
        uniq, cnt = np.unique(ls, return_counts=True)
        return {int(l): int(c) for l, c in zip(uniq, cnt)}

    def buckets(self, num_hashes: int) -> Tuple[np.ndarray, np.ndarray]:
        """(lens int32[N], flat bucket ids int32[total]) at ``num_hashes``."""
        return (self.tok_lens,
                (self.tok_hash % np.uint32(num_hashes)).astype(np.int32))

    def device_ids(self, num_hashes: int, device: torch.device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The token buckets on ``device`` for ``hash_counts``, cached per
        (width, device): (ids, offsets int64 [N + 1]).  Below 1,024 hashes
        ``ids`` is the packed wire (three 10-bit ids per int32 word,
        ``text.pack_ids3``), else plain int32 ids.  The host array goes out
        from pinned memory without blocking; the offsets (the exclusive
        prefix sum of the per-row token counts) are summed on the device."""
        key = (num_hashes, str(device))
        hit = self._device.get(key)
        if hit is None:
            from .text import pack_ids3
            _, flat = self.buckets(num_hashes)
            ids = torch.from_numpy(pack_ids3(flat, num_hashes)
                                   if num_hashes < 1024 else flat)
            lens = torch.from_numpy(self.tok_lens.astype(np.int64))
            if device.type == "cuda":
                ids, lens = ids.pin_memory(), lens.pin_memory()
            ids = ids.to(device, non_blocking=True)
            lens = lens.to(device, non_blocking=True)
            offsets = torch.zeros(len(self.tok_lens) + 1, dtype=torch.int64,
                                  device=device)
            torch.cumsum(lens, dim=0, out=offsets[1:])
            hit = (ids, offsets)
            self._device[key] = hit
        return hit

    def values(self, cap: int = -1) -> InternedValues:
        """Interned distinct values; ``cap`` >= 0 applies the TextStats
        freeze (counting stops once more than ``cap`` distinct values are
        seen), cap < 0 counts exactly (OneHotEstimator's counts).  A cached
        interning is reused when it is provably the same: an unfrozen
        capped run equals the exact run, and an exact run with U values
        equals any run with cap >= U."""
        if cap in self._interned:
            return self._interned[cap]
        for iv in self._interned.values():
            if not iv.frozen and (cap < 0 or len(iv.uniq) <= cap):
                return iv
        self._interned[cap] = _intern(self._strings, cap, self.native)
        return self._interned[cap]


def _py_scan(strings: Sequence, min_token_len: int = 1) -> TextProfile:
    """Pure-Python scan: the products of native/textprof.cpp ``scan``."""
    from .text import fnv1a_32, tokenize_text

    n = len(strings)
    null = np.zeros(n, bool)
    empty = np.zeros(n, bool)
    lengths = np.zeros(n, np.int32)
    crc = np.zeros(n, np.uint32)
    tok_lens = np.zeros(n, np.int32)
    hashes: List[int] = []
    for i, s in enumerate(strings):
        if s is None:
            null[i] = True
            continue
        lengths[i] = len(s)
        b = s.encode("utf-8")
        if not b:
            empty[i] = True
        crc[i] = zlib.crc32(b)
        toks = tokenize_text(s, min_token_len)
        tok_lens[i] = len(toks)
        hashes.extend(fnv1a_32(t) for t in toks)
    return TextProfile(null, empty, lengths, crc, tok_lens,
                       np.asarray(hashes, np.uint32), native=False)


def _py_intern(strings: Sequence, cap: int) -> InternedValues:
    table: Dict[str, int] = {}
    uniq: List[str] = []
    counts: List[int] = []
    codes = np.empty(len(strings), np.int32)
    for i, s in enumerate(strings):
        if s is None:
            codes[i] = -1
            continue
        # TextStats freeze: counting (inserts and increments alike) happens
        # only while the table holds <= cap distinct values
        can_count = cap < 0 or len(uniq) <= cap
        j = table.get(s)
        if j is not None:
            codes[i] = j
            if can_count:
                counts[j] += 1
            continue
        if not can_count:
            codes[i] = -2
            continue
        j = len(uniq)
        table[s] = j
        uniq.append(s)
        counts.append(1)
        codes[i] = j
    return InternedValues(uniq, np.asarray(counts, np.int64), codes, cap,
                          frozen=cap >= 0 and len(uniq) > cap)


def _intern(strings, cap: int, native: bool) -> InternedValues:
    if not native:
        return _py_intern(strings, cap)
    from .. import native as nat
    uniq, counts, codes = nat.load("textprof").intern(list(strings), cap)
    return InternedValues(list(uniq), counts, codes, cap,
                          frozen=cap >= 0 and len(uniq) > cap)


def scan_strings(strings, min_token_len: int = 1,
                 native: bool = True) -> TextProfile:
    """Profile a string sequence: the native pass (raises when the helper
    cannot be built), or with ``native=False`` the pure-Python scan."""
    from .text import fnv1a_32, tokenize_text

    if not native:
        prof = _py_scan(strings, min_token_len)
    else:
        from .. import native as nat
        d = nat.load("textprof").scan(list(strings), min_token_len)
        lens, hashes, fallback = d["tok_lens"], d["tok_hash"], d["fallback"]
        if fallback:
            # non-ASCII rows: splice the Python tokenizer's hashes in place
            # for exact unicode case-folding parity
            fb = {i: np.asarray([fnv1a_32(t) for t in
                                 tokenize_text(strings[i], min_token_len)],
                                np.uint32) for i in fallback}
            out_lens = lens.copy()
            pieces: List[np.ndarray] = []
            pos = 0
            for i, L in enumerate(lens):
                if L < 0:
                    out_lens[i] = len(fb[i])
                    pieces.append(fb[i])
                elif L:
                    pieces.append(hashes[pos:pos + L])
                    pos += L
            hashes = (np.concatenate(pieces).astype(np.uint32) if pieces
                      else np.zeros(0, np.uint32))
            lens = out_lens
        prof = TextProfile(d["null"].astype(bool), d["empty"].astype(bool),
                           d["lengths"], d["crc"], lens, hashes)
    prof._strings = (strings if isinstance(strings, np.ndarray)
                     else np.asarray(list(strings), dtype=object))
    return prof


def column_profile(col) -> TextProfile:
    """Profile of a text-kind Column (the native pass), computed once and
    cached on the instance (columns are never mutated)."""
    prof = getattr(col, "_text_profile", None)
    if prof is None:
        from .categorical import _col_strings
        prof = scan_strings(_col_strings(col))
        col._text_profile = prof
    return prof
