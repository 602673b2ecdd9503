"""Text vectorization (port of ``transmogrifai_tpu/ops/text.py``'s
SmartTextVectorizer and hashing; reference: SmartTextVectorizer.scala:61,
TextTokenizer.scala, OpHashingTF.scala).

Tokenizing and hashing happen on the host, once per column, in the cached
profile's native pass (``text_profile.py``): strings never reach the device.
The token buckets cross to the device as the packed wire (three 10-bit ids
per int32 word below 1,024 hashes) and the ``hash_counts`` kernel
(``text_kernels.py``) writes the [N, H] counts, with the null indicator,
straight into their columns of the vectorizer's output.  Hashing is a stable
32-bit FNV-1a of the lowered token's UTF-8 bytes, mod ``num_hashes``.

The SmartTextVectorizer decision (cardinality <= max → pivot one-hot,
ID-like → ignore, else hash) is made at fit time from one TextStats pass.
With ``sparse_hashing="auto"`` a vectorizer that hashes into 4,096 or more
buckets outputs a ``SparseMatrix`` instead (the host dedupes the bucket
stream, ``sparse/transform.py``): the dense [N, num_hashes] block is never
built.  The JAX package's staged (fused) transform comes with a later slice.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columns import Column, ColumnBatch
from ..stages.base import Estimator, TransformerModel
from ..types import OPVector
from ..vector_meta import (NULL_INDICATOR, OTHER_INDICATOR, VectorColumnMeta,
                           VectorMeta)
from .categorical import encode_column, top_values_by_count
from .text_kernels import hash_counts

_TOKEN_RE = re.compile(r"[A-Za-z0-9_']+")

# hash spaces this wide vectorize as a SparseMatrix under sparse_hashing="auto"
SPARSE_MIN_HASHES = 4096


def fnv1a_32(s: str) -> int:
    """Stable 32-bit FNV-1a of the string's UTF-8 bytes."""
    h = 2166136261
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


def tokenize_text(s: Optional[str], min_token_length: int = 1,
                  to_lowercase: bool = True) -> List[str]:
    """Language-agnostic tokenizer (≙ TextTokenizer with the default
    analyzer: lowercase, split on anything but [A-Za-z0-9_'])."""
    if s is None:
        return []
    if to_lowercase:
        s = s.lower()
    return [t for t in _TOKEN_RE.findall(s) if len(t) >= min_token_length]


def hash_tokens_flat(token_lists: Sequence[Sequence[str]], num_hashes: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Token lists → (lens [N] int32, flat bucket ids [total] int32); each
    distinct token hashes once."""
    n = len(token_lists)
    lens = np.fromiter((len(t) for t in token_lists), np.int32, count=n)
    total = int(lens.sum())
    if not total:
        return lens, np.zeros(0, np.int32)
    flat = np.empty(total, dtype=object)
    pos = 0
    for toks in token_lists:
        flat[pos:pos + len(toks)] = toks
        pos += len(toks)
    uniq, codes = np.unique(flat, return_inverse=True)
    buckets = np.fromiter((fnv1a_32(t) % num_hashes for t in uniq),
                          np.int64, count=len(uniq))
    return lens, buckets[codes].astype(np.int32)


def strings_to_hash_flat(strings: Sequence[Optional[str]], num_hashes: int,
                         native: bool = True
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Strings → (lens [N] int32, flat bucket ids [total] int32) in one
    native pass (``native/fasttok.cpp``: tokenize + FNV + modulo); rows the
    native tokenizer defers (non-ASCII) are spliced from the Python path.
    ``native=False`` takes the Python path throughout."""
    if not native:
        return hash_tokens_flat([tokenize_text(s) for s in strings],
                                num_hashes)
    from .. import native as nat
    lens, buckets, fallback = nat.load("fasttok").tokenize_hash(
        list(strings), num_hashes, 1)
    if not fallback:
        return lens, buckets
    fb = {i: np.asarray([fnv1a_32(t) % num_hashes
                         for t in tokenize_text(strings[i])], np.int32)
          for i in fallback}
    out_lens = lens.copy()
    pieces: List[np.ndarray] = []
    pos = 0
    for i, L in enumerate(lens):
        if L < 0:
            out_lens[i] = len(fb[i])
            pieces.append(fb[i])
        elif L:
            pieces.append(buckets[pos:pos + L])
            pos += L
    flat = (np.concatenate(pieces).astype(np.int32) if pieces
            else np.zeros(0, np.int32))
    return out_lens, flat


def pack_ids3(flat: np.ndarray, num_hashes: int) -> np.ndarray:
    """Bucket ids (< 1024) → int32 words of three 10-bit lanes, the last word
    padded with the sentinel bin ``num_hashes`` (≙ ``_pack_ids3``)."""
    total = int(flat.size)
    w = (total + 2) // 3
    ids = np.full(3 * w, num_hashes, dtype=np.int32)
    ids[:total] = flat
    return (ids[0::3] | (ids[1::3] << 10) | (ids[2::3] << 20)).astype(
        np.int32)


class TextStats:
    """Single-pass text cardinality statistics (≙ SmartTextVectorizer's
    TextStats, SmartTextVectorizer.scala:182-230)."""

    def __init__(self, value_counts: Optional[Counter] = None,
                 length_counts: Optional[Counter] = None):
        self.value_counts = value_counts or Counter()
        self.length_counts = length_counts or Counter()

    @property
    def cardinality(self) -> int:
        return len(self.value_counts)

    @property
    def length_std_dev(self) -> float:
        """Standard deviation of the value lengths (the ID-like test)."""
        n = sum(self.length_counts.values())
        if n == 0:
            return 0.0
        mean = sum(l * c for l, c in self.length_counts.items()) / n
        var = sum(c * (l - mean) ** 2
                  for l, c in self.length_counts.items()) / n
        return var ** 0.5


class SmartTextVectorizerModel(TransformerModel):
    out_kind = OPVector
    # host profile and token ids, then hash_counts on the device
    is_device_op = False
    supports_staging = True

    def block_widths(self) -> List[int]:
        """Each input's column count, in output order."""
        num_hashes = self.get("num_hashes")
        tn = int(self.get("track_nulls", True))
        widths = []
        for f in self.input_features:
            strat = self.fitted["strategies"][f.name]
            if strat == "pivot":
                widths.append(len(self.fitted["vocabs"][f.name]) + 2)
            elif strat == "ignore":
                widths.append(tn)
            else:
                widths.append(num_hashes + tn)
        return widths

    def _transform_sparse(self, batch: ColumnBatch) -> Column:
        """One [N, width] SparseMatrix (≙ ``_transform_sparse``,
        text.py:496-533): each hashed feature's bucket stream deduped on the
        host into COO entries, pivot and null blocks riding along as small
        dense blocks, all stacked on the device by ``combine_blocks``."""
        from ..sparse.transform import combine_blocks, sparse_from_hash_flat
        from .categorical import one_hot
        from .text_profile import column_profile

        num_hashes = self.get("num_hashes")
        track_nulls = self.get("track_nulls", True)
        dev = batch.device
        blocks: List[Any] = []
        for f, w in zip(self.input_features, self.block_widths()):
            strat = self.fitted["strategies"][f.name]
            col = batch[f.name]
            prof = column_profile(col)
            if strat == "pivot":
                vocab = self.fitted["vocabs"][f.name]
                blocks.append(one_hot(encode_column(col, vocab, len(vocab)),
                                      range(w), dev))
                continue
            if strat == "hash":
                lens, flat = prof.buckets(num_hashes)
                blocks.append(sparse_from_hash_flat(
                    lens, flat, num_hashes, record=False, device=dev))
            if track_nulls:
                blocks.append(torch.from_numpy(prof.null).to(dev)[:, None])
        return Column(OPVector, combine_blocks(blocks, len(batch), device=dev),
                      meta=self.fitted["meta"])

    def transform(self, batch: ColumnBatch) -> Column:
        """One [N, width] output; each feature's block is written into its
        own columns: pivots as a device one-hot, hashed text by
        ``hash_counts`` (counts and null column in one pass).  A model fitted
        sparse returns a ``SparseMatrix`` (``_transform_sparse``)."""
        from .categorical import one_hot
        from .text_profile import column_profile

        if self.fitted.get("sparse"):
            return self._transform_sparse(batch)
        num_hashes = self.get("num_hashes")
        track_nulls = self.get("track_nulls", True)
        dev = batch.device
        widths = self.block_widths()
        out = torch.empty((len(batch), sum(widths)), dtype=torch.float32,
                          device=dev)
        c0 = 0
        for f, w in zip(self.input_features, widths):
            strat = self.fitted["strategies"][f.name]
            col = batch[f.name]
            prof = column_profile(col)
            if strat == "pivot":
                vocab = self.fitted["vocabs"][f.name]
                ids = encode_column(col, vocab, len(vocab))
                out[:, c0:c0 + w] = one_hot(ids, range(w), dev)
            elif strat == "ignore":
                if track_nulls:
                    out[:, c0] = torch.from_numpy(prof.null).to(dev)
            else:
                ids, offsets = prof.device_ids(num_hashes, dev)
                null = (torch.from_numpy(prof.null).to(dev) if track_nulls
                        else None)
                hash_counts(ids, offsets, null, num_hashes, out=out, col0=c0,
                            packed=num_hashes < 1024)
            c0 += w
        return Column(OPVector, out, meta=self.fitted["meta"])


class SmartTextVectorizer(Estimator):
    """Cardinality-adaptive text vectorization (≙ SmartTextVectorizer.scala:
    61): one TextStats pass; per feature, cardinality <= max_cardinality →
    pivot one-hot (like categorical); else value-length stddev below
    ``min_length_std_dev`` (ID-like; off by default) → ignore; else
    tokenize + hash.  ``sparse_hashing``: "auto" outputs a SparseMatrix when
    ``num_hashes`` >= 4,096 and any feature hashes; True / False force or
    forbid it (≙ text.py:604-612, :663-673)."""

    out_kind = OPVector

    def __init__(self, max_cardinality: int = 30, top_k: int = 20,
                 min_support: int = 10, num_hashes: int = 512,
                 track_nulls: bool = True, auto_detect_languages: bool = False,
                 min_length_std_dev: float = 0.0,
                 sparse_hashing: Any = "auto", **params):
        super().__init__(max_cardinality=max_cardinality, top_k=top_k,
                         min_support=min_support, num_hashes=num_hashes,
                         track_nulls=track_nulls,
                         auto_detect_languages=auto_detect_languages,
                         min_length_std_dev=min_length_std_dev,
                         sparse_hashing=sparse_hashing, **params)

    def fit(self, batch: ColumnBatch) -> TransformerModel:
        from .text_profile import column_profile

        strategies: Dict[str, str] = {}
        vocabs: Dict[str, Dict[str, int]] = {}
        cols_meta: List[VectorColumnMeta] = []
        max_card = self.get("max_cardinality")
        num_hashes = self.get("num_hashes")
        tn = self.get("track_nulls", True)
        for f in self.input_features:
            kind = f.kind.__name__
            # the one cached native pass serves this fit, the transform's
            # hashing and RawFeatureFilter's statistics
            prof = column_profile(batch[f.name])
            iv = prof.values(max_card)
            stats = TextStats(Counter(iv.value_counts()),
                              Counter(prof.length_counts()))
            if stats.cardinality <= max_card:
                # the reference pivots even single-value columns
                # (SmartTextVectorizer.scala:92-96)
                strategies[f.name] = "pivot"
                top = top_values_by_count(stats.value_counts,
                                          self.get("top_k"),
                                          self.get("min_support"))
                vocabs[f.name] = {v: i for i, v in enumerate(top)}
                cols_meta.extend(VectorColumnMeta(f.name, kind,
                                                  indicator_value=v)
                                 for v in top)
                cols_meta.append(VectorColumnMeta(
                    f.name, kind, indicator_value=OTHER_INDICATOR))
                cols_meta.append(VectorColumnMeta(
                    f.name, kind, indicator_value=NULL_INDICATOR))
                continue
            if stats.length_std_dev < self.get("min_length_std_dev", 0.0):
                # ID-like (SmartTextVectorizer.scala:94 Ignore branch)
                strategies[f.name] = "ignore"
            else:
                strategies[f.name] = "hash"
                cols_meta.extend(VectorColumnMeta(
                    f.name, kind, descriptor_value=f"hash_{j}")
                    for j in range(num_hashes))
            if tn:
                cols_meta.append(VectorColumnMeta(
                    f.name, kind, indicator_value=NULL_INDICATOR))
        meta = VectorMeta(self.output_name(), cols_meta)
        mode = self.get("sparse_hashing", "auto")
        use_sparse = ("hash" in strategies.values()
                      and (mode is True or (mode == "auto" and num_hashes
                                            >= SPARSE_MIN_HASHES)))
        model = SmartTextVectorizerModel(
            fitted={"strategies": strategies, "vocabs": vocabs, "meta": meta,
                    "sparse": use_sparse},
            **self.params)
        model.metadata["strategies"] = dict(strategies)
        model.metadata["sparse"] = use_sparse
        return self._finalize_model(model)
