"""The hashing trick's kernel: ``hash_counts``, its wrapper and its
plain-PyTorch twin (the dispatch rule and launch counters are in
``models/kernels.py``).

| kernel      | replaces (transmogrifai_tpu/ops/text.py)                          |
|-------------|-------------------------------------------------------------------|
| hash_counts | ``_scatter_counts_packed`` (:148-160), ``_scatter_counts_device`` (:135-146), the staged body's scatter (:470-484) |
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models.kernels import check as _check, launch, stream as _stream

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 4 + [_L, _I, _L, _L, _I, _I, _I, _P]
_SMEM_MAX = 227 * 1024
PACKED_MAX_HASHES = 1023     # the sentinel bin H must fit 10 bits
WINDOW_ROWS = 2              # rows of a tile past one row's tile
WINDOW_HASHES = 8192         # columns of such a tile (64 KB at R = 2)


def hash_plan(num_hashes: int) -> dict:
    """How ``hash_counts`` launches ``num_hashes`` columns: tiles of R rows
    of whole [R, H] f32 count rows in shared memory, R <= 32, where one row
    fits (up to 58,112 hashes: one window, WH = H); past that tiles of
    ``WINDOW_ROWS`` rows x ``WINDOW_HASHES`` columns, a second grid
    dimension over the column windows.  Any ``num_hashes`` >= 1 has a
    plan."""
    if num_hashes < 1:
        raise ValueError(f"hash_plan: {num_hashes} hashes")
    r = min(32, _SMEM_MAX // (4 * num_hashes))
    if r >= 1:
        return {"R": r, "WH": num_hashes, "windows": 1}
    return {"R": WINDOW_ROWS, "WH": WINDOW_HASHES,
            "windows": -(-num_hashes // WINDOW_HASHES)}


def unpack_ids3(words: torch.Tensor) -> torch.Tensor:
    """Packed int32 words → the id stream (three 10-bit ids per word, in
    token order)."""
    w = words.to(torch.int64)
    return torch.stack([w & 0x3FF, (w >> 10) & 0x3FF, (w >> 20) & 0x3FF],
                       dim=1).reshape(-1)


def hash_counts_twin(ids: torch.Tensor, offsets: torch.Tensor,
                     null: Optional[torch.Tensor], num_hashes: int,
                     out: torch.Tensor, col0: int = 0,
                     packed: bool = True) -> torch.Tensor:
    """Plain-PyTorch twin of ``hash_counts``: one ``index_put_`` with
    ``accumulate=True`` over the unpacked ids."""
    n = offsets.shape[0] - 1
    total = int(offsets[-1])
    flat = (unpack_ids3(ids) if packed else ids.to(torch.int64))[:total]
    rows = torch.repeat_interleave(torch.arange(n, device=ids.device),
                                   offsets[1:] - offsets[:-1])
    keep = flat < num_hashes
    block = torch.zeros((n, num_hashes), dtype=torch.float32,
                        device=ids.device)
    block.index_put_((rows[keep], flat[keep]),
                     torch.ones((), dtype=torch.float32, device=ids.device),
                     accumulate=True)
    out[:, col0:col0 + num_hashes] = block
    if null is not None:
        out[:, col0 + num_hashes] = null.to(torch.float32)
    return out


def hash_counts(ids: torch.Tensor, offsets: torch.Tensor,
                null: Optional[torch.Tensor], num_hashes: int,
                out: Optional[torch.Tensor] = None, col0: int = 0,
                packed: bool = True) -> torch.Tensor:
    """Counts of each row's hashed token ids → ``out[:, col0 : col0 + H]``
    (f32 [N, ld], allocated [N, H (+1)] when None), with ``null`` (bool or
    uint8 [N]) written as column ``col0 + H`` when given.

    ``ids`` int32: the packed wire (three 10-bit ids per word; needs
    ``num_hashes`` <= 1023) or, with ``packed=False``, one id per token;
    ``offsets`` int64 [N + 1]: row n's tokens are stream positions
    ``offsets[n] .. offsets[n+1] - 1``.  Ids >= ``num_hashes`` (the
    sentinel bin of the packed wire's padding) are dropped.  Every cell of
    the block is written.  Any ``num_hashes`` (:func:`hash_plan`)."""
    dev = ids.device
    _check("hash_counts ids", ids, torch.int32, 1, dev)
    _check("hash_counts offsets", offsets, torch.int64, 1, dev)
    n = offsets.shape[0] - 1
    width = num_hashes + (null is not None)
    if out is None:
        out = torch.empty((n, width), dtype=torch.float32, device=dev)
    _check("hash_counts out", out, torch.float32, 2, dev)
    if null is not None:
        null = null.to(torch.uint8)
        _check("hash_counts null", null, torch.uint8, 1, dev)
    if (out.shape[0] != n or col0 < 0 or col0 + width > out.shape[1]
            or (null is not None and null.shape != (n,))):
        raise ValueError("hash_counts: shapes of offsets/null/out and the "
                         "column slice disagree")
    if packed and num_hashes > PACKED_MAX_HASHES:
        raise ValueError(f"hash_counts: the packed wire holds ids below "
                         f"1024, not {num_hashes} hashes")
    if dev.type == "cpu":
        return hash_counts_twin(ids, offsets, null, num_hashes, out, col0,
                                packed)
    if dev.type != "cuda":
        raise ValueError(f"hash_counts: unsupported device {dev}")
    if n:
        plan = hash_plan(num_hashes)
        launch("hash_counts", _ARGTYPES, ids.data_ptr(), offsets.data_ptr(),
               None if null is None else null.data_ptr(), out.data_ptr(), n,
               num_hashes, out.shape[1], col0, int(packed), plan["R"],
               plan["WH"], _stream(out))
    return out
