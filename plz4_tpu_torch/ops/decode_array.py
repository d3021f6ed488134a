"""A2: LZ4 block decode as a torch tensor program (the array path).

The counterpart of the JAX package's XLA array decoder, written over
(B, C) tensors with the batch on dim 0 and run on whatever device the
tensors live on: torch ops only, no Python loop over rows, no hand-written
kernel. It reformulates the serial token-parse/copy loop (reference
analog: LZ4_decompress_safe, clz4/lz4.c:2016) into stages with no
sequential dependence on the sequence count or the match chains:

  1. *Speculative per-byte parse*: every compressed byte position is
     decoded as if it were a sequence token (literal-length nibble and its
     255-run extension, run lengths from a reverse cumulative-min "next
     non-255" scan; match-length nibble and extension), giving for every
     position p the start of the *next* sequence f[p].
  2. *Path doubling*: the true sequence starts are the orbit of 0 under f,
     materialized by path expansion over jump tables f^(2^k).
  3. *Layout*: per-sequence literal and match lengths gathered at the
     sequence starts; output offsets from a saturating cumsum; a
     scatter+cumsum assigns each output byte its sequence.
  4. *Match resolution*: each output byte points at its source (itself for
     literals, i - offset for match bytes, a negative reach into the
     dictionary window); overlapping matches resolve by pointer doubling
     over the source map, then one gather pulls every byte from the
     literal pool or the dictionary.

Arithmetic is int64 throughout (torch.gather takes int64 indices), so the
saturating cumsum cannot wrap at any block size. Output positions, counts
and a validity flag are computed on the device: a batch decodes with no
host round trip.
"""

from __future__ import annotations

import numpy as np
import torch

from ._array_util import ceil_log2, gather, orbit, rev_cummin, take

I64 = torch.int64


def _parse_all_positions(comp: torch.Tensor, clen: torch.Tensor):
    """Stage 1: decode a hypothetical sequence at EVERY byte position.

    comp (B, C) int64 padded compressed bytes; clen (B, 1) true lengths.
    Returns per-position tensors (B, C): next_seq, lit_len, lit_start,
    match_len (0 for the final literals-only sequence), offset, seq_ok,
    is_final."""
    C = comp.shape[-1]
    idx = torch.arange(C, dtype=I64, device=comp.device)

    # next non-255 byte at or after p
    nz = rev_cummin(torch.where(comp != 255, idx, C))

    lit_nib = comp >> 4
    ml_nib = comp & 15

    # literal length (+ extension byte run)
    ext_start = idx + 1
    ext_end = take(nz, ext_start[None])
    n255 = ext_end - ext_start
    ext_byte = take(comp, ext_end)
    lit_len = torch.where(lit_nib < 15, lit_nib, 15 + 255 * n255 + ext_byte)
    lit_bytes = torch.where(lit_nib < 15, 0, n255 + 1)
    lit_start = idx + 1 + lit_bytes
    after_lit = lit_start + lit_len

    # match offset + match length (+ extension run)
    offset = take(comp, after_lit) | (take(comp, after_lit + 1) << 8)
    m_ext_start = after_lit + 2
    m_ext_end = take(nz, m_ext_start)
    m_n255 = m_ext_end - m_ext_start
    m_ext_byte = take(comp, m_ext_end)
    match_len = torch.where(ml_nib < 15, ml_nib + 4,
                            4 + 15 + 255 * m_n255 + m_ext_byte)
    ml_bytes = torch.where(ml_nib < 15, 0, m_n255 + 1)

    is_final = after_lit >= clen
    next_seq = torch.where(is_final, C, m_ext_start + ml_bytes).clamp(0, C)
    match_len = torch.where(is_final, 0, match_len)

    # structural validity of a sequence *if selected*
    seq_ok = torch.where(
        is_final,
        after_lit == clen,  # final literals must land exactly on the end
        (m_ext_start + ml_bytes <= clen) & (offset >= 1))
    return next_seq, lit_len, lit_start, match_len, offset, seq_ok, is_final


def _decode(comp: torch.Tensor, clen: torch.Tensor, out_cap: int,
            dict_: torch.Tensor | None = None,
            dlen: torch.Tensor | int = 0):
    """comp (B, C) uint8 zero-padded rows, clen (B,) true lengths; dict_
    (B, D) or (D,) uint8 windows, right-aligned (dict_[..., D - dlen:] are
    the usable bytes), dlen (B,) or a scalar."""
    B, C = comp.shape
    N = out_cap
    D = 0 if dict_ is None else dict_.shape[-1]
    dev = comp.device
    comp_i = comp.to(I64)
    clen = clen.to(I64).reshape(B, 1)

    (next_seq, lit_len, lit_start, match_len, offset, seq_ok,
     is_final) = _parse_all_positions(comp_i, clen)

    # f over domain [0, C] with terminal fixpoint at C
    f = torch.cat([next_seq, torch.full((B, 1), C, dtype=I64, device=dev)],
                  dim=-1)
    s_max = 1 << ceil_log2(C // 3 + 2)
    P = orbit(f, 0, s_max)

    valid = P < clen
    vi = valid.to(I64)
    litS = take(lit_len, P) * vi
    mlS = take(match_len, P) * vi
    lit_startS = take(lit_start, P)
    offS = take(offset, P)
    okS = torch.where(valid, take(seq_ok, P), True)
    finS = take(is_final, P) & valid

    # clip per-sequence sizes so corrupt garbage cannot inflate the sum;
    # the saturating inclusive scan caps totals at N+1, which necessarily
    # trips the n_out <= N validity check (with non-negative operands it
    # is min(cumsum, N+1), and the int64 cumsum cannot wrap)
    seq_out = (litS + mlS).clamp(0, N + 1)
    cs = torch.cumsum(seq_out, dim=-1).clamp(max=N + 1)
    n_out_sat = cs[:, -1]
    out_pos = (cs - seq_out).clamp(0, N)
    n_out = n_out_sat.clamp(max=N)

    # overall validity: every selected sequence well-formed, exactly one
    # final literals-only sequence selected, output fits
    ok = (okS.all(-1) & (finS.to(I64).sum(-1) == 1) & (n_out_sat <= N))
    # match offsets may not reach before the window start
    dl = (dlen.to(I64).reshape(-1, 1) if torch.is_tensor(dlen)
          else int(dlen))
    match_start = out_pos + litS
    ok &= torch.where(valid & (mlS > 0), offS <= match_start + dl,
                      True).all(-1)
    # literals must come from within the compressed buffer
    ok &= torch.where(valid, lit_startS + litS <= clen, True).all(-1)

    # ---- stage 3: per-output-byte sequence assignment -------------------
    # out_pos lies in [0, N]; a start at N is dropped (the N+1-th slot)
    i = torch.arange(N, dtype=I64, device=dev)
    starts = torch.zeros((B, N + 1), dtype=I64, device=dev).scatter_add_(
        -1, out_pos, vi)[:, :N]
    seg = (torch.cumsum(starts, dim=-1) - 1).clamp(0, s_max - 1)

    in_off = i - gather(out_pos, seg)
    is_lit = in_off < gather(litS, seg)
    comp_src = gather(lit_startS, seg) + in_off  # valid where is_lit

    # ---- stage 4: match-chain resolution via pointer doubling -----------
    # extended domain j in [0, D+N): [0, D) = dictionary (terminal),
    # [D, D+N) = output bytes
    j = i + D
    ptr = torch.where(is_lit, j, j - gather(offS, seg)).clamp(0, D + N - 1)
    if D > 0:
        ptr = torch.cat([torch.arange(D, dtype=I64, device=dev).expand(B, D),
                         ptr], dim=-1)
    for _ in range(ceil_log2(D + N)):
        ptr = gather(ptr, ptr)
    final = ptr[:, D:]

    # gather bytes: literals from comp, dictionary bytes from dict_ (the
    # window is right-aligned, so extended index j < D is its physical
    # index)
    out_bytes = take(comp_i, take(comp_src, (final - D).clamp(min=0)))
    if D > 0:
        d = dict_.to(I64)
        if d.dim() == 1:
            d = d.expand(B, D)
        out_bytes = torch.where(final < D, take(d, final), out_bytes)

    out = torch.where(i < n_out[:, None], out_bytes, 0).to(torch.uint8)
    return out, n_out.to(torch.int32), ok


def decode_block(comp: torch.Tensor, clen, out_cap: int,
                 dict_: torch.Tensor | None = None, dlen=None,
                 dict_cap: int = 0):
    """Decode one LZ4 block: comp (C,) uint8 zero-padded past clen.

    Returns (out (out_cap,) uint8 zero-padded, n_out int32 scalar, ok bool
    scalar; ok False marks a corrupt stream, reference analog
    ErrDecompress). dict_, when given, is a (dict_cap,) window whose last
    dlen bytes are usable (the 64 KiB sliding-window semantics, reference:
    compress/dict.go:146-199)."""
    clen = torch.as_tensor(clen, device=comp.device).reshape(1)
    if dict_cap > 0:
        if dict_ is None or dict_.shape[-1] != dict_cap:
            raise ValueError("dict_ must be a (dict_cap,) tensor")
        dl = torch.as_tensor(dlen, device=comp.device).reshape(1)
        out, n, ok = _decode(comp[None], clen, out_cap, dict_[None], dl)
    else:
        out, n, ok = _decode(comp[None], clen, out_cap)
    return out[0], n[0], ok[0]


def decode_batch(comp: torch.Tensor, clens: torch.Tensor, out_cap: int):
    """Decode a batch of independent blocks: comp (B, C) uint8, clens (B,).

    Returns (out (B, out_cap) uint8, n_out (B,) int32, ok (B,) bool)."""
    return _decode(comp, clens, out_cap)


def decode_batch_dict(comp: torch.Tensor, clens: torch.Tensor,
                      dict_buf: torch.Tensor, dlen: int, out_cap: int):
    """Decode a batch against one dictionary shared by every row: dict_buf
    (D,) uint8 with its last dlen bytes usable."""
    return _decode(comp, clens, out_cap, dict_buf, dlen)


def decode_block_host(comp: bytes, out_cap: int, dict_: bytes | None = None,
                      device=None) -> bytes:
    """Bytes in, bytes out on the device, CUDA unless device="cpu"; raises
    ErrDecompress on a corrupt stream. C, out_cap and D are bucketed to
    powers of two, as the JAX package's host wrapper does (they set s_max
    and the output shape)."""
    from .. import errors as zerr
    from ..parallel.batch import resolve_device

    dev = resolve_device(device)
    C = 1 << ceil_log2(max(16, len(comp) + 8))
    out_cap = 1 << ceil_log2(max(8, out_cap))
    buf = np.zeros(C, dtype=np.uint8)
    buf[: len(comp)] = np.frombuffer(comp, dtype=np.uint8)
    comp_t = torch.from_numpy(buf).to(dev)
    if dict_:
        D = 1 << ceil_log2(max(8, len(dict_)))
        dbuf = np.zeros(D, dtype=np.uint8)
        dbuf[D - len(dict_):] = np.frombuffer(dict_, dtype=np.uint8)
        out, n, ok = decode_block(comp_t, len(comp), out_cap,
                                  torch.from_numpy(dbuf).to(dev), len(dict_),
                                  dict_cap=D)
    else:
        out, n, ok = decode_block(comp_t, len(comp), out_cap)
    if not bool(ok):
        raise zerr.ErrDecompress
    return out[: int(n)].cpu().numpy().tobytes()
