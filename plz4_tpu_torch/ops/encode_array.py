"""A1: LZ4 block encode as a torch tensor program (the array path).

The counterpart of the JAX package's XLA array encoder, written over
(B, N) tensors with the batch on dim 0 and run on whatever device the
tensors live on: torch ops only, no Python loop over rows, no hand-written
kernel. It reformulates the serial hash-table scan loop (reference
analog: LZ4_compress_fast, clz4/lz4.c:930, and LZ4HC_compress_generic,
clz4/lz4hc.c:1374) into vector stages:

  1. *Match finding*: 4-byte hashes at every position; the K most recent
     previous occurrences of each hash come from one stable argsort
     (positions with equal hash become adjacent; the K predecessors in
     sort order are the candidates: the hash table at K=1, level 1, and
     the hash chain at K>1). Candidates get a short probing extension,
     the winner a full word-at-a-time extension. Periodic runs (offsets
     1..8, 16, 32) get exact unbounded lengths from next-mismatch reverse
     scans.
  2. *Greedy parse*: the orbit of the block start under the jump map
     f(p) = first matchable position g >= p advanced by its match length
     (literal runs collapse into a reverse-cummin "next good position"
     lookup), materialized by pointer-doubling path expansion.
  3. *Emission*: per-sequence byte costs, an exclusive cumsum for the
     layout, and every output byte classifying itself into
     token/extension/literal/offset fields and gathering its value.

Dictionary and linked blocks: the window is a prefix domain, the input
[pad | dict | block], matches start only inside the block but may
reference the dict (LZ4_compress_fast_continue semantics,
clz4/clz4.go:224-248), so blocks with windows still encode in parallel.

The output is byte-identical to the JAX array encoder's: the same hash
(computed in int64 and masked to 32 bits, so no multiply wraps), the same
stable sort, the same tie-breaking (torch.argmax returns the first
maximum). Incompressible blocks surface as a flag so the frame layer
stores them raw (reference: blk/blk.go:75-92).
"""

from __future__ import annotations

import numpy as np
import torch

from ._array_util import ceil_log2, gather, orbit, rev_cummin, take

I64 = torch.int64

HASH_PRIME = 2654435761
HASH_LOG = 16
MAX_DISTANCE = 65535
PERIODS = (1, 2, 3, 4, 5, 6, 7, 8, 16, 32)
PROBE_STEPS = 4    # short probing extension per candidate (up to 20 bytes)
WORD_STEPS = 16    # full extension for the winning candidate
MAX_DICT = 65536
_M32 = 0xFFFFFFFF


def out_width(N: int) -> int:
    """CAP, the output row width of an N-byte input row."""
    return N + N // 255 + 16


def candidates_for_level(level: int) -> int:
    """Sort-neighbourhood candidate count, the hash-chain depth analog
    (reference: lz4hc nbSearches by level, lz4hc.h:47-50)."""
    if level <= 2:
        return 1
    if level <= 5:
        return 2
    if level <= 8:
        return 4
    return 8


def _hash(u32: torch.Tensor) -> torch.Tensor:
    """((u32 * HASH_PRIME) mod 2^32) >> (32 - HASH_LOG), the product split
    into 16-bit halves so that no int64 product exceeds 2^48."""
    lo = (u32 & 0xFFFF) * HASH_PRIME
    hi = (((u32 >> 16) * HASH_PRIME) & 0xFFFF) << 16
    return ((lo + hi) & _M32) >> (32 - HASH_LOG)


def _find_matches(b: torch.Tensor, abs_end: torch.Tensor, first, n_cand: int):
    """Per-position best match over the extended domain [pad|dict|block].

    b (B, M) int64 bytes; abs_end (B, 1) end of real data; first (B, 1) or
    0, the first valid byte (D - dlen). Match starts are restricted by the
    caller; sources must be >= first. Returns (ml, off), each (B, M)."""
    M = b.shape[-1]
    idx = torch.arange(M, dtype=I64, device=b.device)

    u32 = (b | (take(b, idx[None] + 1) << 8) | (take(b, idx[None] + 2) << 16)
           | (take(b, idx[None] + 3) << 24))
    h = _hash(u32)

    order = torch.argsort(h, dim=-1, stable=True)
    h_sorted = gather(h, order)
    inv = torch.zeros_like(order).scatter_(-1, order, idx.expand_as(order))

    mlimit = abs_end - 5

    def extend(ml, active, cand, steps, word):
        """`steps` extension steps of 4-byte words (word) or bytes."""
        src, w = (u32, 4) if word else (b, 1)
        for _ in range(steps):
            room = (idx + ml + 4 <= mlimit) if word else (idx + ml < mlimit)
            eq = take(src, idx + ml) == take(src, cand + ml)
            active = active & room & eq
            ml = ml + torch.where(active, w, 0)
        return ml

    def probe(cand):
        """Short extension: verified 4 + up to PROBE_STEPS words."""
        good = ((cand >= first) & (cand < idx)
                & (idx - cand <= MAX_DISTANCE)
                & (take(u32, cand) == u32)
                & (idx + 4 <= mlimit))
        return extend(torch.where(good, 4, 0), good, cand, PROBE_STEPS, True)

    # K nearest previous same-hash positions via the sort neighbourhood
    best_ml = torch.zeros_like(b)
    best_cand = torch.full_like(b, -1)
    for k in range(1, n_cand + 1):
        prev_ok = (inv - k >= 0) & (take(h_sorted, inv - k) == h)
        cand = torch.where(prev_ok, take(order, inv - k), -1)
        ml_k = probe(cand)
        better = ml_k > best_ml
        best_ml = torch.where(better, ml_k, best_ml)
        best_cand = torch.where(better, cand, best_cand)

    # full extension for the winner
    active0 = best_ml > 0
    ml = extend(best_ml, active0, best_cand, WORD_STEPS, True)
    # the byte steps restart from the winner's flag, as the JAX array
    # encoder's do
    ml = extend(ml, active0, best_cand, 3, False)
    off = torch.where(active0, idx - best_cand, 0)

    # periodic runs: exact unbounded lengths for small offsets
    periods = [d for d in PERIODS if d < M]
    if periods:
        runs = []
        for d in periods:
            # b[idx - d], negative indices wrapping to the row's end (the JAX
            # encoder's fill-mode take); positions idx < d are masked
            # below and the reverse cummin only looks forward
            src = idx - d
            e = take(b, torch.where(src < 0, src + M, src)[None]) == b
            nf = rev_cummin(torch.where(e, M, idx))
            run = torch.minimum((nf - idx).clamp(min=0),
                                (mlimit - idx).clamp(min=0))
            runs.append(torch.where((idx - d >= first) & (run >= 4), run, 0))
        runs = torch.stack(runs)  # (P, B, M)
        best_p = torch.argmax(runs, dim=0)  # the first maximum
        best_run = runs.gather(0, best_p[None])[0]
        better = best_run > ml
        ml = torch.where(better, best_run, ml)
        pv = torch.tensor(periods, dtype=I64, device=b.device)
        off = torch.where(better, pv[best_p], off)
    return ml, off


def _encode(data: torch.Tensor, n: torch.Tensor,
            dict_: torch.Tensor | None = None,
            dlen: torch.Tensor | None = None, n_cand: int = 1):
    """data (B, N) uint8 rows, n (B,) true lengths; dict_ (B, D) uint8
    windows, right-aligned (dict_[:, D - dlen:] are the usable bytes),
    dlen (B,)."""
    B, N = data.shape
    D = 0 if dict_ is None else dict_.shape[-1]
    M = D + N
    CAP = out_width(N)
    dev = data.device
    n = n.to(I64).reshape(B, 1)

    if D > 0:
        ext = torch.cat([dict_, data], dim=-1).to(I64)
        first = D - dlen.to(I64).reshape(B, 1)
    else:
        ext = data.to(I64)
        first = 0

    idx = torch.arange(M, dtype=I64, device=dev)
    abs_end = D + n  # end of real data in ext coords

    ml, off = _find_matches(ext, abs_end, first, n_cand)

    # match starts live inside the block only, with the spec end conditions
    good = ((ml >= 4) & (idx >= D) & (idx <= abs_end - 12)
            & (idx < abs_end))
    ml = torch.where(good, ml, 0)

    # greedy parse over [D, M] with fixpoint at abs_end (clamped to M)
    nxt = rev_cummin(torch.where(good, idx, M))
    tail = torch.full((B, 1), M, dtype=I64, device=dev)
    nxt_ext = torch.cat([nxt, tail], dim=-1)
    f_body = torch.where(nxt < abs_end, nxt + take(ml, nxt), abs_end)
    f = torch.cat([f_body, torch.zeros_like(tail)], dim=-1).clamp(0, M)
    f[:, M] = abs_end[:, 0].clamp(0, M)
    f = torch.where(torch.arange(M + 1, device=dev) == abs_end, abs_end, f)

    s_max = 1 << ceil_log2(N // 4 + 2)
    P = orbit(f, D, s_max)
    valid = P < abs_end
    vi = valid.to(I64)

    g = take(nxt_ext, P)
    is_final = g >= abs_end
    lit = (torch.where(is_final, abs_end, g) - P) * vi
    m = torch.where(is_final, 0, take(ml, g)) * vi
    o = take(off, g)

    litext = torch.where(lit < 15, 0, 1 + (lit - 15) // 255)
    mv = (m - 4).clamp(min=0)
    mext = torch.where(m == 0, 0,
                       torch.where(mv < 15, 0, 1 + (mv - 15) // 255))
    cost = (1 + litext + lit + torch.where(m > 0, 2 + mext, 0)) * vi

    cs = torch.cumsum(cost, dim=-1)
    out_off = cs - cost
    total = torch.where(n[:, 0] == 0, 1, cs[:, -1])

    # ---- vectorized serialization over the output domain ----------------
    # a sequence starting at or past CAP is dropped (the CAP+1-th slot)
    pos = torch.arange(CAP, dtype=I64, device=dev)
    starts = torch.zeros((B, CAP + 1), dtype=I64, device=dev).scatter_add_(
        -1, out_off.clamp(max=CAP), vi)[:, :CAP]
    seg = (torch.cumsum(starts, dim=-1) - 1).clamp(0, s_max - 1)

    t = pos - gather(out_off, seg)
    l_s = gather(lit, seg)
    le_s = gather(litext, seg)
    m_s = gather(m, seg)
    mv_s = gather(mv, seg)
    o_s = gather(o, seg)
    p_s = gather(P, seg)

    a1 = 1 + le_s
    a2 = a1 + l_s
    a3 = a2 + 2

    token = (l_s.clamp(max=15) << 4) | torch.where(m_s > 0, mv_s.clamp(max=15),
                                                   0)
    lit_ext_byte = torch.where(t - 1 < (l_s - 15) // 255, 255,
                               (l_s - 15) % 255)
    lit_byte = take(ext, p_s + (t - a1))
    off_byte = torch.where(t == a2, o_s & 255, o_s >> 8)
    m_ext_byte = torch.where(t - a3 < (mv_s - 15) // 255, 255,
                             (mv_s - 15) % 255)

    val = torch.where(
        t == 0, token,
        torch.where(t < a1, lit_ext_byte,
                    torch.where(t < a2, lit_byte,
                                torch.where(t < a3, off_byte, m_ext_byte))))
    val = torch.where(pos < total[:, None], val, 0)
    val = torch.where((n == 0) & (pos == 0), 0, val)
    out = (val & 255).to(torch.uint8)
    return out, total.to(torch.int32), total < n[:, 0]


def encode_block(data: torch.Tensor, n, dict_: torch.Tensor | None = None,
                 dlen=None, dict_cap: int = 0, level: int = 1):
    """Encode one LZ4 block: data (N,) uint8, n its true length; dict_, when
    given, a (dict_cap,) window whose last dlen bytes are usable.

    Returns (out (out_width(N),) uint8, total int32, compressible bool)."""
    n = torch.as_tensor(n, device=data.device).reshape(1)
    if dict_cap > 0:
        if dict_ is None or dict_.shape[-1] != dict_cap:
            raise ValueError("dict_ must be a (dict_cap,) tensor")
        dl = torch.as_tensor(dlen, device=data.device).reshape(1)
        out, total, ok = _encode(data[None], n, dict_[None], dl,
                                 candidates_for_level(level))
    else:
        out, total, ok = _encode(data[None], n,
                                 n_cand=candidates_for_level(level))
    return out[0], total[0], ok[0]


def encode_batch(data: torch.Tensor, lens: torch.Tensor, level: int = 1):
    """Encode a batch of independent blocks: data (B, N) uint8, lens (B,).

    Returns (out (B, out_width(N)) uint8, totals (B,) int32, compressible
    (B,) bool)."""
    return _encode(data, lens, n_cand=candidates_for_level(level))


def encode_batch_dict(data: torch.Tensor, lens: torch.Tensor,
                      dicts: torch.Tensor, dlens: torch.Tensor,
                      level: int = 1):
    """Encode a batch with per-block windows: dicts (B, D) right-aligned,
    dlens (B,). The linked-block / dictionary path."""
    return _encode(data, lens, dicts, dlens, candidates_for_level(level))


def encode_block_host(data: bytes, level: int = 1,
                      dict_: bytes | None = None,
                      device=None) -> bytes | None:
    """Bytes in, the block's LZ4 stream out on the device, CUDA unless
    device="cpu"; None when incompressible (store raw). The row is
    bucketed to N = pow2(max(16, len)) and the dictionary right-aligned in
    a pow2 window, as the JAX package's host wrapper does."""
    from ..parallel.batch import resolve_device

    dev = resolve_device(device)
    N = 1 << ceil_log2(max(16, len(data)))
    buf = np.zeros(N, dtype=np.uint8)
    buf[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    buf_t = torch.from_numpy(buf).to(dev)
    if dict_:
        dict_ = dict_[-MAX_DICT:]
        D = 1 << ceil_log2(max(16, len(dict_)))
        dbuf = np.zeros(D, dtype=np.uint8)
        dbuf[D - len(dict_):] = np.frombuffer(dict_, dtype=np.uint8)
        out, total, ok = encode_block(
            buf_t, len(data), torch.from_numpy(dbuf).to(dev), len(dict_),
            dict_cap=D, level=level)
    else:
        out, total, ok = encode_block(buf_t, len(data), level=level)
    if len(data) > 0 and not bool(ok):
        return None
    return out[: int(total)].cpu().numpy().tobytes()
