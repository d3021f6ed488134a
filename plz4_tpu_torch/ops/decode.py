"""LZ4 block decode: kernels K1, K3 and K5 and their plain versions.

decode_batch (K1, plain blocks), decode_batch_dict (K3, blocks against a
frame dictionary) and decode_records_batch (K5, the records of large
blocks, each against the previous record's output) run the CUDA kernels
csrc/lz4_decode.cu and csrc/lz4_decode_window.cu on CUDA tensors and the
plain versions on CPU tensors. Each returns what the JAX package's Pallas
kernel returns (decode_pallas.decode_batch_pallas,
decode_block_pallas_dict, decode_chunks_pallas): the same ok and n_out per
row and the same bytes [0, n_out), on corrupt, truncated and bad-offset
streams too. Records differ in two cases, where the Pallas record kernels
are wrong (csrc/lz4_decode_window.cuh): a record that a match fills
exactly is valid here, and K5's widened short-offset copies near a record
start are exact here. Rows carry zero padding past clen (the batch layer
uses C = block_size + 16 for whole blocks).

decode_batch takes whole blocks up to the 4 MiB LZ4 block: out_cap up to
96 KiB on K1, as the Pallas wrapper keeps them on its byte-wide kernel
(bw_fits), and wider on K6a (csrc/lz4_decode_wide.cu), the counterpart of
the packed-word kernel decode_pallas._decode_kernel. decode_block_host
decodes one block of any size.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import errors as zerr
from . import _build

ROW_SLACK = 16  # compressed row width C = block_size + ROW_SLACK
MAX_OUT = 65536  # the batch layer's blocks; wider ones are 64 KiB records
BW_MAX_OUT = 96 * 1024  # the widest output the Pallas byte-wide kernel takes
MAX_WIDE_OUT = 4 << 20  # the widest output K6a takes: the LZ4 maximum block
MAX_WINDOW = 65536  # the LZ4 match window
MAX_SMEM = 232448  # shared memory a thread block can use on the H100
# K1's and K3's shared memory besides their rows (csrc/lz4_decode_ring.cuh):
# the ring of parsed sequences with its barriers (LZ4T_RING_SMEM) and the
# pad staged past the compressed row (LZ4T_RING_PAD)
RING_SMEM = 64 * (32 * 16 + 8 + 8 + 4) + 16
ROW_PAD = 16

launches = 0  # K1 launches by decode_batch
wide_launches = 0  # K6a launches by decode_batch
dict_launches = 0  # K3 launches by decode_batch_dict
record_launches = 0  # K5 launches by decode_records_batch


def bw_fits(out_cap: int) -> bool:
    """Whether the Pallas wrapper decodes a block of out_cap bytes on its
    byte-wide kernel (decode_pallas._BW_MAX_OUT): K1 here, else K6a."""
    return out_cap <= BW_MAX_OUT


def decode_batch(comp: torch.Tensor, clens: torch.Tensor, out_cap: int):
    """comp (B, C) uint8 with C % 4 == 0, clens (B,) int32, out_cap % 4 == 0
    and <= 4 MiB -> (out (B, out_cap) uint8, n_out (B,) int32, ok (B,)
    bool); bytes past n_out are undefined. Up to 96 KiB (bw_fits) reads
    clip at C - 1 as the Pallas byte-wide kernel's do, and K1 needs C +
    out_cap + RING_SMEM + ROW_PAD bytes of shared memory (C + out_cap <=
    198,368: the batch layer's rows, C = out_cap + 16, fit up to 96 KiB);
    wider blocks read zeros past C and, on a corrupt stream, may report
    n_out > out_cap (decode_batch_wide). On CUDA tensors it launches K1 or
    K6a on the current stream without synchronising; on CPU tensors it
    runs the plain version."""
    global launches, wide_launches
    if comp.dim() != 2 or comp.dtype != torch.uint8:
        raise ValueError("comp must be a (B, C) uint8 tensor")
    B, C = comp.shape
    wide = not bw_fits(out_cap)
    if (C % 4 or out_cap % 4 or not 0 < out_cap <= MAX_WIDE_OUT
            or C > (MAX_WIDE_OUT * 3 // 2 if wide
                    else MAX_SMEM - RING_SMEM - ROW_PAD - out_cap)):
        raise ValueError(f"row widths C={C}, out_cap={out_cap}: need "
                         f"multiples of 4, out_cap <= {MAX_WIDE_OUT}, C + "
                         f"out_cap <= {MAX_SMEM - RING_SMEM - ROW_PAD} up "
                         f"to {BW_MAX_OUT}")
    if (clens.shape != (B,) or clens.dtype != torch.int32
            or clens.device != comp.device):
        raise ValueError("clens must be a (B,) int32 tensor on comp's device")
    if comp.device.type == "cpu":
        return (decode_batch_wide_plain if wide else decode_batch_plain)(
            comp, clens, out_cap)
    if comp.device.type != "cuda":
        raise ValueError(f"unsupported device {comp.device}")
    comp, clens = comp.contiguous(), clens.contiguous()
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=comp.device)
    n_out = torch.empty((B,), dtype=torch.int32, device=comp.device)
    ok = torch.empty((B,), dtype=torch.bool, device=comp.device)
    if B:
        with torch.cuda.device(comp.device):
            stream = torch.cuda.current_stream(comp.device).cuda_stream
            _build.launch("lz4_decode_wide" if wide else "lz4_decode",
                          (comp.data_ptr(), clens.data_ptr(), out.data_ptr(),
                           n_out.data_ptr(), ok.data_ptr()),
                          (B, C, out_cap), stream)
        if wide:
            wide_launches += 1
        else:
            launches += 1
    return out, n_out, ok


def max_stream(out_cap: int) -> int:
    """An upper bound on the length of a stream that decodes ok to at most
    out_cap bytes: a sequence's token, offset and length bytes take at
    most its match bytes plus a 255th of its literals, the last one's two
    bytes more."""
    return out_cap + out_cap // 255 + 16


def decode_block_host(comp: bytes, out_cap: int, device=None) -> bytes:
    """Decode one LZ4 block stream of at most out_cap (<= 4 MiB) bytes on
    the device, CUDA unless device="cpu"; raises ErrDecompress on a corrupt
    stream. The counterpart of decode_pallas.decode_block_host (the same
    row: the stream and 8 zero bytes, rounded up to 4)."""
    from ..parallel.batch import resolve_device

    dev = resolve_device(device)
    out_cap = (out_cap + 3) & ~3
    if bw_fits(out_cap) and len(comp) > max_stream(out_cap):
        raise zerr.ErrDecompress  # longer than any stream K1 calls ok
    C = max(16, (len(comp) + 8 + 3) & ~3)
    buf = np.zeros((1, C), dtype=np.uint8)
    buf[0, :len(comp)] = np.frombuffer(comp, dtype=np.uint8)
    out, n, ok = decode_batch(
        torch.from_numpy(buf).to(dev),
        torch.tensor([len(comp)], dtype=torch.int32, device=dev), out_cap)
    if not bool(ok[0]):
        raise zerr.ErrDecompress
    return out[0, :int(n[0])].cpu().numpy().tobytes()


def _launch(fn: str, ptrs, ints, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.launch("lz4_decode_window", ptrs, ints, stream, fn=fn)


def decode_batch_dict(comp: torch.Tensor, clens: torch.Tensor,
                      dict_buf: torch.Tensor, dlen: int, out_cap: int):
    """Decode whole blocks against one frame dictionary.

    comp (B, C) uint8 zero-padded rows, clens (B,) int32; dict_buf (D,)
    uint8 holds the dictionary right-aligned, its last dlen bytes usable;
    C, D and out_cap multiples of 4, out_cap and D <= 64 KiB. Returns (out
    (B, out_cap) uint8, n_out (B,) int32, ok (B,) bool); bytes past n_out
    are undefined. Reads past C return 0. K3 needs C + D + out_cap +
    RING_SMEM + ROW_PAD bytes of shared memory (the batch layer's 64 KiB
    rows, window and blocks: 230,704). On CUDA tensors it launches K3 on
    the current stream without synchronising; on CPU tensors it runs the
    plain version."""
    global dict_launches
    if comp.dim() != 2 or comp.dtype != torch.uint8:
        raise ValueError("comp must be a (B, C) uint8 tensor")
    B, C = comp.shape
    if dict_buf.dim() != 1 or dict_buf.dtype != torch.uint8:
        raise ValueError("dict_buf must be a (D,) uint8 tensor")
    D = dict_buf.shape[0]
    if (C % 4 or D % 4 or out_cap % 4 or not 0 < out_cap <= MAX_OUT
            or not 0 < D <= MAX_WINDOW
            or C + D + out_cap > MAX_SMEM - RING_SMEM - ROW_PAD):
        raise ValueError(f"row widths C={C}, D={D}, out_cap={out_cap}: need "
                         f"multiples of 4, 0 < out_cap, D <= {MAX_OUT}")
    if (clens.shape != (B,) or clens.dtype != torch.int32
            or clens.device != comp.device or dict_buf.device != comp.device):
        raise ValueError("clens must be a (B,) int32 tensor and dict_buf a "
                         "tensor on comp's device")
    if comp.device.type == "cpu":
        return decode_batch_dict_plain(comp, clens, dict_buf, dlen, out_cap)
    if comp.device.type != "cuda":
        raise ValueError(f"unsupported device {comp.device}")
    comp, clens, dict_buf = (comp.contiguous(), clens.contiguous(),
                             dict_buf.contiguous())
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=comp.device)
    n_out = torch.empty((B,), dtype=torch.int32, device=comp.device)
    ok = torch.empty((B,), dtype=torch.bool, device=comp.device)
    if B:
        _launch("lz4t_launch_dict",
                (comp.data_ptr(), clens.data_ptr(), dict_buf.data_ptr(),
                 out.data_ptr(), n_out.data_ptr(), ok.data_ptr()),
                (B, C, D, int(dlen), out_cap), comp.device)
        dict_launches += 1
    return out, n_out, ok


def decode_records_batch(rows: torch.Tensor, metas: torch.Tensor,
                         win0s: torch.Tensor):
    """Decode the records of B large blocks, record k of a block against
    record k-1's output.

    rows (B, K, CIN) uint8 record input slices, zero-padded; metas (B, K, 7)
    int32 [clen, dlen, pre_lit, pre_skip, pre_moff, pre_mlen, out_len] (the
    native chunk_split layout, dlen in column 1); win0s (B, W) uint8 the
    right-aligned window of each block's record 0 (its frame dictionary).
    W is the record span: 64 KiB on the frame path, smaller in tests; CIN
    and W multiples of 4. All-zero records are valid no-ops. Returns (outs
    (B, K, W) uint8, zero past n_out, n_outs (B, K) int32, oks (B, K)
    bool). On CUDA tensors it launches K5 on the current stream without
    synchronising; on CPU tensors it runs the plain version."""
    global record_launches
    if rows.dim() != 3 or rows.dtype != torch.uint8:
        raise ValueError("rows must be a (B, K, CIN) uint8 tensor")
    B, K, CIN = rows.shape
    if win0s.dim() != 2 or win0s.dtype != torch.uint8 or win0s.shape[0] != B:
        raise ValueError("win0s must be a (B, W) uint8 tensor")
    W = win0s.shape[1]
    if CIN % 4 or W % 4 or not 0 < W <= MAX_WINDOW or CIN + 2 * W > MAX_SMEM:
        raise ValueError(f"row widths CIN={CIN}, W={W}: need multiples of "
                         f"4, 0 < W <= {MAX_WINDOW}, CIN + 2 W <= {MAX_SMEM}")
    if (metas.shape != (B, K, 7) or metas.dtype != torch.int32
            or metas.device != rows.device or win0s.device != rows.device):
        raise ValueError("metas must be a (B, K, 7) int32 tensor and win0s a "
                         "tensor on rows' device")
    if rows.device.type == "cpu":
        return decode_records_batch_plain(rows, metas, win0s)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    rows, metas, win0s = (rows.contiguous(), metas.contiguous(),
                          win0s.contiguous())
    outs = torch.empty((B, K, W), dtype=torch.uint8, device=rows.device)
    n_outs = torch.empty((B, K), dtype=torch.int32, device=rows.device)
    oks = torch.empty((B, K), dtype=torch.bool, device=rows.device)
    if B and K:
        # K5's scratch: each record's parsed sequences (at most W / 4 + 2)
        seqs = torch.empty((B, K, W // 4 + 2, 4), dtype=torch.int32,
                           device=rows.device)
        n_seqs = torch.empty((B, K), dtype=torch.int32, device=rows.device)
        _launch("lz4t_launch_records",
                (rows.data_ptr(), metas.data_ptr(), win0s.data_ptr(),
                 outs.data_ptr(), n_outs.data_ptr(), oks.data_ptr(),
                 seqs.data_ptr(), n_seqs.data_ptr()),
                (B, K, CIN, W), rows.device)
        record_launches += 1
    return outs, n_outs, oks


# ---------------------------------------------------------------------------
# plain version: the same sequence loop over Python bytes, one row at a time
# ---------------------------------------------------------------------------

def _varint(c: bytes, C: int, p: int, t: int) -> tuple[int, int]:
    while True:
        b = c[min(p, C - 1)]
        t += b
        p += 1
        if b != 255:
            return t, p
        if p > C:  # endless 255s at the clipped last byte
            return 0x3FFFFFFF, p


def decode_row_plain(c: bytes, clen: int, out_cap: int):
    """One compressed row c (its full width C): (bytes [0, n_out), ok)."""
    C = len(c)
    o = bytearray()
    ip = 0
    ok = clen > 0
    done = clen <= 0
    while not done:
        bad = ip >= clen
        token = c[min(ip, C - 1)]
        ip += 1
        lit = token >> 4
        if lit == 15:
            lit, ip = _varint(c, C, ip, lit)
        bad = bad or ip + lit > clen or len(o) + lit > out_cap
        if not bad:
            seg = c[ip:ip + lit]
            o += seg + bytes([c[C - 1]]) * (lit - len(seg))
            ip += lit
        fin = ip >= clen or bad
        if not fin:
            off = c[min(ip, C - 1)] | (c[min(ip + 1, C - 1)] << 8)
            ip += 2
            bad = ip > clen or off == 0
            ml = token & 15
            if ml == 15:
                ml, ip = _varint(c, C, ip, ml)
            ml += 4
            op = len(o)
            bad = bad or op + ml > out_cap or off > op
            if not bad:
                if off >= ml:
                    o += o[op - off:op - off + ml]
                else:
                    o += (o[op - off:] * (ml // off + 1))[:ml]
        ok = ok and not bad
        done = fin or bad
    return bytes(o), ok and ip == clen


def decode_batch_plain(comp: torch.Tensor, clens: torch.Tensor,
                       out_cap: int):
    """Plain version of K1 (decode_batch's results up to 96 KiB) on CPU
    tensors; bytes past n_out are zero."""
    B = comp.shape[0]
    c = comp.numpy()
    out = torch.zeros((B, out_cap), dtype=torch.uint8)
    n_out = torch.zeros((B,), dtype=torch.int32)
    ok = torch.zeros((B,), dtype=torch.bool)
    o = out.numpy()
    for i, clen in enumerate(clens.tolist()):
        s, good = decode_row_plain(c[i].tobytes(), clen, out_cap)
        o[i, :len(s)] = memoryview(s)
        n_out[i] = len(s)
        ok[i] = good
    return out, n_out, ok


# ---------------------------------------------------------------------------
# plain version of K6a: the packed-word kernel's loop (its rules are in
# csrc/lz4_decode_ring.cuh)
# ---------------------------------------------------------------------------

def decode_row_wide_plain(c: bytes, clen: int, out_cap: int):
    """One compressed row c (its full width C; reads past it give 0):
    (bytes written, n_out, ok). n_out exceeds the bytes written when a bad
    literal run ends the row: K6a advances past it uncopied."""
    o = bytearray()
    ip = op = 0
    ok = clen > 0
    done = clen <= 0
    while not done:
        bad = ip >= clen
        token = _rdz(c, ip)
        ip += 1
        lit = token >> 4
        if lit == 15:
            lit, ip = _varint_z(c, ip, lit)
        bad = bad or ip + lit > clen or op + lit > out_cap
        if not bad:
            o += _slice_z(c, ip, lit)
        ip += lit
        op += lit
        fin = ip >= clen or bad
        if not fin:
            off = _rdz(c, ip) | (_rdz(c, ip + 1) << 8)
            ip += 2
            bad = ip > clen or off == 0
            ml = token & 15
            if ml == 15:
                ml, ip = _varint_z(c, ip, ml)
            ml += 4
            bad = bad or op + ml > out_cap or off > op
            if not bad:
                if off >= ml:
                    o += o[op - off:op - off + ml]
                else:
                    o += (o[op - off:] * (ml // off + 1))[:ml]
                op += ml
        ok = ok and not bad
        done = fin or bad
    return bytes(o), op, ok and ip == clen


def decode_batch_wide_plain(comp: torch.Tensor, clens: torch.Tensor,
                            out_cap: int):
    """Plain version of K6a (decode_batch's results over 96 KiB) on CPU
    tensors; bytes past the written stream are zero."""
    B = comp.shape[0]
    c = comp.numpy()
    out = torch.zeros((B, out_cap), dtype=torch.uint8)
    n_out = torch.zeros((B,), dtype=torch.int32)
    ok = torch.zeros((B,), dtype=torch.bool)
    o = out.numpy()
    for i, clen in enumerate(clens.tolist()):
        s, n, good = decode_row_wide_plain(c[i].tobytes(), clen, out_cap)
        o[i, :len(s)] = memoryview(s)
        n_out[i] = n
        ok[i] = good
    return out, n_out, ok


# ---------------------------------------------------------------------------
# plain version of K3 and K5: decode against a right-aligned window
# (csrc/lz4_decode_window.cuh states the semantics)
# ---------------------------------------------------------------------------

def _rdz(c: bytes, p: int) -> int:
    return c[p] if 0 <= p < len(c) else 0


def _varint_z(c: bytes, p: int, t: int) -> tuple[int, int]:
    while True:
        b = _rdz(c, p)
        t += b
        p += 1
        if b != 255:
            return t, p


def _slice_z(c: bytes, p: int, n: int) -> bytes:
    seg = c[max(p, 0):p + n] if p >= 0 else b""
    return seg + bytes(n - len(seg))


def _copy_match_w(o: bytearray, off: int, m: int, win: bytes) -> None:
    """Append m match bytes from len(o) - off; sources before the row's
    first output byte come from the right-aligned window."""
    off = max(off, 1)
    op = len(o)
    n_win = min(max(off - op, 0), m)
    if n_win:
        W = len(win)
        s = W - off + op
        seg = win[max(s, 0):s + n_win]
        o += bytes(n_win - len(seg)) + seg
    rem = m - n_win
    if rem:
        src = len(o) - off
        if off >= rem:
            o += o[src:src + rem]
        else:
            o += (o[src:] * (rem // off + 1))[:rem]


def decode_window_row_plain(c: bytes, meta, win: bytes, cap: int,
                            strict: bool) -> tuple[bytes, bool]:
    """One row c (its full width) with meta [clen, dlen, pre_lit, pre_skip,
    pre_moff, pre_mlen, out_len] against the right-aligned window win:
    (bytes [0, n_out), ok). strict: K3's whole-block mode; else K5's record
    mode."""
    clen, dlen, pre_lit, pre_skip, pre_moff, pre_mlen, out_len = (
        int(x) for x in meta)
    out_len = min(out_len, cap)
    o = bytearray()
    if strict:
        ip, ok, done = 0, clen > 0, clen <= 0
    else:
        bad = (pre_lit > clen or pre_lit + pre_mlen > out_len
               or (pre_mlen > 0 and pre_moff > pre_lit + dlen)
               or pre_lit < 0 or pre_mlen < 0)
        if not bad:
            o += _slice_z(c, 0, pre_lit)
            _copy_match_w(o, pre_moff, pre_mlen, win)
            ip = pre_lit + pre_skip
        else:
            ip = pre_skip
        bad = bad or ip > clen
        ok, done = not bad, bad or ip >= clen
    while not done:
        op = len(o)
        bad = ip >= clen
        token = _rdz(c, ip)
        ip += 1
        lit = token >> 4
        if lit == 15:
            lit, ip = _varint_z(c, ip, lit)
        clip = False
        if strict:
            bad = bad or ip + lit > clen or op + lit > out_len
            lit_n = 0 if bad else lit
        else:
            lit_n = min(lit, out_len - op)
            bad = bad or lit_n < 0 or ip + lit_n > clen
            lit_n = 0 if bad else lit_n
            clip = not bad and lit_n < lit
        o += _slice_z(c, ip, lit_n)
        ip += lit_n
        op += lit_n
        fin = ip >= clen or bad or clip
        if not fin:
            off = _rdz(c, ip) | (_rdz(c, ip + 1) << 8)
            ip += 2
            bad = ip > clen or off == 0
            ml = token & 15
            if ml == 15:
                ml, ip = _varint_z(c, ip, ml)
            ml += 4
            bad = bad or off > op + dlen
            if strict:
                bad = bad or op + ml > out_len
                m_n = 0 if bad else ml
            else:
                m_n = 0 if bad else min(ml, out_len - op)
                clip = not bad and (m_n < ml or op + m_n == out_len)
            _copy_match_w(o, off, m_n, win)
        ok = ok and not bad
        done = fin or bad or clip
    return bytes(o), ok and ip == clen


def decode_batch_dict_plain(comp: torch.Tensor, clens: torch.Tensor,
                            dict_buf: torch.Tensor, dlen: int, out_cap: int):
    """Plain version of decode_batch_dict (same signature and results) on
    CPU tensors; bytes past n_out are zero."""
    B = comp.shape[0]
    c, win = comp.numpy(), dict_buf.numpy().tobytes()
    out = torch.zeros((B, out_cap), dtype=torch.uint8)
    n_out = torch.zeros((B,), dtype=torch.int32)
    ok = torch.zeros((B,), dtype=torch.bool)
    o = out.numpy()
    for i, clen in enumerate(clens.tolist()):
        s, good = decode_window_row_plain(
            c[i].tobytes(), (clen, dlen, 0, 0, 0, 0, out_cap), win, out_cap,
            strict=True)
        o[i, :len(s)] = memoryview(s)
        n_out[i] = len(s)
        ok[i] = good
    return out, n_out, ok


def decode_records_batch_plain(rows: torch.Tensor, metas: torch.Tensor,
                               win0s: torch.Tensor):
    """Plain version of decode_records_batch (same signature and results)
    on CPU tensors."""
    B, K, _ = rows.shape
    W = win0s.shape[1]
    r, m, w = rows.numpy(), metas.numpy(), win0s.numpy()
    outs = torch.zeros((B, K, W), dtype=torch.uint8)
    n_outs = torch.zeros((B, K), dtype=torch.int32)
    oks = torch.zeros((B, K), dtype=torch.bool)
    o = outs.numpy()
    for b in range(B):
        win = w[b].tobytes()
        for k in range(K):
            s, good = decode_window_row_plain(r[b, k].tobytes(), m[b, k], win,
                                              W, strict=False)
            o[b, k, :len(s)] = memoryview(s)
            n_outs[b, k] = len(s)
            oks[b, k] = good
            win = o[b, k].tobytes()
    return outs, n_outs, oks
