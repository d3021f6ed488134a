"""Deterministic benchmark corpora.

The environment has no network egress, so the classic corpora (enwik8,
Silesia) cannot be downloaded; these generators produce statistically
similar mixtures deterministically from a seed. `enwik_like` follows
enwik8's shape: XML-wrapped natural-language articles with wiki markup,
links, numeric tables and occasional base64-ish blobs — entropy sits in the
same band (lz4 -1 ratio ~1.9-2.2, HC ~2.4-2.8) so per-level ratio and
throughput comparisons carry over.

Reference analog: the Silesia samples used by the reference's tests
(internal/test/samples/README.md) — which were stripped from this mount.
"""

from __future__ import annotations

import numpy as np


def _words(rng) -> list[bytes]:
    """Zipf-ish vocabulary: a few hundred common short words, a long tail
    of longer rare ones (natural-language word-length distribution)."""
    common = [b"the", b"of", b"and", b"in", b"to", b"a", b"is", b"was",
              b"for", b"on", b"as", b"with", b"by", b"at", b"from", b"that",
              b"it", b"his", b"are", b"were", b"which", b"this", b"also",
              b"has", b"had", b"an", b"be", b"or", b"its", b"first", b"one",
              b"new", b"their", b"after", b"who", b"but", b"not", b"have",
              b"her", b"she", b"two", b"other", b"time", b"when", b"during"]
    tail = []
    for _ in range(4000):
        ln = int(rng.integers(4, 14))
        tail.append(bytes(rng.integers(97, 123, ln, dtype=np.uint8)))
    return common, tail


def _sentence(rng, common, tail) -> bytes:
    n = int(rng.integers(6, 22))
    words = []
    for _ in range(n):
        if rng.random() < 0.55:
            words.append(common[int(rng.integers(len(common)))])
        else:
            words.append(tail[int(rng.zipf(1.3)) % len(tail)])
    s = b" ".join(words)
    return s[:1].upper() + s[1:] + b". "


def _article(rng, common, tail, title_id: int) -> bytes:
    out = bytearray()
    out += b'  <page>\n    <title>Article %d</title>\n    <id>%d</id>\n' % (
        title_id, title_id)
    out += b'    <revision>\n      <timestamp>2006-%02d-%02dT%02d:44Z' % (
        int(rng.integers(1, 13)), int(rng.integers(1, 29)),
        int(rng.integers(0, 24)))
    out += b'</timestamp>\n      <text xml:space="preserve">'
    n_par = int(rng.integers(1, 5))
    for _ in range(n_par):
        n_sent = int(rng.integers(3, 12))
        for _ in range(n_sent):
            s = _sentence(rng, common, tail)
            # wiki markup: occasional links and emphasis
            if rng.random() < 0.25:
                w = tail[int(rng.integers(len(tail)))]
                s = s.replace(b" ", b" [[" + w + b"]] ", 1)
            if rng.random() < 0.1:
                s = b"'''" + s
            out += s
        out += b"\n\n"
    if rng.random() < 0.15:  # numeric table
        for _ in range(int(rng.integers(3, 10))):
            row = b"| %d || %d.%02d || %d\n" % tuple(
                int(x) for x in rng.integers(0, 10000, 4))
            out += row
    if rng.random() < 0.05:  # base64-ish blob (high entropy)
        blob = rng.integers(0, 64, int(rng.integers(100, 500)))
        table = (b"ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 b"abcdefghijklmnopqrstuvwxyz0123456789+/")
        out += bytes(table[int(v)] for v in blob) + b"\n"
    out += b"</text>\n    </revision>\n  </page>\n"
    return bytes(out)


def enwik_like(size: int, seed: int = 20060303) -> bytes:
    """Deterministic enwik8-shaped corpus of exactly `size` bytes."""
    rng = np.random.default_rng(seed)
    common, tail = _words(rng)
    out = bytearray()
    out += b'<mediawiki xmlns="http://www.mediawiki.org/xml/export-0.3/">\n'
    i = 0
    while len(out) < size:
        out += _article(rng, common, tail, i)
        i += 1
    return bytes(out[:size])


def byte_runs(size: int, seed: int = 9) -> bytes:
    """Byte runs interleaved with random text — the runs4m sweep-lab class
    (long period-1 runs exercise the pattern-analysis / long-run DP
    machinery; see docs/perf_notes.md). Shared by tools/bench_host_levels
    and the conformance suite's runs-class contract row."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < size:
        out += bytes([int(rng.integers(0, 4))]) * int(rng.integers(64, 8192))
        out += rng.integers(32, 127, int(rng.integers(20, 200)),
                            dtype=np.uint8).tobytes()
    return bytes(out[:size])


def boiler_rows(size: int, seed: int = 7) -> bytes:
    """Templated rows: medium-length repeats at thousands of offsets."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    tmpl = (b'<row id="%06d" class="item item-%d" state="ok">'
            b'<name>unit %05d</name><value>%d.%03d</value></row>\n')
    while len(out) < size:
        out += tmpl % tuple(int(x) for x in rng.integers(0, 1000, 5))
    return bytes(out[:size])


def runs_mix(size: int, seed: int = 7) -> bytes:
    """Byte runs interleaved with text — the runs4m conformance class
    (long single-byte runs force the far-carry / long-run machinery in
    the optimal parse; see docs/perf_notes.md runs4m)."""
    rng = np.random.default_rng(seed)
    text = enwik_like(min(size, 1 << 20), seed=seed + 1)
    out = bytearray()
    ti = 0
    while len(out) < size:
        if rng.random() < 0.5:
            out += bytes([int(rng.integers(0, 256))]) * int(
                rng.integers(20, 4000))
        else:
            n = int(rng.integers(200, 3000))
            out += text[ti % len(text): ti % len(text) + n]
            ti += n
    return bytes(out[:size])


def fixture_payload(spec: dict) -> bytes:
    """Deterministic payload from a manifest spec — the committed
    conformance fixtures (tests/fixtures/, tools/gen_fixtures.py) record
    these specs instead of the raw content so only the compressed frames
    plus hashes live in git (reference analog: the pinned-sha256 sample
    scheme of internal/test/samples/README.md)."""
    kind, size = spec["kind"], int(spec["size"])
    seed = spec.get("seed")
    if kind == "enwik":
        return enwik_like(size, **({"seed": seed} if seed else {}))
    if kind == "silesia":
        return silesia_like(size, **({"seed": seed} if seed else {}))
    if kind == "runs":
        return runs_mix(size, **({"seed": seed} if seed else {}))
    if kind == "random":
        rng = np.random.default_rng(seed if seed is not None else 99)
        return rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    raise ValueError(f"unknown fixture payload kind {kind!r}")


def silesia_like(size: int, seed: int = 2003) -> bytes:
    """Mixed-mode corpus in Silesia's spirit: concatenated segments of
    text, structured records, sparse binary, and incompressible data."""
    rng = np.random.default_rng(seed)
    common, tail = _words(rng)
    out = bytearray()
    while len(out) < size:
        kind = rng.random()
        if kind < 0.45:  # text
            for _ in range(200):
                out += _sentence(rng, common, tail)
        elif kind < 0.70:  # structured records (log lines)
            for _ in range(300):
                out += b"2026-08-%02d %02d:%02d:%02d host%02d svc[%d]: " % (
                    tuple(int(x) for x in (
                        rng.integers(1, 29), rng.integers(0, 24),
                        rng.integers(0, 60), rng.integers(0, 60),
                        rng.integers(1, 20), rng.integers(100, 999))))
                out += common[int(rng.integers(len(common)))] + b" ok\n"
        elif kind < 0.85:  # sparse binary
            seg = np.zeros(int(rng.integers(5000, 20000)), dtype=np.uint8)
            pos = rng.integers(0, len(seg), len(seg) // 50)
            seg[pos] = rng.integers(1, 256, len(pos))
            out += seg.tobytes()
        else:  # incompressible
            out += rng.integers(0, 256, int(rng.integers(3000, 12000)),
                                dtype=np.uint8).tobytes()
    return bytes(out[:size])


def _mid_bucket(words: np.ndarray) -> np.ndarray:
    """The chain encoders' 13-bit bucket of little-endian u32 words."""
    return ((words.astype(np.uint64) * 2654435761 % (1 << 32))
            >> 19).astype(np.int64)


def chain_edge_rows(seed: int = 6) -> tuple[dict, dict]:
    """Rows aimed at the steps of the chain encoders' warp-cooperative parse
    (K2c, K2d), which scores 32 positions per step: (plain, windowed).

    plain maps a name to a block of at most 8 KiB: runs of periods 1-4;
    repeats of words that share one hash bucket, more than four of them
    inside 32 positions; copies after 0-69 fresh bytes, so a step's first
    match falls on every lane; matches that run to the block's end; and
    blocks of 13-80 bytes, whose last scanned position falls inside a step.
    windowed maps a name to (block of at most 4 KiB, 64 KiB window, usable
    window bytes): copies from the window exactly 65,534, 65,535 and 65,536
    bytes back, beside nearer copies of the same words."""
    rng = np.random.default_rng(seed)

    def rand(n: int) -> bytes:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    plain = {f"period{k}": (rand(k) * (8192 // k + 1))[:8192 - k + 1]
             for k in (1, 2, 3, 4)}
    mixed = bytearray(rand(64))
    while len(mixed) < 8000:
        k = int(rng.integers(1, 5))
        mixed += rand(int(rng.integers(1, 40)))
        mixed += (rand(k) * 40)[:int(rng.integers(5, 70))]
    plain["period-runs"] = bytes(mixed)
    # 16 distinct words of one bucket, in shuffled groups
    cand = np.frombuffer(rand(4 << 16), np.uint32)
    b = _mid_bucket(cand)
    words = [w.tobytes() for w in cand[b == np.bincount(b).argmax()][:16]]
    crowd = bytearray(rand(40))
    for g in range(30):
        for k in rng.permutation(len(words))[:int(rng.integers(6, 16))]:
            crowd += words[k]
        crowd += words[g % 4] + words[(g + 1) % 4] + words[g % 4]
        crowd += rand(int(rng.integers(0, 10)))
    plain["bucket-crowd"] = bytes(crowd)
    # fresh words that share a bucket with a word near them, each used
    # once: A B A (A and B distinct, one bucket) and W W where W's 2-byte
    # rotation shares W's bucket, so that a position's candidate is its
    # second-newest lower position in the step
    cand = np.frombuffer(rand(4 << 21), np.uint32)
    b = _mid_bucket(cand)
    order = np.argsort(b, kind="stable")
    same = np.flatnonzero(b[order][1:] == b[order][:-1])[::2][:48]
    pairs = [(cand[order][k].tobytes(), cand[order][k + 1].tobytes())
             for k in same]
    rot = cand[_mid_bucket(cand) == _mid_bucket((cand << 16) | (cand >> 16))]
    order_ = bytearray(rand(24))
    for k, (a, b_) in enumerate(pairs):
        order_ += rand(k % 11) + a + b_ + a + rand(5)
    for k, wv in enumerate(rot[:48]):
        order_ += rand(k % 9) + wv.tobytes() * 2 + rand(6)
    plain["peer-order"] = bytes(order_)
    src = rand(512)
    hits = bytearray(src)
    for k in [40] + list(range(70)):
        a = int(rng.integers(0, len(src) - 16))
        hits += rand(k) + src[a:a + 16]
    plain["lane-hits"] = bytes(hits)
    head = rand(600)
    plain["to-matchlimit"] = head * 3
    plain["to-matchlimit-odd"] = (head[:333] * 4)[:1001]
    for n in (13, 14, 15, 16, 17, 19, 20, 23, 31, 32, 33, 44, 45, 63, 64,
              65, 79, 80):
        k = n % 4 + 1
        body = (rand(k) * 80)[:n] if n % 3 else (rand(12) * 7)[:n]
        plain[f"short{n}"] = body
    window = bytearray(rand(65536))
    block = bytearray(rand(4096))
    for off, back in ((100, 65535), (300, 65536), (500, 65534), (701, 65535),
                      (903, 65536)):
        q = 65536 + off - back
        block[off:off + 16] = window[q:q + 16]
    # a word 65,536 back that is also nearer in the window
    window[40000:40016] = window[1000:1016]
    block[1000:1016] = window[1000:1016]
    block[2000:2400] = window[64000:64400]
    windowed = {"far": (bytes(block), bytes(window), 65536),
                "far-first1": (bytes(block), bytes(window), 65535),
                "far-repeats": ((rand(1000) * 5)[:4096],
                                (rand(4096) * 16)[:65536], 65536)}
    return plain, windowed


def _greedy_bucket(words: np.ndarray) -> np.ndarray:
    """The greedy encoders' 14-bit bucket of little-endian u32 words."""
    return ((words.astype(np.uint64) * 2654435761 % (1 << 32))
            >> 18).astype(np.int64)


def _skip_offset(cnt: int) -> int:
    """Offset from a greedy search's start of its attempt cnt (the skip
    steps 1 + (k >> 6) summed over k < cnt)."""
    return sum(1 + (k >> 6) for k in range(cnt))


def greedy_edge_rows(seed: int = 7) -> tuple[dict, dict]:
    """Rows aimed at the steps of the greedy encoders' warp-cooperative
    parse (K2a, K2b), which runs a search's first attempts as scalar code and
    then scores 32 attempts of the skip schedule per step: (plain,
    windowed).

    plain maps a name to a block of at most 64 KiB:
      * skip rows: a 16-byte key at the row's start, then copies of it, each
        after a fresh stretch that puts the copy at attempt k of its search
        (k = 0-69, 60-70 and 120-134, and one row with k = 1,500 and 2,100),
        so a search's first match falls on every lane of a step, at skip
        strides 1-3 and 24-33, and the stride changes inside a step;
      * buckets: fresh words that share a 14-bit bucket, more than one of
        them inside 32 attempts, in shuffled groups and as A B A (A, B
        distinct), and words whose 2-byte rotation shares their bucket, so a
        lane's candidate is a lower lane that holds another word;
      * corpus.chain_edge_rows' runs of periods 1-4 (alone and after fresh
        bytes), matches to matchlimit and blocks of 13-80 bytes.
    windowed is chain_edge_rows' windowed rows: copies from a 64 KiB window
    exactly 65,534, 65,535 and 65,536 bytes back."""
    rng = np.random.default_rng(seed)

    def rand(n: int) -> bytes:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def skip_row(ks) -> bytes:
        # each copy of the key ends its search at attempt k; the next search
        # starts after the copy (16 bytes, a fresh byte after it). The first
        # search starts on the key itself and takes a copy at attempt 40.
        key = rand(16)
        row = bytearray(key)
        start = 0
        for k in [40] + list(ks):
            fill = start + _skip_offset(k) - len(row)
            row += rand(fill) + key
            start = len(row)
        return bytes(row + rand(16))

    chain_plain, windowed = chain_edge_rows()
    plain = {"skip-0-69": skip_row(range(70)),
             "skip-60-70": skip_row(range(60, 71)),
             "skip-120-134": skip_row(range(120, 135)),
             "skip-1500-2100": skip_row([1500, 2100])}
    # bucket rows: groups of fresh bytes and same-bucket words, each closed
    # by a copy of a key that ends the search, so the next group's words
    # fall on the first lanes of a search's first step (stride 1)
    key = rand(16)
    cand = np.frombuffer(rand(4 << 16), np.uint32)
    b = _greedy_bucket(cand)
    words = [w.tobytes() for w in cand[b == np.bincount(b).argmax()][:8]]
    crowd = bytearray(key + rand(24) + key)
    for g in range(60):
        crowd += rand(int(rng.integers(3, 12)))
        for k in rng.permutation(len(words))[:int(rng.integers(2, 6))]:
            crowd += words[k]
        if g % 2:
            crowd += words[g % 3] + words[(g + 1) % 3] + words[g % 3]
        else:
            crowd += words[g % 8] + rand(g % 3) + words[g % 8]
        crowd += key
    plain["bucket-crowd"] = bytes(crowd)
    cand = np.frombuffer(rand(4 << 20), np.uint32)
    b = _greedy_bucket(cand)
    order = np.argsort(b, kind="stable")
    same = np.flatnonzero(b[order][1:] == b[order][:-1])[::2][:48]
    pairs = [(cand[order][k].tobytes(), cand[order][k + 1].tobytes())
             for k in same]
    rot = cand[b == _greedy_bucket((cand << 16) | (cand >> 16))]
    peer = bytearray(key + rand(24) + key)
    for k, (a, b_) in enumerate(pairs):
        peer += rand(3 + k % 11) + a + b_ + a + rand(5) + key
    for k, wv in enumerate(rot[:48]):
        peer += rand(3 + k % 9) + wv.tobytes() * 2 + rand(6) + key
    plain["peer-order"] = bytes(peer)
    plain.update({k: v for k, v in chain_plain.items()
                  if k.startswith(("period", "to-matchlimit", "short"))})
    return plain, windowed


# the first row width at which each route takes K6b, plain and after a
# 64 KiB window (ops.encode.bw_fits keeps a row 4 bytes narrower on the
# byte-wide kernels): (mid, window bytes) -> width
WIDE_EDGE = {(False, 0): 101144, (True, 0): 109320, (False, 65536): 68440,
             (True, 65536): 76616}


def wide_edge_rows(mid: bool, seed: int = 11) -> tuple[tuple, tuple]:
    """The rows aimed at the greedy (greedy_edge_rows) or the chain
    (chain_edge_rows, mid) parse's steps, at the first width at which K6b
    takes them, whose parse reads its row in device memory:
    ((blocks, N), (blocks, N, windows, wlens)).

    Each plain edge block comes twice at width N = WIDE_EDGE[mid, 0]:
    alone at the row's start, and at the end of a row of N bytes led by
    fresh bytes, so that its last steps meet the end of the row. Each
    windowed block (copies from its 64 KiB window 65,534-65,536 bytes back)
    comes alone and followed by fresh bytes to the full width
    WIDE_EDGE[mid, 65536], after its window."""
    rng = np.random.default_rng(seed)

    def rand(n: int) -> bytes:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    plain, windowed = chain_edge_rows() if mid else greedy_edge_rows()
    N = WIDE_EDGE[mid, 0]
    blocks = []
    for b in plain.values():
        blocks += [b, rand(N - len(b)) + b]
    Nw = WIDE_EDGE[mid, 65536]
    wblocks, wins, wlens = [], [], []
    for b, win, wlen in windowed.values():
        wblocks += [b, b + rand(Nw - len(b))]
        wins += [win, win]
        wlens += [wlen, wlen]
    return (blocks, N), (wblocks, Nw, wins, wlens)


# output positions, offsets and match lengths of decode_edge_batches'
# short-offset rows
SHORT_OFFS = tuple(range(1, 65))
SHORT_MLS = (4, 5, 15, 18, 19, 31, 32, 33, 63, 64, 65, 100, 130)
SHORT_OPS = (0, 1, 7, 31, 32, 40)


def _varint(n: int) -> bytes:
    """The LZ4 length extension bytes of a length field's remainder n."""
    return b"\xff" * (n // 255) + bytes([n % 255])


def lz4_sequence(lits: bytes, off: int = 0, ml: int = 0) -> bytes:
    """One LZ4 sequence: its literals, then (ml >= 4) a match of ml bytes
    at offset off; with ml == 0, a last sequence (literals only)."""
    L, M = len(lits), max(ml - 4, 0)
    out = bytearray([(min(L, 15) << 4) | (min(M, 15) if ml else 0)])
    if L >= 15:
        out += _varint(L - 15)
    out += lits
    if ml:
        out += bytes([off & 255, off >> 8])
        if M >= 15:
            out += _varint(M - 15)
    return bytes(out)


def decode_edge_batches(seed: int = 8) -> dict:
    """Row batches aimed at the block decoders' parse hand-over and copy
    steps (K1 and K3: a parse thread hands sequences, 32 at a time, through
    a ring of 2,048 to warps that copy 224 bytes per step). name -> (rows
    (B, C) uint8, clens (B,) int32, out_cap, window): window is the
    right-aligned dictionary that K3 decodes them against (K1 takes none).

      * short-offsets: one row per (offset 1-64, match length 4-130, output
        position 0-40 where the match starts): a match of a period shorter
        than a step, at and near the row's start, where K3 reads the window
        and K1 refuses an offset past the output;
      * ring-wrap: 64 KiB rows of 8,000-16,000 sequences (the ring wraps 4-8
        times), one of exactly 8,192 (the row ends on a full ring), with
        offsets into the window, and cut or damaged in the middle;
      * clen-over-C: rows whose clen exceeds their width C = 64: literal
        runs and offsets read past it (K1 clips at C - 1, K3 reads zeros),
        length runs of 255s end on its last byte;
      * out-cap: streams that pass out_cap = 64 in the middle of a literal
        run or of a match, or fill it exactly."""
    rng = np.random.default_rng(seed)

    def rand(n: int) -> bytes:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def batch(streams, C, out_cap, window, clens=None):
        rows = np.zeros((len(streams), C), np.uint8)
        for i, s in enumerate(streams):
            s = s[:C]
            rows[i, :len(s)] = np.frombuffer(s, np.uint8)
        if clens is None:
            clens = [len(s) for s in streams]
        return rows, np.asarray(clens, np.int32), out_cap, window

    out = {}
    short = []
    for off in SHORT_OFFS:
        for op in SHORT_OPS:
            lits = bytes((37 * k + 11) & 255 for k in range(op))
            for ml in SHORT_MLS:
                short.append(lz4_sequence(lits, off, ml)
                             + lz4_sequence(b"z"))
    out["short-offsets"] = batch(short, 256, 256, rand(256))

    def chain(n_seq, lit_max, off_max, ml_max, reach, cap=65536 - 64):
        """n_seq match sequences (or until the output nears cap) after 16
        literals, offsets reaching up to `reach` bytes before the row."""
        s = bytearray()
        op = 0
        for k in range(n_seq):
            lits = rand(16 if k == 0 else int(rng.integers(0, lit_max + 1)))
            ml = int(rng.integers(4, ml_max + 1))
            if op + len(lits) + ml > cap:
                break
            off = int(rng.integers(1, min(off_max, op + len(lits) + reach)
                                   + 1))
            s += lz4_sequence(lits, off, ml)
            op += len(lits) + ml
        return bytes(s)

    W = rand(65536)
    m4 = bytearray(lz4_sequence(rand(16), 1, 4))
    for k in range(1, 16000):
        m4 += lz4_sequence(b"", 1 + k % 16, 4)
    wrap = {
        "m4": bytes(m4) + lz4_sequence(rand(5)),
        "mixed": chain(20000, 3, 64, 8, 0) + lz4_sequence(rand(3)),
        "far": chain(12000, 2, 65535, 6, 0) + lz4_sequence(rand(2)),
        "window": chain(12000, 2, 40000, 6, 65536) + lz4_sequence(rand(2)),
        # 8,192 sequences and an empty last one: the parse hands over
        # exactly four rounds of the ring and then an empty batch
        "8192": chain(8192, 1, 300, 6, 0) + bytes([0]),
    }
    for name in ("mixed", "window"):
        s = wrap[name]
        wrap[name + "-cut"] = s[:len(s) * 3 // 5]
        flip = bytearray(s)
        for _ in range(3):
            flip[int(rng.integers(len(s) // 2, len(s)))] ^= int(
                rng.integers(1, 256))
        wrap[name + "-flip"] = bytes(flip)
    out["ring-wrap"] = batch(list(wrap.values()), 65536 + 16, 65536, W)

    C = 64
    over = [
        # literal runs past C, alone and followed by a match
        lz4_sequence(rand(80)), lz4_sequence(rand(61) + b"\x07" * 19),
        lz4_sequence(rand(70), 3, 9) + lz4_sequence(rand(4)),
        # a match length run of 255s that ends on the row's last byte, a
        # literal length that ends there
        b"\x1fa\x01\x00" + b"\xff" * 59 + b"\x02",
        lz4_sequence(rand(16), 9, 4) + b"\xf0" + b"\xff" * 41 + b"\x00",
        # 16 literals and matches whose offset bytes lie past C
        lz4_sequence(rand(16), 5, 6) * 4 + lz4_sequence(rand(9)),
    ]
    clens = [len(s) for s in over]
    over += [rand(C) for _ in range(4)]
    clens += [C + 1, C + 7, 2 * C, 300]
    clens[3], clens[4] = C + 3, C + 9
    out["clen-over-C"] = batch(over, C, 256, rand(256), clens)

    cap = 64
    edge = []
    for lead in (0, 10, 59):
        for extra in (-1, 0, 1, 20):
            n = cap - lead + extra  # the run that reaches cap, +- extra
            head = lz4_sequence(rand(lead), 1, 4) if lead else b""
            pre = lead + 4 if lead else 0
            edge.append(head + lz4_sequence(rand(max(cap - pre + extra, 0))))
            if lead:
                edge.append(lz4_sequence(rand(lead), lead, n)
                            + lz4_sequence(b""))
    edge.append(lz4_sequence(rand(10), 7, 54) + bytes([0]))  # fills it
    edge.append(lz4_sequence(rand(10), 7, 55) + lz4_sequence(rand(2)))
    out["out-cap"] = batch(edge, 128, cap, rand(256))
    return out


def many_sequences(out_len: int, seed: int = 12) -> bytes:
    """A valid LZ4 block stream of short sequences that decodes to at most
    out_len bytes: 0-3 literals and a 4-12 byte match each (~9.5 output
    bytes a sequence, as the whole-block encoder's greedy streams have),
    offsets below 32 for a third of them and anywhere back to 64 KiB for
    the rest, then 5 literals."""
    rng = np.random.default_rng(seed)
    n = out_len // 8
    L = rng.integers(0, 4, n)
    L[0] = 3
    M = rng.integers(4, 13, n)
    end = np.cumsum(L + M)
    n = int(np.searchsorted(end, out_len - 5, side="right"))
    L, M = L[:n], M[:n]
    at = end[:n] - M  # output position of each match
    far = rng.integers(1, 65536, n)
    off = np.where(rng.random(n) < 1 / 3, rng.integers(1, 32, n), far)
    off = np.minimum(off, at)
    size = 3 + L
    start = np.cumsum(size) - size
    s = np.zeros(int(size.sum()), np.uint8)
    s[start] = (L << 4) | (M - 4)
    lit_at = np.repeat(start + 1, L) + (np.arange(int(L.sum()))
                                        - np.repeat(np.cumsum(L) - L, L))
    s[lit_at] = rng.integers(0, 256, len(lit_at), dtype=np.uint8)
    s[start + 1 + L] = off & 255
    s[start + 2 + L] = off >> 8
    return s.tobytes() + lz4_sequence(
        rng.integers(0, 256, 5, dtype=np.uint8).tobytes())


WIDE_CAP = 131072  # K6a's first out_cap in the edge rows (over 96 KiB)
BIG_CAP = 4 << 20  # the LZ4 maximum block


def wide_decode_edge_rows(seed: int = 10) -> dict:
    """Row batches aimed at the whole-block decoder's parse hand-over and
    copy steps with the row and the output in device memory (K6a: a parse
    thread hands sequences, 32 at a time, through a ring of 2,048 to warps
    that copy 224 bytes per step; reads at or past the row's C bytes return
    0; a literal run that fails its checks copies nothing but counts in
    n_out). name -> (rows (B, C) uint8, clens (B,) int32, out_cap).

    At out_cap WIDE_CAP (128 KiB):
      * short-offsets: decode_edge_batches' cases (offset 1-64, match
        length 4-130 after 0-40 literals) chained, one row per offset
        twice: after `offset` literals, and from the row's start with the
        cases rotated so that the first match starts at output position
        0-40 (refused where its offset passes it);
      * ring-wrap: decode_edge_batches' ring-wrap rows (against no window
        their far rows are refused) and 32,700 four-byte matches that fill
        out_cap exactly (the ring wraps 16 times);
      * clen-over-C: decode_edge_batches' rows whose clen exceeds C = 64;
      * out-cap: streams that pass out_cap in the middle of a literal run
        or of a match, or fill it exactly;
      * bad-literal: literal runs that fail their checks (past out_cap,
        past clen, and a junk run read from a token at ip >= clen, whose
        length bytes lie past clen or run to C), each followed by a
        sentinel row that fills out_cap;
      * neighbours: rows of C = 256 whose streams run to C (a literal run
        that ends on C or 4 or 5 bytes before it, a match whose length
        byte lies at C, length runs of 255s that reach it or end 8 or 5
        zero bytes before it, zero literals into the row's zero tail and
        past C, clen > C), each followed by a row of nonzero bytes, the
        last one at the end of the batch.
    At out_cap BIG_CAP (4 MiB):
      * ring-wrap-4m, clen-over-C-4m: the same rows;
      * out-cap-4m: literal runs and matches that pass 4 MiB or fill it;
      * big-4m: many_sequences(BIG_CAP), over 440,000 sequences (the ring
        wraps over 200 times), and after a bad literal run, a cut copy and
        a junk run the full row again as a sentinel (a damaged copy,
        whose verdict depends on where its bytes were flipped, follows a
        sentinel)."""
    rng = np.random.default_rng(seed)

    def rand(n: int) -> bytes:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def batch(streams, out_cap, clens=None, C=None):
        if C is None:
            C = max(16, (max(len(s) for s in streams) + 16 + 3) & ~3)
        rows = np.zeros((len(streams), C), np.uint8)
        for i, s in enumerate(streams):
            s = s[:C]
            rows[i, :len(s)] = np.frombuffer(s, np.uint8)
        clens = [len(s) if n is None else n for s, n in
                 zip(streams, clens or [None] * len(streams))]
        return rows, np.asarray(clens, np.int32), out_cap

    def streams_of(name):
        rows, clens, _, _ = edge[name]
        return [rows[i].tobytes() for i in range(len(clens))], list(clens)

    edge = decode_edge_batches()
    out = {}
    cases = [(op, ml) for op in SHORT_OPS for ml in SHORT_MLS]
    short = []
    for k, off in enumerate(SHORT_OFFS):
        lits = [bytes((37 * j + 11) & 255 for j in range(op))
                for op, _ in cases]
        chain = [lz4_sequence(x, off, ml) for x, (_, ml) in zip(lits, cases)]
        tail = lz4_sequence(b"z")
        # after `off` literals, so that the first match is legal
        short.append(lz4_sequence(rand(off) + lits[0], off, cases[0][1])
                     + b"".join(chain[1:]) + tail)
        r = len(SHORT_MLS) * (k % len(SHORT_OPS))
        short.append(b"".join(chain[r:] + chain[:r]) + tail)
    out["short-offsets"] = batch(short, WIDE_CAP)

    wrap, wrap_clens = streams_of("ring-wrap")
    m4 = bytearray(lz4_sequence(rand(16), 1, 4))
    for k in range(1, 32700):
        m4 += lz4_sequence(b"", 1 + k % 16, 4)
    m4 += lz4_sequence(rand(WIDE_CAP - 4 * 32700 - 16))
    wrap.append(bytes(m4))
    wrap_clens.append(len(m4))
    out["ring-wrap"] = batch(wrap, WIDE_CAP, wrap_clens)
    out["ring-wrap-4m"] = batch(wrap, BIG_CAP, wrap_clens)
    over, over_clens = streams_of("clen-over-C")
    out["clen-over-C"] = batch(over, WIDE_CAP, over_clens, C=64)
    out["clen-over-C-4m"] = batch(over, BIG_CAP, over_clens, C=64)

    def cap_rows(cap, leads, extras):
        """Literal runs that reach cap +- extra after a lead, and matches
        that do (from `lead` bytes back)."""
        rows = []
        for lead in leads:
            for extra in extras:
                head = lz4_sequence(rand(lead), 1, 4) if lead else b""
                pre = lead + 4 if lead else 0
                rows.append(head + lz4_sequence(rand(max(cap - pre + extra,
                                                         0))))
                if lead:
                    rows.append(lz4_sequence(rand(lead), lead,
                                             cap - lead + extra)
                                + lz4_sequence(b""))
        return rows

    fills = [lz4_sequence(rand(10), 7, WIDE_CAP - 10) + bytes([0]),
             lz4_sequence(rand(10), 7, WIDE_CAP - 9) + lz4_sequence(rand(2))]
    out["out-cap"] = batch(cap_rows(WIDE_CAP, (0, 10, 59), (-1, 0, 1, 20))
                           + fills, WIDE_CAP)
    out["out-cap-4m"] = batch(cap_rows(BIG_CAP, (0, 59), (-1, 0, 1)),
                              BIG_CAP)

    def lit_past_cap(cap):
        """9 output bytes, then a literal run 4,000 bytes past cap."""
        n = cap + 4000 - 15
        return (lz4_sequence(b"A", 1, 8) + bytes([0xF0]) + _varint(n)
                + b"b" * 64)

    # a match whose length extension lies past clen, then a junk token
    # there: its run of 541 (or, in the second, 255s that reach C)
    junk = lz4_sequence(b"a", 1, 24)
    junk_clen = len(junk) - 1  # the extension byte lies past clen
    sentinel = many_sequences(WIDE_CAP, seed=seed + 1)
    lit_past_clen = lz4_sequence(rand(16), 3, 20) + lz4_sequence(rand(400))
    bad = [(lit_past_cap(WIDE_CAP), None),
           (lit_past_clen, len(lit_past_clen) - 100),
           (lz4_sequence(rand(400)), 200),
           (junk + bytes([0xF0, 0xFF, 0xFF, 0x10]), junk_clen)]
    streams, clens = [], []
    for s, clen in bad:
        streams += [s, sentinel]
        clens += [len(s) if clen is None else clen, len(sentinel)]
    C = (len(sentinel) + 16 + 3) & ~3
    streams += [junk + bytes([0xF0]) + b"\xff" * (C - len(junk) - 1),
                sentinel]
    clens += [junk_clen, len(sentinel)]
    out["bad-literal"] = batch(streams, WIDE_CAP, clens, C=C)

    C = 256
    nonzero = bytes(rng.integers(1, 256, C, dtype=np.uint8))
    ends = lz4_sequence(rand(254))  # exactly C bytes
    m255 = bytes([0xFF, 1]) + rand(16) + bytes([3, 0])
    m255 += b"\xff" * (C - len(m255))  # a match length run to C
    past = lz4_sequence(rand(300))  # clen > C: zeros past C
    ends5 = lz4_sequence(rand(249))  # 5 zeros after it, the parse reads on
    ends4 = lz4_sequence(rand(249) + b"\x07")  # 4 zeros after it
    # zero literals into the row's zero tail, to C - 4 and past C
    zlits = lz4_sequence(rand(245) + bytes(5))
    zpast = lz4_sequence(rand(240) + bytes(60))
    # literals to C - 2, then the offset: its match length byte lies at C
    at_c = bytes([0xFF, 252 - 15]) + rand(252) + bytes([7, 1])
    l255 = bytes([0xF0]) + b"\xff" * (C - 1)  # a literal length run to C
    # a match length run to the stream's end, 8 zeros before C: the parse's
    # last reads, unguarded, come nearest C
    tail_edge = bytes([0x1F]) + b"a" + bytes([1, 0]) + b"\xff" * (C - 12)
    tail_edge5 = tail_edge + b"\xff" * 3  # 5 zeros: read with the guard
    out["neighbours"] = batch(
        [ends, nonzero, m255, b"\xff" * C, m255, nonzero, past, nonzero,
         ends5, nonzero, ends4, nonzero, at_c, nonzero, zlits, nonzero,
         zpast, nonzero, tail_edge, nonzero, tail_edge5, nonzero, l255,
         b"\xff" * C, l255],
        WIDE_CAP, [C, C, 20, C, C, C, len(past), C] + [C] * 8
        + [len(zpast), C, C - 8, C, C - 5] + [C] * 4, C=C)

    big = many_sequences(BIG_CAP, seed=seed + 2)
    flip = bytearray(big)
    for _ in range(3):
        flip[int(rng.integers(len(big) // 2, len(big)))] ^= int(
            rng.integers(1, 256))
    out["big-4m"] = batch(
        [big, lit_past_cap(BIG_CAP), big, big[:len(big) * 3 // 5], big,
         bytes(flip), junk + bytes([0xF0, 0xFF, 0xFF, 0x10]), big],
        BIG_CAP, [len(big), None, len(big), None, len(big), len(big),
                  junk_clen, len(big)])
    return out
