"""The payload generator, and the objects a traffic mix asks for, made
from the seed.

silesia_bulk draws the segment model of the program's Silesia-like corpus
(plz4_tpu_torch/corpus.py:silesia_like: the same segment kinds, mix,
sizes, vocabulary and word draws) a segment at a time in numpy, so that
32 MiB take about a second where the word-by-word original takes ~15 s.
Its bytes are its own: a change to the program's generator cannot change
the benchmark's inputs. The real Silesia corpus cannot be fetched where
the benchmark runs.

A traffic file gives the sizes (traffic/*.json):
  corpus       the generator (silesia_bulk)
  base_bytes   bytes made once, from corpus_seed
  total_bytes  bytes of each object (silesia.tar's 211,957,760)
  objects      number of objects
  align_bytes  the grain of the offsets (the block size)
Object k is the base, tiled, read from an offset drawn from the run's
seed, a whole number of align_bytes. With independent blocks of that size
every seed sends the same blocks in another order: a seed changes neither
the work nor the ratio, beyond the last partial block. (Offsets at any
byte cut the blocks elsewhere, and moved level 12's rate by up to 8%
from seed to seed, on the H100.)
"""

from __future__ import annotations

import numpy as np

_COMMON = [b"the", b"of", b"and", b"in", b"to", b"a", b"is", b"was",
           b"for", b"on", b"as", b"with", b"by", b"at", b"from", b"that",
           b"it", b"his", b"are", b"were", b"which", b"this", b"also",
           b"has", b"had", b"an", b"be", b"or", b"its", b"first", b"one",
           b"new", b"their", b"after", b"who", b"but", b"not", b"have",
           b"her", b"she", b"two", b"other", b"time", b"when", b"during"]
_LOG = np.frombuffer(b"2026-08-00 00:00:00 host00 svc[000]: ", np.uint8)
# the log line's numbers: (first digit's column, digits, low, high)
_FIELDS = ((8, 2, 1, 29), (11, 2, 0, 24), (14, 2, 0, 60), (17, 2, 0, 60),
           (24, 2, 1, 20), (31, 3, 100, 999))


def _table(words):
    """Words as one byte array, with each word's start and length."""
    lens = np.array([len(w) for w in words], np.int64)
    return (np.frombuffer(b"".join(words), np.uint8),
            np.cumsum(lens) - lens, lens)


def _gather(src, starts, lens):
    """The src[starts[i]:starts[i] + lens[i]], one after another."""
    ends = np.cumsum(lens)
    idx = np.arange(ends[-1]) + np.repeat(starts - (ends - lens), lens)
    return src[idx]


def _ints(rng, lo: int, hi: int, n: int) -> np.ndarray:
    """n whole numbers in [lo, hi), from rng.random() alone: numpy keeps
    that stream from version to version, and does not promise it for its
    integers() and zipf() samplers (a draft of this generator that used
    them made other bytes under numpy 2.0 and 2.3, for one seed)."""
    return lo + (rng.random(n) * (hi - lo)).astype(np.int64)


def _int(rng, lo: int, hi: int) -> int:
    return int(_ints(rng, lo, hi, 1)[0])


def _zipf_mod(n: int, a: float = 1.3, terms: int = 1 << 22) -> np.ndarray:
    """The cumulative distribution of zipf(a) % n over 0..n-1, over its
    first `terms` values (99% of the mass at a = 1.3)."""
    k = np.arange(1, terms + 1)
    p = np.bincount(k % n, weights=k.astype(np.float64) ** -a, minlength=n)
    return np.cumsum(p / p.sum())


def silesia_bulk(size: int, seed: int = 2003) -> bytes:
    """Mixed-mode corpus in Silesia's spirit: concatenated segments of
    text (200 sentences of 6-21 words, 55% from a list of common words,
    the rest Zipf-drawn from 4,000 random words of 4-13 letters),
    structured records (300 log lines), sparse binary (5-20 KB, one byte
    in 50 set) and incompressible data (3-12 KB), drawn in that mix."""
    rng = np.random.default_rng(seed)
    nc = len(_COMMON)
    tl = _ints(rng, 4, 14, 4000)
    letters = _ints(rng, 97, 123, int(tl.sum())).astype(np.uint8).tobytes()
    tail = [letters[a - n:a] for a, n in zip(np.cumsum(tl), tl)]
    zipf = _zipf_mod(len(tail))
    words = _COMMON + tail
    nw = len(words)
    src, starts, lens = _table([w + b" " for w in words]
                               + [w + b". " for w in words]
                               + [w + b" ok\n" for w in _COMMON])
    parts, n = [], 0
    while n < size:
        kind = rng.random()
        if kind < 0.45:  # text: 200 sentences
            k = _ints(rng, 6, 22, 200)
            w = int(k.sum())
            rare = np.searchsorted(zipf, rng.random(w), side="right")
            ids = np.where(rng.random(w) < 0.55, _ints(rng, 0, nc, w),
                           nc + np.minimum(rare, len(tail) - 1))
            last = np.cumsum(k) - 1
            ids[last] += nw  # the sentence's last word ends in ". "
            seg = _gather(src, starts[ids], lens[ids])
            ends = np.cumsum(lens[ids])
            seg[np.concatenate(([0], ends[last[:-1]]))] -= 32  # capital
        elif kind < 0.70:  # structured records: 300 log lines
            lines = np.tile(_LOG, (300, 1))
            for col, nd, lo, hi in _FIELDS:
                v = _ints(rng, lo, hi, 300)
                for d in range(nd):
                    lines[:, col + nd - 1 - d] = 48 + v % 10
                    v = v // 10
            ids = 2 * nw + _ints(rng, 0, nc, 300)
            L = len(_LOG)
            both = np.concatenate((src, lines.reshape(-1)))
            st = np.stack((len(src) + L * np.arange(300), starts[ids]), 1)
            ln = np.stack((np.full(300, L), lens[ids]), 1)
            seg = _gather(both, st.reshape(-1), ln.reshape(-1))
        elif kind < 0.85:  # sparse binary
            seg = np.zeros(_int(rng, 5000, 20000), dtype=np.uint8)
            pos = _ints(rng, 0, len(seg), len(seg) // 50)
            seg[pos] = _ints(rng, 1, 256, len(pos))
        else:  # incompressible
            seg = _ints(rng, 0, 256, _int(rng, 3000, 12000)).astype(np.uint8)
        parts.append(seg)
        n += len(seg)
    return np.concatenate(parts)[:size].tobytes()


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one use of the run's seed (any whole number)."""
    return np.random.default_rng([seed % (1 << 64), *stream])


def objects(traffic: dict, seed: int) -> list[bytes]:
    """The traffic's objects for this seed (see the module docstring)."""
    make = {"silesia_bulk": silesia_bulk}[traffic["corpus"]]
    base = np.frombuffer(make(traffic["base_bytes"], traffic["corpus_seed"]),
                         np.uint8)
    total = traffic["total_bytes"]
    tiled = np.tile(base, -(-total // len(base)) + 1)
    grain = traffic["align_bytes"]
    offsets = grain * seed_rng(seed, 0).integers(0, len(base) // grain,
                                                 traffic["objects"])
    return [tiled[r:r + total].tobytes() for r in offsets]
