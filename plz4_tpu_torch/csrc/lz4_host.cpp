// Host build of the CUDA kernels' row bodies (lz4_encode.cuh,
// lz4_encode_mid.cuh, lz4_encode_deep.cuh, lz4_encode_wide.cuh,
// lz4_decode_window.cuh, lz4_decode_ring.cuh, xxh32.cuh), compiled with g++
// so that the CPU tests can run the kernels' own logic on machines without
// a GPU and hold it to the plain versions and to the Pallas kernels. Same
// layouts and results as the kernels' launchers. The bodies that warps run
// together (K1, K2a-K2d, K3, K4, K5, K6a, K6b) run their lanes' steps as
// loops over lanes 0-31 here (lz4_lanes.cuh).
#include <string.h>

#include <algorithm>
#include <vector>

#include "lz4_decode_ring.cuh"
#include "lz4_decode_window.cuh"
#include "lz4_encode.cuh"
#include "lz4_encode_deep.cuh"
#include "lz4_encode_mid.cuh"
#include "lz4_encode_wide.cuh"
#include "xxh32.cuh"

// Stage row r of a window launch: [the last Dc bytes of its D-byte window |
// block | 8 zero bytes]. Row r takes row r - 1 as its window when r % K > 0,
// else win[r / K]. Returns first, the row's first usable window byte.
static int stage_window_row(std::vector<uint8_t>& row, const uint8_t* data,
                            const uint8_t* win, const int32_t* wlens, int r,
                            int N, int D, int K, int Dc) {
  row.assign(Dc + N + 8, 0);
  if (Dc) {
    const uint8_t* w =
        r % K ? data + (size_t)(r - 1) * N : win + (size_t)(r / K) * D;
    memcpy(row.data(), w + (D - Dc), Dc);
  }
  memcpy(row.data() + Dc, data + (size_t)r * N, N);
  return lz4t_window_first(wlens, r, Dc);
}

// K2a (D = 0, lz4_encode.cu) and K2b (lz4_encode_window.cu): the lanes'
// parse on a u32 copy of the row with one word after it, then the emit of
// its sequences wherever total < CAP.
static void encode_greedy(const uint8_t* data, const int32_t* lens,
                          const uint8_t* win, const int32_t* wlens,
                          uint8_t* out, int32_t* totals, uint8_t* ok, int R,
                          int N, int D, int K, int wstride, int CAP) {
  const int DT = D + N + 8;
  std::vector<uint32_t> tab(1 << LZ4T_HASH_LOG), w(DT / 4 + 1);
  std::vector<uint8_t> own(1 << LZ4T_HASH_LOG);
  std::vector<int> seq(4 * (N / 4 + 2));
  std::vector<uint8_t> row;
  for (int r = 0; r < R; r++) {
    memset(tab.data(), 0, tab.size() * 4);
    const int first = stage_window_row(row, data, win, wlens, r, N, D, K, D);
    lz4t_window_preload(row.data(), D, first, wstride, tab.data());
    int total, okv;
    memcpy(w.data(), row.data(), DT);
    lz4t_seq_store sink = {seq.data()};
    const int k = lz4t_encode_row_lanes(w.data(), DT, D, first, lens[r], CAP,
                                        tab.data(), own.data(), sink, &total,
                                        &okv);
    if (total < CAP)
      lz4t_seq_emit(row.data(), out + (size_t)r * CAP, CAP, D, seq.data(), k,
                    0, 1);
    totals[r] = total;
    ok[r] = okv != 0;
  }
}

// K2a: lz4_encode.cu
extern "C" void lz4t_host_encode(const uint8_t* data, const int32_t* lens,
                                 uint8_t* out, int32_t* totals, uint8_t* ok,
                                 int B, int N, int CAP) {
  encode_greedy(data, lens, nullptr, nullptr, out, totals, ok, B, N, 0, 1, 1,
                CAP);
}

// K2b: lz4_encode_window.cu
extern "C" void lz4t_host_encode_window(const uint8_t* data,
                                        const int32_t* lens,
                                        const uint8_t* win,
                                        const int32_t* wlens, uint8_t* out,
                                        int32_t* totals, uint8_t* ok, int R,
                                        int N, int D, int K, int wstride,
                                        int CAP) {
  encode_greedy(data, lens, win, wlens, out, totals, ok, R, N, D, K, wstride,
                CAP);
}

// K2c (depth 2) and K2d (depth 4): lz4_encode_mid.cu, the lanes' parse on
// a u32 copy of the row with one word after it, then the emit of its
// sequences wherever total < CAP. D = 0 is a plain row.
template <int kDepth>
static void encode_mid_row(const std::vector<uint8_t>& row,
                           const std::vector<uint32_t>& w,
                           std::vector<int>& seq, int D, int first, int n,
                           int wstride, uint8_t* o, int CAP,
                           const lz4t_mid_tabs& t, int* total, int* okv) {
  const int DT = (int)row.size();
  lz4t_mid_preload<kDepth>(row.data(), D, first, wstride, t);
  lz4t_seq_store sink = {seq.data()};
  const int k = lz4t_encode_mid_row_lanes<kDepth>(w.data(), DT, D, first, n,
                                                  CAP, t, sink, total, okv);
  if (*total < CAP) lz4t_seq_emit(row.data(), o, CAP, D, seq.data(), k, 0, 1);
}

static void encode_mid(const uint8_t* data, const int32_t* lens,
                       const uint8_t* win, const int32_t* wlens, uint8_t* out,
                       int32_t* totals, uint8_t* ok, int R, int N, int D,
                       int K, int wstride, int CAP, int depth4) {
  const int T = 1 << LZ4T_MID_HASH_LOG;
  const int DT = D + N + 8;
  std::vector<uint32_t> tabs(4 * T), w(DT / 4 + 1);
  std::vector<int> seq(4 * (N / 4 + 2));
  std::vector<uint8_t> row;
  const lz4t_mid_tabs t = {tabs.data(), tabs.data() + T, tabs.data() + 2 * T,
                           tabs.data() + 3 * T};
  for (int r = 0; r < R; r++) {
    memset(tabs.data(), 0, tabs.size() * 4);
    const int first = stage_window_row(row, data, win, wlens, r, N, D, K, D);
    memcpy(w.data(), row.data(), DT);
    int total, okv;
    uint8_t* o = out + (size_t)r * CAP;
    if (depth4)
      encode_mid_row<4>(row, w, seq, D, first, lens[r], wstride, o, CAP, t,
                        &total, &okv);
    else
      encode_mid_row<2>(row, w, seq, D, first, lens[r], wstride, o, CAP, t,
                        &total, &okv);
    totals[r] = total;
    ok[r] = okv != 0;
  }
}

extern "C" void lz4t_host_encode_mid(const uint8_t* data, const int32_t* lens,
                                     const uint8_t* win, const int32_t* wlens,
                                     uint8_t* out, int32_t* totals,
                                     uint8_t* ok, int R, int N, int D, int K,
                                     int wstride, int CAP, int depth4) {
  encode_mid(data, lens, win, wlens, out, totals, ok, R, N, D, K, wstride,
             CAP, depth4);
}

// K4's peer ring of a plain row's split build (lz4t_peer_ring) on the
// host: where the card's build warp waits for chunk k, the peer words of
// the chunks up to k are computed in order, each only once the chunk
// before it in its slot has been handed back, as the card's peer warps
// wait for it; a chunk the build hands back is poisoned at once, as are
// the slots before their first chunk, so a build that reads a word it has
// not waited for, or one it has handed back, takes a lower peer 31 lanes
// down and writes bucket 0's head, and builds another chain. A chunk
// needed while its slot is still held would hang the card: *stuck is then
// set.
struct host_peer_sync {
  static constexpr uint32_t kPoison =
      LZ4T_PEER_HEAD | LZ4T_PEER_LOWER | 31u << 16;
  const uint8_t* c;
  int last, hash_log;
  uint32_t* slot;
  int made, freed;
  bool* stuck;
  void fill() {
    constexpr int S = LZ4T_DEEP_PEER_SLOTS, E = LZ4T_DEEP_PEER_CHUNK;
    if (made - freed >= S) *stuck = true;
    for (int t0 = made * E; t0 < (made + 1) * E && t0 <= last;
         t0 += LZ4T_LANES)
      lz4t_peer_step(c, t0, last, hash_log, slot + (t0 & (S * E - 1)));
    made++;
  }
  void wait_full(int k) {
    while (made <= k) fill();
  }
  void hand_back(int k) {
    constexpr int S = LZ4T_DEEP_PEER_SLOTS, E = LZ4T_DEEP_PEER_CHUNK;
    std::fill_n(slot + (k & (S - 1)) * E, E, kPoison);
    freed = k + 1;
  }
};

// K4's chain build of row r into delta (Dc + N + 8 entries): the split
// build through the peer ring (peers, LZ4T_DEEP_PEER_SLOTS x
// LZ4T_DEEP_PEER_CHUNK words) where split holds (a plain row of the
// pipelined kernel), else lz4t_deep_build. Returns the row's first usable
// position; a build that would hang the card leaves every delta 0xFFFF.
static int deep_chain_row(std::vector<uint8_t>& row,
                          std::vector<uint32_t>& head,
                          std::vector<uint32_t>& peers, uint16_t* delta,
                          const uint8_t* data, const int32_t* lens,
                          const uint8_t* win, const int32_t* wlens, int r,
                          int N, int D, int K, int Dc, int hash_log,
                          bool split) {
  memset(head.data(), 0, head.size() * 4);
  const int first = stage_window_row(row, data, win, wlens, r, N, D, K, Dc);
  const int last = Dc + lens[r] - 12;
  if (!split) {
    lz4t_deep_build(row.data(), first, last, hash_log, head.data(), delta);
    return first;
  }
  peers.assign(LZ4T_DEEP_PEER_SLOTS * LZ4T_DEEP_PEER_CHUNK,
               host_peer_sync::kPoison);
  bool stuck = false;
  lz4t_peer_ring<host_peer_sync> pr = {
      peers.data(),
      {row.data(), last, hash_log, peers.data(), 0, 0, &stuck}};
  lz4t_deep_build_split(last, head.data(), delta, pr);
  if (stuck)
    for (int q = 0; q < N + 8; q++) delta[q] = 0xFFFF;
  return first;
}

// K4: lz4_encode_deep.cu. Each row's window is the last Dc of its D bytes
// (D = Dc = 0 for plain rows).
extern "C" void lz4t_host_encode_deep(const uint8_t* data,
                                      const int32_t* lens,
                                      const uint8_t* win,
                                      const int32_t* wlens, uint8_t* out,
                                      int32_t* totals, uint8_t* ok, int R,
                                      int N, int D, int K, int Dc, int CAP,
                                      int tries, int hash_log) {
  const int DT = Dc + N + 8;
  std::vector<uint32_t> head(1 << hash_log), tab(N);
  std::vector<uint16_t> ring(LZ4T_DEEP_RING), delta(DT);
  std::vector<uint8_t> row;
  std::vector<uint32_t> peers;
  for (int r = 0; r < R; r++) {
    const int first = deep_chain_row(row, head, peers, delta.data(), data,
                                     lens, win, wlens, r, N, D, K, Dc,
                                     hash_log, false);
    const int mflimit = Dc + lens[r] - 12, matchlimit = Dc + lens[r] - 5;
    for (int q = 0; q < LZ4T_DEEP_RING && q < DT; q++) ring[q] = delta[q];
    lz4t_ring rg = {ring.data(), delta.data(), LZ4T_DEEP_RING};
    lz4t_walk_table(row.data(), Dc, Dc,
                    lz4t_min(mflimit, LZ4T_DEEP_RING - 1), first, matchlimit,
                    tries, rg, tab.data(), 0, 1);
    if (mflimit >= LZ4T_DEEP_RING) {
      for (int q = LZ4T_DEEP_RING; q < DT; q++)
        ring[q & (LZ4T_DEEP_RING - 1)] = delta[q];
      rg.loaded = DT;
      lz4t_walk_table(row.data(), Dc, LZ4T_DEEP_RING, mflimit, first,
                      matchlimit, tries, rg, tab.data(), 0, 1);
    }
    int total, okv;
    lz4t_dev_tab dt = {tab.data(), Dc};
    lz4t_encode_deep_row(row.data(), Dc, first, lens[r],
                         out + (size_t)r * CAP, CAP, tries, rg, dt, &total,
                         &okv);
    totals[r] = total;
    ok[r] = okv != 0;
  }
}

// K4's table ring of plain rows (lz4t_pipe_tab) on the host: where the
// card's parse waits for chunk k, the table fills the chunks up to k in
// order (a chunk, then the parse reads what is ready), each only once the
// chunk before it in its slot has been handed back, as the card's table
// warps wait for it; a chunk the parse hands back is poisoned at once, as
// are the slots before their first chunk, so a parse that reads an entry
// it has not waited for, or one it has handed back, reads a 63-byte match
// at offset 1 and fails the tests. A chunk needed while its slot is still
// held, or a parse that ends holding chunks, would hang the card: the row
// then reports total -1.
struct host_pipe_sync {
  static constexpr uint32_t kPoison = 63u << 16 | 1u;
  const uint8_t* c;
  int base, mflimit, first, matchlimit, tries;
  const lz4t_ring* rg;
  uint32_t* slot;
  int made, freed;
  bool* stuck;
  void fill() {
    constexpr int S = LZ4T_DEEP_PIPE_SLOTS, E = LZ4T_DEEP_PIPE_CHUNK;
    if (made - freed >= S) *stuck = true;
    const int p0 = base + made * E;
    for (int p = p0; p < p0 + E && p <= mflimit; p++)
      slot[(p - base) & (S * E - 1)] =
          lz4t_walk_entry(c, p, first, matchlimit, tries, *rg);
    made++;
  }
  void wait_full(int k) {
    while (made <= k) fill();
  }
  void hand_back(int k) {
    constexpr int S = LZ4T_DEEP_PIPE_SLOTS, E = LZ4T_DEEP_PIPE_CHUNK;
    for (int i = 0; i < E; i++) slot[(k & (S - 1)) * E + i] = kPoison;
    freed = k + 1;
  }
};

// K4 on plain rows: lz4_encode_deep.cu's lz4t_encode_deep_plain_kernel,
// the split build reading its peers through the peer ring, the parse the
// table through the table ring, each as it is filled.
extern "C" void lz4t_host_encode_deep_plain(const uint8_t* data,
                                            const int32_t* lens,
                                            uint8_t* out, int32_t* totals,
                                            uint8_t* ok, int R, int N,
                                            int CAP, int tries,
                                            int hash_log) {
  const int DT = N + 8;
  std::vector<uint32_t> head(1 << hash_log);
  std::vector<uint32_t> slot(LZ4T_DEEP_PIPE_SLOTS * LZ4T_DEEP_PIPE_CHUNK);
  std::vector<uint16_t> ring(LZ4T_DEEP_RING), delta(DT);
  std::vector<uint8_t> row;
  std::vector<uint32_t> peers;
  for (int r = 0; r < R; r++) {
    deep_chain_row(row, head, peers, delta.data(), data, lens, nullptr,
                   nullptr, r, N, 0, 1, 0, hash_log, true);
    const int mflimit = lens[r] - 12, matchlimit = lens[r] - 5;
    for (int q = 0; q < LZ4T_DEEP_RING && q < DT; q++) ring[q] = delta[q];
    const lz4t_ring rg = {ring.data(), delta.data(), LZ4T_DEEP_RING};
    for (uint32_t& e : slot) e = host_pipe_sync::kPoison;
    bool stuck = false;
    lz4t_pipe_tab<host_pipe_sync> tab = {
        slot.data(),
        0,
        lz4t_pipe_chunks(0, mflimit),
        {row.data(), 0, mflimit, 0, matchlimit, tries, &rg, slot.data(), 0,
         0, &stuck},
        0,
        0,
        0,
        0};
    int total, okv;
    lz4t_encode_deep_row(row.data(), 0, 0, lens[r], out + (size_t)r * CAP,
                         CAP, tries, rg, tab, &total, &okv);
    stuck |= tab.freed != tab.nchunks;  // the card's table warps need all
    totals[r] = stuck ? -1 : total;
    ok[r] = okv != 0 && !stuck;
  }
}

// K4's chain alone, built as the kernel that the wrapper routes the rows
// to builds it (the split build for plain rows of at most LZ4T_DEEP_RING
// bytes): delta (R, Dc + N + 8) u16, zeroed by the caller, gets the deltas
// of every row's positions [first, mflimit].
extern "C" void lz4t_host_deep_chain(const uint8_t* data, const int32_t* lens,
                                     const uint8_t* win, const int32_t* wlens,
                                     uint16_t* delta, int R, int N, int D,
                                     int K, int Dc, int hash_log) {
  std::vector<uint32_t> head(1 << hash_log);
  std::vector<uint8_t> row;
  std::vector<uint32_t> peers;
  for (int r = 0; r < R; r++)
    deep_chain_row(row, head, peers, delta + (size_t)r * (Dc + N + 8), data,
                   lens, win, wlens, r, N, D, K, Dc, hash_log,
                   !D && N <= LZ4T_DEEP_RING);
}

// K1, K3 and K6a's ring (lz4_decode_ring.cuh) on the host: the parse fills
// LZ4T_RING_BATCHES slots of 32 sequences, publishing a batch as the card's
// parse does, and where the card's parse would wait for a free slot, the
// copies of the oldest published batch run (LZ4T_RING_WARPS warps, the
// last first), their literals read through the parse's Row. The copies
// read a batch as it was when it was published (a later change to it,
// which the card's copy warps may not see, is lost here), and its slot is
// poisoned as soon as they have read it, so copies that read a slot after
// releasing it fail the tests.
template <class Row>
struct host_ring {
  Row row;
  uint8_t* o;
  const uint8_t* win;
  int W;
  std::vector<int32_t> slots =
      std::vector<int32_t>(LZ4T_RING_BATCHES * 32 * 4);
  std::vector<int32_t> published = slots;  // each slot as published
  int cnt[LZ4T_RING_BATCHES];
  int k = 0, pub = 0, copied = 0, bop = 0;
  int32_t* entry(int q) {
    return slots.data() + ((q >> 5) % LZ4T_RING_BATCHES) * 128 + 4 * (q & 31);
  }
  void copy_oldest() {
    int32_t* e = published.data() + (entry(32 * copied) - slots.data());
    bop = lz4t_copy_batch_lanes<LZ4T_RING_WARPS>(
        row, o, win, W, e, cnt[copied % LZ4T_RING_BATCHES], bop, 0,
        [this, e] {
          memset(e, 0xA5, 128 * sizeof(int32_t));
          memset(entry(32 * copied), 0xA5, 128 * sizeof(int32_t));
        });
    copied++;
  }
  void publish(int n) {
    const int s = pub++ % LZ4T_RING_BATCHES;
    cnt[s] = n;
    memcpy(published.data() + s * 128, slots.data() + s * 128,
           128 * sizeof(int32_t));
  }
  void open() {
    const int b = k >> 5;
    if (pub < b) publish(32);
    while (b - copied >= LZ4T_RING_BATCHES) copy_oldest();
  }
  void operator()(int ip, int n_lit, int off, int m) {
    int32_t* e = entry(k++);
    e[0] = ip;
    e[1] = n_lit;
    e[2] = off;
    e[3] = m;
  }
  void drop_last() { entry(k - 1)[3] = 0; }
  void finish() {
    if ((k & 31) == 0) open();
    publish(k & 31);
    while (copied < pub) copy_oldest();
  }
};

// one row of K1 (kClip) or K3 through the ring: the row staged with its
// pad as the card stages it
template <bool kClip>
static void ring_row(const uint8_t* row, int C, int clen, const uint8_t* win,
                     int W, int dlen, uint8_t* o, int out_cap, int32_t* n_out,
                     uint8_t* ok) {
  std::vector<uint32_t> cw((C + LZ4T_RING_PAD) / 4);
  uint8_t* cb = reinterpret_cast<uint8_t*>(cw.data());
  memcpy(cb, row, C);
  memset(cb + C, kClip && C ? row[C - 1] : 0, LZ4T_RING_PAD);
  const lz4t_pad_row prow = {cb, C};
  host_ring<lz4t_pad_row> ring = {prow, o, win, W};
  int n, okv;
  lz4t_parse_strict<kClip, false>(prow, clen, dlen, out_cap, ring, &n, &okv);
  ring.finish();
  *n_out = n;
  *ok = okv != 0;
}

// K1: lz4_decode.cu
extern "C" void lz4t_host_decode(const uint8_t* comp, const int32_t* clens,
                                 uint8_t* out, int32_t* n_out, uint8_t* ok,
                                 int B, int C, int out_cap) {
  for (int b = 0; b < B; b++)
    ring_row<true>(comp + (size_t)b * C, C, clens[b], nullptr, 0, 0,
                   out + (size_t)b * out_cap, out_cap, n_out + b, ok + b);
}

// K3: lz4_decode_window.cu, lz4t_launch_dict
extern "C" void lz4t_host_decode_dict(const uint8_t* comp,
                                      const int32_t* clens,
                                      const uint8_t* dict, uint8_t* out,
                                      int32_t* n_out, uint8_t* ok, int B,
                                      int C, int D, int dlen, int out_cap) {
  for (int b = 0; b < B; b++)
    ring_row<false>(comp + (size_t)b * C, C, clens[b], dict, D, dlen,
                    out + (size_t)b * out_cap, out_cap, n_out + b, ok + b);
}

// K5's parsed sequences, as the parse kernel stores them
struct host_seqs {
  std::vector<int32_t> v;
  void operator()(int ip, int n_lit, int off, int m) {
    v.insert(v.end(), {ip, n_lit, off, m});
  }
};

// K5: lz4_decode_window.cu, lz4t_launch_records
extern "C" void lz4t_host_decode_records(const uint8_t* rows,
                                         const int32_t* metas,
                                         const uint8_t* win0s, uint8_t* outs,
                                         int32_t* n_outs, uint8_t* oks,
                                         int B, int K, int CIN, int W) {
  for (int b = 0; b < B; b++) {
    const uint8_t* win = win0s + (size_t)b * W;
    for (int k = 0; k < K; k++) {
      const size_t rec = (size_t)b * K + k;
      uint8_t* o = outs + rec * W;
      memset(o, 0, W);
      int n, okv;
      host_seqs seqs;
      lz4t_decode_record(rows + rec * CIN, CIN, metas + rec * 7, W, seqs, &n,
                         &okv);
      lz4t_copy_record_lanes(rows + rec * CIN, CIN, o, win, W, seqs.v.data(),
                             (int)seqs.v.size() / 4, 0);
      n_outs[rec] = n;
      oks[rec] = okv != 0;
      win = o;
    }
  }
}

// K6b's ring (lz4_encode_wide.cuh) on the host: the parse's sink fills
// LZ4T_WRING_BATCHES slots of 32 sequences, storing each batch's first
// anchor, and where the card's parse would wait for a free slot, the
// oldest published batch is written (by LZ4T_WRING_WARPS emit warps, the
// last first). A batch is written as it was when it was published, and
// its slot is poisoned once written.
struct host_wring {
  static constexpr bool kAllLanes = true;
  const uint8_t* c;
  uint8_t* o;
  int OT;
  int anchor;
  std::vector<int> slots = std::vector<int>(LZ4T_WRING_BATCHES * 128);
  std::vector<int> published = slots;  // each slot as published
  int cnt[LZ4T_WRING_BATCHES], anc[LZ4T_WRING_BATCHES];
  int pub = 0, written = 0;
  void write_oldest() {
    const int s = written % LZ4T_WRING_BATCHES;
    int* e = published.data() + s * 128;
    for (int wi = LZ4T_WRING_WARPS - 1; wi >= 0; wi--)
      lz4t_wseq_batch<LZ4T_WRING_WARPS>(c, o, OT, e, cnt[s], anc[s], wi);
    memset(e, 0xA5, 128 * sizeof(int));
    memset(slots.data() + s * 128, 0xA5, 128 * sizeof(int));
    written++;
  }
  void open(int b) {
    while (b - written >= LZ4T_WRING_BATCHES) write_oldest();
    anc[b % LZ4T_WRING_BATCHES] = anchor;
  }
  void publish(int b, int n) {
    const int s = b % LZ4T_WRING_BATCHES;
    cnt[s] = n;
    memcpy(published.data() + s * 128, slots.data() + s * 128,
           128 * sizeof(int));
    pub++;
  }
  void operator()(int k, int op, int mip, int mlen, int mpos) {
    if (!(k & 31)) open(k >> 5);
    lz4t_seq_put(slots.data() + (k >> 5) % LZ4T_WRING_BATCHES * 128, k & 31,
                 op, mip, mlen, mpos);
    anchor = mip + mlen;
    if ((k & 31) == 31) publish(k >> 5, 32);
  }
  void finish(int k) {
    if (!(k & 31)) open(k >> 5);
    publish(k >> 5, k & 31);
    while (written < pub) write_oldest();
  }
};

// K6b: lz4_encode_wide.cu. Rows are [window D | block | 8 zero bytes]; the
// window preload inserts every usable position in order. Each row is read
// from a copy of exactly DT bytes and the one word after them that the
// parse may read (zero), so a read past it shows under AddressSanitizer.
// The tables: greedy's 2^14 positions, or the chain's two tables of 2^13.
extern "C" void lz4t_host_encode_wide(const uint8_t* rows, const int32_t* lens,
                                      const int32_t* wlens, uint8_t* out,
                                      int32_t* totals, uint8_t* ok, int R,
                                      int DT, int D, int CAP, int mid) {
  std::vector<uint32_t> tabs(1 << LZ4T_HASH_LOG);
  std::vector<uint8_t> own(1 << LZ4T_HASH_LOG);
  for (int r = 0; r < R; r++) {
    memset(tabs.data(), 0, tabs.size() * 4);
    std::vector<uint32_t> w(DT / 4 + 1);
    memcpy(w.data(), rows + (size_t)r * DT, DT);
    const uint8_t* c = reinterpret_cast<const uint8_t*>(w.data());
    uint8_t* o = out + (size_t)r * CAP;
    const int first = lz4t_window_first(wlens, r, D);
    const int T = 1 << LZ4T_MID_HASH_LOG;
    const lz4t_mid_tabs t = {tabs.data(), tabs.data() + T, nullptr, nullptr};
    uint32_t* tab = tabs.data();
    int total, okv;
    if (mid)
      lz4t_mid_preload<2>(c, D, first, 1, t);
    else
      lz4t_window_preload(c, D, first, 1, tab);
    host_wring ring = {c, o, CAP, D};
    const int k =
        mid ? lz4t_encode_mid_row_lanes<2, false>(w.data(), DT, D, first,
                                                  lens[r], CAP, t, ring,
                                                  &total, &okv)
            : lz4t_encode_row_lanes<false>(w.data(), DT, D, first, lens[r],
                                           CAP, tab, own.data(), ring, &total,
                                           &okv);
    ring.finish(k);
    totals[r] = total;
    ok[r] = okv != 0;
  }
}

// one row of K6a through the ring, read in place through row
template <class Row>
static void wide_ring_row(const Row& row, int clen, uint8_t* o, int out_cap,
                          int32_t* n_out, uint8_t* ok) {
  host_ring<Row> ring = {row, o, nullptr, 0};
  int n, okv;
  lz4t_parse_strict<false, true>(row, clen, 0, out_cap, ring, &n, &okv);
  ring.finish();
  *n_out = n;
  *ok = okv != 0;
}

// K6a: lz4_decode_wide.cu, the parse and the copies through the ring on
// the row in place, read as the card reads it. A row that ends in zeros
// its stream does not reach (lz4t_tail_row, no guard) is read from a copy
// of exactly its C bytes, so that a read past them shows under
// AddressSanitizer; any other (lz4t_dev_row) from a copy followed by 16
// bytes of 0xFF, as a row in device memory is followed by the next row's
// bytes, so that a read past C that the guard lets through gives other
// results.
extern "C" void lz4t_host_decode_wide(const uint8_t* comp,
                                      const int32_t* clens, uint8_t* out,
                                      int32_t* n_out, uint8_t* ok, int B,
                                      int C, int out_cap) {
  for (int b = 0; b < B; b++) {
    const uint8_t* row = comp + (size_t)b * C;
    uint8_t* o = out + (size_t)b * out_cap;
    if (lz4t_tail_fits(row, C, clens[b])) {
      const std::vector<uint8_t> c(row, row + C);
      wide_ring_row(lz4t_tail_row{c.data(), C}, clens[b], o, out_cap,
                    n_out + b, ok + b);
    } else {
      std::vector<uint8_t> c(C + 16, 0xFF);
      memcpy(c.data(), row, C);
      wide_ring_row(lz4t_dev_row{c.data(), C}, clens[b], o, out_cap,
                    n_out + b, ok + b);
    }
  }
}

// K7: xxh32.cu, the kernel's steps in its order: chunk c + 1 staged into
// the two-chunk ring before chunk c is folded
extern "C" void lz4t_host_xxh32(const uint8_t* data, const int32_t* lens,
                                int64_t* out, int B, int W, int seed) {
  const int CW = LZ4T_XXH_CHUNK / 4;
  std::vector<uint32_t> ring(2 * CW);
  for (int r = 0; r < B; r++) {
    const uint8_t* p = data + (size_t)r * W;
    const int len = lens[r];
    const int nc = (len + LZ4T_XXH_CHUNK - 1) / LZ4T_XXH_CHUNK;
    if (nc)
      lz4t_xxh32_stage(p, len, 0, lz4t_min(len, LZ4T_XXH_CHUNK), ring.data(),
                       0, 1);
    uint32_t acc[4];
    lz4t_xxh32_init(acc, (uint32_t)seed);
    for (int c = 0; c < nc; c++) {
      const int b0 = c * LZ4T_XXH_CHUNK, b1 = b0 + LZ4T_XXH_CHUNK;
      if (b1 < len)
        lz4t_xxh32_stage(p, len, b1, lz4t_min(len, b1 + LZ4T_XXH_CHUNK),
                         ring.data() + ((c + 1) & 1) * CW, 0, 1);
      lz4t_xxh32_stripes(acc, ring.data() + (c & 1) * CW,
                         (lz4t_min(len, b1) - b0) >> 4);
    }
    const int b0 = nc ? (nc - 1) * LZ4T_XXH_CHUNK : 0;
    const uint8_t* last = reinterpret_cast<const uint8_t*>(
        ring.data() + (nc ? (nc - 1) & 1 : 0) * CW);
    out[r] = lz4t_xxh32_finish(acc, last + (len / 16 * 16 - b0), len,
                               (uint32_t)seed);
  }
}
