// Host build of the CUDA kernels' row bodies (lz4_encode.cuh,
// lz4_decode.cuh, lz4_decode_window.cuh), compiled with g++ so that the CPU
// tests can run the kernels' own logic on machines without a GPU. Same
// layouts and results as the kernels' launchers.
#include <string.h>

#include <vector>

#include "lz4_decode.cuh"
#include "lz4_decode_window.cuh"
#include "lz4_encode.cuh"

// K2a: lz4_encode.cu
extern "C" void lz4t_host_encode(const uint8_t* data, const int32_t* lens,
                                 uint8_t* out, int32_t* totals, uint8_t* ok,
                                 int B, int N, int CAP) {
  std::vector<uint32_t> tab(1 << LZ4T_HASH_LOG), vtab(1 << LZ4T_HASH_LOG);
  std::vector<uint8_t> row(N + 8);
  for (int b = 0; b < B; b++) {
    memset(tab.data(), 0, tab.size() * 4);
    memset(vtab.data(), 0, vtab.size() * 4);
    memset(row.data(), 0, row.size());
    memcpy(row.data(), data + (size_t)b * N, N);
    int total, okv;
    lz4t_encode_row<true>(row.data(), N + 8, 0, 0, lens[b],
                          out + (size_t)b * CAP, CAP, tab.data(), vtab.data(),
                          &total, &okv);
    totals[b] = total;
    ok[b] = okv != 0;
  }
}

// K2b: lz4_encode_window.cu
extern "C" void lz4t_host_encode_window(const uint8_t* data,
                                        const int32_t* lens,
                                        const uint8_t* win,
                                        const int32_t* wlens, uint8_t* out,
                                        int32_t* totals, uint8_t* ok, int R,
                                        int N, int D, int K, int wstride,
                                        int CAP) {
  std::vector<uint32_t> tab(1 << LZ4T_HASH_LOG);
  std::vector<uint8_t> row(D + N + 8);
  for (int r = 0; r < R; r++) {
    memset(tab.data(), 0, tab.size() * 4);
    memset(row.data(), 0, row.size());
    memcpy(row.data(),
           r % K ? data + (size_t)(r - 1) * N : win + (size_t)(r / K) * D, D);
    memcpy(row.data() + D, data + (size_t)r * N, N);
    const int first = D - lz4t_min(lz4t_max(wlens[r], 0), D);
    lz4t_window_preload(row.data(), D, first, wstride, tab.data());
    int total, okv;
    lz4t_encode_row<false>(row.data(), D + N + 8, D, first, lens[r],
                           out + (size_t)r * CAP, CAP, tab.data(), nullptr,
                           &total, &okv);
    totals[r] = total;
    ok[r] = okv != 0;
  }
}

// K1: lz4_decode.cu
extern "C" void lz4t_host_decode(const uint8_t* comp, const int32_t* clens,
                                 uint8_t* out, int32_t* n_out, uint8_t* ok,
                                 int B, int C, int out_cap) {
  for (int b = 0; b < B; b++) {
    int n, okv;
    lz4t_decode_row(comp + (size_t)b * C, C, clens[b],
                    out + (size_t)b * out_cap, out_cap, &n, &okv);
    n_out[b] = n;
    ok[b] = okv != 0;
  }
}

// K3: lz4_decode_window.cu, lz4t_launch_dict
extern "C" void lz4t_host_decode_dict(const uint8_t* comp,
                                      const int32_t* clens,
                                      const uint8_t* dict, uint8_t* out,
                                      int32_t* n_out, uint8_t* ok, int B,
                                      int C, int D, int dlen, int out_cap) {
  for (int b = 0; b < B; b++) {
    const int32_t meta[7] = {clens[b], dlen, 0, 0, 0, 0, out_cap};
    int n, okv;
    lz4t_decode_window_row<true>(comp + (size_t)b * C, C, meta, dict, D,
                                 out + (size_t)b * out_cap, out_cap, &n,
                                 &okv);
    n_out[b] = n;
    ok[b] = okv != 0;
  }
}

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
      lz4t_decode_window_row<false>(rows + rec * CIN, CIN, metas + rec * 7,
                                    win, W, o, W, &n, &okv);
      n_outs[rec] = n;
      oks[rec] = okv != 0;
      win = o;
    }
  }
}
