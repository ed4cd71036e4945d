// The kv-tile walk of the flash kernels' block-sparse forms (IDX = true in
// flash_fixed.cu and flash_online.cu): the counterpart of the TPU kernels'
// scalar-prefetched block ids (nunchaku_tpu/ops/attention.py
// block_sparse_attention :1241, the kv BlockSpec index map
// idx[g, i, j]). The ids stay on the card; each block reads its own.
#pragma once

#include "common.cuh"

struct Sparse {
  const int* idx;  // (B*H, nq, kk) int32 kv-block ids, ascending in the last axis
  int nq, kk, bq, bkv;
  float scale_log2;  // the factor on f32(q . k): 1 when q carries softmax-scale * log2(e)
};

// The kv tiles of one query tile (rows q0 .. q0 + tile - 1, inside one query
// block of bq rows). Dense: tile t starts at t * TILE. Sparse: tile t is
// sub-tile t % (bkv / TILE) of the (t / (bkv / TILE))-th selected block; only
// the largest id can be the ragged tail block, whose sub-tiles past Skv are
// left out (the kernels mask its columns past Skv inside a visited one).
template <bool IDX, int TILE>
struct KvWalk {
  const int* ids;  // this query tile's kk block ids (IDX)
  int spb, bkv, nt;
  __device__ KvWalk(const Sparse& sp, int bh, int q0, int Skv) {
    if (IDX) {
      ids = sp.idx + (static_cast<size_t>(bh) * sp.nq + q0 / sp.bq) * sp.kk;
      spb = sp.bkv / TILE;
      bkv = sp.bkv;
      const int rem = max(Skv - __ldg(ids + sp.kk - 1) * sp.bkv, 0);  // valid columns of the last block
      nt = (sp.kk - 1) * spb + min(spb, (rem + TILE - 1) / TILE);
    } else {
      ids = nullptr;
      spb = bkv = 0;
      nt = (Skv + TILE - 1) / TILE;
    }
  }
  __device__ int start(int t) const { return IDX ? __ldg(ids + t / spb) * bkv + (t % spb) * TILE : t * TILE; }
};
