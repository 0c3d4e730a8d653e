// The family epilogue over an NI x NJ register tile of Gram values, for the
// kernels that build k(X, Z) in registers without the shared `gram_tile`
// (K2 and K7 on the cluster route, K5). The arithmetic is gram_tile's
// epilogue: d2 = max(xn + zn - 2 x.z, 0) (the dot product itself for the
// linear family), then family_epilogue; the switch over the family is
// taken once per tile, not once per value.
#pragma once

#include "gram_tile.cuh"

namespace repro {

// g (x . z on entry) -> k(x, z) for an NI x NJ register tile, its rows' and
// columns' squared norms given; the arithmetic of gram_tile's epilogue.
template <int FAM, int NI, int NJ>
__device__ __forceinline__ void tile_epilogue(float (&g)[NI][NJ], const float (&xn)[NI],
                                              const float (&zn)[NJ], float s) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float pre = FAM == LINEAR ? g[i][j] : fmaxf(xn[i] + zn[j] - 2.0f * g[i][j], 0.0f);
      g[i][j] = family_epilogue(FAM, pre, s);
    }
}

// The family switch taken once per register tile, not once per value.
template <int NI, int NJ>
__device__ __forceinline__ void tile_epilogue(int fam, float (&g)[NI][NJ], const float (&xn)[NI],
                                              const float (&zn)[NJ], float s) {
  switch (fam) {
    case GAUSSIAN: tile_epilogue<GAUSSIAN>(g, xn, zn, s); break;
    case LAPLACIAN: tile_epilogue<LAPLACIAN>(g, xn, zn, s); break;
    case LINEAR: tile_epilogue<LINEAR>(g, xn, zn, s); break;
    case MATERN32: tile_epilogue<MATERN32>(g, xn, zn, s); break;
    case CAUCHY: tile_epilogue<CAUCHY>(g, xn, zn, s); break;
    default: tile_epilogue<-1>(g, xn, zn, s);  // NaN: the wrappers never pass another id
  }
}

}  // namespace repro
