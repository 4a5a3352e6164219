// The banded scans and WTA at bands above 64 (banded_wide.cuh) for int16
// costs and volumes.

#include "banded_wide.cuh"

SVT_EXPORT long long svt_banded_wide_diag_scratch_bytes(int P, int Wv, int K, int device) {
  return wide_diag_scratch_bytes<int16_t>(P, Wv, K, device);
}

SVT_EXPORT int svt_banded_wide_vertical(const void* C, const void* shift, void* dn, void* up, void* scratch, int P,
                                        int H, int Wv, int K, int G, int P1, int P2, int diagonals, void* stream) {
  return wide_vertical_entry<int16_t>(C, shift, dn, up, scratch, P, H, Wv, K, G, P1, P2, diagonals, stream);
}

SVT_EXPORT int svt_banded_wide_horizontal(const void* C, const void* shift, void* out, int P, int H, int Wv, int K,
                                          int G, int P1, int P2, int reverse, void* stream) {
  return wide_horizontal_entry<int16_t>(C, shift, out, P, H, Wv, K, G, P1, P2, reverse, stream);
}

SVT_EXPORT int svt_banded_wide_wta(const void* v0, const void* v1, const void* v2, const void* v3, int nvol,
                                   void* minS, void* best, void* m2, void* m3, void* m4, void* uok, int npix, int K,
                                   int uniq, int sub, void* stream) {
  return wide_wta_entry<int16_t>(v0, v1, v2, v3, nvol, minS, best, m2, m3, m4, uok, npix, K, uniq, sub, stream);
}
