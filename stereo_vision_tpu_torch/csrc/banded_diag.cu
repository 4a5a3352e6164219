// The 8-path vertical scan (banded_diag.cuh) for int16 costs and volumes.

#include "banded_diag.cuh"

SVT_EXPORT long long svt_banded_vertical_diag_scratch_bytes(int P, int Wv, int K, int device) {
  return diag_scratch_bytes<int16_t>(P, Wv, K, device);
}

SVT_EXPORT int svt_banded_vertical_diag(const void* C, const void* shift, void* dn, void* up, void* scratch, int P,
                                        int H, int Wv, int K, int G, int P1, int P2, void* stream) {
  return diag_entry<int16_t>(C, shift, dn, up, scratch, P, H, Wv, K, G, P1, P2, stream);
}
