// The 8-path vertical scan (banded_diag.cuh) for int16 costs and volumes.

#include <cstdint>

#define SVT_DIAG_T int16_t
#include "banded_diag.cuh"
