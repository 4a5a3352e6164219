// The 8-path vertical scan (banded_diag.cuh) for int32 costs and volumes.

#define SVT_DIAG_T int
#include "banded_diag.cuh"
