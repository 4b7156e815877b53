// The K2 and K3 instances of k = 5 and 6 (wm_paint.cuh), in a file of
// their own so that the build compiles them beside the other k values.
#include "wm_paint.cuh"

DCTSVD_PAINT_INSTANCES(5)
DCTSVD_PAINT_INSTANCES(6)
