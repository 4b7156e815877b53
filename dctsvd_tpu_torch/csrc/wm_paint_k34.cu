// The K2 and K3 instances of k = 3 and 4 (wm_paint.cuh), in a file of
// their own so that the build compiles them beside the other k values.
#include "wm_paint.cuh"

DCTSVD_PAINT_INSTANCES(3)
DCTSVD_PAINT_INSTANCES(4)
