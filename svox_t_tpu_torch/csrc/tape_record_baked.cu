// The tape_record.cuh kernels (K13a, K13b, K15) on the bake (svox::Baked).
#define SVOX_STRUCTURE svox::Baked
#define SVOX_SUFFIX _baked
#include "tape_record.cuh"
