// The tape_record.cuh kernels (K13a, K13b, K15) on the tree walk (svox::TreeWalk).
#define SVOX_STRUCTURE svox::TreeWalk
#define SVOX_SUFFIX 
#include "tape_record.cuh"
