// The tape_replay.cuh backward (K13d, and K13e: its frame axis) on a
// float32 pool.
#define SVOX_TAPE_PASS 1
#define SVOX_SUFFIX 
#include "tape_replay.cuh"
