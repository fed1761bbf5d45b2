// The tape_replay.cuh forward (K13c) on a float32 pool.
#define SVOX_TAPE_PASS 0
#define SVOX_SUFFIX 
#include "tape_replay.cuh"
