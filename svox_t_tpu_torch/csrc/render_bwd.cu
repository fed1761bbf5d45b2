// The render_bwd.cuh kernels on the tree walk (svox::TreeWalk).
#define SVOX_STRUCTURE svox::TreeWalk
#define SVOX_SUFFIX 
#include "render_bwd.cuh"
