// The render_fwd.cuh kernels on the tree walk (svox::TreeWalk).
#define SVOX_STRUCTURE svox::TreeWalk
#define SVOX_SUFFIX 
#include "render_fwd.cuh"
