// The render_aux.cuh kernels on the tree walk (svox::TreeWalk).
#define SVOX_STRUCTURE svox::TreeWalk
#define SVOX_SUFFIX 
#include "render_aux.cuh"
