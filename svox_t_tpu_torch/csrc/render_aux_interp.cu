// The render_aux.cuh kernels with trilinear interpolation (K4) on the tree walk.
#define SVOX_STRUCTURE svox::TreeWalk
#define SVOX_SUFFIX _interp
#define SVOX_INTERP 1
#include "render_aux.cuh"
