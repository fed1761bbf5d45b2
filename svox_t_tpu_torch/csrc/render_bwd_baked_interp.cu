// The render_bwd.cuh kernels with trilinear interpolation (K4) on the bake.
#define SVOX_STRUCTURE svox::Baked
#define SVOX_SUFFIX _baked_interp
#define SVOX_INTERP 1
#include "render_bwd.cuh"
