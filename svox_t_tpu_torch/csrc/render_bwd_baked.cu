// The render_bwd.cuh kernels on the bake (svox::Baked).
#define SVOX_STRUCTURE svox::Baked
#define SVOX_SUFFIX _baked
#include "render_bwd.cuh"
