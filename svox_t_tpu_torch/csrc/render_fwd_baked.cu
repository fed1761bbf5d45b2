// The render_fwd.cuh kernels on the bake (svox::Baked).
#define SVOX_STRUCTURE svox::Baked
#define SVOX_SUFFIX _baked
#include "render_fwd.cuh"
