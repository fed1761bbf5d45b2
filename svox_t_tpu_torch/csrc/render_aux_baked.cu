// The render_aux.cuh kernels on the bake (svox::Baked).
#define SVOX_STRUCTURE svox::Baked
#define SVOX_SUFFIX _baked
#include "render_aux.cuh"
