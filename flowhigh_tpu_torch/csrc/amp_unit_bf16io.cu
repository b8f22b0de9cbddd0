// Kernel E's launch entry points on bf16 feature maps (amp_unit.cu),
// compiled apart from those on float32 maps so that the two build in
// parallel.
#define FHT_BF16_MAPS
#include "amp_unit.cu"
