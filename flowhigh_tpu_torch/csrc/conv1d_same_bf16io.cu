// Kernel B's launch entry points on bf16 feature maps (conv1d_same.cu),
// compiled apart from those on float32 maps so that the two build in
// parallel.
#define FHT_BF16_MAPS
#include "conv1d_same.cu"
