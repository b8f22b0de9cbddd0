// Kernel C's launch entry points on bf16 feature maps (conv_transpose1d.cu),
// compiled apart from those on float32 maps so that the two build in
// parallel.
#define FHT_BF16_MAPS
#include "conv_transpose1d.cu"
