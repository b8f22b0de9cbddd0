// Kernel D's launch entry points on bf16 feature maps (act_conv1d.cu),
// compiled apart from those on float32 maps so that the two build in
// parallel.
#define FHT_BF16_MAPS
#include "act_conv1d.cu"
