// The on-policy entry points of fused_rollout.cu in their narrower streamed
// lane groups (K1/K3 at 8 and 4 lanes, K4's on-policy actor at 16, 8 and 4,
// the critic pass at 16 samples) as a library of their own, so that its
// nvcc run goes beside the other halves' (ops/_cuda_build.py hashes the
// included file with this one).
#define ELEGANTRL_ONPOLICY_ONLY
#define ELEGANTRL_NARROW
#include "fused_rollout.cu"
