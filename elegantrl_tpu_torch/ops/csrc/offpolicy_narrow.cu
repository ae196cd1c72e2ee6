// The off-policy entry points of fused_rollout.cu in their narrower streamed
// lane groups (K6/K6' at 8 and 4 lanes, K4 under the ddpg, sac and modsac
// heads at 16, 8 and 4) as a library of their own, so that its nvcc run
// goes beside the other halves' (ops/_cuda_build.py hashes the included file
// with this one).
#define ELEGANTRL_OFFPOLICY_ONLY
#define ELEGANTRL_NARROW
#include "fused_rollout.cu"
