// The off-policy entry points of fused_rollout.cu (K6/K6' and K4 under the
// ddpg, sac and modsac heads) as a library of their own, so that its nvcc
// run goes beside onpolicy_rollout.cu's (ops/_cuda_build.py hashes the
// included file with this one).
#define ELEGANTRL_OFFPOLICY_ONLY
#include "fused_rollout.cu"
