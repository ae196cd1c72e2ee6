// The on-policy entry points of fused_rollout.cu (K1/K3, K4's on-policy
// actor kernel and the critic pass) as a library of their own, so that its
// nvcc run goes beside offpolicy_rollout.cu's (ops/_cuda_build.py hashes the
// included file with this one).
#define ELEGANTRL_ONPOLICY_ONLY
#include "fused_rollout.cu"
