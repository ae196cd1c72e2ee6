"""The on-policy kernels at the widths their second designs take: the
rollout (K1/K3, thread-block clusters, up to (320, 320)) and the PPO update
(K2/K5, one cooperative launch, any width).

- The plain rollout at (256, 256) against the JAX package's Pallas rollout
  kernel in interpret mode, and the plain update at (512, 512) against its
  Pallas update kernel in interpret mode, on the same weights, blocks and
  noise, at small N, H and U.  Tolerances as ``test_torch_fused_rollout.py``
  (teacher-forced values and logprobs 2e-5, whole trajectories 1e-4, flags
  exact) and, for the update, ``test_torch_fused_update.py``'s (each
  parameter's update (new - old) to rtol 5e-3, objectives rtol 1e-4) and
  ``chip_smoke.py``'s bound for K2 against this plain version (within 5e-3
  of the largest update of its leaf).  The update starts from warm Adam
  moments (count 5, non-zero mu and nu), so a step depends on the
  gradient's magnitude and not only on its sign, and its clip binds on the
  critic's gradient but not on the actor's; the test also checks that the
  Adam step of twice the JAX gradient falls outside both bounds.
- The Python copies of the kernels' shared-memory reckoning against the
  sources: the rollout's ``RolloutLayout`` evaluated from the text of
  ``csrc/fused_rollout.cu``, the split-K rule of ``cm::tile_dense``, and the
  update's fixed shared memory (``gg::Smem``) and phase count.
"""
import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.agents.ppo import make_ppo as jmake_ppo
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.envs.pendulum import make_pendulum as jmake_pendulum
from elegantrl_tpu.ops.pallas_rollout import make_pendulum_ppo_rollout
from elegantrl_tpu.ops.pallas_update import (_adam_parts, _with_adam_parts,
                                             make_ppo_fused_update as jmake_fused)
from elegantrl_tpu_torch.agents.ppo import norm_state
from elegantrl_tpu_torch.ops import dists
from elegantrl_tpu_torch.ops import fused_rollout as fr
from elegantrl_tpu_torch.ops import fused_update as fu
from elegantrl_tpu_torch.ops.kernels import ldk
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves
from elegantrl_tpu_torch.utils.jax_params import ppo_state_from_numpy, ppo_state_to_numpy

torch.set_num_threads(1)
CSRC = Path(fr.__file__).resolve().parent / 'csrc'
# clip_grad 0.5: the update test's critic gradient (global norm ~0.8) is
# clipped, its actor gradient (~0.3) is not, so both branches of the clip run
HP = dict(ratio_clip=0.25, lambda_entropy=0.001, lr=6e-5, clip_grad=0.5)


def _jax_state(net_dims):
    args = JConfig()
    args.net_dims = net_dims
    s = jmake_ppo(net_dims, 3, 1, args).init(jax.random.PRNGKey(0))
    return s._replace(norm_avg=jnp.array([0.1, -0.2, 0.3]), norm_std=jnp.array([0.9, 1.1, 2.0]))


def test_wide_rollout_plain_matches_pallas_kernel():
    net, H, N = (256, 256), 4, 8
    s = _jax_state(net)
    env = jmake_pendulum()
    env_state = jax.vmap(env.init)(jax.random.split(jax.random.PRNGKey(7), N))
    env_state = env_state._replace(t=(193 + jnp.arange(N)).astype(jnp.int32))   # some truncate
    key = jax.random.PRNGKey(3)
    fast = make_pendulum_ppo_rollout(net, H, N, reward_scale=0.5, block=8, interpret=True)
    jro, jenv2, _ = fast(s, env_state, jax.vmap(env.obs)(env_state), key)
    kz, ku = jax.random.split(key)
    noise = np.array(jnp.concatenate([jax.random.normal(kz, (H, 1, N), jnp.float32),
                                       jax.random.uniform(ku, (H, 2, N), jnp.float32)], axis=1))
    st = ppo_state_from_numpy(jax.tree.map(np.asarray, s), 'cpu')
    f0 = torch.from_numpy(np.stack([np.array(env_state.theta), np.array(env_state.theta_dot)]))
    i0 = torch.from_numpy(np.array(env_state.t))[None]
    out = fr.rollout_reference(st.act_flat, st.cri_flat, st.norm_avg, st.norm_std, f0, i0,
                               noise=torch.from_numpy(noise), net_dims=net, horizon_len=H,
                               reward_scale=0.5)
    np.testing.assert_array_equal(1.0 - out.truncates.numpy(), np.asarray(jro.unmasks))
    np.testing.assert_array_equal(1.0 - out.terminals.numpy(), np.asarray(jro.undones))
    for field, want in (('states', jro.states), ('actions', jro.actions),
                        ('logprobs', jro.logprobs), ('rewards', jro.rewards),
                        ('values', jro.extras['values'])):
        np.testing.assert_allclose(getattr(out, field).numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4, err_msg=field)
    np.testing.assert_allclose(out.env_f[0].numpy(), np.asarray(jenv2.theta), atol=1e-4)
    # teacher-forced on the JAX rollout's own states and actions
    states = torch.from_numpy(np.moveaxis(np.asarray(jro.states), 1, 2).copy())
    actions = torch.from_numpy(np.moveaxis(np.asarray(jro.actions), 1, 2).copy())
    with torch.no_grad():
        x = norm_state(states, st.norm_avg, st.norm_std)
        lp = dists.normal_logprob(actions, st.act(x), torch.exp(st.act.std_log)).sum(-1)
        v = st.cri(x)[..., 0]
    np.testing.assert_allclose(lp.numpy(), np.asarray(jro.logprobs), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jro.extras['values']), rtol=2e-5, atol=2e-5)


def _warm(s, count=5):
    """``s`` at a later step: Adam count ``count`` and non-zero moments."""
    key = iter(jax.random.split(jax.random.PRNGKey(5), 64))

    def warm_opt(opt):
        _, mu, nu = _adam_parts(opt)
        mu = jax.tree.map(lambda x: 1e-4 * jax.random.normal(next(key), x.shape), mu)
        nu = jax.tree.map(lambda x: 1e-8 * jax.random.uniform(next(key), x.shape), nu)
        return _with_adam_parts(opt, jnp.asarray(count, jnp.int32), mu, nu)
    return s._replace(act_opt=warm_opt(s.act_opt), cri_opt=warm_opt(s.cri_opt))


def _adam_step(mu, nu, g, count, b1=0.9, b2=0.999, eps=1e-8):
    """The parameter update of one Adam step from moments ``mu``, ``nu`` at
    ``count`` with gradient ``g`` (optax's ``scale_by_adam`` + ``scale(-lr)``)."""
    mu, nu = b1 * mu + (1 - b1) * g, b2 * nu + (1 - b2) * g * g
    mhat, vhat = mu / (1 - b1 ** (count + 1)), nu / (1 - b2 ** (count + 1))
    return -HP['lr'] * mhat / (np.sqrt(vhat) + eps)


def test_wide_update_plain_matches_pallas_kernel():
    net, B, U, count = (512, 512), 128, 1, 5
    s = _warm(_jax_state(net), count)
    rng = np.random.default_rng(4)
    block = (rng.standard_normal((U, 3, B)).astype(np.float32),
             rng.standard_normal((U, 1, B)).astype(np.float32),
             (rng.standard_normal((U, B)) * 0.3 - 1.2).astype(np.float32),
             rng.standard_normal((U, B)).astype(np.float32),
             rng.standard_normal((U, B)).astype(np.float32),
             (rng.uniform(size=(U, B)) > 0.05).astype(np.float32))
    fused = jmake_fused(3, 1, B, U, interpret=True, **HP)
    act, cri, act_opt, cri_opt, jm = fused(s.act, s.cri, s.act_opt, s.cri_opt, s.norm_avg,
                                           s.norm_std, *map(jnp.asarray, block))
    js_new = s._replace(act=act, cri=cri, act_opt=act_opt, cri_opt=cri_opt)
    st = ppo_state_from_numpy(jax.tree.map(np.asarray, s), 'cpu')
    old = ppo_state_to_numpy(st)
    objs = fu.ppo_update_reference(
        st.act_flat, st.cri_flat, st.act_opt.mu, st.act_opt.nu, st.cri_opt.mu, st.cri_opt.nu,
        st.act_opt.count, st.cri_opt.count, st.norm_avg, st.norm_std,
        *map(torch.from_numpy, block), net_dims=net, **HP)
    new = ppo_state_to_numpy(st)
    jnew, jold = jax.tree.map(np.asarray, js_new), jax.tree.map(np.asarray, s)
    for part in ('act', 'cri'):
        _, mu0, nu0 = _adam_parts(getattr(jold, part + '_opt'))
        mu1 = _adam_parts(getattr(jnew, part + '_opt'))[1]
        for a, b, ja, jb, m0, v0, m1 in zip(
                tree_leaves(getattr(new, part)), tree_leaves(getattr(old, part)),
                jax.tree.leaves(getattr(jnew, part)), jax.tree.leaves(getattr(jold, part)),
                jax.tree.leaves(mu0), jax.tree.leaves(nu0), jax.tree.leaves(mu1)):
            got, want = np.asarray(a) - np.asarray(b), ja - jb
            np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-8, err_msg=part)
            bound = 5e-3 * np.abs(want).max()
            assert np.abs(got - want).max() <= bound, part
            # twice the gradient the JAX kernel took (after its clip) is caught
            # on every leaf of more than one entry (a scalar leaf's step is
            # near lr sign(g): its gradient outweighs both moments)
            g = (m1 - 0.9 * m0) / 0.1
            doubled = _adam_step(m0.astype(np.float64), v0.astype(np.float64), 2.0 * g, count)
            if want.size > 1:
                assert np.abs(doubled - want).max() > bound, part
                assert not np.allclose(doubled, want, rtol=5e-3, atol=1e-8), part
    for k, name in enumerate(('obj_critic', 'obj_actor', 'obj_entropy')):
        np.testing.assert_allclose(float(objs[:, k].mean()), float(jm[name]), rtol=1e-4,
                                   atol=1e-6)


def _round4(n):
    return (n + 3) // 4 * 4


def _layout_floats(text, S, A, NH, NE, D1, D2, c):
    """``RolloutLayout(S, A, NH, NE, D1, D2, c).floats`` evaluated from the
    constructor's text in ``csrc/fused_rollout.cu``."""
    body = text[text.index('__host__ __device__ RolloutLayout('):]
    body = body[body.index('{') + 1:body.index('floats = o;')]
    body = re.sub(r'//[^\n]*', '', body).replace('cm::', '').replace('int o', 'o')
    env = {'round4': _round4, 'slice': lambda d, cc: _round4(-(-d // cc)), 'ldk': ldk,
           'max': max, 'tile_scratch': fr.tile_scratch, 'TE': 32, 'S': S, 'A': A, 'NH': NH,
           'NE': NE, 'D1': D1, 'D2': D2, 'c': c}
    for stmt in ' '.join(body.split()).split(';'):
        if stmt.strip():
            exec(stmt.strip(), env)
    return env['o']


@pytest.mark.parametrize('dims', [(128, 128), (256, 256), (64, 96), (320, 320), (8, 40)],
                         ids=lambda d: f'{d[0]}x{d[1]}')
def test_rollout_layout_copy_matches_the_source(dims):
    text = (CSRC / 'fused_rollout.cu').read_text()
    for body in fr.KERNEL_ENV_BODIES.values():
        nh = body.action_dim if body.discrete else 2 * body.action_dim
        for c in fr.ROLLOUT_CLUSTERS:
            want = 4 * _layout_floats(text, body.state_dim, body.action_dim, nh,
                                      body.n_step + body.n_reset, *dims, c)
            assert fr.rollout_smem_bytes(body, dims, c) == want, (body.env_name, dims, c)


def test_tile_scratch_follows_tile_dense():
    """The split-K rule of ``cm::tile_dense`` is the one both copies of its
    scratch reckoning follow."""
    rule = 'while (2 * ks * tiles <= THREADS && 8 * ks <= K) ks *= 2;'
    assert rule in (CSRC / 'cluster_mlp.cuh').read_text()
    assert rule.replace('THREADS', 'cm::THREADS') in (CSRC / 'fused_rollout.cu').read_text()
    assert fr.tile_scratch(128, 4) == 32 * 4 * 32      # 8 tiles: K cut in 32 parts
    assert fr.tile_scratch(128, 128) == 0              # 256 tiles: no split
    assert fr.tile_scratch(64, 64) == 2 * 64 * 32


def test_rollout_fits_up_to_what_a_cluster_of_8_holds():
    for body in fr.KERNEL_ENV_BODIES.values():
        assert fr.rollout_fits(body, (256, 256)) and fr.rollout_fits(body, (128, 128))
        assert not fr.rollout_fits(body, (384, 384)) and not fr.rollout_fits(body, (64, 64, 64))
        limit = 288 if body.env_name == 'PointChasingDiscreteEnv' else 320
        assert fr.rollout_fits(body, (limit, limit))
        assert not fr.rollout_fits(body, (limit + 4, limit + 4))
        assert min(fr.rollout_smem_bytes(body, (limit, limit), c)
                   for c in fr.ROLLOUT_CLUSTERS) <= fr.SMEM_LIMIT


def test_rollout_cluster_pick_is_asked_once_per_shape(monkeypatch):
    """The wrapper keeps the kernel's cluster pick per (body, envs, widths,
    device) and asks the library again only for a new key or after a
    failed pick."""
    asked = []

    class Lib:
        def fused_rollout_cluster(self, body_id, n, d1, d2, cluster):
            asked.append((body_id, n, d1, d2, cluster))
            return 0 if n == 7 else 4

    monkeypatch.setattr(fr, '_CLUSTER_PICKS', {})
    body, lib = fr.PENDULUM_BODY, Lib()
    dev0, dev1 = torch.device('cuda', 0), torch.device('cuda', 1)
    assert [fr._rollout_cluster(lib, body, 1024, 128, 128, dev0) for _ in range(3)] == [4, 4, 4]
    assert fr._rollout_cluster(lib, body, 1024, 128, 128, dev1) == 4
    assert fr._rollout_cluster(lib, body, 256, 128, 128, dev0) == 4
    assert fr._rollout_cluster(lib, body, 7, 128, 128, dev0) == 0
    assert fr._rollout_cluster(lib, body, 7, 128, 128, dev0) == 0
    assert asked == [(body.kernel_id, n, 128, 128, 0) for n in (1024, 1024, 256, 7, 7)]


class _Smem(ctypes.Structure):  # gg::Smem, csrc/grid_gemm.cuh
    _fields_ = [('a', ctypes.c_float * 33 * 32), ('b', ctypes.c_float * 33 * 32),
                ('red', ctypes.c_float * 2 * 8)]


def test_update_smem_and_phases_match_the_source():
    text = (CSRC / 'ppo_update.cu').read_text()
    assert fu.PPO_SMEM_BYTES == ctypes.sizeof(_Smem)
    assert 'return (int)sizeof(gg::Smem);' in text
    nph = int(re.search(r'constexpr int NPH = (\d+);', text).group(1))
    assert len(fu.PPO_PHASES) == nph == 8
    for net in ((64, 64), (512, 512), (2048, 2048)):
        assert fu.update_fits(net)
    assert not fu.update_fits((64, 64, 64))
