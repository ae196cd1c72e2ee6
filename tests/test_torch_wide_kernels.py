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
  sources: the rollout's ``RolloutLayout``, the off-policy rollout's
  ``OffLayout`` (and the stock body's ``StockActorLayout`` under each head)
  and the critic pass's ``CriticLayout``, each evaluated from the text of
  ``csrc/fused_rollout.cu``, the split-K rule of ``cm::tile_dense``, and the
  update's fixed shared memory (``gg::Smem``) and phase count.
"""
import ctypes
import itertools
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


def _wrow(k, bf):
    """``cm::wrow`` of csrc/cluster_mlp.cuh."""
    k8 = (k + 7) // 8 * 8
    return (k8 + (8 if k8 // 8 % 2 == 0 else 0)) // 2 if bf else ldk(k)


_LAYOUT_HELPERS = {'wrow': _wrow, 'vals': lambda n, bf: n // 2 if bf else n,
                   'SMEM_FLOATS': fr.SMEM_LIMIT // 4}


def _layout_floats(text, S, A, NH, NE, D1, D2, c, bf=0, G=32, st=0):
    """``RolloutLayout(S, A, NH, NE, D1, D2, c, G, bf, st).floats`` evaluated
    from the constructor's text in ``csrc/fused_rollout.cu``."""
    body = text[text.index('__host__ __device__ RolloutLayout('):]
    body = body[body.index('{') + 1:body.index('floats = o;')]
    body = re.sub(r'//[^\n]*', '', body).replace('cm::', '').replace('int o', 'o')
    env = {'round4': _round4, 'slice': lambda d, cc: _round4(-(-d // cc)), 'ldk': ldk,
           'max': max, 'tile_scratch': fr.tile_scratch, 'TE': 32, 'S': S, 'A': A, 'NH': NH,
           'NE': NE, 'D1': D1, 'D2': D2, 'c': c, 'bf': bf, 'G': G, 'st': st, **_LAYOUT_HELPERS}
    for stmt in ' '.join(body.split()).split(';'):
        if stmt.strip():
            exec(stmt.strip(), env)
    return env['o']


def _struct_floats(text, ctor, **env):
    """``<ctor>(...).floats`` evaluated from the constructor's text in
    ``csrc/fused_rollout.cu``, its parameters and constants given in ``env``."""
    body = text[text.index(f'__host__ __device__ {ctor}('):]
    body = body[body.index('{') + 1:body.index('floats = o;')]
    body = re.sub(r'//[^\n]*', '', body).replace('cm::', '').replace('int o', 'o')
    body = re.sub(r'(?:constexpr|const) int ([^;]*);',   # 'const int a = x, b = y;': one
                  lambda m: re.sub(r',\s*(\w+)\s*=', r'; \1 =', m.group(1)) + ';', body)
    body = body.replace('/', '//')                            # C's integer division
    for name, value in (('S_LANE', 16), ('NS', 15), ('S', 151), ('A', 15)):  # StockBody's
        body = body.replace(f'StockBody::{name}', str(value))
    scope = {'round4': _round4, 'slice': lambda d, cc: _round4(-(-d // cc)), 'ldk': ldk,
             'max': max, 'tile_scratch': fr.tile_scratch, 'round64': lambda n: -(-n // 64) * 64,
             'TE': 32, 'SCRATCH': 256 * 16, 'CNC': fr._CNC, 'CKT': fr._CKT, 'CLD': fr._CLD,
             'CKLD': fr._CKLD, 'bf': 0, 'st': 0, 'G': 32, 'STOCK_STREAM_KS': fr._STOCK_STREAM_KS,
             **_LAYOUT_HELPERS, **env}
    for stmt in ' '.join(body.split()).split(';'):
        if stmt.strip():
            exec(stmt.strip(), scope)
    return scope['o']


@pytest.mark.parametrize('dims', [(128, 128), (256, 256), (64, 96), (576, 576), (8, 40)],
                         ids=lambda d: f'{d[0]}x{d[1]}')
def test_offpolicy_layout_copy_matches_the_source(dims):
    """K6/K6′'s ``OffLayout`` for every (body, head) pair and the stock actor
    kernel's ``StockActorLayout`` under each off-policy head, at every
    cluster size, against ``offpolicy_smem_bytes``."""
    from elegantrl_tpu_torch.envs import StockTradingVecEnv
    text = (CSRC / 'fused_rollout.cu').read_text()
    lanes = int(re.search(r'constexpr int OFF_LANES = (\d+);', text).group(1))
    assert lanes == fr.OFF_LANES
    ks = int(re.search(r'constexpr int STOCK_STREAM_KS = (\d+);', text).group(1))
    assert ks == fr._STOCK_STREAM_KS
    for body in fr.KERNEL_ENV_BODIES.values():
        for head in fr.OFFPOLICY_HEADS:
            if not fr.offpolicy_pair_fits(body, head):
                continue
            A = body.action_dim
            for c, bf, st in itertools.product(fr.ROLLOUT_CLUSTERS, (0, 1), (0, 1)):
                want = 4 * _struct_floats(
                    text, 'OffLayout', S=body.state_dim, A=A,
                    O=fr.offpolicy_out_rows(A, head),
                    NH=2 * A if head in fr.CONTINUOUS_HEADS else 2,
                    NE=body.n_step + body.n_reset, D1=dims[0], D2=dims[1], c=c, G=lanes,
                    bf=bf, st=st)
                assert fr.offpolicy_smem_bytes(body, dims, head, c, bool(bf), bool(st)) == want, (
                    body.env_name, head, c, bf, st)
    stock = StockTradingVecEnv(num_envs=1)._def.kernel_body
    for head in fr.CONTINUOUS_HEADS:
        for c, st in itertools.product(fr.ROLLOUT_CLUSTERS, (0, 1)):
            op = _round4(30 if head in ('sac', 'modsac') else 15)
            want = 4 * _struct_floats(text, 'StockActorLayout', D1=dims[0], D2=dims[1], c=c,
                                      OP=op, st=st)
            assert fr.offpolicy_smem_bytes(stock, dims, head, c, False, bool(st)) == want, (
                head, c, st)
            if head == 'ddpg':   # the on-policy head has the ddpg head's rows
                assert fr.actor_smem_bytes(151, dims, 15, c, streamed=bool(st)) == want


@pytest.mark.parametrize('dims', [(128, 128), (256, 256), (320, 320), (448, 448), (576, 64),
                                  (96, 40)], ids=lambda d: f'{d[0]}x{d[1]}')
def test_critic_layout_copy_matches_the_source(dims):
    """The critic pass's ``CriticLayout`` at both tiles (and its constants)
    against ``critic_smem_bytes``: 128 samples fit a block up to a first
    width of 320, 64 up to 576, so the critic takes every width the stock
    actor kernel takes (448)."""
    text = (CSRC / 'fused_rollout.cu').read_text()
    for name, value in (('CNC', fr._CNC), ('CKT', fr._CKT), ('CT_STREAM', fr._CT_STREAM)):
        assert f'constexpr int {name} = {value};' in text, name
    for ct in (128, 64, fr._CT_STREAM):   # the last: the streamed design's tile
        assert fr.critic_smem_bytes(dims, ct) == 4 * _struct_floats(
            text, 'CriticLayout', D1=dims[0], D2=dims[1], CT=ct, st=int(ct == fr._CT_STREAM))
    assert (fr.critic_smem_bytes(dims, 128) <= fr.SMEM_LIMIT) == (dims[0] <= 320)
    assert fr.critic_smem_bytes(dims) == fr.critic_smem_bytes(dims, 128 if dims[0] <= 320 else 64)
    assert fr.critic_smem_bytes(dims) <= fr.SMEM_LIMIT
    # past 576 the 64-sample resident tile does not fit; the streamed one does
    assert fr.critic_smem_bytes((580, 64), 64) > fr.SMEM_LIMIT
    assert fr.critic_tile((580, 64)) == fr._CT_STREAM
    assert fr.critic_smem_bytes((580, 64)) <= fr.SMEM_LIMIT


@pytest.mark.parametrize('dims', [(128, 128), (256, 256), (64, 96), (320, 320), (8, 40),
                                  (512, 512)], ids=lambda d: f'{d[0]}x{d[1]}')
def test_rollout_layout_copy_matches_the_source(dims):
    """Both compute types; in bf16 (512, 512) takes layer 2 unsplit at c = 8."""
    text = (CSRC / 'fused_rollout.cu').read_text()
    lanes = int(re.search(r'constexpr int STREAM_LANES = (\d+);', text).group(1))
    assert lanes == fr.STREAM_LANES
    for body in fr.KERNEL_ENV_BODIES.values():
        nh = body.action_dim if body.discrete else 2 * body.action_dim
        for c, bf, st in itertools.product(fr.ROLLOUT_CLUSTERS, (0, 1), (0, 1)):
            want = 4 * _layout_floats(text, body.state_dim, body.action_dim, nh,
                                      body.n_step + body.n_reset, *dims, c, bf,
                                      lanes if st else 32, st)
            assert fr.rollout_smem_bytes(body, dims, c, bool(bf), bool(st)) == want, (
                body.env_name, dims, c, bf, st)


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
    """The resident design takes what a cluster of 8 holds; past it the
    streamed design takes every width to (1024, 1024) and beyond."""
    for body in fr.KERNEL_ENV_BODIES.values():
        fits = fr.rollout_fits_resident
        assert fits(body, (256, 256)) and fits(body, (128, 128))
        assert not fits(body, (384, 384)) and not fits(body, (64, 64, 64))
        limit = 288 if body.env_name == 'PointChasingDiscreteEnv' else 320
        assert fits(body, (limit, limit))
        assert not fits(body, (limit + 4, limit + 4))
        assert min(fr.rollout_smem_bytes(body, (limit, limit), c)
                   for c in fr.ROLLOUT_CLUSTERS) <= fr.SMEM_LIMIT
        assert fr.rollout_width_limit(body, resident=True) == limit
        for dims in ((limit + 4, limit + 4), (384, 384), (1024, 256), (1024, 1024)):
            assert fr.rollout_fits(body, dims) and fr.rollout_fits(body, dims, bf16=True)
        assert not fr.rollout_fits(body, (64, 64, 64))
        wide = fr.rollout_width_limit(body)
        assert wide >= 1024 and not fr.rollout_fits(body, (wide + 4, wide + 4))


def test_rollout_cluster_pick_is_asked_once_per_shape(monkeypatch):
    """The wrapper keeps the kernel's cluster pick per (body, envs, widths,
    device, compute type) and asks the library again only for a new key or
    after a failed pick."""
    asked = []

    class Lib:
        def fused_rollout_cluster(self, body_id, n, d1, d2, cluster, bf):
            asked.append((body_id, n, d1, d2, cluster, bf))
            return 0 if n == 7 else 4

    monkeypatch.setattr(fr, '_CLUSTER_PICKS', {})
    body, lib = fr.PENDULUM_BODY, Lib()
    dev0, dev1 = torch.device('cuda', 0), torch.device('cuda', 1)
    assert [fr._rollout_cluster(lib, body, 1024, 128, 128, dev0) for _ in range(3)] == [4, 4, 4]
    assert fr._rollout_cluster(lib, body, 1024, 128, 128, dev1) == 4
    assert fr._rollout_cluster(lib, body, 256, 128, 128, dev0) == 4
    assert fr._rollout_cluster(lib, body, 7, 128, 128, dev0) == 0
    assert fr._rollout_cluster(lib, body, 7, 128, 128, dev0) == 0
    assert [fr._rollout_cluster(lib, body, 1024, 128, 128, dev0, 1) for _ in range(2)] == [4, 4]
    assert asked == [(body.kernel_id, n, 128, 128, 0, bf)
                     for n, bf in ((1024, 0), (1024, 0), (256, 0), (7, 0), (7, 0), (1024, 1))]


def test_stock_actor_cluster_pick_is_asked_once_per_shape(monkeypatch):
    """For the stock body the kept pick is the stock actor kernel's
    (``stock_rollout_cluster``), per envs, widths and device."""
    from elegantrl_tpu_torch.envs import StockTradingVecEnv
    asked = []

    class Lib:
        def stock_rollout_cluster(self, n, d1, d2, cluster, bf):
            asked.append((n, d1, d2, cluster, bf))
            return 0 if n == 7 else 8

    monkeypatch.setattr(fr, '_CLUSTER_PICKS', {})
    body, lib = StockTradingVecEnv(num_envs=1)._def.kernel_body, Lib()
    dev0 = torch.device('cuda', 0)
    assert [fr._rollout_cluster(lib, body, 4096, 128, 128, dev0) for _ in range(3)] == [8] * 3
    assert fr._rollout_cluster(lib, body, 256, 256, 256, dev0) == 8
    assert fr._rollout_cluster(lib, body, 7, 128, 128, dev0) == 0
    assert fr._rollout_cluster(lib, body, 7, 128, 128, dev0) == 0
    assert fr._rollout_cluster(lib, body, 4096, 128, 128, dev0, 1) == 8
    assert asked == [(4096, 128, 128, 0, 0), (256, 256, 256, 0, 0), (7, 128, 128, 0, 0),
                     (7, 128, 128, 0, 0), (4096, 128, 128, 0, 1)]


def test_offpolicy_cluster_pick_is_asked_once_per_shape(monkeypatch):
    """The off-policy wrapper keeps the kernel's cluster pick per (body,
    head, envs, widths, device, compute type), as the on-policy one."""
    asked = []

    class Lib:
        def offpolicy_rollout_cluster(self, body_id, head_id, n, d1, d2, cluster, bf):
            asked.append((body_id, head_id, n, d1, d2, cluster, bf))
            return 0 if n == 7 else 2

    monkeypatch.setattr(fr, '_OFF_CLUSTER_PICKS', {})
    body, lib, dev0 = fr.HOPPER_BODY, Lib(), torch.device('cuda', 0)
    assert [fr._offpolicy_cluster(lib, body, 0, 1024, 128, 128, dev0) for _ in range(3)] == [2] * 3
    assert fr._offpolicy_cluster(lib, body, 4, 1024, 128, 128, dev0) == 2
    assert fr._offpolicy_cluster(lib, body, 0, 7, 128, 128, dev0) == 0
    assert fr._offpolicy_cluster(lib, body, 0, 7, 128, 128, dev0) == 0
    assert [fr._offpolicy_cluster(lib, body, 0, 1024, 128, 128, dev0, 1)
            for _ in range(2)] == [2, 2]
    assert asked == [(body.kernel_id, h, n, 128, 128, 0, bf)
                     for h, n, bf in ((0, 1024, 0), (4, 1024, 0), (0, 7, 0), (0, 7, 0),
                                      (0, 1024, 1))]


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


# ------------------------- fault 16's rest: the narrower streamed lane groups
# Past the widest streamed group's limit each rollout kernel takes the widest
# narrower group whose tiles fit a block (K1/K3 and K6/K6': 16, 8, 4 lanes;
# K4's actor: 32, 16, 8, 4; the critic pass: tiles of 32, then 16 samples),
# down to 4 lanes (cm::tile_dense's 4 x 4 register tiles), and raises only
# past the narrowest group's widths.

@pytest.mark.parametrize('dims', [(128, 128), (1412, 1412), (2048, 512), (4096, 4096)],
                         ids=lambda d: f'{d[0]}x{d[1]}')
def test_narrow_layout_copies_match_the_source(dims):
    """Each narrower group's ``RolloutLayout``, ``OffLayout`` and
    ``StockActorLayout`` and the 16-sample ``CriticLayout``, evaluated from
    ``csrc/fused_rollout.cu``, against the Python copies at their levels."""
    text = (CSRC / 'fused_rollout.cu').read_text()
    assert 'constexpr int CT_NARROW = 16;' in text and fr._CT_NARROW == 16
    for body in fr.KERNEL_ENV_BODIES.values():
        nh = body.action_dim if body.discrete else 2 * body.action_dim
        for c, bf, level in itertools.product(fr.ROLLOUT_CLUSTERS, (0, 1), (2, 3)):
            lanes = fr.narrow_lanes(fr.STREAM_LANES, level)
            want = 4 * _layout_floats(text, body.state_dim, body.action_dim, nh,
                                      body.n_step + body.n_reset, *dims, c, bf, lanes, 1)
            assert fr.rollout_smem_bytes(body, dims, c, bool(bf), level) == want
        for head in fr.OFFPOLICY_HEADS:
            if not fr.offpolicy_pair_fits(body, head):
                continue
            A = body.action_dim
            for c, bf, level in itertools.product(fr.ROLLOUT_CLUSTERS, (0, 1), (2, 3)):
                want = 4 * _struct_floats(
                    text, 'OffLayout', S=body.state_dim, A=A, O=fr.offpolicy_out_rows(A, head),
                    NH=2 * A if head in fr.CONTINUOUS_HEADS else 2,
                    NE=body.n_step + body.n_reset, D1=dims[0], D2=dims[1], c=c,
                    G=fr.narrow_lanes(fr.OFF_LANES, level), bf=bf, st=1)
                assert fr.offpolicy_smem_bytes(body, dims, head, c, bool(bf), level) == want
    for head, c, level in itertools.product((None, 'ddpg', 'sac'), fr.ROLLOUT_CLUSTERS,
                                            (2, 3, 4)):
        op = _round4(30 if head == 'sac' else 15)
        want = 4 * _struct_floats(text, 'StockActorLayout', D1=dims[0], D2=dims[1], c=c, OP=op,
                                  st=1, G=fr.narrow_lanes(32, level))
        assert fr.actor_smem_bytes(151, dims, 15, c, head, streamed=level) == want
    assert fr.critic_smem_bytes(dims, 16) == 4 * _struct_floats(
        text, 'CriticLayout', D1=dims[0], D2=dims[1], CT=16, st=1)


def test_variant_numbers_of_the_source_match_the_levels():
    """``ELEGANTRL_VARIANT`` in both builds: variant ``v`` dispatches to
    ``FN<v & 1, v >> 1>`` (bf16, then the design level), the resident and
    streamed designs in the halves, the narrower groups (and the stock
    actor's fourth level) in the narrow libraries, which build from the same
    source with ``ELEGANTRL_NARROW``."""
    text = (CSRC / 'fused_rollout.cu').read_text()
    pairs = re.findall(r'\(variant\) == (\d+)\s*\? FN<(true|false), (\d)>', text)
    assert len(pairs) == 4 + 4 + 2
    for v, bf, level in pairs:
        assert int(v) == (bf == 'true') | int(level) << 1, (v, bf, level)
    narrow = text[text.index('#if defined(ELEGANTRL_NARROW)\n#define ELEGANTRL_VARIANT'):]
    narrow = narrow[:narrow.index('#else')]
    assert sorted(int(lv) for _, _, lv in re.findall(
        r'\(variant\) == (\d+)\s*\? FN<(true|false), (\d)>', narrow)) == [2, 2, 3, 3, 4, 4]
    for half, lib in (('ONPOLICY', 'onpolicy_narrow'), ('OFFPOLICY', 'offpolicy_narrow')):
        src = (CSRC / f'{lib}.cu').read_text()
        assert f'#define ELEGANTRL_{half}_ONLY' in src and '#define ELEGANTRL_NARROW' in src
        assert '#include "fused_rollout.cu"' in src
    assert fr.ROLLOUT_LIBRARIES == (('onpolicy_rollout', 'offpolicy_rollout'),
                                    ('onpolicy_narrow', 'offpolicy_narrow'))
    assert (fr.ROLLOUT_LEVELS, fr.OFF_LEVELS, fr.STOCK_LEVELS) == (3, 3, 4)


def test_narrow_groups_at_the_old_limits_and_past_them():
    """The lane group each kernel takes at its widest streamed group's limit
    (PR 16's), one width past it and at its new limit; one width past the
    narrowest group's limit no design fits.  Float32 and bf16."""
    from elegantrl_tpu_torch.envs import StockTradingVecEnv
    stock = StockTradingVecEnv(num_envs=1)._def.kernel_body
    for bf, old, new in ((False, 1408, 4832), (True, 2624, 8224)):   # K1/K3 on Pendulum
        body = fr.PENDULUM_BODY
        assert [fr.rollout_group_lanes(body, (d, d), bf)
                for d in (old, old + 4, new, new + 4)] == [16, 8, 4, 0]
        assert fr.rollout_width_limit(body, bf) == new and fr.rollout_level(body, (old,) * 2, bf) == 1
    for bf, old, new in ((False, 2752, 9344), (True, 5280, 16544)):  # K6 ddpg on Pendulum
        assert [fr.offpolicy_group_lanes(fr.PENDULUM_BODY, 'ddpg', (d, d), bf)
                for d in (old, old + 4, new, new + 4)] == [16, 8, 4, 0]
        assert fr.offpolicy_width_limit(fr.PENDULUM_BODY, 'ddpg', bf) == new
    # K4's actor alone (the off-policy ddpg head), float32: 32 lanes to 1184
    assert [fr.offpolicy_group_lanes(stock, 'ddpg', (d, d)) for d in (1184, 1188, 6048, 6052)] \
        == [32, 16, 4, 0]
    # on-policy with the critic pass: the actor's 16-lane groups at 1280, the
    # critic's 32-sample tiles to 1408 and 16-sample ones to 2624
    assert fr.rollout_group_lanes(stock, (1280, 1280)) == 16
    assert [fr.critic_tile((d, d)) for d in (576, 580, 1408, 1412)] == [64, 32, 32, 16]
    assert fr.stock_width_limit(None) == 2624 and not fr.rollout_fits(stock, (2628, 2628))
    # the resident designs keep their widths
    assert fr.rollout_width_limit(fr.PENDULUM_BODY, resident=True) == 320
    assert fr.offpolicy_width_limit(fr.HOPPER_BODY, 'ddpg', resident=True) == 576
    assert fr.stock_width_limit(None, resident=True) == 448


def test_wrapper_design_takes_the_first_level_that_fits():
    """``_design`` on the library's reckoning (here the Python copy): each
    level in order, a level a library does not build (-2) never fits, and
    past the narrowest group a raise naming the widest width."""
    body = fr.PENDULUM_BODY

    def smem_of(dims):
        def of(v):
            level = v >> 1
            return min(fr.rollout_smem_bytes(body, dims, c, bool(v & 1), level)
                       for c in ((8,) if level == 0 else fr.ROLLOUT_CLUSTERS))
        return of
    for d, level in ((256, 0), (384, 1), (1408, 1), (1412, 2), (2688, 2), (2692, 3),
                     (4832, 3)):
        assert fr._design(smem_of((d, d)), 0, 'rollout', (d, d), lambda: '4832') == level << 1, d
    assert fr._design(lambda v: -2 if v >> 1 == 2 else (10 ** 6 if v >> 1 < 2 else 1000), 0,
                      'rollout', (8, 8), lambda: '8') == 3 << 1
    with pytest.raises(ValueError, match='groups of 4 lanes.*square widths up to 4832'):
        fr._design(smem_of((4836, 4836)), 0, 'rollout', (4836, 4836), lambda: '4832')
    assert fr._design_tag(0, 16) == '' and fr._design_tag(2, 16) == ',streamed'
    assert fr._design_tag(4, 16) == ',streamed8' and fr._design_tag(8, 32) == ',streamed4'


def test_a_narrow_design_asks_the_narrow_library(monkeypatch):
    """Variants of the design levels 0 and 1 load the two halves; levels 2
    and up their narrow libraries, built at first use."""
    from elegantrl_tpu_torch.ops import _cuda_build
    built, loaded = [], []

    class Fn:
        argtypes = None

    class Lib:
        def __getattr__(self, name):
            return Fn()

    monkeypatch.setattr(_cuda_build, '_loaded', {})
    monkeypatch.setattr(_cuda_build, 'build', lambda names: built.append(tuple(names)))
    monkeypatch.setattr(_cuda_build, 'load', lambda name: loaded.append(name) or Lib())
    fr._library(3)
    fr._library(4)
    fr._library(9)
    assert built == [('onpolicy_rollout', 'offpolicy_rollout'),
                     ('onpolicy_narrow', 'offpolicy_narrow'),
                     ('onpolicy_narrow', 'offpolicy_narrow')]
    assert loaded[0] == 'onpolicy_rollout' and 'onpolicy_narrow' in loaded
