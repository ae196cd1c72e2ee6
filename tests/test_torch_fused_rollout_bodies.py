"""Parity of the port's fused-rollout plain version
(``elegantrl_tpu_torch/ops/fused_rollout.py:rollout_reference``) with the
JAX package's Pallas rollout kernel in interpret mode
(``make_fused_rollout(..., interpret=True)``) for the bodies and heads
beyond Pendulum: CartPole with the categorical head, HopperSlip with the
Gaussian head, and discrete PointChasing (categorical head, per-step env
uniforms); 16 envs x 8 steps, net (16, 16), the same weights and the same
injected noise.  Then the generic Philox draw and the heads' sampling.

The JAX wrapper draws its noise from the key: all uniforms ``(H, A +
n_step + n_reset, N)`` for the categorical head; ``kz, ku = split(key)``,
normals ``(H, A, N)`` then uniforms for the Gaussian head.  The tests
recompute it and hand it to the port in injected-noise mode.

Tolerances: values and logprobs recomputed from the JAX rollout's own
stored states and actions (teacher-forced) 1e-5; whole trajectories 1e-5
over 8 steps (no lane is within rounding of a threshold at these seeds);
discrete actions and flags exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.agents.ppo import make_ppo as jmake_ppo
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.envs.cartpole import make_cartpole as jmake_cartpole
from elegantrl_tpu.envs.hopper import make_hopper as jmake_hopper
from elegantrl_tpu.envs.point_chasing import make_point_chasing_discrete as jmake_chasing_disc
from elegantrl_tpu.ops import pallas_rollout as jpr
from elegantrl_tpu_torch.agents.ppo import make_ppo, norm_state
from elegantrl_tpu_torch.config import Config
from elegantrl_tpu_torch.ops import dists
from elegantrl_tpu_torch.ops import fused_rollout as fr
from elegantrl_tpu_torch.utils.jax_params import ppo_state_from_numpy

torch.set_num_threads(1)
NET_DIMS = (16, 16)
H, N = 8, 16
REWARD_SCALE = 0.5


def _stagger(name, s):
    """Move some lanes next to a terminal or a truncation."""
    lanes = jnp.arange(N)
    if name == 'cartpole':
        return s._replace(x=jnp.where(lanes < 3, 2.35, s.x), x_dot=jnp.where(lanes < 3, 1.5, s.x_dot),
                          t=jnp.where(lanes >= 13, 497, lanes * 31).astype(jnp.int32))
    if name == 'hopper':
        return s._replace(z=jnp.where(lanes < 3, 0.27, s.z), vz=jnp.where(lanes < 3, -3.0, s.vz),
                          t=jnp.where(lanes >= 13, 996, lanes * 61).astype(jnp.int32))
    close = (lanes < 3)[:, None]
    p1 = jnp.where(close, s.p0 + jnp.array([1.5, 1.5]), s.p1)
    return s._replace(p1=p1, v1=jnp.where(close, -20.0, s.v1),
                      distance=jnp.sqrt(jnp.sum(jnp.square(s.p0 - p1), -1)),
                      t=jnp.where(lanes >= 13, 1020, lanes * 63).astype(jnp.int32))


CASES = {'cartpole': (jmake_cartpole, jpr.CARTPOLE_BODY, fr.CARTPOLE_BODY),
         'hopper': (jmake_hopper, jpr.HOPPER_BODY, fr.HOPPER_BODY),
         'chasing_discrete': (jmake_chasing_disc, jpr.CHASING_DISCRETE_BODY,
                              fr.CHASING_DISCRETE_BODY)}


@pytest.fixture(scope='module', params=list(CASES))
def setup(request):
    name = request.param
    jmake, jbody, body = CASES[name]
    S, A, discrete = body.state_dim, body.action_dim, body.discrete
    args = JConfig()
    args.net_dims = NET_DIMS
    s = jmake_ppo(NET_DIMS, S, A, args, discrete=discrete).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    s = s._replace(norm_avg=jnp.asarray(rng.uniform(-0.2, 0.2, S), jnp.float32),
                   norm_std=jnp.asarray(rng.uniform(0.8, 1.5, S), jnp.float32))
    env = jmake()
    env_state = _stagger(name, jax.vmap(env.init)(jax.random.split(jax.random.PRNGKey(7), N)))
    key = jax.random.PRNGKey(3)
    fast = jpr.make_fused_rollout(jbody, NET_DIMS, H, N, REWARD_SCALE, discrete=discrete,
                                  block=8, interpret=True)
    jro, jenv2, jobs2 = fast(s, env_state, None, key)
    n_env = body.n_step + body.n_reset
    if discrete:
        noise = jax.random.uniform(key, (H, A + n_env, N), jnp.float32)
    else:
        kz, ku = jax.random.split(key)
        noise = jnp.concatenate([jax.random.normal(kz, (H, A, N), jnp.float32),
                                 jax.random.uniform(ku, (H, n_env, N), jnp.float32)], 1)
    noise = torch.from_numpy(np.array(noise))
    state = ppo_state_from_numpy(jax.tree.map(np.asarray, s), 'cpu')
    jf0, ji0 = jbody.pack(env_state)
    f0, i0 = torch.from_numpy(np.array(jf0)), torch.from_numpy(np.array(ji0, np.int32))
    kw = dict(net_dims=NET_DIMS, horizon_len=H, reward_scale=REWARD_SCALE, body=body)
    out = fr.rollout_reference(state.act_flat, state.cri_flat, state.norm_avg, state.norm_std,
                               f0, i0, noise=noise, **kw)
    return dict(name=name, body=body, jbody=jbody, state=state, jro=jro, jenv2=jenv2,
                jobs2=jobs2, out=out, f0=f0, i0=i0, noise=noise, kw=kw)


def test_flags_fire_and_match(setup):
    jro, out = setup['jro'], setup['out']
    done = (out.terminals + out.truncates).numpy()
    assert out.terminals.numpy().any() and done.max() == 1.0
    if setup['name'] != 'chasing_discrete':          # PointChasing never truncates
        assert out.truncates.numpy().any()
    np.testing.assert_array_equal(1.0 - out.terminals.numpy(), np.asarray(jro.undones))
    np.testing.assert_array_equal(1.0 - out.truncates.numpy(), np.asarray(jro.unmasks))


def test_teacher_forced_values_and_logprobs(setup):
    """The port's nets and head on the JAX rollout's stored states and
    actions reproduce the JAX rollout's values and logprobs."""
    st, jro, body = setup['state'], setup['jro'], setup['body']
    states = torch.from_numpy(np.moveaxis(np.asarray(jro.states), 1, 2).copy())   # (H, N, S)
    with torch.no_grad():
        x = norm_state(states, st.norm_avg, st.norm_std)
        out = st.act(x)
        if body.discrete:
            lp = dists.categorical_logprob(out, torch.from_numpy(np.array(jro.actions)))
        else:
            actions = torch.from_numpy(np.moveaxis(np.asarray(jro.actions), 1, 2).copy())
            lp = dists.normal_logprob(actions, out, torch.exp(st.act.std_log)).sum(-1)
        v = st.cri(x)[..., 0]
    np.testing.assert_allclose(lp.numpy(), np.asarray(jro.logprobs), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jro.extras['values']), atol=1e-5)


def test_actions_match(setup):
    jro, out, body = setup['jro'], setup['out'], setup['body']
    want = np.asarray(jro.actions)
    assert out.actions.shape == want.shape
    if body.discrete:
        assert out.actions.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(out.actions.numpy(), want)
        assert len(np.unique(want)) == body.action_dim or body.action_dim > 2
    else:
        np.testing.assert_allclose(out.actions.numpy(), want, atol=1e-5)


@pytest.mark.parametrize('field,jfield', [
    ('states', 'states'), ('logprobs', 'logprobs'), ('rewards', 'rewards'), ('values', None)])
def test_whole_trajectory_matches(setup, field, jfield):
    jro, out = setup['jro'], setup['out']
    want = np.asarray(getattr(jro, jfield) if jfield else jro.extras['values'])
    np.testing.assert_allclose(getattr(out, field).numpy(), want, atol=1e-5)


def test_final_env_rows_and_obs(setup):
    out, body, jbody = setup['out'], setup['body'], setup['jbody']
    jf, ji = jbody.pack(setup['jenv2'])
    np.testing.assert_allclose(out.env_f.numpy(), np.asarray(jf), atol=1e-5)
    np.testing.assert_array_equal(out.env_i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(body.obs(out.env_f, out.env_i).T.numpy(),
                               np.asarray(setup['jobs2']), atol=1e-5)


def test_wrapper_on_cpu_runs_the_plain_version(setup):
    st = setup['state']
    before = fr.rollout.launches
    got = fr.rollout(st.act_flat, st.cri_flat, st.norm_avg, st.norm_std, setup['f0'],
                     setup['i0'], noise=setup['noise'], **setup['kw'])
    assert fr.rollout.launches == before
    for a, b in zip(got, setup['out']):
        assert torch.equal(a, b)


def test_env_trace_holds_each_steps_rows(setup):
    st, trace = setup['state'], []
    out = fr.rollout_reference(st.act_flat, st.cri_flat, st.norm_avg, st.norm_std,
                               setup['f0'], setup['i0'], noise=setup['noise'],
                               env_trace=trace, **setup['kw'])
    assert len(trace) == H and torch.equal(trace[0][0], setup['f0'])
    body = setup['body']
    for t in (0, H - 1):
        assert torch.equal(body.obs(*trace[t]), out.states[t])


# ------------------------------------------------------------------ Philox

def test_philox_block_zero_reproduces_the_four_word_draws():
    """Counter word 2 is the block number: block 0 gives, bit for bit, the
    four uniforms that the Pendulum rollout has always drawn from counter
    ``(lane, step, 0, 0)``, whatever the count asked for; block k uses
    counter ``(lane, step, k, 0)``."""
    seed = torch.tensor([20260, -77], dtype=torch.int32)
    hh, nn_ = 5, 33
    k = seed.to(torch.int64) & 0xFFFFFFFF
    lane = torch.arange(nn_, dtype=torch.int64)[None, :].expand(hh, nn_)
    step = torch.arange(hh, dtype=torch.int64)[:, None].expand(hh, nn_)
    zero = torch.zeros_like(lane)

    def block(b):
        words = fr.philox4x32(lane, step, zero + b, zero, k[0], k[1])
        return torch.stack([(w >> 8).to(torch.float32) * 2.0 ** -24 for w in words], dim=1)

    four = fr.philox_uniforms(seed, hh, nn_)
    assert four.shape == (hh, 4, nn_) and torch.equal(four, block(0))
    for body in fr.KERNEL_ENV_BODIES.values():
        count = fr.uniforms_per_step(body)
        u = fr.philox_uniforms(seed, hh, nn_, count)
        assert u.shape == (hh, count, nn_)
        want = torch.cat([block(b) for b in range((count + 3) // 4)], dim=1)[:, :count]
        assert torch.equal(u, want) and torch.equal(u[:, :4], four)
    assert [fr.uniforms_per_step(b) for b in fr.KERNEL_ENV_BODIES.values()] == [4, 6, 6, 10, 15]
    assert [fr.noise_rows(b) for b in fr.KERNEL_ENV_BODIES.values()] == [3, 6, 4, 8, 15]


def _flat_state(body, logits=None):
    """A port agent state for ``body`` from seed 0; with ``logits`` the actor
    is made constant: zero weights and the given output bias."""
    args = Config()
    args.device, args.net_dims = 'cpu', NET_DIMS
    st = make_ppo(NET_DIMS, body.state_dim, body.action_dim, args,
                  discrete=body.discrete).init(0, 'cpu')
    if logits is not None:
        st.act_flat.zero_()
        st.act.mlp.layers[-1].bias.copy_(logits)
    return st


@pytest.mark.parametrize('name', ['cartpole', 'chasing_discrete'])
def test_internal_gumbel_max_samples_the_softmax(name):
    """Internal (Philox) mode with fixed logits: the empirical action
    frequencies over 32,768 draws are within 0.01 of ``softmax(logits)``
    (three standard errors at p = 0.5 are 0.008)."""
    body = CASES[name][2]
    logits = torch.linspace(-1.0, 1.0, body.action_dim)
    st = _flat_state(body, logits)
    hh, nn_ = 64, 512
    f0 = torch.zeros(body.n_f32, nn_)
    f0[-1] = 8.0
    if name == 'chasing_discrete':
        f0[4:6] = -8.0                                # far from the walker: no terminal
    out = fr.rollout_reference(st.act_flat, st.cri_flat, st.norm_avg, st.norm_std, f0,
                               torch.zeros(1, nn_, dtype=torch.int32), net_dims=NET_DIMS,
                               horizon_len=hh, reward_scale=1.0, body=body,
                               seed=torch.tensor([12345, -678], dtype=torch.int32))
    freq = torch.bincount(out.actions.reshape(-1).long(), minlength=body.action_dim) / (hh * nn_)
    probs = torch.softmax(logits, 0)
    assert float((freq - probs).abs().max()) < 0.01
    lp = torch.log_softmax(logits, 0)[out.actions.long()]
    np.testing.assert_allclose(out.logprobs.numpy(), lp.numpy(), atol=1e-6)


def test_internal_chasing_reset_draws_standard_normals():
    """Internal mode: every lane terminates at step 0 (t = 1023), so step 1
    observes fresh states: p0 ~ N(0, 1)^2 and p1 + 8 ~ N(0, 1)^2 by
    Box-Muller, mean and std within 0.03 over 16,384 draws each."""
    body = fr.CHASING_BODY
    st = _flat_state(body)
    nn_ = 8192
    f0 = torch.zeros(body.n_f32, nn_)
    f0[4:6], f0[8] = -8.0, 11.3
    out = fr.rollout_reference(st.act_flat, st.cri_flat, st.norm_avg, st.norm_std, f0,
                               torch.full((1, nn_), 1023, dtype=torch.int32),
                               net_dims=NET_DIMS, horizon_len=2, reward_scale=1.0, body=body,
                               seed=torch.tensor([7, 8], dtype=torch.int32))
    assert bool(out.terminals[0].all()) and not bool(out.truncates.any())
    p0, p1 = out.states[1, 0:2].reshape(-1), out.states[1, 4:6].reshape(-1) + 8.0
    for z in (p0, p1):
        assert abs(float(z.mean())) < 0.03 and abs(float(z.std()) - 1.0) < 0.03
    assert float(out.states[1, 2:4].abs().max()) == 0.0     # fresh velocities
    # the walker's step uniforms lie in [0, 1): v0 = 0.5 * 0 + u at step 0
    assert 0.0 <= float(out.env_f[2:4].min()) and float(out.env_f[2:4].max()) < 1.0


def test_internal_hopper_gaussian_is_standard_normal():
    """Internal mode, A = 2: z = (action - mean) / std has mean 0 and std 1
    within 0.03 per action dim, and the two dims are uncorrelated."""
    body = fr.HOPPER_BODY
    st = _flat_state(body)
    hh, nn_ = 32, 512
    rng = np.random.default_rng(0)
    f0 = torch.zeros(body.n_f32, nn_)
    f0[1] = torch.from_numpy(rng.uniform(0.85, 0.95, nn_).astype(np.float32))
    f0[5] = 0.55
    out = fr.rollout_reference(st.act_flat, st.cri_flat, st.norm_avg, st.norm_std, f0,
                               torch.zeros(1, nn_, dtype=torch.int32), net_dims=NET_DIMS,
                               horizon_len=hh, reward_scale=1.0, body=body,
                               seed=torch.tensor([99, 100], dtype=torch.int32))
    with torch.no_grad():
        mean = st.act(norm_state(out.states.transpose(1, 2), st.norm_avg, st.norm_std))
    z = (out.actions.transpose(1, 2) - mean) / torch.exp(st.act.std_log)
    z = z.reshape(-1, 2)
    assert float(z.mean(0).abs().max()) < 0.03 and float((z.std(0) - 1).abs().max()) < 0.03
    assert abs(float(torch.corrcoef(z.T)[0, 1])) < 0.03
