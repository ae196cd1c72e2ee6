"""The stock body's rollouts (K4) under bf16 compute and bf16 storage: the
plain versions, which the CUDA kernels' bf16 variants are held against on
the card (``chip_smoke.py`` ``k4_bf16_vs_plain``, ``critic_bf16_vs_plain``),
against the JAX package's Pallas kernels in interpret mode with
``compute_dtype='bfloat16'`` and ``store_dtype=bfloat16``, on the same
weights (through numpy) and noise; then the selection on a simulated card:
K4's bf16 variants taken where the JAX runner takes its kernel, and the
card raising past their bf16 width limits, naming them.

8 envs, 8 steps, nets (16, 16), a market cut to 10 days, as in
``test_torch_stock_rollout.py``.  Tolerances are those of
``test_torch_bf16.py``: both packages sum float32 products of
bf16 operands in another order, and where a sum lies within its last bit
of a bf16 rounding boundary the next layer's operand moves by one bf16
step, so float outputs are held to 1e-5 on at least 99% of their entries
and to 2e-2 relative (2e-3 absolute) on all; stored states exactly where
stored in float32 (the obs is the same function) and to one bf16 step where
stored in bf16; lots, days and flags exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.agents.ddpg_td3 import _make as jmake_ddpg_td3
from elegantrl_tpu.agents.ppo import make_ppo as jmake_ppo
from elegantrl_tpu.agents.sac import make_sac as jmake_sac
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.envs.stock_trading import make_stock_trading as jmake_stock
from elegantrl_tpu.ops import pallas_rollout as jpr
from elegantrl_tpu_torch import Config
from elegantrl_tpu_torch.agents import AgentPPO, AgentSAC, AgentTD3
from elegantrl_tpu_torch.envs import StockTradingVecEnv
from elegantrl_tpu_torch.envs import stock_trading as st
from elegantrl_tpu_torch.ops import fused_rollout as fr
from elegantrl_tpu_torch.utils.jax_params import (ddpg_state_from_numpy, env_state_from_numpy,
                                                  ppo_state_from_numpy, sac_state_from_numpy)

torch.set_num_threads(1)
BF = torch.bfloat16
NET_DIMS = (16, 16)
H, N, END = 8, 8, 10
S, A = 151, 15


def _close(got, want, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    near = np.abs(got - want) <= 1e-5 + 1e-5 * np.abs(want)
    assert near.mean() >= 0.99, (what, near.mean())
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-3, err_msg=what)


def _envs():
    jenv = jmake_stock(end_idx=END)
    env = st.make_stock_trading(end_idx=END)
    jstate = jax.jit(jax.vmap(jenv.init))(jax.random.split(jax.random.PRNGKey(9), N))
    jstate = jstate._replace(day=jnp.full((N,), 4, jnp.int32))   # 5 steps to the last day
    state = env_state_from_numpy(st.StockState, jax.tree.map(np.asarray, jstate), 'cpu')
    return jenv, env, jstate, state


def _noise(key):
    kz, ku = jax.random.split(key)
    return jnp.concatenate([jax.random.normal(kz, (H, A, N), jnp.float32),
                            jax.random.uniform(ku, (H, 17, N), jnp.float32)], axis=1)


def _rows(f, jf):
    np.testing.assert_array_equal(f[1:1 + A].numpy(), np.asarray(jf)[1:1 + A])   # lots
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-2)


def _states(got, want, store):
    """States exactly where stored in float32; in bf16 at most one bf16 step
    apart (an obs value within the last f32 bit of a rounding boundary)."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if not store:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-6)
        assert np.mean(got == want) >= 0.99


TYPES = {'bf16': (BF, None, 'bfloat16', None), 'bf16_store': (BF, BF, 'bfloat16', jnp.bfloat16),
         'f32_store': (None, BF, None, jnp.bfloat16)}


@pytest.mark.parametrize('types', list(TYPES))
def test_onpolicy_plain_matches_pallas_bf16(types):
    cdt, sdt, jcdt, jsdt = TYPES[types]
    jenv, env, jstate, state = _envs()
    args = JConfig()
    args.net_dims = NET_DIMS
    js = jmake_ppo(NET_DIMS, S, A, args).init(jax.random.PRNGKey(0))
    js = js._replace(norm_avg=jnp.linspace(-0.1, 0.1, S), norm_std=jnp.linspace(0.8, 1.2, S))
    fast = jpr.make_fused_rollout(jenv.kernel_body, NET_DIMS, H, N, 0.5, discrete=False,
                                  block=8, interpret=True, compute_dtype=jcdt,
                                  store_dtype=jsdt)
    key = jax.random.PRNGKey(3)
    jro, jstate2, _ = jax.jit(fast)(js, jstate, jax.vmap(jenv.obs)(jstate), key)
    jro = jax.tree.map(np.asarray, jro)
    ps = ppo_state_from_numpy(jax.tree.map(np.asarray, js), 'cpu')
    ro, state2, _ = fr.make_fused_rollout(env.kernel_body, NET_DIMS, H, N, 0.5,
                                          compute_dtype=cdt, store_dtype=sdt)(
        ps, state, None, noise=torch.tensor(np.asarray(_noise(key))))
    assert ro.states.dtype == (sdt or torch.float32)
    _states(ro.states, jro.states, sdt is not None)
    _close(ro.actions.numpy(), jro.actions, 'actions')
    _close(ro.logprobs.numpy(), jro.logprobs, 'logprobs')
    _close(ro.extras['values'].numpy(), jro.extras['values'], 'values')
    np.testing.assert_allclose(ro.rewards.numpy(), jro.rewards, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(ro.undones.numpy(), jro.undones)
    assert float((1 - ro.undones).sum()) == N            # every lane ends its episode once
    f2, _ = env.kernel_body.pack(state2)
    j2 = jax.tree.map(np.asarray, jstate2)
    _rows(f2, np.concatenate([j2.amount[None], j2.shares.T, j2.total_asset[None],
                              j2.reward_sum[None], j2.cumulative_returns[None]]))
    # the critic pass over the stored states gives the rollout's values: the
    # card's route runs the critic as that second pass, in the same types
    v = fr.critic_values(ps.cri_flat, ps.norm_avg, ps.norm_std, ro.states, net_dims=NET_DIMS,
                         compute_dtype=cdt)
    torch.testing.assert_close(v, ro.extras['values'], rtol=0, atol=1e-6)


@pytest.mark.parametrize('head,types', [('ddpg', 'bf16'), ('sac', 'bf16_store'),
                                        ('modsac', 'f32_store')])
def test_offpolicy_plain_matches_pallas_bf16(head, types):
    cdt, sdt, jcdt, jsdt = TYPES[types]
    jenv, env, jstate, state = _envs()
    args = JConfig()
    if head == 'ddpg':
        js = jmake_ddpg_td3(NET_DIMS, S, A, args, None, td3=True).init(jax.random.PRNGKey(1))
        flat = ddpg_state_from_numpy(jax.tree.map(np.asarray, js), 'cpu').act
    else:
        js = jmake_sac(NET_DIMS, S, A, args, None, modsac=head == 'modsac').init(
            jax.random.PRNGKey(1))
        flat = sac_state_from_numpy(jax.tree.map(np.asarray, js), 'cpu', head == 'modsac').act
    std_clip = (-20.0, 2.0) if head == 'modsac' else (-16.0, 2.0)
    fast = jpr.make_fused_offpolicy_rollout(
        jenv.kernel_body, NET_DIMS, H, N, 0.5, head=head,
        head_cfg={'noise_std': 0.1, 'explore_rate': 0.25, 'std_clip': std_clip}, block=8,
        interpret=True, compute_dtype=jcdt, store_dtype=jsdt)
    key = jax.random.PRNGKey(4)
    jro, _, _ = jax.jit(fast)(js, jstate, jax.vmap(jenv.obs)(jstate), key)
    jro = jax.tree.map(np.asarray, jro)
    f0, i0 = env.kernel_body.pack(state)
    got = fr.offpolicy_rollout(flat, f0, i0, body=env.kernel_body, head=head,
                               net_dims=NET_DIMS, horizon_len=H, reward_scale=0.5,
                               noise_std=0.1, std_clip=std_clip,
                               noise=torch.tensor(np.asarray(_noise(key))),
                               compute_dtype=cdt, store_dtype=sdt)
    assert got.states.dtype == got.actions.dtype == (sdt or torch.float32)
    _states(got.states, jro.states, sdt is not None)
    if sdt is None:
        _close(got.actions.numpy(), jro.actions, 'actions')
    else:   # stored in bf16: one bf16 step where the f32 actions straddle a rounding boundary
        np.testing.assert_allclose(got.actions.float().numpy(),
                                   np.asarray(jro.actions, np.float32), rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(got.rewards.numpy(), jro.rewards, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(1.0 - got.terminals.numpy(), jro.undones)


def _stock_args(agent_class, dims, compute='bfloat16', storage='float32'):
    a = Config(agent_class, StockTradingVecEnv,
               {'env_name': 'StockTradingEnv-v2', 'num_envs': 256, 'max_step': 9,
                'state_dim': S, 'action_dim': A, 'if_discrete': False, 'end_idx': 10})
    a.device, a.net_dims, a.compute_dtype, a.storage_dtype = 'cuda', dims, compute, storage
    a.horizon_len = 32
    return a


@pytest.mark.parametrize('agent_class,head', [(AgentTD3, 'ddpg'), (AgentSAC, 'sac'),
                                              (AgentPPO, None)])
def test_card_takes_k4_bf16_and_raises_past_its_limit(monkeypatch, agent_class, head):
    """On a simulated card the stock body takes K4's bf16 variant (the
    compute and storage types the JAX runner hands its kernel) up to the
    bf16 width limit of its resident designs (576 on-policy, the critic
    pass's tile; 704 for ddpg, 640 for sac and modsac), wider than float32's
    (448; 416), then its streamed designs, in narrower lane groups past their
    widest groups' limits (1408 on-policy, the critic pass's 32-sample
    tiles; 2368 for ddpg, 2016 for sac), and raises past those (2624
    on-policy, the critic pass on 16-sample tiles; 11072 for ddpg, 9152 for
    sac), naming the limit."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    from elegantrl_tpu_torch.train import runner
    made = {}
    monkeypatch.setattr(fr, 'make_fused_rollout', lambda *a, **k: made.update(k) or 'fused')
    monkeypatch.setattr(fr, 'make_fused_offpolicy_rollout',
                        lambda *a, **k: made.update(k) or 'fused')
    body = StockTradingVecEnv(num_envs=1, end_idx=10)._def.kernel_body
    limit = fr.stock_width_limit(head, bf16=True, resident=True)
    assert limit == {None: 576, 'ddpg': 704, 'sac': 640}[head]
    assert fr.stock_width_limit(head, resident=True) == {None: 448, 'ddpg': 448,
                                                         'sac': 416}[head]
    widest = fr.stock_width_limit(head, bf16=True)
    assert widest == {None: 2624, 'ddpg': 11072, 'sac': 9152}[head]
    old = {None: 1408, 'ddpg': 2368, 'sac': 2016}[head]   # the widest groups' limit
    for dims, storage in (((limit, limit), 'float32'), ((128, 128), 'bfloat16'),
                          ((limit + 4, limit + 4), 'float32'), ((old + 4, old + 4), 'float32')):
        a = _stock_args(agent_class, dims, storage=storage)
        env = runner._resolve_env_def(a)
        a.state_dim, a.action_dim, a.if_discrete = S, A, False
        rb = None
        if head is not None:
            from elegantrl_tpu_torch.train.replay_buffer import ReplayBuffer
            rb = ReplayBuffer(max_size=64, state_dim=S, action_dim=A, num_seqs=256, args=a,
                              device='cpu')
        made.clear()
        agent = runner._make_agent(a, rb)
        assert runner._maybe_fused_rollout(a, env, agent, torch.device('cuda'), 256, 32,
                                           1.0) == 'fused'
        assert made['compute_dtype'] == BF
        assert made['store_dtype'] == (BF if storage == 'bfloat16' else None)
        fits = (fr.rollout_fits(body, dims, bf16=True) if head is None
                else fr.offpolicy_fits(body, head, dims, bf16=True))
        assert fits
    assert not (fr.rollout_fits_resident(body, (limit + 4, limit + 4), bf16=True)
                if head is None else
                fr.offpolicy_fits_resident(body, head, (limit + 4, limit + 4), bf16=True))
    wide = (widest + 4, widest + 4)
    assert not (fr.rollout_fits(body, wide, bf16=True) if head is None
                else fr.offpolicy_fits(body, head, wide, bf16=True))
    a = _stock_args(agent_class, wide)
    env = runner._resolve_env_def(a)
    a.state_dim, a.action_dim, a.if_discrete = S, A, False
    rb = None
    if head is not None:
        from elegantrl_tpu_torch.train.replay_buffer import ReplayBuffer
        rb = ReplayBuffer(max_size=64, state_dim=S, action_dim=A, num_seqs=256, args=a,
                          device='cpu')
    agent = runner._make_agent(a, rb)
    text = (f'{widest} on StockTradingEnv-v2' if head is None
            else f'{widest} for {head} on StockTradingEnv-v2 in bf16')
    with pytest.raises(ValueError, match=text):
        runner._maybe_fused_rollout(a, env, agent, torch.device('cuda'), 256, 32, 1.0)
