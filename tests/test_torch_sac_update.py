"""Parity of the port's SAC/ModSAC update chunk's plain version
(``elegantrl_tpu_torch/ops/fused_offpolicy_update.py:sac_chunk_reference``)
with the JAX package's Pallas chunk called directly in interpret mode
(``make_sac_fused_chunk``) on identical pre-gathered blocks, noise, weights,
targets, Adam moments, temperature state and per-step table: S=3, A=2, net
(16, 16), B=128, C=16 with the last 4 steps invalid, SAC with E=4 and
ModSAC with E=8 from update 0 (so the gate skips some steps); then the
backward formulas that ``csrc/sac_update.cu`` writes by hand, against
autograd.

Tolerances, as the JAX package's own chunk tests
(``tests/test_pallas_update.py:364-376``): parameter and target UPDATES
(new - old), Adam moments and the temperature's state to rtol 5e-3, atol
4e-7; objectives to 1e-5; counts exactly.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.ops.pallas_update import make_sac_fused_chunk
from elegantrl_tpu_torch.ops import fused_offpolicy_update as fo
from elegantrl_tpu_torch.ops.nets import sac_act_shapes, sac_cri_shapes, split_flat

torch.set_num_threads(1)
NET_DIMS = (16, 16)
S, A, B, C, VALID = 3, 2, 128, 16, 12       # steps 12-15 of the chunk are invalid
HP = dict(gamma=0.99, tau=5e-3, lr=1e-3, clip_grad=3.0)
VARIANTS = {'sac': (False, 4), 'modsac': (True, 8)}


def _to_kernel(flat, shapes):
    """Kernel-layout leaves of a flat buffer: W (out, in), biases (out, 1)."""
    return tuple(jnp.asarray(x.reshape(-1, 1) if x.dim() == 1 else x)
                 for x in split_flat(torch.as_tensor(flat), shapes))


def _from_kernel(leaves):
    return np.concatenate([np.asarray(x).reshape(-1) for x in leaves])


def _buffers(rng, n, scale):
    """Params, a nearby target, and warm Adam moments (a later step)."""
    p = rng.normal(0, scale, n).astype(np.float32)
    t = (p + rng.normal(0, 0.01, n)).astype(np.float32)
    mu = rng.normal(0, 1e-3, n).astype(np.float32)
    nu = rng.uniform(0, 1e-6, n).astype(np.float32)
    return p, t, mu, nu


def _hypers(modsac, E):
    return dict(HP, modsac=modsac, num_ensembles=E,
                target_entropy=-math.log(A) if modsac else math.log(A),
                std_clip=(-20.0, 2.0) if modsac else (-16.0, 2.0))


@pytest.fixture(scope='module', params=list(VARIANTS))
def sac_pair(request):
    modsac, E = VARIANTS[request.param]
    rng = np.random.default_rng(13)
    act_shapes = sac_act_shapes(S, NET_DIMS, A, modsac)
    cri_shapes = sac_cri_shapes(S, A, NET_DIMS, E)
    na, nc = (sum(math.prod(s) for s in sh) for sh in (act_shapes, cri_shapes))
    # the actor's scale keeps tanh off saturation: near |a| = 1 SAC's
    # log(1.000001 - a^2) turns last-bit differences into large ones
    pa, ta, mua, nua = _buffers(rng, na, 0.1)
    pc, tc, muc, nuc = _buffers(rng, nc, 0.3)
    misc = np.array([-1.2, 1e-3, 1e-6, 7.0, 3.0], np.float32)  # alpha_log, mu, nu, count, upd_a
    blocks = [rng.standard_normal((C, S, B)), rng.standard_normal((C, S, B)),
              rng.uniform(-1, 1, (C, A, B)), rng.standard_normal((C, B)),
              (rng.random((C, B)) > 0.1), (rng.random((C, B)) > 0.1),
              rng.standard_normal((C, A, B)), rng.standard_normal((C, A, B))]
    sb, nsb, ab, rb, ud, um, nzn, nzp = [np.ascontiguousarray(x, np.float32) for x in blocks]
    bcv = fo.sac_bcv(9, 9, torch.arange(C), VALID).numpy()
    hp = _hypers(modsac, E)
    chunk = make_sac_fused_chunk(S, A, B, C, interpret=True, **hp)
    ta_k = _to_kernel(ta, act_shapes) if modsac else ()
    out = chunk(_to_kernel(pa, act_shapes), _to_kernel(pc, cri_shapes), ta_k,
                _to_kernel(tc, cri_shapes), _to_kernel(mua, act_shapes),
                _to_kernel(muc, cri_shapes), _to_kernel(nua, act_shapes),
                _to_kernel(nuc, cri_shapes), tuple(jnp.asarray(v).reshape(1, 1) for v in misc),
                *[jnp.asarray(x) for x in (sb, nsb, ab)],
                *[jnp.asarray(x[:, None, :]) for x in (rb, ud, um)],
                jnp.asarray(nzn), jnp.asarray(nzp), jnp.asarray(bcv))
    want = [_from_kernel(g) if g else None for g in out[:9]] + [np.asarray(out[9])]
    base = [pa, pc, ta if modsac else None, tc, mua, muc, nua, nuc, misc]
    got = [None if x is None else torch.tensor(x) for x in base]
    data = [torch.tensor(x) for x in (sb, nsb, ab, rb, ud, um, nzn, nzp, bcv)]
    objs = fo.sac_chunk(*got, *data, net_dims=NET_DIMS, **hp)
    got = [None if x is None else x.numpy() for x in got] + [objs.numpy()]
    return request.param, base, want, got, data, hp


def test_params_and_targets(sac_pair):
    _, base, want, got, *_ = sac_pair
    for i in range(4):
        if base[i] is None:
            assert got[i] is None and want[i] is None
            continue
        np.testing.assert_allclose(got[i] - base[i], want[i] - base[i], rtol=5e-3, atol=4e-7,
                                   err_msg=f'buffer {i}')
        assert np.abs(got[i] - base[i]).max() > 0, i


def test_adam_moments(sac_pair):
    _, _, want, got, *_ = sac_pair
    for i in range(4, 8):
        np.testing.assert_allclose(got[i], want[i], rtol=5e-3, atol=4e-7, err_msg=f'buffer {i}')


def test_temperature_gate_and_counts(sac_pair):
    """``alpha_log`` and its moments to the chunk tolerance; the actor's Adam
    count and ModSAC's ``update_a`` exactly, and as the host replays the
    gate (``modsac_do_actor``) for the agents' counts."""
    name, base, want, got, *_ = sac_pair
    np.testing.assert_allclose(got[8][:3], want[8][:3], rtol=5e-3, atol=4e-7)
    assert got[8][3] == want[8][3] and got[8][4] == want[8][4]
    do = [True] * VALID
    upd = int(base[8][4])
    if name == 'modsac':
        for t in range(VALID):
            do[t], upd = fo.modsac_do_actor(upd, t)
        assert not all(do)              # the gate skipped some steps
    assert got[8][3] == base[8][3] + sum(do)
    assert got[8][4] == upd
    np.testing.assert_array_equal(got[9][:VALID, 2], np.array(do, np.float32))
    np.testing.assert_array_equal(got[9][VALID:, 2], 0.0)


def test_objectives(sac_pair):
    """The critic loss on every step; the actor objective on the steps the
    actor takes (the callers weigh it by the third column: an invalid step's
    objective goes through a target critic the TPU kernel moved and the
    port's left as it was)."""
    _, _, want, got, *_ = sac_pair
    np.testing.assert_allclose(got[9][:, 0], want[9][:, 0], rtol=1e-5, atol=1e-5)
    took = want[9][:, 2] > 0
    np.testing.assert_allclose(got[9][took, 1], want[9][took, 1], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[9][:, 2], want[9][:, 2])


def test_invalid_steps_leave_state(sac_pair):
    """The chunk with its last four steps invalid ends bit-identical to the
    first twelve steps alone."""
    _, base, _, got, data, hp = sac_pair
    bufs = [None if x is None else torch.tensor(x) for x in base]
    fo.sac_chunk(*bufs, *[x[:VALID] for x in data], net_dims=NET_DIMS, **hp)
    for a, b in zip(bufs, got):
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b)


# ------------------------------------------- hand-written backward formulas

def _autograd(fn, *xs):
    xs = [x.detach().clone().requires_grad_(True) for x in xs]
    return torch.autograd.grad(fn(*xs), xs)


@pytest.mark.parametrize('modsac', [False, True], ids=['sac', 'modsac'])
def test_head_backward_through_logprob_and_clip(modsac):
    """Both logprob forms through the reparameterisation, tanh and the
    log_std clip (some raw log_std outside it, where the gradient is 0)."""
    std_clip = (-20.0, 2.0) if modsac else (-16.0, 2.0)
    gen = torch.Generator().manual_seed(int(modsac))
    Bn, An = 64, 3
    # moderate pre-tanh values: near |a| = 1 the formula and autograd part by
    # the rounding of a^2 (see sac_pair)
    out = 0.5 * torch.randn(Bn, 2 * An, generator=gen)
    out[:, An:] = 0.3 * out[:, An:] - 0.5                       # std near 0.6
    out[:8, An:] = 3.0 + torch.rand(8, An, generator=gen)       # above the clip
    noise = torch.randn(Bn, An, generator=gen)
    noise[:8] *= 0.05
    g_act = torch.randn(Bn, An, generator=gen) * 0.1
    w_lp = 0.37 / Bn

    def loss(o):
        mean, raw = o[:, :An], o[:, An:]
        log_std = torch.clamp(raw, *std_clip)
        std = torch.exp(log_std)
        pre = mean + std * noise
        from elegantrl_tpu_torch.ops.dists import (tanh_normal_logprob,
                                                    tanh_normal_logprob_simple)
        lp = (tanh_normal_logprob(log_std, noise, pre) if modsac
              else tanh_normal_logprob_simple(mean, std, pre))
        return torch.sum(g_act * torch.tanh(pre)) + w_lp * torch.sum(lp)

    want, = _autograd(loss, out)
    got = fo.sac_head_backward(out, noise, g_act, w_lp, modsac, std_clip)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    assert float(got[:8, An:].abs().max()) == 0.0


@pytest.mark.parametrize('E', [4, 8])
def test_ensemble_to_action_gradient(E):
    """The actor step's backward through the ensemble, head by head, to the
    critic's inputs."""
    gen = torch.Generator().manual_seed(E)
    shapes = sac_cri_shapes(6, 2, NET_DIMS, E)
    leaves = [torch.randn(s, generator=gen) * 0.4 for s in shapes]
    x, a = torch.randn(10, 6, generator=gen), torch.randn(10, 2, generator=gen)
    g_q = torch.full((10, E), -1.0 / (10 * E))
    want = _autograd(lambda x_, a_: torch.sum(fo.sac_q_values(leaves, x_, a_, E) * g_q), x, a)
    got = fo.sac_q_input_grad(leaves, x, a, g_q, E)
    torch.testing.assert_close(got, torch.cat(want, dim=-1), rtol=1e-5, atol=1e-7)


def test_td_head_gradient():
    gen = torch.Generator().manual_seed(3)
    qs, label = torch.randn(32, 4, generator=gen), torch.randn(32, generator=gen)
    um = (torch.rand(32, generator=gen) > 0.2).float()
    want, = _autograd(lambda q: torch.mean(torch.mean(torch.square(q - label[:, None]), -1) * um),
                      qs)
    torch.testing.assert_close(fo.sac_td_head_grad(qs, label, um), want, rtol=1e-6, atol=1e-8)


def test_alpha_step():
    """The temperature's gradient is ``te - mean(logp)`` (autograd of its
    loss), clipped by its norm, then Adam and the [-16, 2] clip."""
    gen = torch.Generator().manual_seed(4)
    lp = torch.randn(128, generator=gen) * 3.0 - 5.0
    te = math.log(2.0)
    alpha_log = torch.tensor(-1.0)
    g, = _autograd(lambda al: torch.mean(al * (te - lp)), alpha_log)
    torch.testing.assert_close(g, te - torch.mean(lp))
    mu, nu = torch.tensor(1e-3), torch.tensor(1e-6)
    al2, mu2, nu2 = fo.sac_alpha_step(alpha_log, mu, nu, torch.mean(lp), te, 0.5, 0.01, 0.1, 3.0)
    gc = g * min(1.0, 3.0 / float(g.abs()))
    torch.testing.assert_close(mu2, 0.9 * mu + 0.1 * gc)
    torch.testing.assert_close(nu2, 0.999 * nu + 0.001 * gc * gc)
    torch.testing.assert_close(al2, torch.clamp(alpha_log - 0.1 * (mu2 / 0.5)
                                                / (torch.sqrt(nu2 / 0.01) + 1e-8), -16.0, 2.0))
    low, _, _ = fo.sac_alpha_step(torch.tensor(-15.99), mu, nu, torch.tensor(-1e6), te, 0.5,
                                  0.01, 10.0, 3.0)
    assert float(low) == -16.0
