"""The port's replay ring buffer (``elegantrl_tpu_torch/train/replay_buffer.py``)
against the JAX package's ``ReplayBuffer`` on the same inserts: a ring that
wraps, then ``sample`` and ``sample_rows`` with the ids or rows the JAX
buffer draws from its key, held equal exactly (both only copy and gather).
Also the float32 update-count arithmetic of ``agents/off_policy.py`` against
the JAX formula, and the PER, cumulative-return and save/load methods, which
refuse a buffer built without the switch they need (their parity with the
JAX package is ``tests/test_torch_per.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.train.replay_buffer import ReplayBuffer as JReplayBuffer
from elegantrl_tpu_torch.agents.off_policy import offpolicy_update_times
from elegantrl_tpu_torch.train.replay_buffer import ReplayBuffer
from elegantrl_tpu_torch.utils.jax_params import buffer_state_to_numpy

M, N, S, A, H, B = 10, 4, 3, 2, 6, 16


def _items(rng, discrete):
    actions = (rng.integers(0, 5, (H, N)).astype(np.int32) if discrete
               else rng.standard_normal((H, N, A)).astype(np.float32))
    return (rng.standard_normal((H, N, S)).astype(np.float32), actions,
            rng.standard_normal((H, N)).astype(np.float32),
            (rng.random((H, N)) > 0.2).astype(np.float32),
            (rng.random((H, N)) > 0.2).astype(np.float32))


@pytest.fixture(scope='module', params=[False, True], ids=['continuous', 'discrete'])
def buffers(request):
    """Both buffers after three inserts of H = 6 rows into M = 10: the
    pointer runs 0 -> 6 -> 2 -> 8 and the ring wraps twice."""
    discrete = request.param
    jrb = JReplayBuffer(M, S, A, num_seqs=N, if_discrete=discrete, args=JConfig())
    rb = ReplayBuffer(M, S, A, num_seqs=N, if_discrete=discrete, device='cpu')
    jbuf, buf = jrb.init(), rb.init()
    rng = np.random.default_rng(0)
    states = []
    for _ in range(3):
        items = _items(rng, discrete)
        jbuf = jrb.update(jbuf, tuple(jnp.asarray(x) for x in items))
        buf = rb.update(buf, tuple(torch.as_tensor(x) for x in items))
        states.append((jax.tree.map(np.asarray, jbuf), buffer_state_to_numpy(buf)))
    return jrb, rb, jbuf, buf, states


def test_update_wraps_like_jax(buffers):
    _, _, _, _, states = buffers
    for jtree, tree in states:
        for name in ('states', 'actions', 'rewards', 'undones', 'unmasks', 'ptr', 'size'):
            np.testing.assert_array_equal(getattr(tree, name), getattr(jtree, name), err_msg=name)
    assert [int(t.ptr) for _, t in states] == [6, 2, 8]
    assert [int(t.size) for _, t in states] == [6, 10, 10]


@pytest.mark.parametrize('seed', [1, 2])
def test_sample_same_ids_like_jax(buffers, seed):
    jrb, rb, jbuf, buf, _ = buffers
    key = jax.random.PRNGKey(seed)
    want = jrb.sample(jbuf, key, B)
    sample_len = max(int(jbuf.size) - 1, 1)
    ids = jax.random.randint(key, (B,), 0, sample_len * N)       # the JAX buffer's draw
    got = rb.sample(buf, B, ids=torch.tensor(np.asarray(ids)).long())
    for g, w in zip(got[:6], want[:6]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[6], want[6]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize('seed', [1, 2])
def test_sample_rows_same_rows_like_jax(buffers, seed):
    jrb, rb, jbuf, buf, _ = buffers
    key = jax.random.PRNGKey(seed)
    want = jrb.sample_rows(jbuf, key, B)
    sample_len = max(int(jbuf.size) - 1, 1)
    rows = jax.random.randint(key, (B // N,), 0, sample_len)
    got = rb.sample_rows(buf, B, rows=torch.tensor(np.asarray(rows)).long())
    for g, w in zip(got[:6], want[:6]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[6], want[6]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sample_rows_takes_leading_axes(buffers):
    """The chunked updates gather C minibatches at once: ``(C, R)`` rows give
    ``(C, B, ...)`` blocks equal to C separate samples."""
    _, rb, _, buf, _ = buffers
    rows = torch.tensor([[0, 3, 5, 8], [1, 1, 2, 7]])
    both = rb.sample_rows(buf, B, rows=rows)
    for c in range(2):
        one = rb.sample_rows(buf, B, rows=rows[c])
        for g, w in zip(both[:6], one[:6]):
            assert torch.equal(g[c], w)


def test_draw_ranges(buffers):
    _, rb, _, buf, _ = buffers
    gen = torch.Generator().manual_seed(0)
    ids = rb.draw(buf, gen, 5, B, rows=False)
    rows = rb.draw(buf, gen, 5, B, rows=True)
    assert ids.shape == (5, B) and int(ids.max()) < (M - 1) * N and int(ids.min()) >= 0
    assert rows.shape == (5, B // N) and int(rows.max()) < M - 1


@pytest.mark.parametrize('size,repeat,batch', [
    (0, 1.0, 64), (63, 1.0, 64), (4000, 4.0, 1024), (20000, 1.0, 128), (40, 64.0, 128),
    (123457, 0.37, 256)])
def test_update_times_like_jax(size, repeat, batch):
    want = int(jnp.maximum((jnp.asarray(size, jnp.int32).astype(jnp.float32) * repeat
                            / batch).astype(jnp.int32), 1))
    assert offpolicy_update_times(size, repeat, batch) == want


@pytest.mark.parametrize('method', ['sample_for_per', 'td_error_update_for_per',
                                    'update_cum_rewards', 'save_or_load_history'])
def test_unported_methods_raise(method, tmp_path):
    """Once unported, now each method runs on a buffer with its switch on
    (``if_use_per``, ``lambda_fit_cum_r``) and raises on one without it;
    ``save_or_load_history`` needs none and round-trips a plain buffer."""
    from elegantrl_tpu_torch import Config
    args = Config()
    args.lambda_fit_cum_r = 0.5
    rng = np.random.default_rng(1)
    plain = ReplayBuffer(M, S, A, num_seqs=N, device='cpu')
    full = ReplayBuffer(M, S, A, num_seqs=N, if_use_per=True, args=args, device='cpu')
    buf = full.update(full.init(), tuple(torch.tensor(x) for x in _items(rng, False)))
    ids = (torch.tensor([0, 3, 3]), torch.tensor([1, 2, 2]))
    calls = {'sample_for_per': lambda rb, b: rb.sample_for_per(b, B, u=torch.rand(N, B // N)),
             'td_error_update_for_per': lambda rb, b: rb.td_error_update_for_per(
                 b, ids, torch.tensor([1.0, 2.0, 3.0])),
             'update_cum_rewards': lambda rb, b: rb.update_cum_rewards(b, H, torch.ones(H, N)),
             'save_or_load_history': lambda rb, b: rb.save_or_load_history(
                 b, str(tmp_path), if_save=True)}
    out = calls[method](full, buf)
    if method == 'sample_for_per':
        assert out[6].shape == (B,) and bool(torch.all(out[6] > 0))
    elif method == 'td_error_update_for_per':
        assert float(out.per_tree[1][2, 3]) == pytest.approx(3.0 ** 0.6)
    elif method == 'update_cum_rewards':
        assert float(out.cum_rewards[:H].sum()) == H * N
    if method == 'save_or_load_history':
        plain_buf = plain.update(plain.init(), tuple(torch.tensor(x) for x in _items(rng, False)))
        plain.save_or_load_history(plain_buf, str(tmp_path), if_save=True)
        back = plain.save_or_load_history(plain.init(), str(tmp_path), if_save=False)
        assert all(torch.equal(a, b) for a, b in zip(back[:5], plain_buf[:5]))
        assert (back.ptr, back.size) == (plain_buf.ptr, plain_buf.size)
    else:
        with pytest.raises(ValueError, match='if_use_per|lambda_fit_cum_r'):
            calls[method](plain, plain.init())
