"""Evaluator: parallel greedy episodes plus host-side recording
(counterpart of ``elegantrl_tpu/train/evaluator.py``).

Every ``eval_per_step`` training steps it runs ``eval_times`` greedy
episodes side by side as one batch of envs (an episode is frozen once
done; where the env has ``episode_return``, a finished episode reports that
instead of its summed reward), prints the ``ID Step Time | avgR stdR avgS
stdS | expR objC objA`` table (a trailing string in the logging tuple, the
discrete action histogram, is printed after the numbers), appends to
``recorder.npy``, saves actor checkpoints and, at the end of a run,
``LearningCurve.jpg``.  With ``if_tensorboard`` (the argument or
``args.if_tensorboard``) it also writes the JAX evaluator's five scalars
under ``{cwd}/tensorboard``, where ``torch.utils.tensorboard`` imports.
The greedy forwards are the agents' own: a plain 3-linear actor or Q net
runs K11b (``ops/kernels.py:fused_mlp3``) on a card, so an evaluation there
differs from the CPU's by f32 rounding.  A host env (``EnvDef.host_pool``)
is evaluated on its own pool (``host_eval``, the runner's
``args.host_rollout``): the greedy forward on the run's device, the pool
stepped on the host (``envs/host_env.py:HostLink``), episodes run to their
first done; with ``host_eval`` off, through the env's batched
``init``/``step``.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable

import numpy as np
import torch

from ..envs.base import EnvDef
from ..utils.checkpoint import save_tree


def make_eval_fn(env: EnvDef, greedy_action: Callable, num_episodes: int,
                 max_step: int, device, host_eval: bool = True) -> Callable:
    """``fn(agent_state, gen) -> (returns, steps)`` as numpy arrays over
    ``num_episodes`` parallel greedy episodes run to their first done
    (``host_eval``: a host env's pool path, as the module says)."""
    if env.batched and env.host_pool is not None and host_eval:
        from ..envs.host_env import HostLink
        pool = env.host_pool
        link = HostLink(pool, device)

        @torch.no_grad()
        def eval_fn_host(agent_state, gen):
            del gen   # the pool's envs own their reset randomness
            obs = (pool.reset_all(num_episodes, device) if link.native
                   else pool.reset_all(num_episodes))
            done = np.zeros(num_episodes, bool)
            ret = np.zeros(num_episodes, np.float32)
            steps = np.zeros(num_episodes, np.int32)
            for _ in range(max_step):
                obs, reward, terminal, truncate = link.step(
                    greedy_action(agent_state, link.up(obs)))
                if link.native:
                    reward, terminal, truncate = (x.cpu().numpy()
                                                  for x in (reward, terminal, truncate))
                alive = ~done
                ret += reward * alive
                steps += alive
                done |= terminal | truncate
                if done.all():
                    break
            return ret, steps

        return eval_fn_host

    if env.batched:   # whole-batch init/step; no state to freeze
        @torch.no_grad()
        def eval_fn_batched(agent_state, gen):
            state, obs = env.init(gen, num_episodes, device)
            done = torch.zeros(num_episodes, dtype=torch.bool, device=device)
            ret = torch.zeros(num_episodes, device=device)
            steps = torch.zeros(num_episodes, dtype=torch.int32, device=device)
            for _ in range(max_step):
                state, obs, reward, terminal, truncate = env.step(
                    state, greedy_action(agent_state, obs), gen)
                alive = ~done
                ret += reward * alive
                steps += alive.to(torch.int32)
                done = done | terminal | truncate
            both = torch.stack([ret, steps.float()]).cpu().numpy()
            return both[0], both[1]

        return eval_fn_batched

    @torch.no_grad()
    def eval_fn(agent_state, gen):
        state = env.init(gen, num_episodes, device)
        obs = env.obs(state)
        done = torch.zeros(num_episodes, dtype=torch.bool, device=device)
        ret = torch.zeros(num_episodes, device=device)
        steps = torch.zeros(num_episodes, dtype=torch.int32, device=device)
        for _ in range(max_step):
            action = greedy_action(agent_state, obs)     # (N, A), or (N,) indices
            new_state, reward, terminal, truncate = env.step(state, action, gen)
            alive = ~done
            ret += reward * alive
            steps += alive.to(torch.int32)
            # an episode that is done keeps its state; fields may be (N, dim)
            state = type(state)(*[
                torch.where(done.reshape((-1,) + (1,) * (old.dim() - 1)), old, new)
                for new, old in zip(new_state, state)])
            done = done | terminal | truncate
            obs = env.obs(state)
        if env.episode_return is not None:   # e.g. the stock env's cumulative return
            ret = torch.where(done, env.episode_return(state), ret)
        both = torch.stack([ret, steps.float()]).cpu().numpy()
        return both[0], both[1]

    return eval_fn


class Evaluator:
    def __init__(self, cwd: str, env: EnvDef, greedy_action: Callable, args, device,
                 if_tensorboard: bool = False, host_eval: bool = True):
        self.cwd = cwd
        self.agent_id = int(getattr(args, 'gpu_id', 0))
        self.total_step = 0
        self.start_time = time.time()
        self.eval_times = int(getattr(args, 'eval_times', 3))
        self.eval_per_step = int(getattr(args, 'eval_per_step', 2e4))
        self.eval_step_counter = -self.eval_per_step
        self.save_gap = int(getattr(args, 'save_gap', 8))
        self.save_counter = 0
        self.if_keep_save = bool(getattr(args, 'if_keep_save', True))
        self.if_over_write = bool(getattr(args, 'if_over_write', False))
        self.recorder_path = os.path.join(cwd, 'recorder.npy')
        self.recorder = []
        self.recorder_times = []
        self.recorder_step = int(getattr(args, 'eval_record_step', 0))
        self.max_r = -np.inf
        max_step = int(getattr(args, 'max_step', env.spec.max_step))
        self._eval_fn = make_eval_fn(env, greedy_action, self.eval_times, max_step, device,
                                     host_eval)
        self._gen = torch.Generator(device=device)
        self._gen.manual_seed(int(getattr(args, 'random_seed', 0) or 0) + 1943)
        # TensorBoard scalars under {cwd}/tensorboard, the JAX evaluator's tags;
        # nothing where tensorboard is not installed
        self.tensorboard = None
        if if_tensorboard or bool(getattr(args, 'if_tensorboard', False)):
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tensorboard = SummaryWriter(os.path.join(cwd, 'tensorboard'))
            except ImportError:
                pass
        print("| Evaluator:"
              "\n| `step`: Number of samples (env.step() calls)."
              "\n| `time`: Seconds since start of training."
              "\n| `avgR/stdR`: mean/std of episodic cumulative returns."
              "\n| `avgS/stdS`: mean/std of episode lengths."
              "\n| `objC`: critic objective.  `objA`: actor objective."
              f"\n{'#' * 80}\n"
              f"{'ID':<3}{'Step':>8}{'Time':>8} |"
              f"{'avgR':>8}{'stdR':>7}{'avgS':>7}{'stdS':>6} |"
              f"{'expR':>8}{'objC':>7}{'objA':>7}", flush=True)

    def evaluate_and_save(self, agent_state: Any, steps: int, exp_r: float,
                          logging_tuple: tuple, to_numpy: Callable) -> None:
        """Account ``steps`` and, when the cadence is due, evaluate, record,
        print and checkpoint (``to_numpy`` maps the agent state to the tree
        that is saved)."""
        self.total_step += steps
        if self.total_step < self.recorder_step:
            return
        if self.total_step < self.eval_step_counter + self.eval_per_step:
            return
        self.eval_step_counter = self.total_step
        returns, ep_steps = self._eval_fn(agent_state, self._gen)
        avg_r, std_r = float(returns.mean()), float(returns.std())
        avg_s, std_s = float(ep_steps.mean()), float(ep_steps.std())
        used_time = int(time.time() - self.start_time)
        values = [v for v in logging_tuple if isinstance(v, (int, float))]
        logging_str = logging_tuple[-1] if (logging_tuple and isinstance(
            logging_tuple[-1], str)) else ''
        self.recorder.append((self.total_step, avg_r, std_r, exp_r, *values))
        self.recorder_times.append(float(used_time))
        if self.tensorboard is not None:
            step = self.total_step
            self.tensorboard.add_scalar('reward/avg_reward_sample', avg_r, step)
            self.tensorboard.add_scalar('reward/std_reward_sample', std_r, step)
            self.tensorboard.add_scalar('reward/exp_reward_sample', exp_r, step)
            if values:
                self.tensorboard.add_scalar('info/critic_loss_sample', values[0], step)
            if len(values) > 1:
                self.tensorboard.add_scalar('info/actor_obj_sample', values[1], step)
        prev_max_r = self.max_r
        self.max_r = max(self.max_r, avg_r)
        print(f"{self.agent_id:<3}{self.total_step:8.2e}{used_time:8.0f} |"
              f"{avg_r:8.2f}{std_r:7.1f}{avg_s:7.0f}{std_s:6.0f} |"
              f"{exp_r:8.2f}{''.join(f'{v:7.2f}' for v in values)}{logging_str}",
              flush=True)

        if not self.if_keep_save:
            return
        self.save_counter += 1
        actor_path = None
        if avg_r > prev_max_r:
            actor_path = (os.path.join(self.cwd, 'actor.npz') if self.if_over_write
                          else os.path.join(self.cwd, f'actor__{self.total_step:012}_'
                                                      f'{self.max_r:09.3f}.npz'))
        elif self.save_counter >= self.save_gap:
            self.save_counter = 0
            actor_path = (os.path.join(self.cwd, 'actor.npz') if self.if_over_write
                          else os.path.join(self.cwd, f'actor__{self.total_step:012}.npz'))
        if actor_path:
            save_tree(actor_path, to_numpy(agent_state))
            self.save_or_load_recorder(if_save=True)

    def save_or_load_recorder(self, if_save: bool) -> None:
        if if_save:
            np.save(self.recorder_path, np.array(self.recorder, dtype=np.float64))
        elif os.path.exists(self.recorder_path):
            rec = np.load(self.recorder_path)
            self.recorder = [tuple(r) for r in rec]
            if self.recorder:
                self.total_step = int(self.recorder[-1][0])

    def save_training_curve_jpg(self) -> None:
        """Render ``LearningCurve.jpg``: avgR against the step, with the
        band of one stdR.  Without matplotlib (not every machine has it)
        nothing is drawn."""
        if not self.recorder:
            return
        try:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
        except ImportError:
            return
        rec = np.array(self.recorder, dtype=np.float64)
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.plot(rec[:, 0], rec[:, 1], color='tab:blue', label='avgR')
        ax.fill_between(rec[:, 0], rec[:, 1] - rec[:, 2], rec[:, 1] + rec[:, 2],
                        color='tab:blue', alpha=0.25)
        ax.set_xlabel('total step')
        ax.set_ylabel('episode return')
        ax.grid(alpha=0.4)
        ax.legend()
        fig.savefig(os.path.join(self.cwd, 'LearningCurve.jpg'), dpi=120)
        plt.close(fig)
