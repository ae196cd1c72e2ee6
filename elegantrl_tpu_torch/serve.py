"""Policy serving: batched greedy inference behind a small HTTP endpoint
(counterpart of ``elegantrl_tpu/serve.py``).

Load an ``.npz`` checkpoint saved by training (by this package or the JAX
one: ``utils/checkpoint.py:load_tree`` reads the JAX leaf order), and serve
batched ``obs -> action`` over HTTP (stdlib only, a thread per request).
One process owns the card; any number of clients (paper-trading loops,
simulators, dashboards) post observation batches.

    from elegantrl_tpu_torch.serve import PolicyServer
    srv = PolicyServer(AgentPPO, net_dims=(64, 64), env_args={...},
                       checkpoint='cwd/agent.npz')
    srv.start(port=8400)          # non-blocking; srv.stop() to shut down

    POST /act    {"obs": [[...], ...]}  ->  {"action": [[...], ...]}
    GET  /health                        ->  {"ok": true, "requests": N, ...}

The server runs on the ``Config``'s device: the card unless ``device='cpu'``
(without a GPU the default raises, naming ``device='cpu'``).  The greedy
forward is the agent's own ``greedy_action``, so on the card a request to a
3-linear actor or Q net (PPO, the plain DQN) is one launch of K11b
(``ops/kernels.py:fused_mlp3``).  Rows are served as given: the JAX package
pads each batch to a power of two to bound its compiled variants, and the
port compiles none, so nothing is padded; the served rows equal the greedy
action on those rows either way.

Threads: the kernels are built and loaded, and the greedy path run once, in
``__init__`` (before ``start`` can return); each ``act`` runs under one lock
(the launch counters and the request count are plain integers) and under
``device_scope`` of the server's device (a new thread starts on CUDA device
0, and the wrappers launch on the current device).  Nothing falls back: a
client's malformed request is answered 400, and any other failure, a CUDA
error among them, fails the request with 500; no request is answered from
the CPU for a card's server.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from .config import Config, resolve_device
from .parallel.mesh import device_scope
from .utils.checkpoint import load_tree


class PolicyServer:
    def __init__(self, agent_class, net_dims, env_args: dict, checkpoint: str,
                 args: Optional[Config] = None, device: Optional[str] = None):
        args = args or Config(agent_class, None, dict(env_args))
        args.net_dims = net_dims
        if device is not None:
            args.device = device
        self.device = resolve_device(args, owner='PolicyServer')
        from .train.runner import _make_agent
        rb = None
        if args.if_off_policy:
            # the off-policy makers need a buffer object only for update();
            # serving never updates: a one-slot dummy on the server's device
            from .train.replay_buffer import ReplayBuffer
            rb = ReplayBuffer(max_size=8, state_dim=args.state_dim,
                              action_dim=args.action_dim, num_seqs=1,
                              if_discrete=bool(args.if_discrete), args=args,
                              device=self.device)
        agent = _make_agent(args, rb)
        self.state_dim = int(args.state_dim)
        self.if_discrete = bool(args.if_discrete)
        like = agent.state_to_numpy(agent.init(0, self.device))
        self.agent_state = agent.state_from_numpy(load_tree(checkpoint, like), self.device)
        self._greedy = agent.greedy_action
        self._lock = threading.Lock()
        self.requests = 0
        self._httpd = None
        self._thread = None
        # build and load the path's kernels now, not in a request's thread
        self._forward(np.zeros((1, self.state_dim), np.float32))

    def _forward(self, obs: np.ndarray) -> np.ndarray:
        with self._lock, device_scope(self.device), torch.no_grad():
            x = torch.as_tensor(obs, device=self.device)
            return self._greedy(self.agent_state, x).cpu().numpy()

    def _check(self, obs) -> tuple:
        """``(rows, squeeze)``: ``obs`` as float32 rows, or a ValueError for
        a shape the server does not take (the client's error)."""
        obs = np.asarray(obs, np.float32)
        squeeze = obs.ndim == 1
        if squeeze:
            obs = obs[None]
        if obs.ndim != 2 or obs.shape[1] != self.state_dim or obs.shape[0] == 0:
            raise ValueError(f'obs of shape {tuple(obs.shape)}; the server takes '
                             f'(B, {self.state_dim}) with B >= 1, or ({self.state_dim},)')
        return obs, squeeze

    def _serve(self, obs: np.ndarray, squeeze: bool) -> np.ndarray:
        action = self._forward(obs)
        with self._lock:
            self.requests += 1
        return action[0] if squeeze else action

    def act(self, obs: np.ndarray) -> np.ndarray:
        """The greedy action of each row of ``obs`` (``(B, state_dim)``, or
        one observation ``(state_dim,)``), the rows served as given."""
        return self._serve(*self._check(obs))

    # ---- HTTP layer -------------------------------------------------------

    def start(self, host: str = '127.0.0.1', port: int = 8400) -> int:
        """Serve in a background thread; returns the bound port (``port=0``
        takes a free one)."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == '/health':
                    self._reply(200, {'ok': True,
                                      'requests': server.requests,
                                      'state_dim': server.state_dim,
                                      'if_discrete': server.if_discrete})
                else:
                    self._reply(404, {'error': 'unknown path'})

            def do_POST(self):
                if self.path != '/act':
                    self._reply(404, {'error': 'unknown path'})
                    return
                try:
                    n = int(self.headers.get('Content-Length', 0))
                    rows = server._check(json.loads(self.rfile.read(n))['obs'])
                except (ValueError, KeyError, TypeError) as e:    # the client's error
                    self._reply(400, {'error': f'{type(e).__name__}: {e}'})
                    return
                try:
                    action = server._serve(*rows)
                except Exception as e:                             # the server's: fail it
                    self._reply(500, {'error': f'{type(e).__name__}: {e}'})
                    return
                self._reply(200, {'action': np.asarray(action).tolist()})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread.join()
            self._thread = None
